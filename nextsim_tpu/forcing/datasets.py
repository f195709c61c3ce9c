"""Declarative forcing-dataset registry + NetCDF ingest pipeline.

The replacement of the reference's DataSet/ExternalData machinery
(reference: model/dataset.cpp:59-9735 — 52 hard-coded descriptors;
model/externaldata.cpp:130-439 — lazy reload, unit transforms, vector
rotation, time interpolation). The descriptors become data (DatasetSpec
below); ingest runs on the host: bracketing time planes are read from
NetCDF, spatially interpolated onto the model grid with precomputed weights,
vector fields rotated from east/north into the model's stereographic x/y,
then the per-step linear time interpolation (with the spin-up ramp,
externaldata.cpp:366-404) produces each step's `Forcing`. A background
thread prefetches the next planes so file IO never blocks the device step.

Grid types cover the reference's three cases (dataset.hpp:42-51):
* regular lat/lon (ERA5, CFSR)             -> bilinear in lat/lon
* polar-stereographic x/y (generic_ps, ASR)-> bilinear in projected coords
* curvilinear lat/lon (TOPAZ, GLORYS)      -> Delaunay linear interpolation
  (the analog of BamgTriangulatex + InterpFromMeshToMesh2dx)
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from nextsim_tpu.forcing.base import Forcing
from nextsim_tpu.forcing.netcdf_io import NCFile
from nextsim_tpu.grid.projection import NPS_ASR, NPS_NEXTSIM, PolarStereo
from nextsim_tpu.utils import dates


@dataclasses.dataclass(frozen=True)
class DataVar:
    file_var: str  # variable name inside the file
    target: str  # Forcing field name ('wind_u', 'tair', ...)
    a: float = 1.0  # unit transform: value*a + b (dataset.hpp:81-111)
    b: float = 0.0
    var_string: Optional[str] = None  # ${VARSTRING} in per-variable files
    # 'inv': 1/x after scaling (wave peak frequency -> period);
    # 'wave_dir_from': angle in degrees interpolated via its unit components
    # (the reference's wavDirOptions x/yComponent pair, dataset.hpp:87-96)
    transform: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class GridSpec:
    kind: str  # 'regular_latlon' | 'polar_stereo' | 'curvilinear'
    lat_name: str = "latitude"
    lon_name: str = "longitude"
    x_name: str = "x"
    y_name: str = "y"
    projection: Optional[PolarStereo] = None  # for polar_stereo grids
    cyclic_lon: bool = False


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    filename_mask: str  # strftime mask, ${VARSTRING} substitution allowed
    frequency: str  # 'yearly' | 'monthly' | 'daily' | 'static'
    grid: GridSpec
    variables: Tuple[DataVar, ...]
    vectors: Tuple[Tuple[str, str], ...] = ()  # (u_target, v_target) to rotate
    nodal_targets: Tuple[str, ...] = ()  # targets sampled at nodes
    reference_date: str = "1900-01-01"
    time_name: str = "time"
    # vectors already on the source grid's axes rather than east/north
    # (the reference's east_west_oriented=false, dataset.hpp:117): rotated by
    # the local grid-axis angle instead of the meridian convergence
    grid_oriented_vectors: bool = False
    # extra record dimension selecting the ensemble member (reference:
    # externaldata.cpp:852-858 'ensemble_member')
    member_dim: Optional[str] = None


# ---------------------------------------------------------------------------
# Registry (transcribed from model/dataset.cpp descriptors)
# ---------------------------------------------------------------------------

_REGULAR_LL = GridSpec(kind="regular_latlon", cyclic_lon=True)

REGISTRY: Dict[str, DatasetSpec] = {}


def _register(spec: DatasetSpec):
    REGISTRY[spec.name] = spec
    return spec


# ERA5 (reference: dataset.cpp:8575-8990): per-variable yearly files
_register(
    DatasetSpec(
        name="era5",
        filename_mask="ERA5_${VARSTRING}_y%Y.nc",
        frequency="yearly",
        grid=_REGULAR_LL,
        variables=(
            DataVar("u10", "wind_u", var_string="u10"),
            DataVar("v10", "wind_v", var_string="v10"),
            DataVar("t2m", "tair", b=-273.15, var_string="t2m"),
            DataVar("d2m", "dair", b=-273.15, var_string="d2m"),
            DataVar("msl", "mslp", var_string="msl"),
            DataVar("msdwswrf", "qsw_in", var_string="msdwswrf"),
            DataVar("msdwlwrf", "qlw_in", var_string="msdwlwrf"),
            DataVar("mtpr", "precip", var_string="mtpr"),
            DataVar("msr", "snowfall", var_string="msr"),
        ),
        vectors=(("wind_u", "wind_v"),),
        nodal_targets=("wind_u", "wind_v"),
    )
)

# generic polar-stereographic atmosphere (reference: dataset.cpp:496-840):
# daily files on the NpsNextsim projection
_register(
    DatasetSpec(
        name="generic_ps",
        filename_mask="generic_ps_atm_%Y%m%d.nc",
        frequency="daily",
        grid=GridSpec(kind="polar_stereo", projection=NPS_NEXTSIM),
        variables=(
            DataVar("u_wind_10m", "wind_u"),
            DataVar("v_wind_10m", "wind_v"),
            DataVar("t2m", "tair", b=-273.15),
            DataVar("d2m", "dair", b=-273.15),
            DataVar("msl", "mslp"),
            DataVar("ssrd", "qsw_in"),
            DataVar("strd", "qlw_in"),
            DataVar("tp", "precip"),
            DataVar("sf", "snowfall"),
        ),
        vectors=(),  # already on the model projection
        nodal_targets=("wind_u", "wind_v"),
    )
)

# ASR (reference: dataset.cpp ASR_nodes/elements): polar stereo on NpsASR
_register(
    DatasetSpec(
        name="asr",
        filename_mask="asr30km.comb.2D.%Y%m.nc",
        frequency="monthly",
        grid=GridSpec(kind="polar_stereo", projection=NPS_ASR),
        variables=(
            DataVar("U10", "wind_u"),
            DataVar("V10", "wind_v"),
            DataVar("T2", "tair", b=-273.15),
            DataVar("Q2", "sphuma"),
            DataVar("PSFC", "mslp"),
            DataVar("SWDNB", "qsw_in"),
            DataVar("LWDNB", "qlw_in"),
            DataVar("RAINNC", "precip", a=1.0 / 10800.0),  # mm/3h -> kg/m2/s
            DataVar("SNOWNC", "snowfall", a=1.0 / 10800.0),
        ),
        vectors=(("wind_u", "wind_v"),),
        nodal_targets=("wind_u", "wind_v"),
    )
)

# CFSR (reference: dataset.cpp cfsr_nodes/elements)
_register(
    DatasetSpec(
        name="cfsr",
        filename_mask="cfsr.6h.%Y%m.nc",
        frequency="monthly",
        grid=_REGULAR_LL,
        variables=(
            DataVar("U_GRD_L103", "wind_u"),
            DataVar("V_GRD_L103", "wind_v"),
            DataVar("TMP_L103", "tair", b=-273.15),
            DataVar("SPF_H_L103", "sphuma"),
            DataVar("PRES_L1", "mslp"),
            DataVar("DSWRF_L1", "qsw_in"),
            DataVar("DLWRF_L1", "qlw_in"),
            DataVar("PRATE_L1", "precip"),
        ),
        vectors=(("wind_u", "wind_v"),),
        nodal_targets=("wind_u", "wind_v"),
    )
)

# ECMWF NRT forecast atmosphere (reference: dataset.cpp:9087-9353
# ecmwf_nrt_*: regular lat/lon, daily files)
_register(
    DatasetSpec(
        name="ecmwf_nrt",
        filename_mask="ecmwf_nrt_%Y%m%d.nc",
        frequency="daily",
        grid=GridSpec(kind="regular_latlon", lat_name="lat", lon_name="lon", cyclic_lon=True),
        variables=(
            DataVar("10U", "wind_u"),
            DataVar("10V", "wind_v"),
            DataVar("2T", "tair", b=-273.15),
            DataVar("2D", "dair", b=-273.15),
            DataVar("MSL", "mslp"),
            DataVar("SSRD", "qsw_in", a=1.0 / 21600.0),  # J/m2 per 6h -> W/m2
            DataVar("STRD", "qlw_in", a=1.0 / 21600.0),
            DataVar("TCC", "tcc"),
            DataVar("TP", "precip", a=1000.0 / 21600.0),  # m per 6h -> kg/m2/s
        ),
        vectors=(("wind_u", "wind_v"),),
        nodal_targets=("wind_u", "wind_v"),
    )
)

# TOPAZ4 reanalysis ocean (reference: dataset.cpp:1916-2311 topaz4r —
# curvilinear grid, monthly files %Y/topaz_rean_%Y%m.nc; the same files also
# carry the ice fields siconc/sithick/sisnthick used by ice init)
_register(
    DatasetSpec(
        name="topaz4r",
        filename_mask="%Y/topaz_rean_%Y%m.nc",
        frequency="monthly",
        grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
        variables=(
            DataVar("uo", "ocean_u"),
            DataVar("vo", "ocean_v"),
            DataVar("zos", "ssh"),
            DataVar("thetao", "ocean_temp"),
            DataVar("so", "ocean_salt"),
            DataVar("mlotst", "mld"),
        ),
        vectors=(("ocean_u", "ocean_v"),),
        nodal_targets=("ocean_u", "ocean_v", "ssh"),
    )
)

# TOPAZ NRT forecast ocean (reference: dataset.cpp:4752-5432 topaz_nrt)
_register(
    DatasetSpec(
        name="topaz4nrt",
        filename_mask="topaz_nrt_%Y%m%d.nc",
        frequency="daily",
        grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
        variables=(
            DataVar("uo", "ocean_u"),
            DataVar("vo", "ocean_v"),
            DataVar("zos", "ssh"),
            DataVar("thetao", "ocean_temp"),
            DataVar("so", "ocean_salt"),
            DataVar("mlotst", "mld"),
        ),
        vectors=(("ocean_u", "ocean_v"),),
        nodal_targets=("ocean_u", "ocean_v", "ssh"),
    )
)

# --- observed ice products for ice init / assimilation (reference:
# dataset.cpp ice_* descriptors; conc products are in percent -> a=0.01) ----

_register(DatasetSpec(
    name="ice_osisaf",
    filename_mask="ice_conc_nh_polstere-100_multi_%Y%m%d1200.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="lat", lon_name="lon"),
    variables=(DataVar("ice_conc", "obs_conc", a=0.01),),
))
_register(DatasetSpec(
    name="ice_osisaf_type",
    filename_mask="ice_type_nh_polstere-100_multi_%Y%m%d1200.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="lat", lon_name="lon"),
    variables=(DataVar("ice_type", "obs_type"),),
))
_register(DatasetSpec(
    name="ice_amsr2",
    filename_mask="Arc_%Y%m%d_res3.125_pyres.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(DataVar("sea_ice_concentration", "obs_conc", a=0.01),),
))
_register(DatasetSpec(
    name="ice_amsre",
    filename_mask="asi-n6250-%Y%m%d-v5i.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(DataVar("sea_ice_concentration", "obs_conc", a=0.01),),
))
_register(DatasetSpec(
    name="ice_smos",
    filename_mask="SMOS_Icethickness_v3.1_north_%Y%m%d.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(DataVar("sea_ice_thickness", "obs_thick"),),
))
_register(DatasetSpec(
    name="ice_cs2_smos",
    filename_mask="cs2_smos_ice_thickness_%Y%m%d.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="lat", lon_name="lon"),
    variables=(
        DataVar("analysis_sea_ice_thickness", "obs_thick"),
        DataVar("sea_ice_concentration", "obs_conc", a=0.01),
    ),
))
_register(DatasetSpec(
    name="ice_nic",
    filename_mask="NIC_%Y%m%d_res3.125_pyres.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(DataVar("sea_ice_concentration", "obs_conc", a=0.01),),
))
_register(DatasetSpec(
    name="ice_nic_weekly",
    filename_mask="NIC_weekly_%Y%m%d_res3.125_pyres.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(DataVar("sea_ice_concentration", "obs_conc", a=0.01),),
))
_register(DatasetSpec(
    name="ice_icesat",
    filename_mask="icesat_icethk_ON06_filled.nc",
    frequency="static",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(DataVar("icethk", "obs_thick", a=0.01),),  # cm -> m
))
# AROME-blended ECMWF NRT atmosphere (reference: dataset.cpp:925-1354
# ecmwf_nrt_arome_{nodes,elements}): daily curvilinear 2.5 km files; winds
# are oriented along the source grid axes (east_west_oriented=false)
_register(DatasetSpec(
    name="ecmwf_nrt_arome",
    filename_mask="ecmwf_nrt_arome_blended_%Y%m%d.nc",
    frequency="daily",
    reference_date="1970-01-01",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(
        DataVar("x_wind_10m", "wind_u"),
        DataVar("y_wind_10m", "wind_v"),
        DataVar("air_temperature_2m", "tair", b=-273.15),
        DataVar("specific_humidity_2m", "sphuma"),
        DataVar("air_pressure_at_sea_level", "mslp"),
        DataVar("integral_of_surface_downwelling_shortwave_flux_in_air_wrt_time",
                "qsw_in", a=1.0 / 3600.0),  # 1h-integrated -> rate
        DataVar("integral_of_surface_downwelling_longwave_flux_in_air_wrt_time",
                "qlw_in", a=1.0 / 3600.0),
        DataVar("integral_of_snowfall_amount_wrt_time", "snowfall", a=1.0 / 3600.0),
        DataVar("precipitation_amount_acc", "precip", a=1.0 / 3600.0),
    ),
    vectors=(("wind_u", "wind_v"),),
    nodal_targets=("wind_u", "wind_v"),
    grid_oriented_vectors=True,
))
# ensemble variant (dataset.cpp:1354-1916): same fields with an extra
# ensemble_member record dimension selected by statevector.ensemble_member
_register(dataclasses.replace(
    REGISTRY["ecmwf_nrt_arome"],
    name="ecmwf_nrt_arome_ensemble",
    filename_mask="ecmwf_nrt_arome_blended_ensemble_%Y%m%d.nc",
    member_dim="ensemble_member",
))
# CFSR high-resolution winds (dataset.cpp:8392-8575 cfsr_nodes_hi): monthly
# files carrying only the 10 m wind; thermo fields come from regular cfsr
_register(DatasetSpec(
    name="cfsr_hi",
    filename_mask="cfsr_h.sh.%Y%m.nc",
    frequency="monthly",
    time_name="time0",
    grid=GridSpec(kind="regular_latlon", lat_name="lat", lon_name="lon", cyclic_lon=True),
    variables=(
        DataVar("U_GRD_L103", "wind_u"),
        DataVar("V_GRD_L103", "wind_v"),
    ),
    vectors=(("wind_u", "wind_v"),),
    nodal_targets=("wind_u", "wind_v"),
))
# TOPAZ5 NRT ocean (dataset.cpp:5044-5500 topaz5_nrt_{nodes,elements}):
# daily files, vxo/vyo current names (vs uo/vo in topaz4_nrt)
_register(DatasetSpec(
    name="topaz5_nrt",
    filename_mask="topaz_nrt_%Y%m%d.nc",
    frequency="daily",
    reference_date="1970-01-01",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(
        DataVar("vxo", "ocean_u"),
        DataVar("vyo", "ocean_v"),
        DataVar("zos", "ssh"),
        DataVar("thetao", "ocean_temp"),
        DataVar("so", "ocean_salt"),
        DataVar("mlotst", "mld"),
        DataVar("siconc", "obs_conc"),
        DataVar("sithick", "obs_thick"),
        DataVar("sisnthick", "obs_snow"),
    ),
    vectors=(("ocean_u", "ocean_v"),),
    nodal_targets=("ocean_u", "ocean_v", "ssh"),
))
# Standalone wave forcing for the WIM (dataset.cpp:9469-9735 ww3a_elements,
# erai_waves_1deg_elements). Operationally wave fields ride the OASIS-WW3
# coupling exchange (coupling/exchange.py); these files drive the WIM when
# wimsetup.wave-type selects them. Directions interpolate via their unit
# components (wavDirOptions x/yComponent); ww3a's peak frequency converts
# to a period.
_register(DatasetSpec(
    name="ww3a",
    filename_mask="SWARP_WW3_ARCTIC-12K_%Y%m%d.nc",
    frequency="daily",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(
        DataVar("hs", "swh"),
        DataVar("fp", "mwp", transform="inv"),  # peak frequency -> period
        DataVar("dir", "mwd", transform="wave_dir_from"),
    ),
))
_register(DatasetSpec(
    name="erai_waves_1deg",
    filename_mask="erai_waves_1deg_%Y.nc",
    frequency="yearly",
    grid=GridSpec(kind="regular_latlon", lat_name="latitude", lon_name="longitude", cyclic_lon=True),
    variables=(
        DataVar("swh", "swh"),
        DataVar("mwp", "mwp"),
        DataVar("mwd", "mwd", transform="wave_dir_from"),
    ),
))
_register(DatasetSpec(
    name="dist2coast",
    filename_mask="dist2coast_4deg.nc",
    frequency="static",
    grid=GridSpec(kind="regular_latlon", lat_name="lat", lon_name="lon"),
    # km -> m, matching the reference's a:1000 (dataset.cpp dist2coast "dist")
    variables=(DataVar("dist", "dist", a=1000.0),),
))
_register(DatasetSpec(
    name="ice_nemo",
    filename_mask="NEMO_icemod.nc",
    frequency="static",
    grid=GridSpec(kind="curvilinear", lat_name="nav_lat", lon_name="nav_lon"),
    variables=(
        DataVar("frld", "obs_conc", a=-1.0, b=1.0),  # lead fraction -> conc
        DataVar("hicif", "obs_thick"),
        DataVar("hsnif", "obs_snow"),
    ),
))
_register(DatasetSpec(
    name="ice_cice",
    filename_mask="CICE_%Y%m.nc",
    frequency="monthly",
    grid=GridSpec(kind="curvilinear", lat_name="lat", lon_name="lon"),
    variables=(
        DataVar("aice", "obs_conc"),
        DataVar("hi", "obs_thick"),
        DataVar("hs", "obs_snow"),
    ),
))
_register(DatasetSpec(
    name="ice_piomas",
    filename_mask="PIOMAS_%Y.nc",
    frequency="yearly",
    grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
    variables=(
        DataVar("area", "obs_conc"),
        DataVar("heff", "obs_thick"),
        DataVar("snow", "obs_snow"),
    ),
))

# GLORYS12 ocean (reference: dataset.cpp glorys12: regular lat/lon)
_register(
    DatasetSpec(
        name="glorys12",
        filename_mask="GLORYS12V1_%Y%m%d.nc",
        frequency="daily",
        grid=_REGULAR_LL,
        variables=(
            DataVar("uo", "ocean_u"),
            DataVar("vo", "ocean_v"),
            DataVar("zos", "ssh"),
            DataVar("thetao", "ocean_temp"),
            DataVar("so", "ocean_salt"),
            DataVar("mlotst", "mld"),
        ),
        vectors=(("ocean_u", "ocean_v"),),
        nodal_targets=("ocean_u", "ocean_v", "ssh"),
    )
)

# Altimeter-derived surface currents (reference: dataset.cpp:5839-6080
# ocean_currents_nodes — yearly current_%Y.nc on a curvilinear grid, U/V
# [m/s] on the grid's own axes (east_west_oriented=false) + SSH [m],
# 1950-01-01 epoch). The nodes dataset of
# setup.ocean-type=topaz4_rean-altimeter (fe.cpp:792-795), layered over the
# topaz4r elements dataset.
_register(
    DatasetSpec(
        name="ocean_currents",
        filename_mask="current_%Y.nc",
        frequency="yearly",
        grid=GridSpec(kind="curvilinear", lat_name="latitude", lon_name="longitude"),
        variables=(
            DataVar("U", "ocean_u"),
            DataVar("V", "ocean_v"),
            DataVar("SSH", "ssh"),
        ),
        vectors=(("ocean_u", "ocean_v"),),
        nodal_targets=("ocean_u", "ocean_v", "ssh"),
        reference_date="1950-01-01",
        grid_oriented_vectors=True,
    )
)

# ETOPO bathymetry (reference: dataset.cpp etopo + initBathymetry
# fe.cpp:13749-13777): static
_register(
    DatasetSpec(
        name="etopo",
        filename_mask="ETOPO_Arctic_2arcmin.nc",
        frequency="static",
        grid=GridSpec(kind="regular_latlon", lat_name="lat", lon_name="lon"),
        variables=(DataVar("z", "depth", a=-1.0),),  # depth positive down
    )
)


# ---------------------------------------------------------------------------
# Spatial interpolators (precomputed at init)
# ---------------------------------------------------------------------------


class _RegularLatLonInterp:
    """Bilinear in lat/lon with optional cyclic longitude (the analog of
    InterpFromGridToMeshx, contrib/bamg/src/InterpFromGridToMeshx.cpp)."""

    def __init__(self, lats: np.ndarray, lons: np.ndarray, q_lat, q_lon, cyclic: bool):
        lats = np.asarray(lats, np.float64)
        lons = np.asarray(lons, np.float64)
        self.flip_lat = lats[0] > lats[-1]
        if self.flip_lat:
            lats = lats[::-1]
        q_lon = np.mod(np.asarray(q_lon) - lons[0], 360.0) + lons[0]
        nlat, nlon = len(lats), len(lons)
        fy = np.interp(np.asarray(q_lat).ravel(), lats, np.arange(nlat))
        lon_ext = lons
        fx = np.interp(q_lon.ravel(), lon_ext, np.arange(nlon))
        if cyclic:
            # points beyond the last longitude wrap to [last, first+360)
            dlon = lons[1] - lons[0]
            beyond = q_lon.ravel() > lons[-1]
            fx = np.where(
                beyond, (q_lon.ravel() - lons[-1]) / dlon + (nlon - 1), fx
            )
        self.j0 = np.floor(fy).astype(int)
        self.j1 = np.minimum(self.j0 + 1, nlat - 1)
        self.wy = fy - self.j0
        self.i0 = np.floor(fx).astype(int) % nlon
        self.i1 = (self.i0 + 1) % nlon if cyclic else np.minimum(self.i0 + 1, nlon - 1)
        self.wx = fx - np.floor(fx)
        self.out_shape = np.asarray(q_lat).shape

    def __call__(self, field2d: np.ndarray) -> np.ndarray:
        f = np.asarray(field2d, np.float64)
        if self.flip_lat:
            f = f[::-1, :]
        v = (
            f[self.j0, self.i0] * (1 - self.wx) * (1 - self.wy)
            + f[self.j0, self.i1] * self.wx * (1 - self.wy)
            + f[self.j1, self.i0] * (1 - self.wx) * self.wy
            + f[self.j1, self.i1] * self.wx * self.wy
        )
        return v.reshape(self.out_shape)


class _PolarStereoInterp:
    """Bilinear in the dataset's own projected x/y coordinates."""

    def __init__(self, xs: np.ndarray, ys: np.ndarray, proj: PolarStereo, q_lat, q_lon):
        qx, qy = proj.forward(np.asarray(q_lat), np.asarray(q_lon))
        qx, qy = np.asarray(qx), np.asarray(qy)
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        fx = np.interp(qx.ravel(), xs, np.arange(len(xs)))
        fy = np.interp(qy.ravel(), ys, np.arange(len(ys)))
        self.i0 = np.floor(fx).astype(int)
        self.i1 = np.minimum(self.i0 + 1, len(xs) - 1)
        self.wx = fx - self.i0
        self.j0 = np.floor(fy).astype(int)
        self.j1 = np.minimum(self.j0 + 1, len(ys) - 1)
        self.wy = fy - self.j0
        self.out_shape = qx.shape

    def __call__(self, field2d: np.ndarray) -> np.ndarray:
        f = np.asarray(field2d, np.float64)
        v = (
            f[self.j0, self.i0] * (1 - self.wx) * (1 - self.wy)
            + f[self.j0, self.i1] * self.wx * (1 - self.wy)
            + f[self.j1, self.i0] * (1 - self.wx) * self.wy
            + f[self.j1, self.i1] * self.wx * self.wy
        )
        return v.reshape(self.out_shape)


class _CurvilinearInterp:
    """Delaunay linear interpolation from scattered curvilinear grid points —
    the analog of the reference's BamgTriangulatex + InterpFromMeshToMesh2dx
    path used for TOPAZ-style grids (dataset.cpp loadGrid)."""

    def __init__(self, lat2d, lon2d, proj: PolarStereo, q_lat, q_lon):
        from scipy.spatial import Delaunay

        px, py = proj.forward(np.asarray(lat2d).ravel(), np.asarray(lon2d).ravel())
        self.pts = np.column_stack([np.asarray(px), np.asarray(py)])
        self.tri = Delaunay(self.pts)
        qx, qy = proj.forward(np.asarray(q_lat), np.asarray(q_lon))
        q = np.column_stack([np.asarray(qx).ravel(), np.asarray(qy).ravel()])
        simplex = self.tri.find_simplex(q)
        self.inside = simplex >= 0
        simplex_c = np.maximum(simplex, 0)
        X = self.tri.transform[simplex_c]
        bary = np.einsum("ijk,ik->ij", X[:, :2], q - X[:, 2])
        self.weights = np.column_stack([bary, 1.0 - bary.sum(axis=1)])
        self.verts = self.tri.simplices[simplex_c]
        # fallback: nearest point for outside queries
        from scipy.spatial import cKDTree

        self.nearest = cKDTree(self.pts).query(q)[1]
        self.out_shape = np.asarray(q_lat).shape

    def __call__(self, field2d: np.ndarray) -> np.ndarray:
        f = np.asarray(field2d, np.float64).ravel()
        v = (f[self.verts] * self.weights).sum(axis=1)
        v = np.where(self.inside, v, f[self.nearest])
        return v.reshape(self.out_shape)


def _rotation_angles(proj_lon0: float, lon: np.ndarray):
    """cos/sin of the angle rotating east/north components into the model's
    stereographic x/y (reference: ExternalData::transformData rotation,
    externaldata.cpp): east = (cos(lam), sin(lam)), north = (-sin(lam),
    cos(lam)) with lam = lon - lon0."""
    lam = np.deg2rad(np.asarray(lon) - proj_lon0)
    return np.cos(lam), np.sin(lam)


# ---------------------------------------------------------------------------
# Time handling
# ---------------------------------------------------------------------------

_UNIT_FACTORS = {"seconds": 1.0 / 86400.0, "hours": 1.0 / 24.0, "days": 1.0}


def _parse_time_units(units: str) -> Tuple[float, float]:
    """Returns (datenum of epoch, factor to days)."""
    m = re.match(r"(\w+)\s+since\s+([0-9:\-\sTZ]+)", units.strip())
    if not m:
        raise ValueError(f"cannot parse time units {units!r}")
    unit, epoch = m.group(1).lower(), m.group(2).strip()
    factor = _UNIT_FACTORS.get(unit.rstrip("s") + "s")
    if factor is None:
        raise ValueError(f"unknown time unit {unit!r}")
    return dates.string_to_datenum(epoch.split(".")[0].strip()), factor


def _file_dates(frequency: str, t: float) -> List:
    """Candidate file datetimes bracketing model time t."""
    d = dates.datenum_to_datetime(t)
    if frequency == "static":
        return [d]
    if frequency == "yearly":
        return [d.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)]
    if frequency == "monthly":
        return [d.replace(day=1, hour=0, minute=0, second=0, microsecond=0)]
    return [d.replace(hour=0, minute=0, second=0, microsecond=0)]


# ---------------------------------------------------------------------------
# The provider
# ---------------------------------------------------------------------------


class DatasetForcing:
    """Builds a Forcing per step from NetCDF datasets, mirroring the
    reference's checkReloadMainDatasets -> check_and_reload flow
    (fe.cpp:967-992; externaldata.cpp:130-306), with host-side prefetch."""

    def __init__(self, cfg, grid, dtype=None):
        import jax.numpy as jnp

        self.cfg = cfg
        self.grid = grid
        self.dtype = dtype or jnp.float32
        self.spinup_days = cfg["simul.spinup_duration"]
        self.data_dir = os.environ.get("NEXTSIM_DATA_DIR", ".")
        self.atm_dir = cfg["setup.atmospheric_forcing_input_path"] or self.data_dir
        self.ocn_dir = cfg["setup.oceanic_forcing_input_path"] or self.data_dir

        atm = cfg["setup.atmosphere-type"]
        ocn = cfg["setup.ocean-type"]
        member = cfg["statevector.ensemble_member"]
        # atmosphere-type -> dataset stack (later readers override earlier
        # fields; cfsr_hi layers hi-res winds over the regular cfsr thermo
        # fields, matching the reference's cfsr_nodes_hi + cfsr_elements)
        atm_map = {
            "era5": ["era5"], "generic_ps": ["generic_ps"], "asr": ["asr"],
            "cfsr": ["cfsr"], "cfsr_hi": ["cfsr", "cfsr_hi"],
            "ecmwf_nrt": ["ecmwf_nrt"],
            "ecmwf_nrt_arome": ["ecmwf_nrt_arome"],
            "ecmwf_nrt_arome_ensemble": ["ecmwf_nrt_arome_ensemble"],
        }
        # ocean-type -> dataset stack (reference str2ocean spellings accepted
        # alongside the hyphenated ones; fe.cpp:1314-1322 + dispatch 781-815).
        # topaz4_rean-altimeter layers the altimeter ocean_currents nodes
        # dataset over the topaz4r elements fields (fe.cpp:792-795);
        # *_atrest keeps topaz4r hydrography but the currents stay at the
        # ideal_simul constants (fe.cpp:11219-11236).
        ocn_map = {
            "topaz4": ["topaz4r"], "topaz4_rean": ["topaz4r"],
            "topaz4-atrest": ["topaz4r"], "topaz4_rean_atrest": ["topaz4r"],
            "topaz4_rean-altimeter": ["topaz4r", "ocean_currents"],
            "topaz4-nrt": ["topaz4nrt"], "topaz4_nrt": ["topaz4nrt"],
            "topaz5-nrt": ["topaz5_nrt"], "topaz5_nrt": ["topaz5_nrt"],
            "glorys12": ["glorys12"],
        }
        self._ocean_at_rest = ocn in ("topaz4-atrest", "topaz4_rean_atrest")
        self.sources: List[_DatasetReader] = []
        if atm in atm_map:
            for nm in atm_map[atm]:
                self.sources.append(
                    _DatasetReader(REGISTRY[nm], grid, self.atm_dir, member=member)
                )
        elif atm != "constant":
            raise NotImplementedError(f"atmosphere-type {atm}")
        if ocn in ocn_map:
            for nm in ocn_map[ocn]:
                self.sources.append(
                    _DatasetReader(REGISTRY[nm], grid, self.ocn_dir)
                )
        elif ocn not in ("constant", "coupled"):
            raise NotImplementedError(f"ocean-type {ocn}")
        # ETOPO bathymetry -> Forcing.depth (reference: initBathymetry,
        # fe.cpp:13749-13777; etopo_elements dataset). File absent ->
        # ideal_simul.constant_bathymetry fallback (logged once).
        if cfg["setup.bathymetry-type"] == "etopo":
            from nextsim_tpu.forcing.bathymetry import etopo_path

            bpath = etopo_path(cfg)
            if os.path.exists(bpath):
                spec = REGISTRY["etopo"]
                fname = cfg["setup.bathymetry-file"]
                if fname and fname != spec.filename_mask:
                    spec = dataclasses.replace(spec, filename_mask=fname)
                self.sources.append(
                    _DatasetReader(spec, grid, os.path.dirname(bpath) or ".")
                )
            else:
                from nextsim_tpu.utils.logging import get_logger

                get_logger().warning(
                    f"setup.bathymetry-type=etopo but {bpath} is absent: "
                    f"falling back to ideal_simul.constant_bathymetry"
                )
        # standalone wave forcing for the WIM (wimsetup.wave-type)
        wave = cfg["wimsetup.wave-type"]
        wave_map = {"ww3a": "ww3a", "eraiw_1deg": "erai_waves_1deg"}
        if wave in wave_map:
            self.sources.append(
                _DatasetReader(REGISTRY[wave_map[wave]], grid, self.data_dir)
            )
        # constant pieces fill whatever the datasets don't provide
        from nextsim_tpu.forcing.providers import ConstantForcing

        self._fallback = ConstantForcing(cfg, grid, self.dtype)
        # additive forecast bias correction on dataset air/dew temperature
        # (reference: forcingAtmosphere passes it into every non-constant
        # M_tair/M_dair ExternalData; fe.cpp:10837,10866-10918)
        self._tair_corr = float(cfg["forecast.air_temperature_correction"])
        # per-target single-slot device cache: static datasets (etopo) hand
        # back the identical numpy plane every call — re-uploading it each
        # step would be a host-to-device copy per plane. Keyed on object
        # identity; the source ref is kept so the id cannot be recycled.
        self._dev_cache: Dict[str, tuple] = {}

    def __call__(self, t_days: float, time_init_days: float) -> Forcing:
        base = self._fallback(t_days, time_init_days)
        f = self._fallback.spinup_factor(t_days, time_init_days)
        updates = {}
        for src in self.sources:
            fields = src.fields_at(t_days)
            for target, arr in fields.items():
                if target in ("wind_u", "wind_v", "ocean_u", "ocean_v", "ssh"):
                    arr = arr * f  # spin-up on dynamic fields (ed.cpp:392-404)
                elif target in ("tair", "dair") and self._tair_corr != 0.0:
                    # forecast bias correction (fe.cpp:10837,10866-10918)
                    arr = arr + self._tair_corr
                # NO astype here: static planes must keep their identity so
                # the device cache below can recognise them (dev() casts)
                updates[target] = arr
        if self._ocean_at_rest:
            # *_atrest: currents stay at the ideal_simul constants while
            # SSH/hydrography come from the dataset (fe.cpp:11219-11236)
            updates.pop("ocean_u", None)
            updates.pop("ocean_v", None)
        # recombine directions interpolated via unit components
        for tgt in [k[1:-4] for k in list(updates) if k.startswith("_") and k.endswith("_cos")]:
            c = updates.pop(f"_{tgt}_cos")
            s = updates.pop(f"_{tgt}_sin")
            updates[tgt] = np.degrees(np.arctan2(s, c)).astype(np.float32)
        if updates:
            valid = {f.name for f in dataclasses.fields(Forcing)}

            def dev(k, v):
                hit = self._dev_cache.get(k)
                if hit is not None and hit[0] is v:
                    return hit[1]
                d = _to_device(np.asarray(v, np.float32), self.dtype)
                self._dev_cache[k] = (v, d)
                return d

            base = base.replace(
                **{k: dev(k, v) for k, v in updates.items() if k in valid}
            )
        return base


def _to_device(arr, dtype):
    import jax.numpy as jnp

    return jnp.asarray(arr, dtype)


class _DatasetReader:
    """One dataset: grid loading, interpolation weights, time series,
    double-buffered (prev, next) planes + background prefetch."""

    def __init__(self, spec: DatasetSpec, grid, dirname: str, member: int = 1):
        self.spec = spec
        self.grid = grid
        self.dirname = dirname
        self._member = max(0, member - 1)  # 1-based (statevector.ensemble_member)
        self._grid_angle = None
        self._interp_cell = None
        self._interp_node = None
        self._rot = None  # (cos, sin) at cells and nodes
        self._time_index: List[Tuple[float, str, int]] = []
        self._plane_cache: Dict[Tuple[str, int], Dict[str, np.ndarray]] = {}
        self._indexed_files: set = set()
        self._lock = threading.Lock()
        self._prefetch_thread: Optional[threading.Thread] = None

    # -- grid/weights ------------------------------------------------------
    def _build_interps(self, nc: NCFile):
        g = self.spec.grid
        q_lat_c, q_lon_c = self.grid.cell_latlon()
        q_lat_n, q_lon_n = self.grid.node_latlon()
        if g.kind == "regular_latlon":
            lats = nc.variables[g.lat_name][:]
            lons = nc.variables[g.lon_name][:]
            self._interp_cell = _RegularLatLonInterp(lats, lons, q_lat_c, q_lon_c, g.cyclic_lon)
            self._interp_node = _RegularLatLonInterp(lats, lons, q_lat_n, q_lon_n, g.cyclic_lon)
        elif g.kind == "polar_stereo":
            xs = nc.variables[g.x_name][:]
            ys = nc.variables[g.y_name][:]
            self._interp_cell = _PolarStereoInterp(xs, ys, g.projection, q_lat_c, q_lon_c)
            self._interp_node = _PolarStereoInterp(xs, ys, g.projection, q_lat_n, q_lon_n)
        else:  # curvilinear
            lat2d = nc.variables[g.lat_name][:]
            lon2d = nc.variables[g.lon_name][:]
            proj = self.grid.projection
            self._interp_cell = _CurvilinearInterp(lat2d, lon2d, proj, q_lat_c, q_lon_c)
            self._interp_node = _CurvilinearInterp(lat2d, lon2d, proj, q_lat_n, q_lon_n)
        # rotation angles (only needed where vectors are sampled -> nodes)
        lon0 = self.grid.projection.lon0
        self._rot = _rotation_angles(lon0, q_lon_n)
        if self.spec.grid_oriented_vectors:
            # local angle of the source grid's +x axis in the model
            # projection, from the projected source-grid coordinates
            lat2d = np.asarray(nc.variables[g.lat_name][:], np.float64)
            lon2d = np.asarray(nc.variables[g.lon_name][:], np.float64)
            px, py = self.grid.projection.forward(lat2d, lon2d)
            px, py = np.asarray(px), np.asarray(py)
            dx_i = np.gradient(px, axis=-1)
            dy_i = np.gradient(py, axis=-1)
            phi = np.arctan2(dy_i, dx_i)
            self._grid_angle = (np.cos(phi), np.sin(phi))

    # -- files & time index ------------------------------------------------
    def _filename(self, d, var_string: Optional[str]) -> str:
        mask = self.spec.filename_mask
        if var_string is not None:
            mask = mask.replace("${VARSTRING}", var_string)
        return os.path.join(self.dirname, d.strftime(mask))

    def _index_file(self, path: str):
        if path in self._indexed_files or not os.path.exists(path):
            self._indexed_files.add(path)
            return
        with NCFile(path) as nc:
            if self._interp_cell is None:
                self._build_interps(nc)
            if self.spec.frequency == "static":
                self._time_index.append((-np.inf, path, 0))
            else:
                tvar = nc.variables[self.spec.time_name]
                epoch, factor = _parse_time_units(
                    tvar.attrs.get("units", f"days since {self.spec.reference_date}")
                )
                times = epoch + np.asarray(tvar[:], np.float64) * factor
                for i, tt in enumerate(times):
                    self._time_index.append((float(tt), path, i))
            self._time_index.sort(key=lambda r: r[0])
        self._indexed_files.add(path)

    def _ensure_indexed(self, t: float):
        import datetime as _dt

        for delta in (-1, 0, 1):
            for d in _file_dates(self.spec.frequency, t):
                if self.spec.frequency == "yearly":
                    d2 = d.replace(year=d.year + delta)
                elif self.spec.frequency == "monthly":
                    m = d.month - 1 + delta
                    d2 = d.replace(year=d.year + m // 12, month=m % 12 + 1)
                elif self.spec.frequency == "daily":
                    d2 = d + _dt.timedelta(days=delta)
                else:
                    d2 = d
                vs = {v.var_string for v in self.spec.variables}
                for s in vs:
                    self._index_file(self._filename(d2, s))

    # -- plane loading -----------------------------------------------------
    def _load_plane(self, path: str, idx: int) -> Dict[str, np.ndarray]:
        key = (path, idx)
        with self._lock:
            if key in self._plane_cache:
                return self._plane_cache[key]
        fields: Dict[str, np.ndarray] = {}
        for v in self.spec.variables:
            p = path
            if v.var_string is not None:
                # per-variable files share the time index; substitute name
                p = re.sub(
                    "|".join(
                        re.escape(x.var_string)
                        for x in self.spec.variables
                        if x.var_string
                    ),
                    v.var_string,
                    path,
                    count=1,
                )
            if not os.path.exists(p):
                continue
            with NCFile(p) as nc:
                if v.file_var not in nc.variables:
                    continue
                raw = nc.variables[v.file_var]
                if self.spec.member_dim is not None and self.spec.member_dim in raw.dimensions:
                    # select the ensemble member's record (externaldata.cpp:
                    # 852-858); member dim follows time in the reference files
                    data = raw[idx][self._member]
                elif self.spec.frequency != "static" or raw.shape and len(raw.shape) == 3:
                    data = raw[idx]
                else:
                    data = raw[:]
                data = np.squeeze(np.asarray(data, np.float64))
                data = data * v.a + v.b
                if v.transform == "inv":
                    data = np.where(np.abs(data) > 1e-12, 1.0 / np.where(data == 0, 1.0, data), 0.0)
                nodal = v.target in self.spec.nodal_targets
                interp = self._interp_node if nodal else self._interp_cell
                if v.transform == "wave_dir_from":
                    # interpolate the direction's unit components (the
                    # reference's wavDirOptions x/yComponent split) so the
                    # angle never wraps through the average
                    rad = np.deg2rad(data)
                    fields[f"_{v.target}_cos"] = np.nan_to_num(interp(np.cos(rad)), nan=0.0)
                    fields[f"_{v.target}_sin"] = np.nan_to_num(interp(np.sin(rad)), nan=0.0)
                    continue
                if self.spec.grid_oriented_vectors and any(
                    v.target in pair for pair in self.spec.vectors
                ):
                    # keep raw (source-grid) planes for local-axis rotation
                    fields["_raw_" + v.target] = data
                    continue
                fields[v.target] = np.nan_to_num(interp(data), nan=0.0)
        # vector rotation into model x/y (externaldata.cpp transformData)
        for (ut, vt) in self.spec.vectors:
            if self.spec.grid_oriented_vectors:
                if "_raw_" + ut not in fields or "_raw_" + vt not in fields:
                    continue
                # components follow the source grid axes
                # (east_west_oriented=false): rotate by the local angle of the
                # source grid's +x axis in the model projection, then interp
                cosg, sing = self._grid_angle
                ug, vg = fields.pop("_raw_" + ut), fields.pop("_raw_" + vt)
                um = ug * cosg - vg * sing
                vm = ug * sing + vg * cosg
                nodal = ut in self.spec.nodal_targets
                interp = self._interp_node if nodal else self._interp_cell
                fields[ut] = np.nan_to_num(interp(um), nan=0.0)
                fields[vt] = np.nan_to_num(interp(vm), nan=0.0)
            elif ut in fields and vt in fields:
                cosl, sinl = self._rot
                ue, vn = fields[ut], fields[vt]
                fields[ut] = ue * cosl - vn * sinl
                fields[vt] = ue * sinl + vn * cosl
        with self._lock:
            self._plane_cache[key] = fields
            if len(self._plane_cache) > 8:  # keep the cache small
                for k in list(self._plane_cache)[:-8]:
                    del self._plane_cache[k]
        return fields

    # -- public ------------------------------------------------------------
    def fields_at(self, t: float) -> Dict[str, np.ndarray]:
        self._ensure_indexed(t)
        if not self._time_index:
            return {}
        if self.spec.frequency == "static":
            _, path, idx = self._time_index[0]
            return self._load_plane(path, idx)
        times = [r[0] for r in self._time_index]
        import bisect

        k = bisect.bisect_right(times, t)
        k0 = max(0, k - 1)
        k1 = min(len(times) - 1, k)
        t0, p0, i0 = self._time_index[k0]
        t1, p1, i1 = self._time_index[k1]
        f0 = self._load_plane(p0, i0)
        f1 = self._load_plane(p1, i1)
        # linear time interpolation (externaldata.cpp:366-390)
        if t1 > t0:
            c1 = np.clip((t - t0) / (t1 - t0), 0.0, 1.0)
        else:
            c1 = 0.0
        out = {}
        for key in f0:
            if key in f1:
                out[key] = (1.0 - c1) * f0[key] + c1 * f1[key]
            else:
                out[key] = f0[key]
        # prefetch the following plane in the background
        self._start_prefetch(k1 + 1)
        return out

    def _start_prefetch(self, k: int):
        if k >= len(self._time_index):
            return
        if self._prefetch_thread is not None and self._prefetch_thread.is_alive():
            return
        _, path, idx = self._time_index[k]

        def work():
            self._load_plane(path, idx)

        self._prefetch_thread = threading.Thread(target=work, daemon=True)
        self._prefetch_thread.start()
