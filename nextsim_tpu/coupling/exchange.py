"""Coupling exchange surface — the OASIS3-MCT stand-in.

The reference couples to NEMO (ocean) and WW3 (waves) through OASIS3-MCT
(reference: modules/oasis/src/oasis_cpp_interface.cpp:1-149; initOASIS
fe.cpp:7585-7860; the put loop fe.cpp:8226-8265). The exchange grid is a
GridOutput instance (M_cpl_out), fields are time-averaged over
`coupler.timestep` and put/get via the coupler library.

Here the same exchange surface is file-based ("OASIS stub with prescribed
ocean exchange fields", BASELINE.md deployment 4): sent fields are averaged,
remapped and written as `cpl_out_<YYYYMMDDTHHMMSSZ>.nc` on the exchange
grid; received fields are read from `cpl_in_<...>.nc` when present and
override the ocean/wave forcing for the next window. A real OASIS/socket
transport can replace the file IO behind the same interface.

The exchange GRID follows the reference: when `coupler.exchange_grid_file`
names an existing NetCDF with 2-D `plat`/`plon` (and optionally the grid
rotation `ptheta`), puts are conservatively remapped onto that grid with
vector pairs rotated to its orientation, and receives arriving on it are
interpolated back to the model grid with the inverse rotation (reference:
GridOutput::Grid(exchange_grid_file, "plat", "plon", "ptheta",
interpMethod::conservative) at fe.cpp:7650-7676; rotateVectors
gridoutput.cpp:578-624). When the file is absent the exchange stays on the
raw model grid (the stub's original mode).

Sent fields (reference: go.hpp:223-233 + setupCplFields):
  taux, tauy        ice-ocean stress        [N/m2]
  emp               evap minus precip       [kg/m2/s]
  QNoSw, QSwOcean   non-solar / solar flux  [W/m2]
  Sflx              salt flux               [g/m2/day]
  conc              ice concentration       [1]
Received fields (reference: ocean_cpl_* / wave_cpl_* datasets,
dataset.cpp:2609-3396):
  sst, sss, uocean, vocean, ssh, mld, qsrml, tauwix, tauwiy, wlbk
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from nextsim_tpu.utils import dates

SENT_FIELDS = {
    "taux": ("diag", "tau_wx"),
    "tauy": ("diag", "tau_wy"),
    "emp": ("diag", "fwflux"),  # sign: reference sends -fwflux as emp
    "QNoSw": ("diag", "qnosun"),
    "QSwOcean": ("diag", "qsw_ocean"),
    "Sflx": ("diag", "dels"),
    "conc": ("state", "conc"),
}

RECEIVED_TO_FORCING = {
    "sst": "ocean_temp",
    "sss": "ocean_salt",
    "uocean": "ocean_u",
    "vocean": "ocean_v",
    "ssh": "ssh",
    "mld": "mld",
    # fraction of shortwave absorbed in the mixed layer (reference:
    # I_FrcQsr received at fe.cpp:7781 -> M_qsrml, consumed in the
    # open-water heat budget Qow += Qsw*qsrml, fe.cpp:5154)
    "qsrml": "qsrml",
    "tauwix": "tau_wi_u",
    "tauwiy": "tau_wi_v",
    "wlbk": "wlbk",
}

NODE_TARGETS = {"ocean_u", "ocean_v", "ssh", "tau_wi_u", "tau_wi_v"}

#: sent vector pairs rotated to the exchange-grid orientation (reference:
#: Vectorial_Variable tau, fe.cpp:7648; rotateVectors gridoutput.cpp:578-624)
SENT_VECTOR_PAIRS = (("taux", "tauy"),)

#: received vector pairs rotated back from the exchange-grid orientation to
#: model x/y (the ExternalData transformData role for ocean_cpl/wave_cpl)
RECEIVED_VECTOR_PAIRS = (("uocean", "vocean"), ("tauwix", "tauwiy"))


class Coupler:
    def __init__(self, cfg, grid, time_init: float, directory: Optional[str] = None):
        self.cfg = cfg
        self.grid = grid
        self.dt_cpl = cfg["coupler.timestep"]  # seconds
        self.directory = directory or os.path.join(cfg["output.exporter_path"], "coupler")
        os.makedirs(self.directory, exist_ok=True)
        self._accum: Dict[str, np.ndarray] = {}
        self._count = 0
        self._last_put = time_init
        self._received: Dict[str, jnp.ndarray] = {}
        self.exchange_grid = None
        gf = cfg["coupler.exchange_grid_file"]
        if gf and os.path.exists(gf):
            self._init_exchange_grid(gf)

    def _init_exchange_grid(self, path: str) -> None:
        """Build the coupler-grid remap machinery (reference: M_cpl_out
        GridOutput on the exchange_grid_file grid, fe.cpp:7650-7698):
        conservative model->coupler binning for cell fields (the
        interpMethod::conservative of the Grid ctor), point sampling for
        node fields, Delaunay coupler->model interpolation for receives,
        and the orientation angle for vector rotation."""
        from nextsim_tpu.forcing.netcdf_io import NCFile

        with NCFile(path) as nc:
            plat = np.asarray(nc.variables["plat"][:], np.float64)
            plon = np.asarray(nc.variables["plon"][:], np.float64)
            ptheta = (
                np.asarray(nc.variables["ptheta"][:], np.float64)
                if "ptheta" in nc.variables else None
            )
        from nextsim_tpu.forcing.datasets import _CurvilinearInterp
        from nextsim_tpu.output.moorings import _BinnedConservative, _PointSampler

        g = self.grid
        xq, yq = g.projection.forward(plat, plon)
        xq, yq = np.asarray(xq), np.asarray(yq)
        point = _PointSampler(
            g.x0 + 0.5 * g.dx, g.y0 + 0.5 * g.dx, g.dx, g.shape, xq, yq
        )
        cx, cy = g.cell_xy()
        cell_lat, cell_lon = g.cell_latlon()
        # rotation angle at the coupler points: projection rotation minus
        # the grid angle (ptheta, radians) when provided, else minus the
        # point longitude -> east/north (rotateVectors' false/true-easting
        # branches, gridoutput.cpp:596-615)
        rot0 = np.deg2rad(g.projection.lon0)
        ang = rot0 - (ptheta if ptheta is not None else np.deg2rad(plon))
        self.exchange_grid = dict(
            lat=plat, lon=plon, shape=plat.shape,
            cell_interp=_BinnedConservative(cx, cy, xq, yq, point),
            node_interp=_PointSampler(
                g.x0, g.y0, g.dx, g.node_shape, xq, yq
            ),
            back_interp=_CurvilinearInterp(
                plat, plon, g.projection, cell_lat, cell_lon
            ),
            cos=np.cos(ang), sin=np.sin(ang),
        )

    # -- put path ----------------------------------------------------------
    def add_sums(self, sums: Dict[str, np.ndarray], n_steps: int) -> None:
        """Fold per-step field SUMS (already summed over `n_steps` steps,
        keyed by SENT_FIELDS name) into the running window accumulators.
        The single owner of the window-mean bookkeeping — both the per-step
        path (accumulate) and the fused-chunk path (Simulator.step_chunk)
        route through it, so any future averaging/sign change lives here."""
        for name, v in sums.items():
            self._accum[name] = self._accum.get(name, 0.0) + np.asarray(
                v, np.float64
            )
        self._count += n_steps

    def accumulate(self, state, diag: Dict):
        """Per-step running means (reference: updateMeans for M_cpl_out)."""
        sums = {}
        for name, (src, field) in SENT_FIELDS.items():
            if src == "state":
                arr = getattr(state, field, None)
            else:
                arr = diag.get(field)
            if arr is None:
                continue
            sums[name] = np.asarray(arr, np.float64)
        self.add_sums(sums, 1)

    def maybe_exchange(self, t_days: float) -> bool:
        """Put the averaged fields + read any provided input file when a
        coupling window closes. Returns True when an exchange happened."""
        window_days = self.dt_cpl / 86400.0
        if t_days - self._last_put < window_days - 1e-9 or self._count == 0:
            return False
        tag = dates.datenum_to_string(t_days)
        self._write_put(tag)
        self._read_get(tag)
        self._accum = {}
        self._count = 0
        self._last_put = t_days
        return True

    def _write_put(self, tag: str):
        from scipy.io import netcdf_file

        from nextsim_tpu.parallel.multihost import is_writer

        if not is_writer():
            return  # accumulate() inputs were gathered; process 0 puts
        path = os.path.join(self.directory, f"cpl_out_{tag}.nc")
        ny, nx = self.grid.shape
        eg = self.exchange_grid
        fields: Dict[str, np.ndarray] = {}
        for name, acc in self._accum.items():
            mean = acc / self._count
            if eg is not None:
                # conservative remap onto the exchange grid (reference:
                # updateGridMean with interpMethod::conservative for
                # M_cpl_out, fe.cpp:7652, gridoutput.cpp:387-450)
                if mean.shape == (ny, nx):
                    fields[name] = eg["cell_interp"](mean)
                else:
                    fields[name] = eg["node_interp"](mean)
            else:
                if mean.shape != (ny, nx):  # node field -> cell mean
                    mean = 0.25 * (
                        mean[:-1, :-1] + mean[:-1, 1:] + mean[1:, :-1] + mean[1:, 1:]
                    )
                fields[name] = mean
        if eg is not None:
            # rotate sent vector pairs to the exchange-grid orientation
            # (reference: rotateVectors, gridoutput.cpp:596-624)
            for ukey, vkey in SENT_VECTOR_PAIRS:
                if ukey in fields and vkey in fields:
                    u, v = fields[ukey], fields[vkey]
                    fields[ukey] = eg["cos"] * u - eg["sin"] * v
                    fields[vkey] = eg["sin"] * u + eg["cos"] * v
        shape = eg["shape"] if eg is not None else (ny, nx)
        with netcdf_file(path, "w", version=2) as nc:
            nc.createDimension("y", shape[0])
            nc.createDimension("x", shape[1])
            if eg is not None:
                for nm, arr in (("plat", eg["lat"]), ("plon", eg["lon"])):
                    v = nc.createVariable(nm, "f8", ("y", "x"))
                    v[:] = arr
            for name, arr in fields.items():
                v = nc.createVariable(name, "f4", ("y", "x"))
                v[:] = arr.astype(np.float32)

    def _read_get(self, tag: str):
        path = os.path.join(self.directory, f"cpl_in_{tag}.nc")
        if not os.path.exists(path):
            # also accept a static prescribed file
            path = os.path.join(self.directory, "cpl_in.nc")
            if not os.path.exists(path):
                return
        from nextsim_tpu.forcing.netcdf_io import NCFile

        raw: Dict[str, np.ndarray] = {}
        with NCFile(path) as nc:
            for name in RECEIVED_TO_FORCING:
                if name in nc.variables:
                    raw[name] = np.squeeze(
                        np.asarray(nc.variables[name][:], np.float32)
                    )
        eg = self.exchange_grid
        if eg is not None:
            on_eg = {k: v.shape == eg["shape"] for k, v in raw.items()}
            # vector pairs arriving on the exchange grid: rotate back to
            # model x/y at the source points (inverse of the send rotation)
            # before interpolating the components
            for ukey, vkey in RECEIVED_VECTOR_PAIRS:
                if on_eg.get(ukey) and on_eg.get(vkey):
                    u, v = raw[ukey], raw[vkey]
                    raw[ukey] = eg["cos"] * u + eg["sin"] * v
                    raw[vkey] = -eg["sin"] * u + eg["cos"] * v
                elif on_eg.get(ukey) or on_eg.get(vkey):
                    # one component on the exchange grid without its partner
                    # cannot be rotated back to model x/y — applying it
                    # unrotated would be a silently mis-oriented forcing
                    raise ValueError(
                        f"coupler receive: vector pair ({ukey}, {vkey}) must "
                        "arrive together on the exchange grid (got "
                        f"{ukey}: {on_eg.get(ukey)}, {vkey}: {on_eg.get(vkey)}"
                        ") — the grid-orientation rotation needs both "
                        "components"
                    )
            for name, v in raw.items():
                if on_eg[name]:
                    # coupler grid -> model cells (the ExternalData
                    # setElementWeights role, fe.cpp:7688-7697)
                    raw[name] = eg["back_interp"](v).astype(np.float32)
        for name, v in raw.items():
            self._received[RECEIVED_TO_FORCING[name]] = jnp.asarray(v)

    # -- get path ----------------------------------------------------------
    def apply_received(self, forcing):
        """Override forcing with the last received exchange fields."""
        if not self._received:
            return forcing
        updates = {}
        for target, arr in self._received.items():
            want_node = target in NODE_TARGETS
            if want_node and arr.shape == self.grid.shape:
                from nextsim_tpu.ops import stencil

                arr = stencil.node_mean_of_cells(arr, jnp.ones_like(arr))
            updates[target] = arr
        return forcing.replace(**updates)
