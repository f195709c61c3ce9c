"""Real-coastline grids from ETOPO-style bathymetry (VERDICT r2 item 4;
reference: initBathymetry fe.cpp:13749-13777 + the mesh-encoded coastline,
mesh/README.md)."""

import os

import numpy as np
import pytest

from nextsim_tpu.config import Config
from nextsim_tpu.forcing.bathymetry import (
    arctic_etopo_grid,
    load_depth,
    mask_from_depth,
)


def write_etopo_like(tmp_path, fname="ETOPO_Arctic_2arcmin.nc"):
    """Synthetic pan-Arctic elevation: ocean basin around the pole with a
    continent wedge (land), an island, and a disconnected inland lake."""
    from scipy.io import netcdf_file

    lats = np.arange(55.0, 90.01, 0.25)
    lons = np.arange(-180.0, 180.0, 0.5)
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    z = np.full(lat2.shape, -3000.0)  # deep ocean
    # continent: a wedge of longitudes below 80N is land (+500 m)
    wedge = (lon2 > 20.0) & (lon2 < 120.0) & (lat2 < 80.0)
    z[wedge] = 500.0
    # island at (75N, -60..-50E)
    island = (lon2 > -60.0) & (lon2 < -50.0) & (lat2 > 74.0) & (lat2 < 76.0)
    z[island] = 300.0
    # inland lake inside the continent wedge (water, but disconnected)
    lake = (lon2 > 60.0) & (lon2 < 70.0) & (lat2 > 65.0) & (lat2 < 68.0)
    z[lake] = -50.0
    with netcdf_file(os.path.join(tmp_path, fname), "w", version=2) as nc:
        nc.createDimension("lat", len(lats))
        nc.createDimension("lon", len(lons))
        nc.createVariable("lat", "f4", ("lat",))[:] = lats
        nc.createVariable("lon", "f4", ("lon",))[:] = lons
        nc.createVariable("z", "f4", ("lat", "lon"))[:] = z.astype(np.float32)


def test_mask_from_depth_connectivity():
    depth = np.zeros((10, 10))
    depth[1:9, 1:9] = 100.0  # ocean block
    depth[1:9, 5] = -10.0  # land wall splits it
    depth[2:4, 6:8] = 100.0  # small right-hand pond, disconnected
    m = mask_from_depth(depth)
    assert m[5, 2] == 1.0  # big component kept
    assert m[2, 6] == 0.0  # small component removed
    assert m[5, 5] == 0.0  # land
    m2 = mask_from_depth(depth, keep_largest=False)
    assert m2[2, 6] == 1.0


def test_load_depth_and_arctic_etopo_grid(tmp_path):
    write_etopo_like(tmp_path)
    grid, depth = arctic_etopo_grid(
        dx=50e3, nx=96, ny=96, data_dir=str(tmp_path)
    )
    mask = grid.mask
    frac_ocean = mask.mean()
    assert 0.3 < frac_ocean < 0.95  # real coastline: neither empty nor full
    # the continent wedge is land; the central basin is ocean
    lat, lon = grid.cell_latlon()
    wedge = (lon > 40.0) & (lon < 100.0) & (lat < 75.0) & (lat > 60.0)
    assert mask[wedge].mean() < 0.05
    basin = lat > 85.0
    assert mask[basin].mean() > 0.95
    # the inland lake was removed by the connectivity cleanup
    lake = (lon > 61.0) & (lon < 69.0) & (lat > 65.5) & (lat < 67.5)
    if lake.any():
        assert mask[lake].max() == 0.0
    # depth is positive-down water depth, clipped at land
    assert depth.min() >= 0.0
    assert depth.max() > 2000.0
    # load_depth alone returns signed elevation-derived depth
    d = load_depth(grid, data_dir=str(tmp_path))
    assert (d[mask > 0.5] > 0).mean() > 0.99


def test_missing_file_raises(tmp_path):
    from nextsim_tpu.grid.grid import Grid

    with pytest.raises(FileNotFoundError, match="bathymetry"):
        arctic_etopo_grid(dx=50e3, nx=32, ny=32, data_dir=str(tmp_path))


@pytest.mark.slow
def test_simulator_on_etopo_coastline(tmp_path, monkeypatch):
    """End-to-end: grid.preset=arctic_etopo + setup.bathymetry-type=etopo —
    the model runs on the real-coastline mask, the forcing carries the ETOPO
    depth (not the constant), and the fields stay sane."""
    from nextsim_tpu.model.simulator import Simulator

    write_etopo_like(tmp_path)
    monkeypatch.setenv("NEXTSIM_DATA_DIR", str(tmp_path))
    cfg = Config(overrides={
        "grid.preset": "arctic_etopo",
        "grid.nx": 64, "grid.ny": 64, "grid.resolution": 75e3,
        "simul.timestep": 900, "simul.time_init": "2015-10-16 00:00:00",
        "dynamics.substeps": 120,
        "thermo.use_thermo_forcing": False,
        "setup.ice-type": "constant_partial",
        "setup.atmosphere-type": "constant",
        "setup.ocean-type": "constant",
        "setup.bathymetry-type": "etopo",
        "ideal_simul.constant_wind_u": 15.0,
        "simul.spinup_duration": 0.0,
        "tpu.donate_state": False,
    })
    sim = Simulator(cfg)
    assert 0.3 < sim.grid.mask.mean() < 0.95
    f = sim.forcing_provider(sim.current_time, sim.time_init)
    d = np.asarray(f.depth)
    mask = sim.grid.mask
    # ETOPO depth reached the forcing: ocean depths vary (not the constant)
    assert d[mask > 0.5].std() > 10.0
    for _ in range(3):
        sim.step()
    s = sim.host_state()
    assert np.isfinite(np.asarray(s.conc)).all()
    assert np.isfinite(np.asarray(s.vt_u)).all()
    # land cells hold no ice
    assert np.asarray(s.conc)[mask < 0.5].max() == 0.0


def _synthetic_etopo():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import make_synthetic_etopo

    return make_synthetic_etopo


def test_synthetic_etopo_land_mask_matches_matplotlib():
    """The numpy even-odd ray test rasterises every landmass exactly as
    matplotlib's Path.contains_points did, on the generator's own grid
    (whose lines pass through many polygon vertices)."""
    mpath = pytest.importorskip("matplotlib.path")
    mse = _synthetic_etopo()
    lats = np.arange(50.0, 90.0 + 1e-9, 0.25)
    lons = np.arange(-180.0, 180.0, 0.5)
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    pts = np.column_stack([lon2.ravel(), lat2.ravel()])
    want = np.zeros(lon2.size, bool)
    for poly in mse.LANDMASSES:
        want |= mpath.Path(np.asarray(poly)).contains_points(pts)
    got = mse.land_mask(lon2, lat2)
    assert got.sum() > 10000
    np.testing.assert_array_equal(got, want.reshape(lon2.shape))


def test_points_in_polygon_even_odd():
    """Concave polygon: the notch is outside, both lobes inside."""
    mse = _synthetic_etopo()
    u_shape = [(0, 0), (3, 0), (3, 3), (2, 3), (2, 1), (1, 1), (1, 3), (0, 3)]
    x = np.array([0.5, 2.5, 1.5, 1.5, 4.0, -0.5])
    y = np.array([2.0, 2.0, 2.0, 0.5, 1.0, 1.0])
    np.testing.assert_array_equal(
        mse.points_in_polygon(x, y, u_shape),
        [True, True, False, True, False, False],
    )
