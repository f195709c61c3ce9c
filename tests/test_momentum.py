"""Momentum solver integration tests (toy-config regime: constant wind,
closed square, BBM/mEVP — reference config-files/nextsim.toy.cfg)."""

import functools
import jax.numpy as jnp
import numpy as np
import pytest

from nextsim_tpu.config import Config
from nextsim_tpu.core import constants as phys
from nextsim_tpu.forcing.providers import ConstantForcing
from nextsim_tpu.grid.grid import Grid
from nextsim_tpu.model import init_state, params
from nextsim_tpu.ops import momentum


def make_setup(nx=32, ny=32, dx=10e3, wind=10.0, dynamics="bbm", substeps=120):
    """Stable regime: elastic wave speed sqrt(E/rhoi) ~ 0.8 km/s needs
    dte < ~dx/c; dx=10 km, dt=200 s, 120 substeps gives CFL ~ 0.13 (the
    reference's own default operating point, options.cpp:363)."""
    cfg = Config(
        overrides={
            "grid.nx": nx,
            "grid.ny": ny,
            "grid.resolution": dx,
            "ideal_simul.constant_wind_u": wind,
            "setup.atmosphere-type": "constant",
            "setup.dynamics-type": dynamics,
            "dynamics.substeps": substeps,
            "dynamics.use_coriolis": False,
            "dynamics.oceanic_turning_angle": 0.0,
            "thermo.use_thermo_forcing": False,
            "simul.spinup_duration": 0.0,
        }
    )
    grid = Grid.square(nx=nx, ny=ny, dx=dx)
    state = init_state.init_state(cfg, grid)
    forcing = ConstantForcing(cfg, grid)(0.0, 0.0)
    dyn = params.dyn_params(cfg, dx)
    node_lat, _ = grid.node_latlon()
    c_fix, c_alea = params.cohesion_params(cfg, dx)
    ga = {
        "mask": jnp.asarray(grid.mask),
        "open_mask": jnp.asarray(grid.open_mask),
        "node_mask": jnp.asarray(grid.node_mask),
        "node_dirichlet": jnp.asarray(grid.node_dirichlet),
        "node_lat": jnp.asarray(node_lat, jnp.float32),
        "delta_x": dx,
        "cohesion": c_fix + c_alea * state.random_number,
    }
    return cfg, grid, state, forcing, dyn, ga


def test_free_drift_terminal_velocity():
    cfg, grid, state, forcing, dyn, ga = make_setup(dynamics="free_drift", wind=10.0)
    # analytic balance: ca*rhoa*|w-u|*(w-u) = co*rhow*|u|*u  ->
    # u* = w / (1 + sqrt(co*rhow/(ca*rhoa))).  The reference update
    # (fe.cpp:10156-10170) is one fixed-point sweep per step, which preserves
    # u* exactly; verify the formula by checking u* is a fixed point.
    ratio = np.sqrt(
        dyn.quad_drag_coef_water * phys.rhow / (dyn.quad_drag_coef_air * phys.rhoa)
    )
    expected = 10.0 / (1.0 + ratio)
    state = state.replace(vt_u=jnp.full_like(state.vt_u, expected))
    state = momentum.free_drift(state, forcing, ga, 300.0, dyn)
    interior = np.asarray(state.vt_u)[5:-5, 5:-5]
    np.testing.assert_allclose(interior, expected, rtol=0.02)
    assert abs(np.asarray(state.vt_v)[5:-5, 5:-5]).max() < 0.05


@pytest.mark.parametrize("dynamics", ["bbm", "mevp", "evp"])
def test_explicit_solve_runs_and_is_sane(dynamics):
    cfg, grid, state, forcing, dyn, ga = make_setup(dynamics=dynamics, wind=10.0)
    state2, diag = momentum.explicit_solve(state, forcing, ga, 300.0, dyn)
    u = np.asarray(state2.vt_u)
    v = np.asarray(state2.vt_v)
    assert np.isfinite(u).all() and np.isfinite(v).all()
    speed = np.hypot(u, v)
    assert speed.max() < 1.0  # well under free drift for packed ice
    assert speed.max() > 1e-4  # but it does move
    # dirichlet boundary nodes pinned
    nd = np.asarray(grid.node_dirichlet) > 0.5
    np.testing.assert_allclose(u[nd], 0.0, atol=1e-12)
    # y-symmetry of the setup -> u symmetric about the mid row
    # float32 reduction-order noise is amplified by the stiff substep loop;
    # symmetry holds to ~1e-2 of the ~0.2 m/s signal
    mid_u = u[1:-1, :]
    np.testing.assert_allclose(mid_u, mid_u[::-1, :], atol=5e-3)
    # stress built up somewhere
    assert float(jnp.abs(state2.sigma).max()) > 0.0


def test_bbm_damage_grows_near_coast():
    """With strong wind pushing packed ice against a wall, BBM damage
    localises — the toy-config behaviour (Olason et al. 2024)."""
    cfg, grid, state, forcing, dyn, ga = make_setup(wind=20.0, substeps=120)
    s = state
    for _ in range(5):
        s, _ = momentum.explicit_solve(s, forcing, ga, 300.0, dyn)
    dmg = np.asarray(s.damage)
    assert np.isfinite(dmg).all()
    assert dmg.max() > 0.01  # damage has developed
    assert dmg.min() >= 0.0 and dmg.max() <= 1.0


def test_no_ice_no_motion_from_stress():
    """Ice-free domain: velocities stay zero through the solver (mass-free
    nodes are skipped), smoother keeps them zero."""
    cfg, grid, state, forcing, dyn, ga = make_setup(wind=10.0)
    state = state.replace(
        conc=jnp.zeros_like(state.conc), thick=jnp.zeros_like(state.thick),
        conc_young=jnp.zeros_like(state.conc_young),
        h_young=jnp.zeros_like(state.h_young),
    )
    s2, _ = momentum.explicit_solve(state, forcing, ga, 300.0, dyn)
    np.testing.assert_allclose(np.asarray(s2.vt_u), 0.0, atol=1e-10)


def test_substep_unroll_auto_resolution():
    """tpu.substep_unroll defaults to 4, the fastest of 1/2/4 at every grid
    size measured on the H100 (464^2, 608^2, 1216^2; PERF.md); explicit
    values are honoured as given and values below 1 are refused."""
    from nextsim_tpu.config import Config
    from nextsim_tpu.model import params

    cfg = Config()
    assert params.dyn_params(cfg, 10e3).substep_unroll == 4
    assert params.dyn_params(cfg, 5e3).substep_unroll == 4
    cfg2 = Config(overrides={"tpu.substep_unroll": 8})
    assert params.dyn_params(cfg2, 5e3).substep_unroll == 8
    with pytest.raises(ValueError, match="substep_unroll"):
        params.dyn_params(Config(overrides={"tpu.substep_unroll": 0}), 10e3)
