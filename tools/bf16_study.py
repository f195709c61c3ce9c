"""bf16 mixed-precision error-budget study of the dynamics substep loop.

VERDICT r2 item 5 asked whether bfloat16 coefficients/intermediates (f32
carries) can speed up the substep loop within an acceptable field-error
budget. This script measures the two ends of the trade on the GPU:

* **speed** — the full-bf16 variant (every input plane, every carry, every
  intermediate in bf16) is a strict UPPER BOUND on the speedup of any mixed
  scheme: a mixed scheme does the same arithmetic plus up/down conversions
  and keeps some planes in f32.
* **error** — the same full-bf16 variant is an upper bound on the field
  error of any mixed scheme (f32 carries only reduce it).

If the upper-bound speedup is within noise of 1x, every mixed scheme is
dominated and the lever is dead regardless of the error column. On the
physics side bf16 is already known to fail: damage diverged within 15 steps
of a full-bf16 run (ROADMAP.md).

Run on the GPU:  python tools/bf16_study.py
Run the error half on CPU:  JAX_PLATFORMS=cpu python tools/bf16_study.py --error-only
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from nextsim_tpu.config import Config
from nextsim_tpu.model.simulator import Simulator
from nextsim_tpu.ops import momentum as M


def _setup(nx: int, substeps: int = 120):
    cfg = Config(overrides={
        "grid.preset": "arctic", "grid.nx": nx, "grid.ny": nx,
        "grid.resolution": 10e3, "simul.timestep": 200,
        "simul.time_init": "2015-10-16 00:00:00",
        "dynamics.substeps": substeps, "dynamics.alea_factor": 0.33,
        "thermo.use_thermo_forcing": False,
        "setup.ice-type": "constant", "setup.atmosphere-type": "constant",
        "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 10.0,
        "ideal_simul.constant_wind_v": -3.0,
        "dynamics.use_coriolis": True,
        "simul.spinup_duration": 0.0,  # wind on from step 1 (else v = 0)
    })
    sim = Simulator(cfg)
    forcing = sim.forcing_provider(sim.current_time, sim.time_init)
    state = sim.host_state()
    ga = dict(sim.grid_arrays)
    ga["cohesion"] = sim.c_fix + sim.c_alea * state.random_number
    return sim, state, forcing, ga


def _cast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        tree,
    )


def _step_fn(ga, dt, p, dtype):
    def fn(state, forcing):
        s, f, g = _cast(state, dtype), _cast(forcing, dtype), _cast(ga, dtype)
        out, _ = M.explicit_solve(s, f, g, dt, p)
        return _cast(out, jnp.float32)
    return jax.jit(fn)


def speed(nx: int = 464, reps: int = 20) -> float:
    sim, state, forcing, ga = _setup(nx)
    rows = []
    for dtype in (jnp.float32, jnp.bfloat16):
        fn = _step_fn(ga, sim.dt, sim.dyn, dtype)
        out = fn(state, forcing)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(state, forcing)
        jax.block_until_ready(out)
        dt_wall = (time.perf_counter() - t0) / reps
        rows.append((dtype.__name__, dt_wall))
        print(f"{dtype.__name__:9s}: {dt_wall * 1e3:.2f} ms/step")
    ratio = rows[0][1] / rows[1][1]
    print(f"full-bf16 speedup over f32 (upper bound for any mixed scheme): "
          f"{ratio:.3f}x")
    return ratio


def error(nx: int = 96, n_steps: int = 15) -> dict:
    """Field error of full-bf16 dynamics after n_steps vs the f32 run."""
    sim, state, forcing, ga = _setup(nx, substeps=60)
    outs = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        fn = _step_fn(ga, sim.dt, sim.dyn, dtype)
        s = state
        for _ in range(n_steps):
            s = fn(s, forcing)
        outs[dtype.__name__] = jax.device_get(s)
    a, b = outs["float32"], outs["bfloat16"]
    report = {}
    for f, scale in (("vt_u", 0.01), ("sigma", 1e3), ("damage", 1.0)):
        x = np.asarray(getattr(a, f), np.float64)
        y = np.asarray(getattr(b, f), np.float64)
        err = np.abs(x - y)
        report[f] = (float(err.max()), float(err.max() / scale))
        print(f"{f:7s}: max abs err {err.max():.3e}  "
              f"({err.max() / scale * 100:.1f}% of typical scale {scale})")
    return report


if __name__ == "__main__":
    if "--error-only" not in sys.argv:
        speed()
    error()
