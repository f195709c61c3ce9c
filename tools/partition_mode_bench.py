"""Head-to-head bench of the two multi-chip substep schedules.

Measures tpu.partition_mode=gspmd (XLA-inserted halo collectives,
parallel/sharding.py) vs =shard_map (hand-scheduled seam blocks with one
explicit ppermute ring exchange per substep, parallel/seam.py — the analog
of the reference's per-substep updateGhosts, fe.cpp:10534) on whatever
device mesh is available. Intended for the GPUs, where collective
scheduling matters; on the virtual CPU mesh the numbers only sanity-check
relative plumbing overhead, not the interconnect.

Run from the repo root:

    python tools/partition_mode_bench.py [DPYxDPX] [grid_n]

e.g. `XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
python tools/partition_mode_bench.py 2x4 128`.
Prints one JSON line per mode.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from nextsim_tpu.config import Config
from nextsim_tpu.model.simulator import Simulator
from nextsim_tpu.parallel.sharding import make_device_mesh, shard_tree


def measure(mode: str, mesh, n: int, n_steps: int = 20, reps: int = 3,
            halo_depth: int = 1) -> dict:
    cfg = Config(
        overrides={
            "grid.preset": "arctic",
            "grid.nx": n,
            "grid.ny": n,
            "grid.resolution": 10e3,
            "simul.timestep": 200,
            "simul.time_init": "2015-10-16 00:00:00",
            "dynamics.substeps": 120,
            "thermo.use_thermo_forcing": False,
            "setup.ice-type": "constant",
            "setup.atmosphere-type": "constant",
            "setup.ocean-type": "constant",
            "ideal_simul.constant_wind_u": 10.0,
            "ideal_simul.constant_wind_v": -3.0,
            "simul.spinup_duration": 0.0,
            "tpu.donate_state": False,
            "tpu.partition_mode": mode,
            "tpu.halo_depth": halo_depth,
        }
    )
    sim = Simulator(cfg, mesh=mesh)
    forcing = shard_tree(
        sim.forcing_provider(sim.current_time, sim.time_init), mesh
    )
    tinfo = sim.time_info()

    state, _, _ = sim._step_fn(sim.state, forcing, tinfo)  # compile + warm
    jax.block_until_ready(state)

    best = float("inf")
    for _ in range(reps):
        s = state
        t0 = time.perf_counter()
        for _ in range(n_steps):
            s, _, _ = sim._step_fn(s, forcing, tinfo)
        jax.block_until_ready(s)
        best = min(best, (time.perf_counter() - t0) / n_steps)
    return {
        "mode": mode,
        "halo_depth": halo_depth,
        "ms_per_step": round(best * 1e3, 3),
        "us_per_substep": round(best * 1e6 / 120, 2),
    }


def main():
    shape = None
    if len(sys.argv) > 1 and "x" in sys.argv[1]:
        dpy, dpx = (int(v) for v in sys.argv[1].split("x"))
        shape = (dpy, dpx)
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    mesh = make_device_mesh(shape)
    print(f"# mesh {mesh.devices.shape} on {jax.devices()[0].platform}, grid {n}^2")
    dpy, dpx = mesh.devices.shape
    block = min(n // dpy, n // dpx)
    runs = [("gspmd", 1)] + [
        ("shard_map", h) for h in (1, 4, 8) if 120 % h == 0 and h < block
    ]
    for mode, h in runs:
        out = measure(mode, mesh, n, halo_depth=h)
        out["mesh"] = list(mesh.devices.shape)
        out["grid"] = n
        print(json.dumps(out))


if __name__ == "__main__":
    main()
