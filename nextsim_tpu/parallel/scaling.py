"""Weak/strong scaling harness.

Measures full-model-step throughput across device-mesh sizes (weak
scaling on up to four GPUs). On a CPU-mesh host it still runs (validating
the sharded step and producing correctness-grade numbers); efficiency
numbers come from the same entry point on the GPUs.

Usage:  python -m nextsim_tpu.parallel.scaling [cells_per_device_side]
"""

from __future__ import annotations

import json
import time
from typing import List

import jax


def measure(cells_per_device_side: int = 304, steps: int = 5, substeps: int = 120,
            partition_mode: str = "gspmd", halo_depth: int = 1,
            mode: str = "weak") -> List[dict]:
    """mode='weak': the grid grows with the mesh (cells_per_device_side^2
    cells per device — the SURVEY §6 north-star measurement). mode='strong':
    one FIXED global grid (sized for the full mesh) is re-run on every mesh
    size; efficiency = rate(nd) / (nd * rate(1))."""
    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator
    from nextsim_tpu.parallel.sharding import make_device_mesh, shard_tree

    results = []
    n_total = len(jax.devices())
    sizes = []
    n = 1
    while n <= n_total:
        sizes.append(n)
        n *= 2
    if sizes[-1] != n_total:
        sizes.append(n_total)

    full = make_device_mesh(devices=jax.devices()).devices.shape
    base_rate = None
    for nd in sizes:
        mesh = make_device_mesh(devices=jax.devices()[:nd])
        dpy, dpx = mesh.devices.shape
        if mode == "strong":
            # fixed global grid sized for the FULL mesh (divisible by every
            # smaller near-square mesh by construction: power-of-two fronts)
            ny = cells_per_device_side * full[0]
            nx = cells_per_device_side * full[1]
        else:
            ny = cells_per_device_side * dpy
            nx = cells_per_device_side * dpx
        cfg = Config(overrides={
            "grid.preset": "arctic", "grid.nx": nx, "grid.ny": ny,
            "grid.resolution": 10e3,
            "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00",
            "dynamics.substeps": substeps,
            "thermo.use_thermo_forcing": False,
            "setup.ice-type": "constant", "setup.atmosphere-type": "constant",
            "setup.ocean-type": "constant",
            "ideal_simul.constant_wind_u": 10.0,
            "tpu.donate_state": False,
            # single device: shard_map needs a mesh axis to permute over;
            # run the plain schedule for the baseline point
            "tpu.partition_mode": partition_mode if nd > 1 else "gspmd",
            "tpu.halo_depth": halo_depth if nd > 1 else 1,
        })
        sim = Simulator(cfg, mesh=mesh)
        forcing = shard_tree(sim.forcing_provider(sim.current_time, sim.time_init), mesh)
        tinfo = sim.time_info()
        state, diag, viol = sim._step_fn(sim.state, forcing, tinfo)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, diag, viol = sim._step_fn(state, forcing, tinfo)
        jax.block_until_ready(state)
        dt_wall = time.perf_counter() - t0
        rate = nx * ny * substeps * steps / dt_wall  # cell-substeps/s total
        per_dev = rate / nd
        if base_rate is None:
            base_rate = rate if mode == "strong" else per_dev
        eff = (rate / (nd * base_rate)) if mode == "strong" else per_dev / base_rate
        results.append({
            "devices": nd,
            "mode": mode,
            "schedule": f"{partition_mode}@H{halo_depth}" if nd > 1 else "gspmd",
            "mesh": list(mesh.devices.shape),
            "grid": f"{nx}x{ny}",
            "cell_substeps_per_s": round(rate, 1),
            "per_device": round(per_dev, 1),
            "scaling_efficiency": round(eff, 4),
        })
        print(json.dumps(results[-1]))
    return results


def write_artifact(path: str, cells_per_device_side: int = 64, steps: int = 3,
                   substeps: int = 120) -> dict:
    """Race every schedule across mesh sizes on whatever devices exist and
    write a JSON record: per-mesh-size rates for gspmd and the
    hand-scheduled shard_map at halo depths 1 and 4. On a CPU host mesh
    the numbers race the *schedules*, not the interconnect — the same entry
    point measures the GPUs when they are there."""
    legs = [("gspmd", 1)]
    if len(jax.devices()) > 1:
        legs += [("shard_map", 1), ("shard_map", 4)]
    runs = []
    for pmode, depth in legs:
        runs += measure(cells_per_device_side, steps, substeps, pmode, depth)
    if len(jax.devices()) > 1:
        # one strong-scaling series (fixed global grid) for the default
        # schedule — the operations-facing complement to the weak series
        runs += measure(cells_per_device_side, steps, substeps, "gspmd", 1,
                        mode="strong")
    artifact = {
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "n_devices": len(jax.devices()),
        "cells_per_device_side": cells_per_device_side,
        "steps": steps,
        "substeps": substeps,
        "note": (
            "mode=weak: grid grows with the mesh (cells_per_device_side^2 "
            "cells per device), efficiency = per-device rate vs the "
            "1-device point of the same schedule. mode=strong: one fixed "
            "global grid, efficiency = rate(nd)/(nd*rate(1))."
        ),
        "runs": runs,
    }
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")
    return artifact


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 2 and sys.argv[1] == "--artifact":
        # usage: python -m nextsim_tpu.parallel.scaling --artifact OUT.json [side]
        side = int(sys.argv[3]) if len(sys.argv) > 3 else 64
        write_artifact(sys.argv[2], side)
    else:
        # usage: python -m nextsim_tpu.parallel.scaling [side] [gspmd|shard_map] [H]
        side = int(sys.argv[1]) if len(sys.argv) > 1 else 304
        mode = sys.argv[2] if len(sys.argv) > 2 else "gspmd"
        depth = int(sys.argv[3]) if len(sys.argv) > 3 else 1
        measure(side, partition_mode=mode, halo_depth=depth)
