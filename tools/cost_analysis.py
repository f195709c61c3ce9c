"""Per-substep roofline numbers for the momentum hot loop.

XLA's `Compiled.cost_analysis()` counts a `while` body ONCE, so the
production 120-substep program under-reports loop flops. The honest count
here is MARGINAL: two fully-unrolled variants (substeps=4 and substeps=12,
unroll=substeps, so no while loop remains) are compiled and differenced —
(flops(12) - flops(4)) / 8 is exactly one substep's flop/transcendental
count with prep, smoother and output handling cancelled. The same
difference on measured wall time gives the marginal substep time free of
dispatch overhead.

Only XLA's own counts are reported; a roofline share needs the device's
peak rates, which belong with the benchmark.

Usage: python tools/cost_analysis.py [--nx 464] [--json out.json]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _build(nx, substeps, unroll, resolution=10e3):
    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator

    cfg = Config(overrides={
        "grid.preset": "arctic",
        "grid.nx": nx, "grid.ny": nx, "grid.resolution": resolution,
        "simul.timestep": 200,
        "simul.time_init": "2015-10-16 00:00:00",
        "dynamics.substeps": substeps,
        "tpu.substep_unroll": unroll,
        "dynamics.alea_factor": 0.33,
        "thermo.use_thermo_forcing": False,
        "setup.ice-type": "constant",
        "setup.atmosphere-type": "constant",
        "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 10.0,
        "ideal_simul.constant_wind_v": -3.0,
        "dynamics.use_coriolis": True,
    })
    sim = Simulator(cfg)
    forcing = sim.forcing_provider(sim.current_time, sim.time_init)
    return sim, forcing, sim.time_info()


def _measure(sim, forcing, tinfo, n_steps=30, windows=4):
    """XLA's counts and the memory footprint of one compiled step, and its
    time per step: the median of ``windows`` windows of ``n_steps``."""
    import jax

    compiled = jax.jit(sim.raw_step_fn).lower(
        sim.state, forcing, tinfo
    ).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    try:
        ma = compiled.memory_analysis()
        mem = {
            "temp_bytes": int(getattr(ma, "temp_size_in_bytes", 0)),
            "argument_bytes": int(getattr(ma, "argument_size_in_bytes", 0)),
            "output_bytes": int(getattr(ma, "output_size_in_bytes", 0)),
        }
    except Exception:
        mem = {}
    s, _, _ = compiled(sim.state, forcing, tinfo)
    jax.block_until_ready(s)
    per_step = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            s, _, _ = compiled(s, forcing, tinfo)
        jax.block_until_ready(s)
        per_step.append((time.perf_counter() - t0) / n_steps)
    return {
        "flops": float(ca.get("flops", 0.0)),
        "transcendentals": float(ca.get("transcendentals", 0.0)),
        "bytes": float(ca.get("bytes accessed", 0.0)),
        "step_s": sorted(per_step)[len(per_step) // 2],
        "window_step_s": per_step,
        "memory": mem,
    }


def marginal_substep(nx, resolution=10e3, lo_sub=4, hi_sub=12):
    """One substep's XLA flops, transcendentals and bytes, and its marginal
    time, from two fully unrolled programs (see the module docstring)."""
    runs = {}
    for tag, sub in (("lo", lo_sub), ("hi", hi_sub)):
        sim, forcing, tinfo = _build(nx, sub, sub, resolution)
        runs[tag] = _measure(sim, forcing, tinfo)
    dsub = hi_sub - lo_sub
    return {
        k: (runs["hi"][k] - runs["lo"][k]) / dsub
        for k in ("flops", "transcendentals", "bytes", "step_s")
    }


def main() -> None:
    import jax

    nx = int(sys.argv[sys.argv.index("--nx") + 1]) if "--nx" in sys.argv else 464
    cells = nx * nx
    per_substep = marginal_substep(nx)
    sim, forcing, tinfo = _build(nx, 120, 4)
    prod = _measure(sim, forcing, tinfo)
    report = {
        "grid": f"{nx}x{nx}",
        "cells": cells,
        "method": (
            "marginal between fully-unrolled substeps=4 and =12 programs "
            "(XLA cost_analysis counts while bodies once; full unroll "
            "removes the loop)"
        ),
        "per_substep": {
            "flops": per_substep["flops"],
            "flops_per_cell": per_substep["flops"] / cells,
            "transcendentals": per_substep["transcendentals"],
            "transcendentals_per_cell": per_substep["transcendentals"] / cells,
            "hlo_bytes": per_substep["bytes"],
            "marginal_us": per_substep["step_s"] * 1e6,
        },
        "production": {
            "substeps": 120, "unroll": sim.dyn.substep_unroll,
            "step_ms": prod["step_s"] * 1e3,
            "us_per_substep": prod["step_s"] * 1e6 / 120,
            # achieved rates from the marginal counts (the prep/smoother
            # work is amortised over 120 substeps)
            "achieved_flops_per_s": per_substep["flops"] * 120 / prod["step_s"],
            "achieved_bytes_per_s": per_substep["bytes"] * 120 / prod["step_s"],
        },
        "memory": prod["memory"],
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
        },
    }
    out = json.dumps(report, indent=1)
    print(out)
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        with open(path, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
