"""Benchmark: momentum+rheology substep throughput on the pan-Arctic domain.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Metric: OCEAN grid-cell substeps per second per chip for the fused BBM
momentum+rheology kernel (the reference's hot loop #1, explicitSolve,
model/finiteelement.cpp:10182-10643 — 120 substeps per 200 s model step on a
10 km pan-Arctic mesh). Land cells are excluded from the headline (the
608x608 stereographic Arctic box is ~2/3 ocean); the raw whole-grid rate is
reported in detail.raw_cell_substeps_per_s (the kernel does compute land
lanes — they are masked, not skipped).

vs_baseline: the reference publishes no benchmark numbers (BASELINE.md) and
cannot be compiled in this image (its Boost.MPI/NetCDF-C++/Gmsh deps are
absent), so the anchor is MEASURED from an original C++ -O3 transcription of
its hot loop (native/ref_hotloop_bench.cpp, double precision, P1 triangles,
per-substep exp/pow): 1.4e7 element-substeps/s/core on this image's Xeon
2.1 GHz, x64 cores for the reference's example HPC job (16 MPI ranks x 4
threads, model/job_mpi.pbs) assuming PERFECT scaling = 8.96e8
element-substeps/s — an upper bound that ignores the per-substep MPI ghost
exchange, remeshing and the OW smoother, i.e. conservative in the
reference's favor. One 10 km quad cell covers the area of two reference P1
triangles, so vs_baseline = ocean_cell_rate * 2 / anchor: chip-vs-64-core-job
at equal physical work. Reproduce the anchor: python tools/bench_anchor.py.
"""

from __future__ import annotations

import json
import time

# measured: tools/bench_anchor.py (best of runs: 1.40e7..1.50e7 /core)
REF_CORE_ELEMENT_SUBSTEPS_PER_S = 1.4e7
REF_JOB_CORES = 64  # model/job_mpi.pbs:10-35 (16 ranks x 4 OMP)
REF_ANCHOR_ELEMENT_SUBSTEPS_PER_S = REF_CORE_ELEMENT_SUBSTEPS_PER_S * REF_JOB_CORES
TRIANGLES_PER_QUAD_CELL = 2.0


def main() -> None:
    import jax
    import numpy as np

    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator

    # pan-Arctic scale at 10 km. The ocean disc (lat > 68N) has a ~4640 km
    # stereographic diameter, so a 464-cell box is its tight bounding box —
    # the honest analog of the reference's unstructured mesh, which contains
    # NO land elements at all (the earlier 608x608 box spent 42% of the
    # device program on an all-land border the reference never computes).
    # ~169k ocean cells of 215k.
    nx = ny = 464
    substeps = 120
    cfg = Config(
        overrides={
            "grid.preset": "arctic",
            "grid.nx": nx,
            "grid.ny": ny,
            "grid.resolution": 10e3,
            "simul.timestep": 200,
            "simul.time_init": "2015-10-16 00:00:00",
            "dynamics.substeps": substeps,
            "dynamics.alea_factor": 0.33,
            "thermo.use_thermo_forcing": False,
            "setup.ice-type": "constant",
            "setup.atmosphere-type": "constant",
            "setup.ocean-type": "constant",
            "ideal_simul.constant_wind_u": 10.0,
            "ideal_simul.constant_wind_v": -3.0,
            "dynamics.use_coriolis": True,
        }
    )
    # fused multi-step device program; 30 = one device call per timing
    # window
    cfg.set("tpu.steps_per_call", 30)
    sim = Simulator(cfg)
    k = sim._chunk_k
    forcing = sim.forcing_provider(sim.current_time, sim.time_init)
    tinfo = sim.time_info()
    # per-step forcing/tinfo threading (constant forcing here, so the tail
    # stacks replicate one bundle — same program shape as a real run)
    import jax.numpy as jnp

    f_rest = jax.tree.map(lambda *xs: jnp.stack(xs), *([forcing] * (k - 1)))
    ti_rest = jax.tree.map(lambda *xs: jnp.stack(xs), *([tinfo] * (k - 1)))
    chunk = sim._build_chunk_fn(k)

    ocean_cells = int(np.asarray(sim.grid.mask).sum())

    # warmup/compile
    state, diag, viol, acc, lex = chunk(sim.state, forcing, f_rest, tinfo, ti_rest)
    jax.block_until_ready(state)

    # N timing windows; the headline is their median, every window is
    # reported so the spread shows
    n_steps = 30
    n_windows = 4
    windows = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(n_steps // k):
            state, diag, viol, acc, lex = chunk(
                state, forcing, f_rest, tinfo, ti_rest
            )
        jax.block_until_ready(state)
        windows.append(time.perf_counter() - t0)
    dt_wall = sorted(windows)[n_windows // 2]

    cells = nx * ny
    raw_rate = cells * substeps * n_steps / dt_wall
    ocean_rate = ocean_cells * substeps * n_steps / dt_wall
    steps_per_s = n_steps / dt_wall
    vs_baseline = (
        ocean_rate * TRIANGLES_PER_QUAD_CELL / REF_ANCHOR_ELEMENT_SUBSTEPS_PER_S
    )

    print(
        json.dumps(
            {
                "metric": "bbm_momentum_ocean_cell_substeps_per_s_per_chip",
                "value": round(ocean_rate, 1),
                "unit": "ocean-cell-substeps/s",
                "vs_baseline": round(vs_baseline, 3),
                "detail": {
                    "grid": f"{nx}x{ny}@10km",
                    "ocean_cells": ocean_cells,
                    "raw_cell_substeps_per_s": round(raw_rate, 1),
                    "substeps": substeps,
                    "steps_per_s": round(steps_per_s, 3),
                    "model_s_per_wall_s": round(steps_per_s * 200.0, 1),
                    "anchor_element_substeps_per_s": REF_ANCHOR_ELEMENT_SUBSTEPS_PER_S,
                    "anchor_note": "measured C++ hot loop x64-core ideal (tools/bench_anchor.py)",
                    "timing": f"median of {n_windows} x {n_steps}-step windows",
                    "window_ocean_rates": [
                        round(ocean_cells * substeps * n_steps / w, 1)
                        for w in windows
                    ],
                    "aggregate_ocean_rate": round(
                        ocean_cells * substeps * n_steps * n_windows / sum(windows), 1
                    ),
                    "device": {
                        "platform": jax.devices()[0].platform,
                        "kind": jax.devices()[0].device_kind,
                        "count": len(jax.devices()),
                    },
                },
            }
        )
    )


if __name__ == "__main__":
    main()
