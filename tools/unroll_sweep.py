"""Time the momentum substep loop per grid size and unroll factor.

For each size (464^2 and 608^2 at 10 km, 1216^2 at 5 km; the `arctic` box,
BBM, 120 substeps, thermo off, constant forcing) this compiles the model
step once per unroll factor and times it (median of 4 windows of 30
steps), and takes one substep's XLA byte and flop counts from two fully
unrolled programs (tools/cost_analysis.py; their time difference is
dispatch noise at these sizes and is not reported). Per size
and unroll it prints one JSON line: ms per step, us per substep (step time
/ 120: the per-step prep, smoother and transport are included), and the
achieved bytes/s, XLA's bytes of one substep over that time. A first line
gives what a plain device copy reaches on the same card, the practical
ceiling for those bytes/s.

Timing needs the GPU: on any other platform the sweep refuses to run.

Usage: python tools/unroll_sweep.py [--sizes 464,608,1216] [--unrolls 1,2,4]
                                    [--json out.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from cost_analysis import _build, _measure, marginal_substep  # noqa: E402

SUBSTEPS = 120


def resolution_for(size: int) -> float:
    """10 km up to the 608^2 operational grid; finer grids cover the same
    pan-Arctic box (1216^2 is the 5 km grid)."""
    return 10e3 * min(1.0, 608 / size)


def copy_bandwidth(n_bytes: int = 2 << 30, reps: int = 10) -> dict:
    """Bytes/s of ``y = x + 1`` on a float32 array of n_bytes (read + write
    counted), median of ``reps`` calls."""
    import time

    import jax
    import jax.numpy as jnp

    x = jnp.zeros((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    jax.block_until_ready(f(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        times.append(time.perf_counter() - t0)
    t = sorted(times)[reps // 2]
    return {"copy_bytes": 2 * n_bytes, "copy_s": t, "copy_bytes_per_s": 2 * n_bytes / t}


def main(argv=None) -> None:
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="464,608,1216")
    ap.add_argument("--unrolls", default="1,2,4")
    ap.add_argument("--json", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"unroll_sweep: no GPU (JAX's devices are {dev.platform})")
    print(json.dumps(dict(copy_bandwidth(), device=dev.device_kind)), flush=True)
    for size in (int(v) for v in args.sizes.split(",")):
        res = resolution_for(size)
        sub = marginal_substep(size, res)
        for unroll in (int(v) for v in args.unrolls.split(",")):
            sim, forcing, tinfo = _build(size, SUBSTEPS, unroll, res)
            m = _measure(sim, forcing, tinfo)
            us = m["step_s"] * 1e6 / SUBSTEPS
            line = {
                "grid": f"{size}x{size}@{res / 1e3:g}km",
                "cells": size * size,
                "unroll": unroll,
                "ms_per_step": m["step_s"] * 1e3,
                "window_ms_per_step": [w * 1e3 for w in m["window_step_s"]],
                "us_per_substep": us,
                "xla_bytes_per_substep": sub["bytes"],
                "xla_flops_per_substep": sub["flops"],
                "achieved_bytes_per_s": sub["bytes"] / (us * 1e-6),
                "temp_bytes": m["memory"].get("temp_bytes"),
                "device": dev.device_kind,
            }
            out = json.dumps(line)
            print(out, flush=True)
            if args.json:
                with open(args.json, "a") as f:
                    f.write(out + "\n")


if __name__ == "__main__":
    main()
