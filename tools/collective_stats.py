"""Count communication collectives in the compiled multi-chip step.

Compiles one full model step on the virtual 8-device CPU mesh for each
schedule and tallies the collective ops XLA emitted (op counts + payload
bytes from the HLO result shapes). This is the checkable artifact behind
the round-5 seam layout-conversion rework (VERDICT r4 #1): the gather-based
global<->ext conversions lowered to all-gather-shaped reshuffles of whole
planes every dynamics step; the strip-exchange conversions replace them
with O((dp+H)*n)-byte collective-permutes.

Collectives are interconnect traffic either way — between GPUs they ride
NVLink — so the BYTES column is the schedule-comparison currency even
though the CPU mesh cannot time them.

Usage:
    env JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/collective_stats.py [--nx 64 --ny 64] [--halo-depth 4]
"""

from __future__ import annotations

import argparse
import json
import re
import sys

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "all-to-all",
    "collective-permute",
    "reduce-scatter",
)

_DTYPE_BYTES = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "pred": 1, "s8": 1, "u8": 1}


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO result type like 'f32[17,33]' or a tuple of them."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_stats(hlo_text: str) -> dict:
    """Tally collective ops in an HLO dump: {op: {count, bytes}}."""
    out = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"(?:ROOT )?%?[\w.\-]+ = (.*?) (\w[\w\-]*)\(", line)
        if not m:
            continue
        op = m.group(2)
        base = op
        for suf in ("-start", "-done"):
            if base.endswith(suf):
                base = base[: -len(suf)]
        if base not in _COLLECTIVES:
            continue
        if op.endswith("-done"):
            continue  # counted at -start
        d = out.setdefault(base, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += _shape_bytes(m.group(1))
    return out


def compile_step(mode: str, nx: int, ny: int, halo_depth: int, resident: bool = True):
    import jax

    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator
    from nextsim_tpu.parallel import seam
    from nextsim_tpu.parallel.sharding import make_device_mesh, shard_tree

    orig_supported = seam.ring_conversion_supported
    if not resident:
        seam.ring_conversion_supported = lambda *a: False  # gather fallback

    mesh = make_device_mesh(devices=jax.devices()[:8])
    over = {
        "grid.nx": nx, "grid.ny": ny, "grid.resolution": 10e3,
        "simul.timestep": 200, "dynamics.substeps": 120,
        "thermo.use_thermo_forcing": False,
        "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
        "setup.ice-type": "constant_partial",
        "simul.spinup_duration": 0.0,
        "tpu.donate_state": False,
        "tpu.partition_mode": mode,
    }
    if mode == "shard_map":
        over["tpu.halo_depth"] = halo_depth
    sim = Simulator(Config(overrides=over), mesh=mesh)
    f = shard_tree(sim.forcing_provider(sim.current_time, sim.time_init), mesh)
    t = sim.time_info()
    try:
        lowered = jax.jit(sim.raw_step_fn).lower(sim.state, f, t)
        compiled = lowered.compile()
        return collective_stats(compiled.as_text())
    finally:
        seam.ring_conversion_supported = orig_supported


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--halo-depth", type=int, default=4)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    rows = {}
    rows["gspmd"] = compile_step("gspmd", args.nx, args.ny, args.halo_depth)
    rows[f"shard_map_resident_H{args.halo_depth}"] = compile_step(
        "shard_map", args.nx, args.ny, args.halo_depth, resident=True
    )
    rows[f"shard_map_gather_H{args.halo_depth}"] = compile_step(
        "shard_map", args.nx, args.ny, args.halo_depth, resident=False
    )

    if args.json:
        print(json.dumps(rows, indent=1))
        return 0
    for name, stats in rows.items():
        total_b = sum(d["bytes"] for d in stats.values())
        total_c = sum(d["count"] for d in stats.values())
        print(f"\n== {name}: {total_c} collectives, {total_b/1e6:.3f} MB/step ==")
        for op, d in sorted(stats.items()):
            print(f"  {op:<22} n={d['count']:<5} {d['bytes']/1e6:.3f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
