"""Inspect the compiled step's GSPMD partitioning on a virtual CPU mesh.

VERDICT r1 weak-point #2: node-staggered (ny+1, nx+1) arrays are replicated
at the jit boundary; nothing verified that the compiled momentum substep loop
is actually partitioned rather than replicated per device. This tool dumps
the sharding of every while-loop carry in the compiled HLO and reports
per-device FLOPs vs global.

Run: JAX_PLATFORMS=cpu \
       XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/check_sharding.py [nx] [substeps]
"""

from __future__ import annotations

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    substeps = int(sys.argv[2]) if len(sys.argv) > 2 else 120

    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator
    from nextsim_tpu.parallel.sharding import make_device_mesh

    mesh = make_device_mesh()
    cfg = Config(
        overrides={
            "grid.nx": nx,
            "grid.ny": nx,
            "grid.resolution": 10e3,
            "simul.timestep": 200,
            "simul.time_init": "2015-10-16 00:00:00",
            "dynamics.substeps": substeps,
            "thermo.use_thermo_forcing": False,
            "setup.ice-type": "constant",
            "setup.atmosphere-type": "constant",
            "setup.ocean-type": "constant",
            "ideal_simul.constant_wind_u": 10.0,
            "tpu.donate_state": False,
        }
    )
    sim = Simulator(cfg, mesh=mesh)
    forcing = sim.forcing_provider(sim.current_time, sim.time_init)
    from nextsim_tpu.parallel.sharding import shard_tree

    forcing = shard_tree(forcing, mesh)

    from nextsim_tpu.parallel.partition_check import substep_partition_report

    print(f"devices: {mesh.devices.shape}, grid {nx}x{nx}, substeps {substeps}")
    rep = substep_partition_report(
        sim.raw_step_fn, (sim.state, forcing, sim.time_info()), mesh, substeps
    )
    uniq = sorted(set(rep["carry_shapes"]))
    print(f"substep while-loop carry local shapes: {uniq}")
    print(f"collective-permutes in module: {rep['n_collective_permute']}")

    lowered = jax.jit(sim.raw_step_fn).lower(sim.state, forcing, sim.time_info())
    compiled = lowered.compile()
    hlo = compiled.as_text()

    # --- per-device cost vs global --------------------------------------
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = ca.get("flops", float("nan"))
    print(f"per-device flops (cost_analysis): {flops:.3e}")

    # single-device comparison
    sim1 = Simulator(cfg)
    forcing1 = sim.forcing_provider(sim.current_time, sim.time_init)
    c1 = jax.jit(sim1.raw_step_fn).lower(
        sim1.state, forcing1, sim1.time_info()
    ).compile()
    ca1 = c1.cost_analysis()
    if isinstance(ca1, list):
        ca1 = ca1[0]
    flops1 = ca1.get("flops", float("nan"))
    print(f"single-device flops:             {flops1:.3e}")
    print(f"ratio per-device/global: {flops / flops1:.3f} "
          f"(ideal {1.0 / mesh.devices.size:.3f} for {mesh.devices.size} devices)")

    # dump carry sharding of the largest while loop for eyeballing
    out = "/tmp/step_hlo.txt"
    with open(out, "w") as f:
        f.write(hlo)
    print(f"full HLO written to {out}")


if __name__ == "__main__":
    main()
