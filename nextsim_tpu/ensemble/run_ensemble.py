"""Ensemble run driver.

The analog of the reference's ensemble run scripts (reference:
scripts/ensemble/run_ensemble.sh, modules/enkf/run_ensemble_in_docker.sh):
launch N members of the same configuration with member-specific perturbed
forcing (statevector.ensemble_member = 1..N; member 0 is the unperturbed
control), each writing to its own output directory ``mem_<k>/``.

On several cards the layout is one member per card and process (BASELINE.md
deployment 5): each process runs this driver with its own ``--member`` and its
own ``--device``, so that it sees and reserves only that card (a JAX process
reserves most of the memory of every card it can see). In one process the
members run one after another.

Usage:
    python -m nextsim_tpu.ensemble.run_ensemble --config-files X.cfg \
        --num-members 4 [--control] [opt=value ...]
    python -m nextsim_tpu.ensemble.run_ensemble --config-files X.cfg \
        --member 2 --device 1 [opt=value ...]      # one process per card
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List


def run_member(cfg_files: List[str], overrides: dict, member: int, base_out: str):
    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator

    member_overrides = dict(overrides)
    member_overrides["statevector.ensemble_member"] = member
    member_overrides["output.exporter_path"] = os.path.join(base_out, f"mem_{member}")
    cfg = Config.from_files(*cfg_files, overrides=member_overrides)
    sim = Simulator(cfg)
    sim.run()
    return sim


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nextsim_tpu.ensemble")
    parser.add_argument("--config-files", action="append", default=[])
    parser.add_argument("--num-members", type=int, default=4)
    parser.add_argument("--control", action="store_true",
                        help="also run the unperturbed member 0")
    parser.add_argument("--member", type=int, default=None,
                        help="run only this member (multi-process layout)")
    parser.add_argument("--device", type=int, default=None,
                        help="run on this card only (one process per card)")
    args, extra = parser.parse_known_args(argv)
    if args.device is not None:
        from nextsim_tpu.parallel.distributed import use_local_devices

        use_local_devices([args.device])
    from nextsim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    overrides = {}
    files = list(args.config_files)
    for ov in extra:
        if "=" in ov and not ov.endswith(".cfg"):
            k, _, v = ov.partition("=")
            overrides[k.lstrip("-")] = v
        else:
            files.append(ov)

    from nextsim_tpu.config import Config

    base_cfg = Config.from_files(*files, overrides=overrides)
    base_out = base_cfg["output.exporter_path"]

    members = (
        [args.member]
        if args.member is not None
        else ([0] if args.control else []) + list(range(1, args.num_members + 1))
    )
    for m in members:
        print(f"=== ensemble member {m} ===", file=sys.stderr)
        run_member(files, overrides, m, base_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
