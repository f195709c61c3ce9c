"""Command-line entry point.

The reference ships one executable (reference: model/main.cpp:21-37;
model/run.sh:55: ``mpirun -np N nextsim.exec --config-files=X.cfg``). Here:

    python -m nextsim_tpu --config-files=X.cfg [section.option=value ...]

Multiple config files merge left-to-right; bare ``name=value`` arguments
override individual options (like the reference's CLI override of
program_options). A run log with the full resolved config and git hash is
written next to the outputs (reference: writeLogFile, fe.cpp:14371-14487).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def write_log_file(sim) -> None:
    cfg = sim.cfg
    path = cfg["output.exporter_path"]
    os.makedirs(path, exist_ok=True)
    try:
        git_hash = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip()
    except Exception:
        git_hash = "unknown"
    with open(os.path.join(path, "nextsim_tpu.log"), "w") as f:
        f.write(f"# nextsim_tpu run log\n# git: {git_hash}\n")
        f.write(f"# argv: {' '.join(sys.argv)}\n\n")
        f.write(cfg.dump())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nextsim_tpu",
        epilog="Remaining arguments: more .cfg files, or section.option=value "
               "overrides. --help-options lists every option.",
    )
    parser.add_argument("--config-file", action="append", default=[])
    parser.add_argument("--config-files", action="append", default=[])
    parser.add_argument(
        "--help-options", action="store_true",
        help="print every config option (type, default, allowed values) and exit",
    )
    args, extra = parser.parse_known_args(argv)

    from nextsim_tpu.config import Config

    if args.help_options:
        # the analog of the reference's --help option dump (model/main.cpp:27-33)
        print(Config.describe_options())
        return 0

    files = list(args.config_file) + list(args.config_files)
    overrides = {}
    for ov in extra:
        # remaining args: either more config files or section.option=value
        if "=" in ov and not ov.endswith(".cfg"):
            k, _, v = ov.partition("=")
            overrides[k.lstrip("-")] = v
        else:
            files.append(ov)

    try:
        cfg = Config.from_files(*files, overrides=overrides)
    except (KeyError, ValueError, FileNotFoundError) as e:
        # config mistakes get a one-line message, not a traceback (the
        # reference prints program_options' error string; main.cpp:34-36)
        if isinstance(e, FileNotFoundError):
            msg = f"config file not found: {e.filename}"
        else:
            msg = e.args[0] if e.args else str(e)
        print(f"nextsim_tpu: config error: {msg}", file=sys.stderr)
        return 2

    # multi-process boot (no-op without a coordinator; reference:
    # Environment ctor)
    from nextsim_tpu.parallel.distributed import init_distributed
    from nextsim_tpu.utils.compile_cache import enable_compile_cache

    init_distributed()
    enable_compile_cache()

    from nextsim_tpu.model.simulator import Simulator
    from nextsim_tpu.parallel.multihost import is_writer

    sim = Simulator(cfg)
    if is_writer():
        write_log_file(sim)
    sim.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
