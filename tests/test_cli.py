"""CLI surface tests (reference: model/main.cpp:21-37 — --help prints the
option table; program_options errors print one-line messages)."""

import os
import subprocess
import sys

import pytest

from nextsim_tpu.__main__ import main


def test_help_options_lists_everything(capsys):
    assert main(["--help-options"]) == 0
    out = capsys.readouterr().out
    # every section header present, enums rendered, 300+ lines
    for sec in ("[simul]", "[dynamics]", "[thermo]", "[moorings]", "[tpu]"):
        assert sec in out
    assert "one of" in out and "default=" in out
    assert len(out.splitlines()) > 300


@pytest.mark.parametrize("argv,needle", [
    (["--config-files", "/does/not/exist.cfg"], "config file not found"),
    (["setup.dynamics-type=bogus"], "allowed"),
    (["nosuch.option=1"], "unknown option"),
    # options of the retired blocked substep kernel and of the old cache
    # setting are unknown, not silently ignored
    (["tpu.substep_kernel=pallas"], "unknown option"),
    (["tpu.pallas_block_rows=32"], "unknown option"),
    (["tpu.pallas_group_substeps=8"], "unknown option"),
    (["tpu.pallas_unroll=1"], "unknown option"),
    (["tpu.compilation_cache_dir=/tmp/c"], "unknown option"),
])
def test_config_errors_are_one_liners(argv, needle, capsys):
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert "config error" in err and needle in err
    assert "Traceback" not in err


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


_PRINT_CACHE = (
    "import jax\n"
    "from nextsim_tpu.utils.compile_cache import enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_retired_option_in_cfg_file_is_an_error(tmp_path, capsys):
    """A config file that still sets a retired [tpu] option fails with the
    one-line unknown-option error instead of running without it."""
    cfg = tmp_path / "old.cfg"
    cfg.write_text("[tpu]\nsteps_per_call=2\nsubstep_kernel=pallas\n")
    assert main(["--config-files", str(cfg)]) == 2
    err = capsys.readouterr().err
    assert "unknown option 'tpu.substep_kernel'" in err
    assert "Traceback" not in err


def test_compile_cache_env_dir_is_used(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the CLI's compiled programs land
    in that directory and the program names no other."""
    cache = tmp_path / "xla_cache"
    env = _env(JAX_COMPILATION_CACHE_DIR=str(cache))
    r = subprocess.run([sys.executable, "-c", _PRINT_CACHE], env=env,
                       capture_output=True, text=True, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [str(cache), str(cache)]
    args = [
        sys.executable, "-m", "nextsim_tpu",
        "--config-files", "configs/toy.cfg",
        "grid.nx=32", "grid.ny=32", "simul.duration=0.003472222",
        f"output.exporter_path={tmp_path / 'out'}",
        "moorings.use_moorings=false", "output.output_per_day=0",
    ]
    r = subprocess.run(args, env=env, capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert list(cache.glob("*")), "no compilation cache entries written"


@pytest.mark.parametrize("where", ["tmp", "tests"])
def test_compile_cache_default_is_the_checkout_path(where, tmp_path):
    """Without the variable the cache is <checkout>/.jax_cache whatever the
    working directory, so a relaunch from elsewhere still hits it."""
    cwd = tmp_path if where == "tmp" else os.path.join(REPO, "tests")
    r = subprocess.run([sys.executable, "-c", _PRINT_CACHE], env=_env(),
                       capture_output=True, text=True, cwd=cwd)
    assert r.returncode == 0, r.stderr[-2000:]
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]


@pytest.mark.parametrize("coord,nproc,pid", [
    ("localhost:1", None, None),  # coordinator named, no process count
    ("localhost:1", 2, None),  # no process id
    ("localhost:1", 2, 5),  # id outside the process count
])
def test_init_distributed_raises_on_bad_setup(coord, nproc, pid, monkeypatch):
    """A named coordinator with an incomplete or inconsistent process setup
    raises instead of quietly running as one process."""
    from nextsim_tpu.parallel.distributed import init_distributed

    for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError):
        init_distributed(coord, nproc, pid)


def test_init_distributed_without_coordinator_is_a_no_op(monkeypatch):
    from nextsim_tpu.parallel.distributed import init_distributed

    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False


def test_profile_dir_writes_trace(tmp_path):
    """debugging.profile_dir wraps the main loop in a jax.profiler trace
    (the xprof analog of the reference's gperftools hook, run.sh:64-78)."""
    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator

    prof = tmp_path / "prof"
    cfg = Config(overrides={
        "grid.nx": 32, "grid.ny": 32, "grid.resolution": 10e3,
        "simul.timestep": 300, "simul.duration": 900.0 / 86400.0,
        "simul.time_init": "2015-10-16 00:00:00",
        "dynamics.substeps": 30,
        "thermo.use_thermo_forcing": False,
        "setup.ice-type": "constant", "setup.atmosphere-type": "constant",
        "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 10.0,
        "output.exporter_path": str(tmp_path / "out"),
        "output.output_per_day": 0,
        "debugging.profile_dir": str(prof),
    })
    Simulator(cfg).run()
    traces = list(prof.rglob("*.pb")) + list(prof.rglob("*.json.gz")) \
        + list(prof.rglob("*.trace*"))
    assert traces, f"no trace files under {prof}"
