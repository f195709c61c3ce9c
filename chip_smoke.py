"""Proof that the sea-ice model runs on an NVIDIA GPU, end to end.

    python chip_smoke.py            # one card: device, main, reference
    python chip_smoke.py --multi    # four cards: domain split and ensemble

Phases of the default run, in order:

* ``device``: JAX's devices must be GPUs (anything else fails the run);
  prints the card's name and power limit as nvidia-smi gives them.
* ``main``: the operational pan-Arctic configuration
  (configs/arctic_10km.cfg: 608x608 cells at 10 km, BBM with 120 substeps,
  dt 200 s, moorings, drifters, final restart, async IO) with thermodynamics
  on, through the command-line entry point: 108 steps (0.25 model days),
  then a resume from that restart for 27 more steps, compared with a
  continuous 135-step run. Prints the compile time, run walls and model
  steps per second.
* ``reference``: the same 608x608 model step on the GPU and on the CPU
  backend in one process, both float32, compared field by field over the
  first 3 substeps and statistically after one full step.

``--multi`` runs only the four-card path and what it is compared with: one
608x608 step on a 2x2 device mesh under the gspmd and the shard_map
(halo depth 4) schedules against the one-card step, a 4-member
member-sharded ensemble against the same batch on one card, and
``__graft_entry__.dryrun_multichip(4)``.

Every phase that fails raises, so the script exits non-zero and never
prints its last line, which is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The synthetic ETOPO file and the run outputs go to ``.chip_smoke/`` in the
checkout, the compiled programs to the persistent compile cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")
CFG = os.path.join(REPO, "configs", "arctic_10km.cfg")

# Thermodynamics on. The constant ocean holds the SST at +1 C; under the
# default init_SST_limit that clears the initial ice cover, so the limit is
# raised to keep the ice.
THERMO = {"thermo.use_thermo_forcing": "true", "ideal_simul.init_SST_limit": "10"}
# 0.25 model days = 108 steps of 200 s: one moorings record (6-hourly), one
# drifter record (6-hourly here, against the default 12) and a final
# restart. The resume adds 27 steps (3 chunks of 9) and the continuous run
# covers both, 135 steps.
RUN = dict(THERMO, **{"drifters.equally_spaced_drifters_output_time_step": "0.25"})
FIRST_DAYS, RESUME_DAYS = 0.25, 0.0625
FIRST_STEPS, RESUME_STEPS = 108, 27

# --- tolerances --------------------------------------------------------
# GPU against CPU, the same float32 program. Over the first 3 substeps no
# cell has crossed the BBM failure threshold, so the fields differ only by
# each backend's rounding: other FMA contraction and other exp/pow/sqrt
# implementations, a few ULP per operation over some 700 operations per
# cell and substep. 1e-5 is about 80 float32 ULP; the absolute floor, 1e-5
# of the field's largest magnitude, covers cells where cancellation leaves
# a value near zero.
FIELD_RTOL = 1e-5
FIELD_ATOL_OF_MAX = 1e-5
# After full steps the failure branch turns those ULP differences into
# cell-level differences (the same divergence the repo's sharded-vs-single
# tests allow for), so the statistics are compared: mean ice speed, mean
# damage and total ice volume.
MEAN_SPEED_RTOL = 1e-3
MEAN_DAMAGE_ATOL = 1e-3
VOLUME_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


# --- comparisons -------------------------------------------------------
def compare_fields(name, got, want, rtol=FIELD_RTOL, atol_of_max=FIELD_ATOL_OF_MAX):
    """Field-by-field check |got - want| <= atol + rtol |want| with atol =
    atol_of_max * max|want|. Returns a one-line report; raises when a field
    differs in shape, is not finite or is off by more than the tolerance."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    atol = atol_of_max * float(np.abs(want).max(initial=0.0))
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    rel = float((err / np.maximum(np.abs(want), 1e-30)).max(initial=0.0))
    report = (f"{name}: max|diff|={float(err.max(initial=0.0)):.3e} "
              f"max rel={rel:.3e} (rtol {rtol:g}, atol {atol:.3e})")
    if bad.any():
        raise AssertionError(f"{report}: {int(bad.sum())} cells out of tolerance")
    return report


def state_stats(state):
    """Mean ice speed over the node plane, mean damage and total ice volume
    (sum of conc * thick over cells), in float64 on the host."""
    import numpy as np

    u = np.asarray(state.vt_u, np.float64)
    v = np.asarray(state.vt_v, np.float64)
    return {
        "mean_speed": float(np.sqrt(u * u + v * v).mean()),
        "mean_damage": float(np.asarray(state.damage, np.float64).mean()),
        "volume": float((np.asarray(state.conc, np.float64)
                         * np.asarray(state.thick, np.float64)).sum()),
    }


def compare_stats(name, got, want):
    """Statistical check of two states (dicts from state_stats). Returns a
    one-line report; raises when a statistic is off by more than its
    tolerance."""
    checks = (
        ("mean_speed", abs(got["mean_speed"] - want["mean_speed"])
         <= MEAN_SPEED_RTOL * abs(want["mean_speed"])),
        ("mean_damage", abs(got["mean_damage"] - want["mean_damage"])
         <= MEAN_DAMAGE_ATOL),
        ("volume", abs(got["volume"] - want["volume"])
         <= VOLUME_RTOL * abs(want["volume"])),
    )
    report = f"{name}: " + " ".join(
        f"{k}={got[k]:.9g}/{want[k]:.9g}" for k, _ in checks
    )
    failed = [k for k, ok in checks if not ok]
    if failed:
        raise AssertionError(f"{report}: out of tolerance: {failed}")
    return report


def _crop_to(a, like):
    """Drop the end padding a sharded leaf carries (parallel/sharding.py)."""
    import numpy as np

    a = np.asarray(a)
    return a[tuple(slice(0, d) for d in np.shape(like))]


# --- set-up ------------------------------------------------------------
def card_info() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi lists no card")
    return out


def make_etopo(work: str) -> str:
    """Generate the synthetic ETOPO file the operational configuration
    reads, and point NEXTSIM_DATA_DIR at it."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_synthetic_etopo

    data = os.path.join(work, "data")
    os.makedirs(data, exist_ok=True)
    make_synthetic_etopo.write(os.path.join(data, "ETOPO_Arctic_2arcmin.nc"))
    os.environ["NEXTSIM_DATA_DIR"] = data
    return data


def _args(over: dict) -> list:
    return ["--config-files", CFG] + [f"{k}={v}" for k, v in over.items()]


class RunClock:
    """Listens to JAX's monitoring events: trace, lowering and
    backend-compile durations (a compile served from the persistent cache
    counts its load time), and the Simulator's steady stepping loop."""

    COMPILE_EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        from nextsim_tpu.model.simulator import STEADY_LOOP_EVENT

        self._loop_event = STEADY_LOOP_EVENT
        self.compiles = []  # (end time, duration)
        self.loop = None  # (seconds, steps) of the last run, compiles taken out
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    @property
    def compile_total(self) -> float:
        return sum(d for _, d in self.compiles)

    def _on_event(self, event, duration, **kwargs):
        now = time.perf_counter()
        if event in self.COMPILE_EVENTS:
            self.compiles.append((now, duration))
        elif event == self._loop_event:
            # outputs first written inside the loop compile their programs
            # there; that time is set-up, not stepping
            inside = sum(d for t, d in self.compiles if t >= now - duration)
            self.loop = (duration - inside, kwargs["steps"])


def _load_restart(path):
    import numpy as np

    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"]))
        arrays = {k: f[k] for k in f.files if k != "__meta__"}
    return meta, arrays


# --- phases ------------------------------------------------------------
def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's devices are {devs[0].platform} ({devs})"
        )
    cards = card_info()
    for line in cards:
        log(line)
    tag = f"[{cards[0]}]"
    log(f"device: {len(devs)} x {devs[0].device_kind} {tag}")
    return tag


def phase_main(tag: str, work: str, extra: dict | None = None) -> dict:
    """The operational run through the CLI, its resume and the continuous
    run it must match. ``extra`` overrides (e.g. a smaller grid) are for
    rehearsing the phase away from the card."""
    import numpy as np
    from scipy.io import netcdf_file

    from nextsim_tpu.__main__ import main as cli

    base = dict(RUN, **(extra or {}))
    clock = RunClock()
    outs = {k: os.path.join(work, k) for k in ("first", "resume", "continuous")}
    for d in outs.values():
        shutil.rmtree(d, ignore_errors=True)

    def run(name, over):
        c0, t0 = clock.compile_total, time.perf_counter()
        clock.loop = None
        rc = cli(_args(dict(base, **over, **{"output.exporter_path": outs[name]})))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"main: the {name} run exited {rc}")
        if clock.loop is None:
            raise RuntimeError(f"main: the {name} run timed no stepping loop")
        return wall, clock.compile_total - c0, clock.loop

    wall1, comp1, loop1 = run("first", {"simul.duration": FIRST_DAYS})
    log(f"main: first run {FIRST_STEPS} steps wall_s={wall1:.3f} "
        f"compile_s={comp1:.3f} (first in this process: a cold compile unless "
        f"the persistent cache already holds the programs) {tag}")

    # outputs of the first run
    first = outs["first"]
    moorings = sorted(glob.glob(os.path.join(first, "Moorings*.nc")))
    if not moorings:
        raise RuntimeError(f"main: no moorings file in {first}")
    with netcdf_file(moorings[0], "r", mmap=False) as nc:
        sic = np.array(nc.variables["sic"][:], np.float64)
        ocean = np.array(nc.variables["lsm"][:]) > 0  # land holds NaN
        ntime = nc.variables["time"].shape[0]
    sic = sic[:, ocean]
    if ntime < 1 or not np.isfinite(sic).all() or sic.min() < 0 or sic.max() > 1:
        raise RuntimeError(f"main: moorings hold {ntime} records, sic in "
                           f"[{np.nanmin(sic)}, {np.nanmax(sic)}]")
    drifters = sorted(glob.glob(os.path.join(first, "Drifters_*.nc")))
    if not drifters:
        raise RuntimeError(f"main: no drifter output in {first}")
    restart = os.path.join(first, "restart", "restart_final.npz")
    meta, fields = _load_restart(restart)
    if meta["pcpt"] != FIRST_STEPS:
        raise RuntimeError(f"main: restart at step {meta['pcpt']} != {FIRST_STEPS}")
    for k, a in fields.items():
        if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
            raise RuntimeError(f"main: restart field {k} is not finite")
    conc = fields["conc"]
    if conc.min() < 0.0 or conc.max() > 1.0:
        raise RuntimeError(f"main: conc outside [0, 1]: {conc.min()} {conc.max()}")
    log(f"main: outputs {os.path.basename(moorings[0])} ({ntime} record), "
        f"{len(drifters)} drifter file(s), restart at step {meta['pcpt']}; "
        f"fields finite, conc in [{conc.min():.4f}, {conc.max():.4f}], "
        f"mean thick {float(fields['thick'].mean()):.6f} m")

    # resume from that restart, and the continuous run it must equal
    os.makedirs(os.path.join(outs["resume"], "restart"))
    shutil.copy(restart, os.path.join(outs["resume"], "restart"))
    wall2, comp2, _ = run("resume", {
        "simul.duration": RESUME_DAYS,
        "restart.start_from_restart": "true",
        "restart.type": "continue",
        "restart.basename": "final",
    })
    wall3, comp3, loop3 = run("continuous", {"simul.duration": FIRST_DAYS + RESUME_DAYS})
    meta_r, res = _load_restart(os.path.join(outs["resume"], "restart", "restart_final.npz"))
    meta_c, con = _load_restart(os.path.join(outs["continuous"], "restart", "restart_final.npz"))
    end = FIRST_STEPS + RESUME_STEPS
    if not meta_r["pcpt"] == meta_c["pcpt"] == end:
        raise RuntimeError(f"main: resumed/continuous end at {meta_r['pcpt']}/{meta_c['pcpt']} != {end}")
    if sorted(res) != sorted(con):
        raise RuntimeError("main: resumed and continuous restarts hold other fields")
    differ = {k: float(np.abs(res[k].astype(np.float64) - con[k]).max(initial=0.0))
              for k in res if not np.array_equal(res[k], con[k])}
    if differ:
        raise RuntimeError(f"main: resumed run differs from the continuous run: {differ}")
    log(f"main: resume of {RESUME_STEPS} steps is bitwise equal to the "
        f"continuous {end}-step run ({len(res)} fields)")

    log(f"main: resume wall_s={wall2:.3f} compile_s={comp2:.3f}, continuous "
        f"wall_s={wall3:.3f} compile_s={comp3:.3f} (programs from the "
        f"persistent cache) {tag}")
    # the stepping loop after its first device call, outputs included,
    # compiles inside it taken out
    for name, (secs, steps) in (("first", loop1), ("continuous", loop3)):
        steps_per_s = steps / secs
        log(f"main: {name} run loop wall_s={secs:.3f} for {steps} steps "
            f"= {secs / steps * 1e3:.3f} ms/step, {steps_per_s:.3f} steps/s, "
            f"{steps_per_s * 200.0 / 86400.0 * 3600.0:.3f} model days per "
            f"wall hour {tag}")
    return {"restart": restart}


def _reference_sim(device, restart, extra):
    """A Simulator of the operational configuration on ``device``, started
    from ``restart`` (a developed state) with the full wind from its first
    step, outputs off."""
    import jax

    from nextsim_tpu.config import Config
    from nextsim_tpu.model.simulator import Simulator

    over = dict(THERMO, **(extra or {}))
    over.update({
        "simul.spinup_duration": "0",
        "moorings.use_moorings": "false",
        "drifters.use_equally_spaced_drifters": "false",
        "output.output_per_day": "0",
        "restart.write_final_restart": "false",
        "restart.start_from_restart": "true",
        "restart.type": "continue",
        "restart.basename": "final",
        "restart.input_path": os.path.dirname(restart),
        "output.exporter_path": os.path.join(WORK, f"reference_{device.platform}"),
        "tpu.donate_state": "false",
        "tpu.steps_per_call": "1",
    })
    with jax.default_device(device):
        return Simulator(Config.from_files(CFG, overrides=over))


def phase_reference(tag, accel, cpu, restart, extra=None):
    """The model step on ``accel`` against the CPU backend."""
    import jax

    from nextsim_tpu.ops import momentum

    def run(device):
        sim = _reference_sim(device, restart, extra)
        with jax.default_device(device):
            forcing = sim.forcing_provider(sim.current_time, sim.time_init)
            tinfo = sim.time_info()
            ga = dict(sim.grid_arrays)
            ga["cohesion"] = sim.c_fix + sim.c_alea * sim.state.random_number
            # 3 substeps of the production length dte = dt / 120
            n = 3
            dyn3 = dataclasses.replace(sim.dyn, substeps=n)
            solve3 = jax.jit(lambda s, f: momentum.explicit_solve(
                s, f, ga, sim.dt * n / sim.dyn.substeps, dyn3)[0])
            short = jax.device_get(solve3(sim.state, forcing))
            t0 = time.perf_counter()
            full, _, viol = sim._step_fn(sim.state, forcing, tinfo)
            full = jax.block_until_ready(full)
            wall = time.perf_counter() - t0
            if bool(viol.any()):
                raise RuntimeError(f"reference: field violations on {device}")
        return short, jax.device_get(full), wall

    short_a, full_a, wall_a = run(accel)
    short_c, full_c, wall_c = run(cpu)
    log(f"reference: one step (compile included) {accel.platform} "
        f"wall_s={wall_a:.3f}, cpu wall_s={wall_c:.3f} {tag}")
    for name in ("vt_u", "vt_v", "sigma", "damage", "ut_u", "ut_v"):
        log("reference: 3 substeps " + compare_fields(
            name, getattr(short_a, name), getattr(short_c, name)))
    log("reference: 1 step " + compare_stats(
        "stats", state_stats(full_a), state_stats(full_c)))


def phase_multi(tag, devices, extra=None):
    """Four cards: the 2x2 domain split under both schedules and the
    member-sharded ensemble, each against one card."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import __graft_entry__
    from nextsim_tpu.config import Config
    from nextsim_tpu.ensemble.batched import BatchedEnsemble
    from nextsim_tpu.model.simulator import Simulator
    from nextsim_tpu.parallel.sharding import shard_tree

    if len(devices) < 4:
        raise RuntimeError(f"--multi needs 4 devices, JAX sees {len(devices)}")
    devices = devices[:4]
    over = dict(THERMO, **(extra or {}))
    over.update({
        "simul.spinup_duration": "0",
        "moorings.use_moorings": "false",
        "drifters.use_equally_spaced_drifters": "false",
        "output.output_per_day": "0",
        "restart.write_final_restart": "false",
        "output.exporter_path": os.path.join(WORK, "multi"),
        "tpu.donate_state": "false",
        "tpu.steps_per_call": "1",
    })
    n_steps = 3

    def steps(sim, mesh):
        forcing = sim.forcing_provider(sim.current_time, sim.time_init)
        if mesh is not None:
            forcing = shard_tree(forcing, mesh)
        tinfo = sim.time_info()
        state = sim.state
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _, viol = sim._step_fn(state, forcing, tinfo)
            if bool(viol.any()):
                raise RuntimeError("multi: field violations")
        state = jax.block_until_ready(state)
        return jax.device_get(state), time.perf_counter() - t0

    with jax.default_device(devices[0]):
        one, wall1 = steps(Simulator(Config.from_files(CFG, overrides=over)), None)
    ref = state_stats(one)
    log(f"multi: one card {n_steps} steps wall_s={wall1:.3f} (compile included) {tag}")
    for mode, depth in (("gspmd", 1), ("shard_map", 4)):
        cfg = Config.from_files(CFG, overrides=dict(over, **{
            "tpu.mesh_shape": "2x2", "tpu.partition_mode": mode,
            "tpu.halo_depth": str(depth),
        }))
        sim = Simulator(cfg)
        got, wall = steps(sim, sim.device_mesh)
        cropped = type(got)(**{
            f.name: None if getattr(got, f.name) is None
            else _crop_to(getattr(got, f.name), getattr(one, f.name))
            for f in dataclasses.fields(got)
        })
        log(f"multi: 2x2 {mode} H={depth} wall_s={wall:.3f} (compile included) {tag}")
        log("multi: " + compare_stats(f"2x2 {mode} H={depth} vs one card",
                                      state_stats(cropped), ref))

    ens_over = dict(over)
    members = 4

    def ensemble(mesh):
        ens = BatchedEnsemble(Config.from_files(CFG, overrides=ens_over),
                              n_members=members, mesh=mesh)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            ens.step()
        jax.block_until_ready(ens.states)
        wall = time.perf_counter() - t0
        return [jax.device_get(ens.member_state(k)) for k in range(members)], wall

    with jax.default_device(devices[0]):
        ens_one, wall_e1 = ensemble(None)
    ens_four, wall_e4 = ensemble(Mesh(np.asarray(devices), ("member",)))
    log(f"multi: ensemble of {members} x {n_steps} steps one card "
        f"wall_s={wall_e1:.3f}, member-sharded on 4 wall_s={wall_e4:.3f} "
        f"(compile included) {tag}")
    for k in range(members):
        log("multi: " + compare_stats(f"ensemble member {k} sharded vs one card",
                                      state_stats(ens_four[k]),
                                      state_stats(ens_one[k])))
    __graft_entry__.dryrun_multichip(4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card path and its comparisons")
    args = parser.parse_args(argv)

    # the reference phase needs the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    from nextsim_tpu.utils.compile_cache import enable_compile_cache

    tag = phase_device()
    enable_compile_cache()
    os.makedirs(WORK, exist_ok=True)
    make_etopo(WORK)
    devices = jax.devices()
    if args.multi:
        phase_multi(tag, devices)
    else:
        res = phase_main(tag, WORK)
        phase_reference(tag, devices[0], jax.devices("cpu")[0], res["restart"])
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
