"""Checkpoint / resume.

Equivalent of the reference's writeRestart/readRestart (reference:
model/finiteelement.cpp:9503-9948): the full prognostic state + step counters
+ drifter state, named ``restart_<name>.npz`` (single-file analog of the
reference's {field,mesh}_<name>.{bin,dat} pair — no mesh needs saving because
the grid is static and reproducible from the config). Resume is
deterministic: the restored state is bitwise the saved one.

Restart types (reference: options.cpp restart.type):
* extend   — continue for `simul.duration` from the restart's time
* continue — duration counted from the original time_init
* arbitrary— ignore restart time; use config time_init
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from nextsim_tpu.core.state import State
from nextsim_tpu.utils import dates


def save_npz_restart(fname: str, meta: dict, arrays: dict,
                     async_io: bool = False) -> str:
    """Write one npz restart payload (__meta__ JSON + arrays) — the single
    owner of the on-disk format `read_restart`/`_apply_restart` load; the
    Simulator path and the batched-ensemble per-member export both route
    through it so the format cannot drift."""
    if async_io:
        # arrays must already be host numpy (frozen at submit time); only
        # the compression + disk write rides the worker
        from nextsim_tpu.utils import async_writer

        async_writer.get_writer().submit(
            np.savez_compressed, fname, __meta__=json.dumps(meta), **arrays
        )
    else:
        np.savez_compressed(fname, __meta__=json.dumps(meta), **arrays)
    return fname


def restart_meta(sim) -> dict:
    """The meta block every restart carries (grid identity + counters)."""
    return {
        "pcpt": sim.pcpt,
        "time_init": sim.time_init,
        "current_time": sim.current_time,
        "grid": {"nx": sim.grid.nx, "ny": sim.grid.ny, "dx": sim.grid.dx,
                 "x0": sim.grid.x0, "y0": sim.grid.y0},
    }


def write_restart(sim, name: Optional[str] = None) -> str:
    cfg = sim.cfg
    path = cfg["restart.input_path"] or os.path.join(cfg["output.exporter_path"], "restart")
    os.makedirs(path, exist_ok=True)
    if name is None:
        if cfg["restart.datetime_in_filename"]:
            name = dates.datenum_to_string(sim.current_time)
        else:
            name = str(sim.pcpt)
    fmt = cfg["restart.format"]
    arrays = {}
    # orbax: keep the state leaves on DEVICE — orbax writes each process's
    # shards in parallel with NO global gather (the sharded alternative
    # to the reference's rank-0 writeRestart, fe.cpp:9503-9696; O(shard)
    # host memory instead of O(global))
    hstate = sim._crop(sim.state) if fmt == "orbax" else sim.host_state()
    for f in dataclasses.fields(hstate):
        v = getattr(hstate, f.name)
        if v is None:  # optional leaves (e.g. FSD when disabled)
            continue
        arrays[f.name] = v if fmt == "orbax" else np.asarray(v)
    meta = restart_meta(sim)
    drifters = getattr(sim, "drifters", None)
    if drifters:
        for i, d in enumerate(drifters):
            arrays[f"__drifter{i}_x"] = d.x
            arrays[f"__drifter{i}_y"] = d.y
            arrays[f"__drifter{i}_id"] = d.ids
            arrays[f"__drifter{i}_alive"] = d.alive
            arrays[f"__drifter{i}_last_output"] = np.asarray(d._last_output, np.float64)
        # where the displacement the drifters ride was last sampled: a resume
        # moves them by the displacement since then, not since step 0
        arrays["__drifter_last_move"] = np.asarray(sim._drifter_last_move, np.float64)
        if sim._drifter_ut_prev is not None:
            arrays["__drifter_ut_prev_u"], arrays["__drifter_ut_prev_v"] = (
                sim._drifter_ut_prev
            )
    # WIM floe-number field (the WAVES-era M_nfloes prognostic participates
    # in the reference restart)
    if getattr(sim, "wim", None) is not None and getattr(sim, "_wim_nfloes", None) is not None:
        from nextsim_tpu.parallel.multihost import gather_to_host

        arrays["__wim_nfloes"] = gather_to_host(sim._wim_nfloes)
        # wave-spectrum persistence: resumes keep sub-window swell memory
        # instead of re-spinning the spectrum from incident waves
        arrays["__wim_sdf"] = gather_to_host(sim.wim.sdf)
    if fmt == "orbax":
        return save_orbax_checkpoint(
            os.path.join(path, f"restart_{name}.orbax"), arrays, meta
        )
    fname = os.path.join(path, f"restart_{name}.npz")
    from nextsim_tpu.parallel.multihost import is_writer

    if not is_writer():
        # host_state() above is the collective gather; only process 0 writes
        # (reference: writeRestart on rank 0, fe.cpp:9503-9696)
        return fname
    return save_npz_restart(fname, meta, arrays, async_io=cfg["output.async_io"])


def save_orbax_checkpoint(fname: str, arrays: dict, meta: dict) -> str:
    """Sharded checkpoint via orbax: every process writes its own shards in
    parallel (TensorStore/OCDBT under the hood) — no rank-0 gather, no
    O(global) host buffer. A JSON sidecar records meta + the leaf spec so a
    restore can run under ANY topology (different process count or mesh)
    without trusting the checkpoint's saved shardings. Shared by the
    Simulator restart and the batched-ensemble checkpoint.

    The save is synchronous-but-parallel (orbax's own multi-writer IO);
    ``output.async_io`` applies to the npz path, whose cost is the
    single-process gather+compress this format avoids."""
    import orbax.checkpoint as ocp

    from nextsim_tpu.parallel.multihost import is_writer

    fname = os.path.abspath(fname)
    ck = ocp.StandardCheckpointer()
    ck.save(fname, arrays, force=True)  # collective across processes
    ck.wait_until_finished()
    if is_writer():
        sidecar = dict(meta)
        sidecar["fields"] = {
            k: [list(np.shape(v)), str(v.dtype)] for k, v in arrays.items()
        }
        with open(fname + ".json", "w") as f:
            json.dump(sidecar, f, indent=1)
    return fname


def load_orbax_checkpoint(fname: str):
    """(arrays, sidecar-meta) for a checkpoint written by
    save_orbax_checkpoint: restore against numpy zero templates built from
    the sidecar spec, so the load is topology-agnostic (a 2-process
    checkpoint resumes on 1 process and vice versa)."""
    import orbax.checkpoint as ocp

    fname = os.path.abspath(fname)
    with open(fname + ".json") as f:
        sidecar = json.load(f)
    fields = sidecar.pop("fields")
    target = {
        k: np.zeros(tuple(shape), np.dtype(dtype))
        for k, (shape, dtype) in fields.items()
    }
    data = ocp.StandardCheckpointer().restore(fname, target)
    return data, sidecar


def read_restart(sim, basename: Optional[str] = None) -> None:
    """Restore state + counters into an initialised Simulator (reference:
    readRestart, fe.cpp:9701-9948)."""
    cfg = sim.cfg
    path = cfg["restart.input_path"] or os.path.join(cfg["output.exporter_path"], "restart")
    basename = basename or cfg["restart.basename"]
    # a pending asynchronous write of this very file must land first
    from nextsim_tpu.utils import async_writer

    async_writer.flush()
    if cfg["restart.format"] == "orbax":
        data, meta = load_orbax_checkpoint(
            os.path.join(path, f"restart_{basename}.orbax")
        )
        _apply_restart(sim, data, meta)
    else:
        fname = os.path.join(path, f"restart_{basename}.npz")
        with np.load(fname, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            _apply_restart(sim, data, meta)


def _apply_restart(sim, data, meta) -> None:
    """Apply a loaded restart payload (npz mapping or orbax-restored dict)
    to an initialised Simulator — one code path for both formats."""
    cfg = sim.cfg
    g = meta["grid"]
    if (g["nx"], g["ny"]) != (sim.grid.nx, sim.grid.ny):
        raise ValueError(
            f"restart grid {g['nx']}x{g['ny']} != model grid "
            f"{sim.grid.nx}x{sim.grid.ny}"
        )
    kw = {}
    for f in dataclasses.fields(sim.state):
        if f.name in data:
            kw[f.name] = jnp.asarray(data[f.name], sim.dtype)
        else:
            kw[f.name] = None
    sim.state = State(**kw)
    if sim.device_mesh is not None:
        from nextsim_tpu.parallel.sharding import shard_tree

        sim.state = shard_tree(sim.state, sim.device_mesh)
    # the drifters' clocks are times; a restart that ignores its own time
    # (restart.type=arbitrary) keeps the config's
    keep_clock = cfg["restart.type"] != "arbitrary"
    drifters = getattr(sim, "drifters", None)
    if drifters:
        for i, d in enumerate(drifters):
            if getattr(d, "ignore_restart", False):
                continue  # drifters.<flavour>_ignore_restart: re-init
            if f"__drifter{i}_x" in data:
                d.x = data[f"__drifter{i}_x"]
                d.y = data[f"__drifter{i}_y"]
                d.ids = data[f"__drifter{i}_id"]
                d.alive = data[f"__drifter{i}_alive"]
                if keep_clock and f"__drifter{i}_last_output" in data:
                    d._last_output = float(data[f"__drifter{i}_last_output"])
        if "__drifter_last_move" in data:
            if keep_clock:
                sim._drifter_last_move = float(data["__drifter_last_move"])
            sim._drifter_ut_prev = (
                (np.asarray(data["__drifter_ut_prev_u"]),
                 np.asarray(data["__drifter_ut_prev_v"]))
                if "__drifter_ut_prev_u" in data else None
            )
    if getattr(sim, "wim", None) is not None and "__wim_nfloes" in data:
        sim._wim_nfloes = jnp.asarray(data["__wim_nfloes"], sim.dtype)
        if "__wim_sdf" in data and data["__wim_sdf"].shape == sim.wim.sdf.shape:
            sim.wim.sdf = jnp.asarray(data["__wim_sdf"], sim.dtype)

    rtype = cfg["restart.type"]
    if rtype == "arbitrary":
        pass  # keep config time_init and pcpt=0
    elif rtype == "extend":
        # restart time becomes the new time origin (fe.cpp restart extend)
        sim.time_init = meta["current_time"]
        sim.pcpt = 0
    elif rtype == "continue":
        sim.time_init = meta["time_init"]
        sim.pcpt = meta["pcpt"]
    else:
        raise ValueError(f"restart.type {rtype!r}")

    # Re-anchor step-cadence state on the restored counter. read_restart may
    # be called on a Simulator that already stepped (tools, DA cycles): a
    # stale _wim_last_pcpt would de-anchor the WIM exchange from the
    # absolute 0, f, 2f grid after the pcpt jump (extend resets pcpt to 0;
    # continue may move it forward), and check/export batching would
    # measure from the pre-restart counter.
    if hasattr(sim, "_wim_last_pcpt"):
        del sim._wim_last_pcpt  # _wim_due re-derives the absolute grid
    sim._last_check_pcpt = sim.pcpt
    sim._last_export_pcpt = sim.pcpt
    sim._last_restart_pcpt = sim.pcpt

    if cfg["restart.restart_at_rest"]:
        sim.state = sim.state.replace(
            vt_u=jnp.zeros_like(sim.state.vt_u),
            vt_v=jnp.zeros_like(sim.state.vt_v),
        )
