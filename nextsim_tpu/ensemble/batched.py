"""Batched (vmapped) ensemble: all members in ONE device program.

The reference runs ensemble members as separate MPI jobs (reference:
scripts/ensemble/run_ensemble.sh; modules/enkf perturbations applied per
process under #ifdef ENSEMBLE, externaldata.cpp:244-278). Here the natural
layout for small/medium domains is a leading member axis: the model step is
`jax.vmap`-ed over the state and the perturbed forcing, so N members run as
one device program over one wide batch instead of N processes. (The
per-process driver, ensemble/run_ensemble.py, remains the layout for
one-member-per-card runs and for members that need their own output
streams.)

Member 0 is the unperturbed control (same convention as the reference and
run_ensemble.py); members 1..N-1 carry independent AR(1) spectral forcing
perturbations (ensemble/perturbation.py — Evensen red noise, SLP-geostrophic
wind option), advanced for all members in the same device program.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nextsim_tpu.ensemble.perturbation import EnsembleForcing, PerturbationParams


class BatchedEnsemble:
    """N-member ensemble advanced by one vmapped step program."""

    def __init__(self, cfg, n_members: int, seed: int = 11,
                 params: Optional[PerturbationParams] = None, mesh=None):
        """``mesh``: optional 1-D `jax.sharding.Mesh` over axis ``'member'``
        — members distribute across devices as pure data parallelism (the
        analog of the reference's one-MPI-job-per-member layout,
        scripts/ensemble/run_ensemble.sh, with zero physics changes: GSPMD
        partitions the leading member axis). n_members must divide the
        mesh. Without a mesh the ensemble batches on one device
        exactly as before."""
        from nextsim_tpu.model.simulator import Simulator

        if n_members < 1:
            raise ValueError("n_members must be >= 1")
        if cfg["statevector.ensemble_member"] > 0:
            raise ValueError(
                "BatchedEnsemble manages perturbations itself: leave "
                "statevector.ensemble_member at 0"
            )
        self.n = n_members
        self.member_mesh = mesh
        if mesh is not None:
            names = tuple(mesh.axis_names)
            if names not in (("member",), ("member", "y", "x")):
                raise ValueError(
                    "BatchedEnsemble mesh must be 1-D ('member',) or 3-D "
                    "('member','y','x') — members × domain decomposition"
                )
            if n_members % mesh.devices.shape[0]:
                raise ValueError(
                    f"the mesh's member axis ({mesh.devices.shape[0]} "
                    f"devices) must divide n_members={n_members}"
                )
        self.sim = Simulator(cfg)  # template: control provider, step fn, grid
        if mesh is not None and tuple(mesh.axis_names) == ("member", "y", "x"):
            _, dpy, dpx = mesh.devices.shape
            ny, nx = self.sim.grid.shape
            if ny % dpy or nx % dpx:
                raise ValueError(
                    f"grid {ny}x{nx} does not divide the member mesh's "
                    f"({dpy},{dpx}) spatial axes: choose grid.ny/nx "
                    "divisible by them (same rule as tpu.mesh_shape)"
                )
        self.states = jax.tree.map(
            lambda x: self._place(jnp.stack([x] * n_members)), self.sim.state
        )

        # one perturbation engine per member semantics, but vectorized:
        # member 0 gets zero perturbation, members>=1 get independent keys
        self._pert = EnsembleForcing(
            self.sim.forcing_provider, self.sim.grid, cfg, params=params,
            seed=seed,
        )
        self._pert.member = 1  # enable the perturbed path
        # sharded layout: every member (incl. the control slot 0, whose
        # perturbation is discarded) carries a key/carry so the leading axis
        # divides the mesh; member m>=1 keys match the unsharded path
        first = 0 if mesh is not None else 1
        self._seed = seed
        self.keys = self._place(jax.vmap(
            lambda m: jax.random.PRNGKey(seed * 1000003 + m)
        )(jnp.arange(first, n_members)))
        self._ran = None  # AR(1) carry, (n[-1], 4, ny, nx)
        self._vdraw = jax.jit(jax.vmap(self._pert._draw_stack))
        self._vpert = jax.jit(jax.vmap(self._pert._step, in_axes=(0, 0, None)))
        if mesh is not None and tuple(mesh.axis_names) == ("member", "y", "x"):
            # members × domain decomposition: node planes arrive end-padded
            # (see _place); crop to the logical staggered view before the
            # vmapped physics and re-pad + re-pin the 3-D sharding after —
            # the same layout discipline as the Simulator's own mesh path
            from nextsim_tpu.parallel.sharding import crop_node_leaves

            ny, nx = self.sim.grid.shape
            raw = self.sim.raw_step_fn

            def sharded_step(states, forcing, tinfo):
                states = crop_node_leaves(states, ny, nx)
                forcing = crop_node_leaves(forcing, ny, nx)
                s, d, v = jax.vmap(raw, in_axes=(0, 0, None))(
                    states, forcing, tinfo
                )
                return self._constrain(s), self._constrain(d), v

            self._vstep = jax.jit(sharded_step)
        else:
            self._vstep = jax.jit(
                jax.vmap(self.sim.raw_step_fn, in_axes=(0, 0, None))
            )
        self.pcpt = 0

    def _pad_spec(self, x):
        """(padded array, PartitionSpec) for a leading-member-axis array
        under the member mesh. On a 3-D ('member','y','x') mesh the
        trailing two dims of grid planes also block-shard (members × domain
        decomposition — BASELINE.md deployment 5's members combined with
        SURVEY §7's spatial mesh); node
        planes are end-padded to shard-divisible shapes exactly like the
        Simulator's own mesh path (the step crops them internally). ONE
        source of truth for both the host-side placement (_place) and the
        in-jit constraint (_constrain)."""
        from jax.sharding import PartitionSpec as P

        names = tuple(self.member_mesh.axis_names)
        if names == ("member", "y", "x") and x.ndim >= 3:
            from nextsim_tpu.parallel.sharding import padded_dim

            _, dpy, dpx = self.member_mesh.devices.shape
            py = padded_dim(x.shape[-2], dpy) - x.shape[-2]
            px = padded_dim(x.shape[-1], dpx) - x.shape[-1]
            if py or px:
                widths = [(0, 0)] * (x.ndim - 2) + [(0, py), (0, px)]
                x = jnp.pad(x, widths)
            return x, P(*(["member"] + [None] * (x.ndim - 3) + ["y", "x"]))
        return x, P(*(["member"] + [None] * (x.ndim - 1)))

    def _place(self, x):
        """Host-side: shard a leading-member-axis array over the member
        mesh (no-op without one)."""
        if self.member_mesh is None or getattr(x, "ndim", 0) < 1:
            return x
        from jax.sharding import NamedSharding

        x, spec = self._pad_spec(x)
        return jax.device_put(x, NamedSharding(self.member_mesh, spec))

    def _constrain(self, tree):
        """In-jit analog of _place: pad + pin the member-mesh sharding on
        every leading-member-axis leaf."""
        from jax.sharding import NamedSharding

        def f(x):
            if x is None or getattr(x, "ndim", 0) < 1:
                return x
            x, spec = self._pad_spec(x)
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(self.member_mesh, spec)
            )

        return jax.tree.map(f, tree)

    # -- forcing ----------------------------------------------------------
    def _batched_forcing(self, t_days: float):
        """Shared base forcing + per-member perturbations, leading axis n.

        Member 0 rides unperturbed; the perturbed members' AR(1) red-noise
        carry advances inside one vmapped device program."""
        base = self.sim.forcing_provider(t_days, self.sim.time_init)
        if self.n == 1:
            return jax.tree.map(lambda x: x[None], base)
        if self._ran is None:
            self.keys, subs = jax.vmap(jax.random.split, out_axes=1)(self.keys)
            self._ran = self._place(self._vdraw(subs))
        self.keys, self._ran, perturbed = self._vpert(self.keys, self._ran, base)
        if self.member_mesh is not None:
            # all n slots are perturbed (even leading axis); the control's
            # slot 0 is overwritten with the unperturbed base in place, so
            # the member axis stays block-sharded (no concatenate
            # reshuffle). One jitted program: an eager at[].set + pad +
            # device_put here would issue per-leaf host dispatches and a
            # cross-device reshard every step
            if not hasattr(self, "_fix0"):
                def fix0(b, p):
                    out = jax.tree.map(
                        lambda bb, pp: pp.at[0].set(bb), b, p
                    )
                    return self._constrain(out)

                self._fix0 = jax.jit(fix0)
            return self._fix0(base, perturbed)
        return jax.tree.map(
            lambda b, p: jnp.concatenate([b[None], p]), base, perturbed
        )

    # -- stepping ---------------------------------------------------------
    def step(self) -> None:
        from nextsim_tpu.utils import dates

        t_next = self.sim.time_init + (self.pcpt + 1) * self.sim.dt * dates.DAYS_IN_SEC
        forcing = self._batched_forcing(t_next)
        tinfo = self.sim.time_info_at(
            self.sim.time_init + self.pcpt * self.sim.dt * dates.DAYS_IN_SEC
        )
        self.states, _diag, _viol = self._vstep(self.states, forcing, tinfo)
        self.pcpt += 1
        if self.sim.moorings is not None:
            self._maybe_output_stats()

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step()

    # -- outputs ----------------------------------------------------------
    @property
    def current_time(self) -> float:
        from nextsim_tpu.utils import dates

        return self.sim.time_init + self.pcpt * self.sim.dt * dates.DAYS_IN_SEC

    def _stat_fields(self):
        """Per-variable ensemble mean and spread on the model grid, keyed
        ``<nc_name>_mean`` / ``<nc_name>_std`` — the ensemble-statistics
        observability channel (the reference runs full per-member jobs and
        computes statistics offline; scripts/ensemble/run_ensemble.sh)."""
        from nextsim_tpu.output.moorings import MOORING_VARIABLES, VECTOR_VARIABLES

        states = self._logical(self.states)
        out = {}

        def add(nc_name, a):
            out[nc_name + "_mean"] = jnp.mean(a, axis=0)
            out[nc_name + "_std"] = jnp.std(a, axis=0)

        for name in self.sim.moorings.names:
            if name in VECTOR_VARIABLES:
                (unm, *_, uf), (vnm, *_, vf) = VECTOR_VARIABLES[name]
                u, v = getattr(states, uf), getattr(states, vf)
                if not self.sim.moorings.false_easting:
                    # rotate each MEMBER to east/north before the statistics
                    # (rotation is linear so the mean commutes, but the
                    # component std does not — rotating stds would be
                    # wrong). _write_record's own rotation only matches the
                    # bare siu/siv keys, so *_mean/*_std must arrive
                    # already oriented; angle at the model nodes (the
                    # regular path rotates after remap at the output-grid
                    # longitude — difference is second order in the angle
                    # variation across a cell).
                    c, s = self._node_rot()
                    u, v = c * u - s * v, s * u + c * v
                add(unm, u)
                add(vnm, v)
                continue
            mv = MOORING_VARIABLES.get(name)
            if mv is None or mv.source != "state":
                continue  # diag/forcing channels are per-member quantities
            a = getattr(states, mv.field, None)
            if a is None:
                continue
            if mv.index is not None:
                a = a[:, mv.index]  # component axis sits after the member axis
            add(mv.nc_name, a)
        return out

    def _node_rot(self):
        """(cos, sin) of the east/north rotation angle at the model nodes
        (reference: rotateVectors' true-easting branch, rotation - lon;
        gridoutput.cpp:596-615)."""
        rot = getattr(self, "_node_rot_cache", None)
        if rot is None:
            _, node_lon = self.sim.grid.node_latlon()
            ang = np.deg2rad(self.sim.grid.projection.lon0) - np.deg2rad(
                np.asarray(node_lon)
            )
            rot = (jnp.asarray(np.cos(ang), self.sim.dtype),
                   jnp.asarray(np.sin(ang), self.sim.dtype))
            self._node_rot_cache = rot
        return rot

    def _maybe_output_stats(self) -> None:
        """Write an ensemble-statistics moorings record when the configured
        moorings window closes (snapshot statistics at the output instants;
        rides the same Moorings grid/remap/rollover/append machinery)."""
        moor = self.sim.moorings
        t = self.current_time
        if t - moor._last_output_time < moor.output_dt_days - 1e-9:
            return
        stats = self._stat_fields()
        if not stats:
            return
        moor._accum = stats
        moor._count = 1
        moor._last_output_time = t
        moor._write_record(t)

    def write_restart(self, name: str = "batched") -> str:
        """ONE sharded checkpoint of the whole ensemble via orbax (shared
        writer: output/restart.py:save_orbax_checkpoint — the member axis
        is just another sharded dim, every device writes its members'
        shards in parallel, no gather). The perturbation chain (keys +
        AR(1) carry) is saved too, so a resumed ensemble continues the
        exact same forcing-noise stream."""
        from nextsim_tpu.output.restart import save_orbax_checkpoint

        path = os.path.join(self.sim.cfg["output.exporter_path"], "restart")
        os.makedirs(path, exist_ok=True)
        arrays = {
            f"state_{f.name}": getattr(self.states, f.name)
            for f in dataclasses.fields(self.states)
            if getattr(self.states, f.name) is not None
        }
        arrays["keys"] = self.keys
        if self._ran is not None:
            arrays["ran"] = self._ran
        meta = {
            "pcpt": self.pcpt,
            "n_members": self.n,
            "time_init": self.sim.time_init,
        }
        return save_orbax_checkpoint(
            os.path.join(path, f"restart_{name}.orbax"), arrays, meta
        )

    def read_restart(self, name: str = "batched") -> None:
        """Restore a batched-ensemble checkpoint written by write_restart
        (topology-agnostic: numpy zero templates from the sidecar spec)."""
        from nextsim_tpu.output.restart import load_orbax_checkpoint

        path = os.path.join(self.sim.cfg["output.exporter_path"], "restart")
        fname = os.path.join(path, f"restart_{name}.orbax")
        data, sidecar = load_orbax_checkpoint(fname)
        if int(sidecar["n_members"]) != self.n:
            raise ValueError(
                f"checkpoint {fname} holds {sidecar['n_members']} members; "
                f"this ensemble was built with n_members={self.n}"
            )
        if abs(float(sidecar["time_init"]) - self.sim.time_init) > 1e-9:
            raise ValueError(
                f"checkpoint time_init {sidecar['time_init']} != configured "
                f"simul.time_init ({self.sim.time_init})"
            )
        kw = {}
        for f in dataclasses.fields(self.states):
            key = f"state_{f.name}"
            cur = getattr(self.states, f.name)
            if key in data:
                arr = jnp.asarray(data[key], cur.dtype if cur is not None else None)
                if cur is not None and arr.shape != cur.shape:
                    # a 3-D ('member','y','x') mesh end-pads node planes to
                    # shard-divisible shapes; a checkpoint written under one
                    # padding cannot be silently reinterpreted under another
                    raise ValueError(
                        f"checkpoint {fname} holds {key} with shape "
                        f"{arr.shape} but this ensemble's layout expects "
                        f"{cur.shape} — batched checkpoints written under a "
                        "3-D member mesh restore only into the same spatial "
                        "mesh shape (for topology changes use "
                        "export_member_restarts + per-member Simulators)"
                    )
                kw[f.name] = self._place(arr)
            else:
                kw[f.name] = None
        self.states = type(self.states)(**kw)
        # The key/carry arrays have a layout-dependent member-axis length:
        # n with a member mesh (slot 0 = discarded control placeholder),
        # n-1 without. Reconcile so a checkpoint crosses between a 1-D
        # member mesh and the unsharded batch (member m>=1 streams are
        # identical by construction; the slot-0 entries are regenerated /
        # dropped, never consumed).
        keys = jnp.asarray(data["keys"], jnp.uint32)
        ran = jnp.asarray(data["ran"]) if "ran" in data else None
        want = self.n if self.member_mesh is not None else self.n - 1
        if keys.shape[0] == want + 1:
            keys = keys[1:]
            ran = ran[1:] if ran is not None else None
        elif keys.shape[0] == want - 1:
            key0 = jax.random.PRNGKey(self._seed * 1000003)[None]
            keys = jnp.concatenate([key0, keys])
            if ran is not None:
                ran = jnp.concatenate([jnp.zeros_like(ran[:1]), ran])
        elif keys.shape[0] != want:
            raise ValueError(
                f"checkpoint {fname} carries {keys.shape[0]} member keys; "
                f"this layout expects {want}"
            )
        self.keys = self._place(keys)
        self._ran = self._place(ran) if ran is not None else None
        self.pcpt = int(sidecar["pcpt"])
        if self.sim.moorings is not None:
            # re-anchor the stats cadence on the absolute output grid, as
            # if the run had been unbroken — otherwise the first step after
            # a resume writes an off-cadence record (review r5)
            moor = self.sim.moorings
            w = moor.output_dt_days
            elapsed = self.current_time - self.sim.time_init
            moor._last_output_time = (
                self.sim.time_init + math.floor(elapsed / w + 1e-9) * w
            )

    def export_member_restarts(self, name: str = "final") -> list:
        """Per-member standard restarts: member k's state is written as
        ``mem_<k>/restart/restart_<name>.npz`` in the ensemble output tree,
        loadable by a plain Simulator (restart.start_from_restart=true) —
        so the per-process driver (ensemble/run_ensemble.py) can resume a
        forecast cycle that was advanced batched (the per-member outputs of
        the reference's scripts/ensemble/run_ensemble.sh)."""
        from nextsim_tpu.output.restart import restart_meta, save_npz_restart

        base = self.sim.cfg["output.exporter_path"]
        # the counters live on the ensemble, not the template Simulator
        meta = dict(
            restart_meta(self.sim),
            pcpt=self.pcpt, current_time=self.current_time,
        )
        written = []
        for k in range(self.n):
            st = self.member_state(k)
            arrays = {
                f.name: np.asarray(getattr(st, f.name))
                for f in dataclasses.fields(st)
                if getattr(st, f.name) is not None
            }
            path = os.path.join(base, f"mem_{k}", "restart")
            os.makedirs(path, exist_ok=True)
            written.append(save_npz_restart(
                os.path.join(path, f"restart_{name}.npz"), meta, arrays
            ))
        return written

    # -- analysis ---------------------------------------------------------
    def member_state(self, k: int):
        """Unstacked State of member k (0 = control), at logical shapes."""
        st = jax.tree.map(lambda x: x[k], self.states)
        return self._logical(st)

    def _logical(self, tree):
        """Crop boundary-padded node leaves (3-D member mesh) back to the
        logical staggered view; no-op otherwise."""
        if (
            self.member_mesh is not None
            and tuple(self.member_mesh.axis_names) == ("member", "y", "x")
        ):
            from nextsim_tpu.parallel.sharding import crop_node_leaves

            tree = crop_node_leaves(tree, *self.sim.grid.shape)
        return tree

    def spread(self, fields=("conc", "thick", "vt_u", "vt_v")) -> Dict[str, float]:
        """Domain-mean ensemble standard deviation per field (the usual
        spread diagnostic for perturbation sanity)."""
        out = {}
        states = self._logical(self.states)  # exclude boundary-pad lanes
        for name in fields:
            x = getattr(states, name)
            if x is None:
                continue
            out[name] = float(jnp.asarray(x, jnp.float32).std(axis=0).mean())
        return out

    def mean_state(self):
        """Ensemble-mean State (the EnKF forecast mean), at logical shapes."""
        return self._logical(jax.tree.map(
            lambda x: x.mean(axis=0).astype(x.dtype), self.states
        ))
