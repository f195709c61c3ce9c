"""The Simulator: init → step loop → outputs.

The counterpart of FiniteElement::run/init/step (reference:
model/finiteelement.cpp:8450-8509, 6970-7088, 7963-8289). One jit-compiled
`step_fn` advances the full model state one time step on device:

    thermo (pointwise)  →  dynamics (momentum substeps)  →
    transport (advection + ridging redistribution)       →  diagnostics

The host loop handles forcing reloads, output scheduling, invariant checks
and checkpointing — none of which sit on the device critical path.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nextsim_tpu.config import Config
from nextsim_tpu.core import constants as phys
from nextsim_tpu.core.state import State
from nextsim_tpu.forcing.providers import make_provider
from nextsim_tpu.grid.grid import Grid
from nextsim_tpu.model import checks, init_state, params
from nextsim_tpu.ops import momentum
from nextsim_tpu.utils import dates
from nextsim_tpu.utils.logging import get_logger
from nextsim_tpu.utils.timer import Timer

# jax.monitoring duration event recorded at the end of Simulator.run: the
# stepping loop's wall time from the end of its first device call (which
# carries the compile) to the last step, outputs included; `steps` is the
# number of model steps it covers
STEADY_LOOP_EVENT = "/nextsim_tpu/run/steady_loop_duration"

class Simulator:
    def __init__(self, cfg: Config, grid: Optional[Grid] = None, mesh=None):
        self.cfg = cfg
        self.log = get_logger(cfg["debugging.log-level"], cfg["debugging.log-all"])
        self.timer = Timer()
        self.grid = grid if grid is not None else Grid.from_config(cfg)

        # tpu.mesh_shape = "DPYxDPX" builds the device mesh from config so a
        # plain CLI run engages multi-chip (the analog of the reference's
        # mpirun -np N; model/run.sh:55). An explicit `mesh` argument wins.
        if mesh is None:
            ms = str(cfg["tpu.mesh_shape"]).lower().strip()
            if ms and ms not in ("1x1", ""):
                from nextsim_tpu.parallel.sharding import make_device_mesh

                dpy, dpx = (int(v) for v in ms.split("x"))
                if dpy * dpx > 1:
                    import jax as _jax

                    devs = _jax.devices()
                    if dpy * dpx > len(devs):
                        raise ValueError(
                            f"tpu.mesh_shape={ms} needs {dpy * dpx} devices; "
                            f"only {len(devs)} visible"
                        )
                    mesh = make_device_mesh((dpy, dpx), devs[: dpy * dpx])

        dtype_name = cfg["tpu.dtype"]
        self.dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype_name]

        # --- time bookkeeping (host) -------------------------------------
        self.dt = float(cfg["simul.timestep"])  # seconds
        time_init_str = cfg["simul.time_init"]
        self.time_init = (
            dates.string_to_datenum(time_init_str) if time_init_str else 0.0
        )
        self.duration_days = cfg["simul.duration"]
        self.maxiteration = cfg["debugging.maxiteration"]
        self.pcpt = 0  # step counter (reference pcpt)

        # --- parameters ---------------------------------------------------
        self.dyn = params.dyn_params(cfg, self.grid.dx)
        self.c_fix, self.c_alea = params.cohesion_params(cfg, self.grid.dx)
        self.use_young = cfg["thermo.newice_type"] == 4
        self.use_thermo = cfg["thermo.use_thermo_forcing"]
        self.thermo_type = cfg["setup.thermo-type"]
        self.check_fast = cfg["debugging.check_fields_fast"]

        # --- static grid arrays on device ---------------------------------
        node_lat, _ = self.grid.node_latlon()
        self.grid_arrays: Dict[str, jnp.ndarray] = {
            "mask": jnp.asarray(self.grid.mask, self.dtype),
            "open_mask": jnp.asarray(self.grid.open_mask, self.dtype),
            "node_mask": jnp.asarray(self.grid.node_mask, self.dtype),
            "node_dirichlet": jnp.asarray(self.grid.node_dirichlet, self.dtype),
            "node_lat": jnp.asarray(node_lat, self.dtype),
            "delta_x": self.grid.dx,
        }

        # --- state + forcing ----------------------------------------------
        self.state = init_state.init_state(cfg, self.grid, dtype=self.dtype)

        # FSD (reference: initFsd fe.cpp:7399-7585; OASIS-gated there,
        # enabled here whenever wave_coupling.num_fsd_bins > 0)
        self.fsd_params = None
        self.fsd_bins = None
        if cfg["wave_coupling.num_fsd_bins"] > 0:
            from nextsim_tpu.ops import fsd as fsd_ops

            self.fsd_params = fsd_ops.FSDParams.from_config(cfg)
            self.fsd_bins = fsd_ops.make_bins(self.fsd_params)
            ctot0 = self.state.conc + self.state.conc_young
            cf = fsd_ops.init_fsd(self.fsd_params, ctot0)
            self.state = self.state.replace(
                conc_fsd=cf,
                # distinct buffer: aliasing would break argument donation
                conc_mech_fsd=(cf + 0.0) if self.fsd_params.distinguish_mech_fsd else None,
            )
        self.forcing_provider = make_provider(cfg, self.grid, self.dtype)
        # ensemble member > 0: perturbed forcing (reference: #ifdef ENSEMBLE,
        # externaldata.cpp:244-278; modules/enkf/perturbation)
        self._ens_pert = None  # device-resident perturbation (chunked path)
        self._pert_state = None
        if cfg["statevector.ensemble_member"] > 0:
            from nextsim_tpu.ensemble import EnsembleForcing

            self.forcing_provider = EnsembleForcing(
                self.forcing_provider, self.grid, cfg
            )
            self._ens_pert = self.forcing_provider

        # sharding (multi-chip): annotate the state with a 2-D mesh layout.
        # Node-staggered (ny+1, nx+1) leaves are end-padded to shard-divisible
        # shapes so EVERY leaf crossing the jit boundary is genuinely sharded
        # (no replication fallback); cell dims must divide the mesh.
        self.device_mesh = mesh
        if mesh is not None:
            from nextsim_tpu.parallel.sharding import shard_state_and_grid

            dpy, dpx = mesh.devices.shape
            ny, nx = self.grid.shape
            if ny % dpy or nx % dpx:
                raise ValueError(
                    f"grid {ny}x{nx} does not divide the ({dpy},{dpx}) device "
                    f"mesh: choose grid.ny divisible by {dpy} and grid.nx "
                    f"divisible by {dpx} (silent replication is not supported)"
                )
            self.state, self.grid_arrays = shard_state_and_grid(
                self.state, self.grid_arrays, mesh
            )

        self._step_fn = self._build_step_fn()
        self._chunk_k = max(1, cfg["tpu.steps_per_call"])
        self._chunk_fn = None  # built lazily (needs moorings constructed)

        # --- output subsystems (reference: initMoorings fe.cpp:9037;
        # instantiateDrifters fe.cpp:13565; checkOutputs fe.cpp:8316) ------
        self.moorings = None
        if cfg["moorings.use_moorings"]:
            from nextsim_tpu.output.moorings import Moorings

            self.moorings = Moorings(cfg, self.grid, self.time_init)
        from nextsim_tpu.output.drifters import instantiate_drifters
        from nextsim_tpu.parallel.multihost import gather_to_host

        self.drifters = instantiate_drifters(
            cfg, self.grid, gather_to_host(self.state.conc), self.time_init
        )
        self._drifter_last_move = self.time_init
        self._drifter_ut_prev = None
        # coupling exchange (reference: initOASIS fe.cpp:7585-7860)
        self.coupler = None
        if cfg["setup.ocean-type"] == "coupled" or cfg["coupler.with_waves"]:
            from nextsim_tpu.coupling import Coupler

            self.coupler = Coupler(cfg, self.grid, self.time_init)

        # waves-in-ice module (reference: modules/wim; nextwim.* options in
        # options_wim.cpp). coupling-option=break_on_mesh/run_on_mesh run
        # co-located on the model grid; =naive runs the WIM on its own grid
        # (wimgrid.*) with a mask-aware regrid each exchange (reference
        # gridinfo.cpp mesh<->grid interpolation).
        self.wim = None
        self._wim_regrid = None
        if cfg["nextwim.use_wim"]:
            from nextsim_tpu.wim import Wim, WimParams

            wim_grid = self.grid
            if cfg["nextwim.coupling-option"] == "naive":
                from nextsim_tpu.wim.regrid import Regridder, make_wim_grid

                wim_grid = make_wim_grid(cfg, self.grid)
                self._wim_regrid = Regridder(self.grid, wim_grid, self.dtype)
            # co-located WIM rides the model's device mesh (own-grid shapes
            # that don't divide it fall back to unsharded inside Wim)
            self.wim = Wim(
                WimParams.from_config(cfg), wim_grid, self.dtype,
                mesh=self.device_mesh,
            )
            self.wim_couplingfreq = max(1, cfg["nextwim.couplingfreq"])
            self._wim_stress = None
            self._wim_wlbk = None
            self._wim_nfloes = None

        # nesting sponge (reference: forcingNesting fe.cpp:11060-11130)
        self.nesting = None
        if cfg["nesting.use_nesting"]:
            from nextsim_tpu.model.nesting_source import make_nesting_source
            from nextsim_tpu.ops.nesting import (
                NestingParams,
                distance_to_open_boundary,
                nudge_weight,
            )

            npar = NestingParams.from_config(cfg)
            dist = distance_to_open_boundary(self.grid)
            # host constant: closed over by the step jit (multi-process jits
            # may not close over device arrays; GSPMD shards constants)
            weight = np.asarray(
                nudge_weight(dist, npar, self.dt), np.dtype(self.dtype)
            )
            source = make_nesting_source(cfg, self.grid)
            self.nesting = (npar, weight, source)

        opd = cfg["output.output_per_day"]
        if opd > 0:
            self.export_interval_steps = max(1, int(round(phys.days_in_sec / opd / self.dt)))
        elif opd < 0:
            self.export_interval_steps = 1
        else:
            self.export_interval_steps = 0
        self._last_export_pcpt = 0
        self._last_restart_pcpt = 0
        if cfg["restart.write_interval_restart"]:
            iv = cfg["restart.output_interval"]
            if cfg["restart.output_interval_units"] == "time_steps":
                self.restart_interval_steps = max(1, int(iv))
            else:
                self.restart_interval_steps = max(1, int(round(iv * phys.days_in_sec / self.dt)))
        else:
            self.restart_interval_steps = 0

        if cfg["restart.start_from_restart"]:
            from nextsim_tpu.output.restart import read_restart

            read_restart(self)
            # interval anchors restart from the resumed step counter
            self._last_export_pcpt = self.pcpt
            self._last_restart_pcpt = self.pcpt
            if cfg["restart.check_restart"]:
                # audit the restarted fields (reference: M_check_restart ->
                # checkFields at init, fe.cpp:7065-7070)
                self._check_fields_detailed()
            # DataAssimilation at restart (reference: init() fe.cpp:7055-7058
            # -> DataAssimilation fe.cpp:509-525: slab ocean then ice, then
            # consistency check)
            if cfg["setup.use_assimilation"]:
                self.data_assimilation()
        if cfg["restart.write_initial_restart"]:
            from nextsim_tpu.output.restart import write_restart

            write_restart(self, name="initial")

    # ------------------------------------------------------------------
    def _crop(self, tree):
        """Logical view of a boundary-padded pytree (no-op without a mesh).
        Works inside jit (shard-local slice) and on host (output paths)."""
        if self.device_mesh is None:
            return tree
        from nextsim_tpu.parallel.sharding import crop_node_leaves

        ny, nx = self.grid.shape
        return crop_node_leaves(tree, ny, nx)

    def _pad(self, tree):
        """Pad logical node leaves back to the sharded boundary layout and
        (inside jit) pin the block sharding on every leaf so nothing —
        including broadcast-constant diagnostics — leaves replicated."""
        if self.device_mesh is None:
            return tree
        from nextsim_tpu.parallel.sharding import constrain_tree, pad_node_leaves

        ny, nx = self.grid.shape
        tree = pad_node_leaves(tree, ny, nx, self.device_mesh)
        return constrain_tree(tree, self.device_mesh)

    def host_state(self) -> State:
        """The GLOBAL state at logical shapes as host numpy, for host
        consumers (IO, drifters, checks). Under multi-process execution the
        sharded leaves are collectively all-gathered (the reference gathers
        to rank 0 for IO, fe.cpp:2901-3557); single-process it is a plain
        device->host copy, bit-identical to the device values. COLLECTIVE
        when jax.process_count() > 1 — every process must call it."""
        from nextsim_tpu.parallel.multihost import gather_to_host

        return gather_to_host(self._crop(self.state))

    def _shard_forcing(self, forcing):
        """Place a fresh forcing bundle on the device mesh, node planes
        padded — each device receives only its shard (no replication)."""
        if self.device_mesh is None:
            return forcing
        from nextsim_tpu.parallel.sharding import shard_tree

        return shard_tree(forcing, self.device_mesh)

    # ------------------------------------------------------------------
    def _build_step_fn(self) -> Callable:
        cfg = self.cfg
        dyn = self.dyn
        dt = self.dt
        grid_arrays = dict(self.grid_arrays)
        c_fix, c_alea = self.c_fix, self.c_alea
        use_thermo = self.use_thermo
        dynamics_type = dyn.dynamics_type
        crop, pad = self._crop, self._pad
        # tpu.partition_mode=shard_map: hand-scheduled substep loop with one
        # explicit ppermute ring exchange per substep (parallel/seam.py) —
        # the analog of the reference's per-substep updateGhosts
        # (fe.cpp:10534). Default gspmd lets XLA schedule the halos.
        partition_mode = cfg["tpu.partition_mode"]
        halo_depth = cfg["tpu.halo_depth"]
        mesh = self.device_mesh
        if partition_mode == "shard_map" and mesh is None:
            raise ValueError(
                "tpu.partition_mode=shard_map needs a device mesh: set "
                "tpu.mesh_shape (e.g. 2x4) or pass mesh= to Simulator"
            )
        if partition_mode != "shard_map" and halo_depth != 1:
            raise ValueError(
                f"tpu.halo_depth={halo_depth} only affects the hand-scheduled "
                "schedule; set tpu.partition_mode=shard_map (gspmd lets XLA "
                "place the halo collectives and ignores halo_depth)"
            )

        def step_fn(state: State, forcing, tinfo, nest=None) -> State:
            # boundary-padded (sharded) -> logical staggered view; the crop
            # is shard-local by construction (see parallel/sharding.py)
            state = crop(state)
            forcing = crop(forcing)
            # cohesion field for this step (reference: calcCohesion,
            # fe.cpp:3909-3914)
            ga = dict(grid_arrays)
            ga["cohesion"] = c_fix + c_alea * state.random_number

            diag = {}

            # ---- thermodynamics (reference: fe.cpp:8140 → thermo()) -----
            if use_thermo:
                from nextsim_tpu.ops import thermo as thermo_ops

                state, tdiag = thermo_ops.thermo_step(
                    state, forcing, ga, dt, cfg_params=self._thermo_params,
                    tinfo=tinfo, fsd_params=self.fsd_params,
                    fsd_bins=self.fsd_bins,
                )
                diag.update(tdiag)

            # ---- FSD: welding on freezing + rescale to new conc; breakup
            # under waves (reference: weldingRoach in thermo fe.cpp:5782-5797;
            # redistributeFSD at coupling steps; updateFSD from step())
            if self.fsd_params is not None:
                from nextsim_tpu.ops import fsd as fsd_ops

                fp, fb = self.fsd_params, self.fsd_bins
                ctot = state.conc + state.conc_young
                cf = fsd_ops.update_fsd(state.conc_fsd, ctot)
                if use_thermo and fp.welding_type == "roach":
                    freezing = diag.get("del_hi", jnp.zeros_like(ctot)) > 0.0
                    cf = fsd_ops.welding_roach(cf, dt, fp, fb, freezing)
                    cf = fsd_ops.update_fsd(cf, ctot)
                damage = state.damage
                if forcing.wlbk is not None:
                    cf, broke = fsd_ops.wave_breakup(
                        cf, state.thick, state.conc, state.h_young,
                        state.conc_young, forcing.wlbk, dt, fp, fb,
                    )
                    damage = fsd_ops.fsd_damage(cf, damage, fp, broke)
                mech = state.conc_mech_fsd
                if mech is not None:
                    mech = fsd_ops.update_fsd(mech, ctot)
                    if forcing.wlbk is not None:
                        # after breakup both coincide (fe.cpp:4424); distinct
                        # buffer to keep donation legal next step
                        mech = cf + 0.0
                state = state.replace(conc_fsd=cf, conc_mech_fsd=mech, damage=damage)
                # floe-size diagnostics for moorings (reference dmax/dmean
                # GridOutput variables, gridoutput.hpp:219-220)
                diag["dmax"], diag["dmean"] = fsd_ops.dmax_dmean(cf, fp, fb)

            # ---- dynamics (reference: fe.cpp:8197-8221) ------------------
            if dynamics_type in ("bbm", "evp", "mevp"):
                state, mdiag = momentum.explicit_solve(
                    state, forcing, ga, dt, dyn,
                    mesh=mesh, partition_mode=partition_mode,
                    halo_depth=halo_depth,
                )
                diag.update(mdiag)
            elif dynamics_type == "free_drift":
                state = momentum.free_drift(state, forcing, ga, dt, dyn)
            elif dynamics_type == "no_motion":
                pass

            # ---- transport + ridging (Eulerian replacement of the
            # Lagrangian mesh-motion + update(), reference fe.cpp:8221,3919)
            if dynamics_type != "no_motion":
                from nextsim_tpu.ops import transport

                state, vdiag = transport.transport_and_ridge(
                    state, ga, dt, self._transport_params
                )
                diag.update(vdiag)

            # ---- nesting sponge: relax toward the outer run, inside the
            # device program so chunked stepping carries it (reference:
            # nestingIce/nestingDynamics each step, fe.cpp:8172-8192).
            # nest = (outer_fields, on_scalar); on=0 turns the relaxation
            # off for steps with no outer data without changing the program.
            if nest is not None and self.nesting is not None:
                from nextsim_tpu.ops.nesting import apply_nesting

                npar_, weight_, _src = self.nesting
                outer_f, on = nest
                # node planes arrive boundary-padded (sharded layout)
                state = apply_nesting(state, crop(outer_f), weight_ * on, npar_)

            viol = checks.violations(state, use_young_ice=dyn.use_young_ice)
            # logical -> boundary-padded so every output leaf is sharded
            return pad(state), pad(diag), viol

        self.raw_step_fn = step_fn
        return jax.jit(step_fn, donate_argnums=(0,) if cfg["tpu.donate_state"] else ())

    # ------------------------------------------------------------------
    def _build_chunk_fn(self, k: int):
        """Fuse k model steps into one device program (tpu.steps_per_call).

        A `lax.scan` over the raw step removes per-call dispatch latency.
        Moorings accumulation moves inside the scan (running sums carried),
        so nothing per-step leaks back to the host; violations are maxed
        over the chunk (same semantics as tpu.check_interval batching).
        Forcing and the thermo date flags are threaded per step: the chunk
        takes the first step's bundle plus a leading-(k-1)-stacked tail the
        scan consumes as xs — chunked execution is exact under time-varying
        forcing (same per-step reloads as the reference's checkReloadDatetime
        cadence, fe.cpp:8130-8138).
        """
        raw = self.raw_step_fn
        moorings = self.moorings
        coupler = self.coupler
        crop = self._crop

        def extract(state, diag):
            out = {}
            if moorings is not None or coupler is not None:
                state, diag = crop(state), crop(diag)
            if moorings is not None:
                for name in moorings.names:
                    d = moorings._extract(name, state, diag)
                    if d:
                        out.update(d)
            if coupler is not None:
                # coupler running means ride the scan exactly like moorings
                # (reference: updateMeans for M_cpl_out then put at the
                # coupler cadence, fe.cpp:8226-8265)
                from nextsim_tpu.coupling.exchange import SENT_FIELDS

                for name, (src, field) in SENT_FIELDS.items():
                    arr = (
                        getattr(state, field, None)
                        if src == "state" else diag.get(field)
                    )
                    if arr is not None:
                        out["__cpl_" + name] = arr
            return out

        pert = self._ens_pert

        def chunk_fn(state, forcing0, forcings_rest, tinfo0, tinfos_rest,
                     nest0=None, nests_rest=None):
            state, diag, viol = raw(state, forcing0, tinfo0, nest0)
            acc = extract(state, diag)

            def body(carry, xs):
                forcing, tinfo, nest = xs
                st, vmax, a, _dg = carry
                st, dg, vl = raw(st, forcing, tinfo, nest)
                ex = extract(st, dg)
                a = {kk: a[kk] + ex[kk] for kk in a}
                # diag rides the carry (only the last step's survives) —
                # returning it as a scan output would materialise K copies
                return (st, jnp.maximum(vmax, vl), a, dg), None

            (state, viol, acc, diag), _ = jax.lax.scan(
                body, (state, viol, acc, diag),
                (forcings_rest, tinfos_rest, nests_rest),
            )
            last_extract = extract(state, diag)  # snapshot-mode moorings
            return state, diag, viol, acc, last_extract

        def chunk_fn_pert(state, forcing0, forcings_rest, tinfo0, tinfos_rest,
                          pert_state, nest0=None, nests_rest=None):
            """Perturbed variant: the AR(1) forcing perturbation advances
            inside the program (one chain update + application per step, in
            step order), so perturbed runs cost zero extra host dispatches."""
            pert_state, f0 = pert.apply(pert_state, forcing0)
            state, diag, viol = raw(state, f0, tinfo0, nest0)
            acc = extract(state, diag)

            def body(carry, xs):
                forcing, tinfo, nest = xs
                st, vmax, a, _dg, ps, _lf = carry
                ps, fp = pert.apply(ps, forcing)
                st, dg, vl = raw(st, fp, tinfo, nest)
                ex = extract(st, dg)
                a = {kk: a[kk] + ex[kk] for kk in a}
                return (st, jnp.maximum(vmax, vl), a, dg, ps, fp), None

            (state, viol, acc, diag, pert_state, last_f), _ = jax.lax.scan(
                body, (state, viol, acc, diag, pert_state, f0),
                (forcings_rest, tinfos_rest, nests_rest),
            )
            last_extract = extract(state, diag)
            if self.device_mesh is not None:
                from nextsim_tpu.parallel.sharding import constrain_tree

                pert_state = constrain_tree(pert_state, self.device_mesh)
                last_f = constrain_tree(last_f, self.device_mesh)
            return state, diag, viol, acc, last_extract, pert_state, last_f

        return jax.jit(
            chunk_fn if pert is None else chunk_fn_pert,
            donate_argnums=(0,) if self.cfg["tpu.donate_state"] else (),
        )

    def step_chunk(self) -> None:
        """Advance tpu.steps_per_call steps in one device call."""
        k = self._chunk_k
        self.timer.tick("step")
        self.timer.tick("forcing")
        dt_days = self.dt * dates.DAYS_IN_SEC
        t0 = self.current_time
        # perturbed runs: base (unperturbed) forcing on host, AR(1) noise
        # advanced and applied INSIDE the chunk program — zero per-step host
        # dispatches (the reference perturbs on rank 0 at forcing load,
        # externaldata.cpp:244-278; here the whole chain rides the scan)
        pert = self._ens_pert
        provider = pert.provider if pert is not None else self.forcing_provider
        forcings = [
            provider(t0 + (i + 1) * dt_days, self.time_init)
            for i in range(k)
        ]
        if self.wim is not None:
            if self._wim_due():
                self._wim_exchange(forcings[0])
            forcings = [self._apply_wim_forcing(f) for f in forcings]
        if self.coupler is not None:
            # fields received at the last window close override the whole
            # chunk's forcing (k divides the coupler window — enforced in
            # run() — so receives only ever change at chunk boundaries)
            forcings = [self.coupler.apply_received(f) for f in forcings]
        nest0 = nests_rest = None
        if self.nesting is not None:
            _, _, source = self.nesting
            outers = [
                source.fields_at(t0 + (i + 1) * dt_days) for i in range(k)
            ]
            if self.cfg["nesting.use_ocean_nesting"]:
                # outer SST/SSS become the slab nudging targets per step
                # (reference: forcingOcean ocean-nesting, fe.cpp:11133-11143)
                for i, o in enumerate(outers):
                    if o and "sst" in o and "sss" in o:
                        forcings[i] = forcings[i].replace(
                            ocean_temp=o["sst"], ocean_salt=o["sss"]
                        )
            for o in outers:  # prime/extend the key template over the WHOLE
                if o:         # chunk so every bundle shares one structure
                    self._nest_bundle(o)
            bundles = [self._nest_bundle(o) for o in outers]
            if bundles[0] is not None:
                nest0 = bundles[0]
                nests_rest = jax.tree.map(
                    lambda *xs: jnp.stack(xs), *bundles[1:]
                )
            self._nesting_outer = outers[-1] or None
        if self.device_mesh is not None:
            forcings = [self._shard_forcing(f) for f in forcings]
            if nest0 is not None:
                from nextsim_tpu.parallel.sharding import shard_tree

                nest0 = shard_tree(nest0, self.device_mesh)
                nests_rest = shard_tree(nests_rest, self.device_mesh)
        tinfos = [self.time_info_at(t0 + i * dt_days) for i in range(k)]
        # stack the tail along a leading axis for the scan's xs (None leaves
        # are skipped by tree.map; the leaf structure is static per provider).
        # The stacked tree is cached on the identity of every input leaf:
        # with constant/static forcing the providers hand back the same
        # device arrays each chunk, and re-stacking them would cost ~30
        # device dispatches per chunk.
        leaf_ids = tuple(
            id(leaf) for f in forcings[1:] for leaf in jax.tree_util.tree_leaves(f)
        )
        cache = getattr(self, "_stack_cache", None)
        if cache is not None and cache[0] == leaf_ids:
            forcings_rest = cache[1]
        else:
            forcings_rest = jax.tree.map(lambda *xs: jnp.stack(xs), *forcings[1:])
            # keep the source bundles alive so no id can be recycled
            self._stack_cache = (leaf_ids, forcings_rest, list(forcings[1:]))
        tinfos_rest = jax.tree.map(lambda *xs: jnp.stack(xs), *tinfos[1:])
        self.timer.tock("forcing")

        self.timer.tick("device_step")
        if self._chunk_fn is None:
            self._chunk_fn = self._build_chunk_fn(k)
        if pert is not None:
            if self._pert_state is None:
                ps = pert.init_state()
                if self.device_mesh is not None:
                    from nextsim_tpu.parallel.sharding import shard_tree

                    ps = shard_tree(ps, self.device_mesh)
                self._pert_state = ps
            (self.state, self.diag, viol, acc, last_ex,
             self._pert_state, last_f) = self._chunk_fn(
                self.state, forcings[0], forcings_rest, tinfos[0], tinfos_rest,
                self._pert_state, nest0, nests_rest,
            )
            self.last_forcing = last_f
        else:
            self.state, self.diag, viol, acc, last_ex = self._chunk_fn(
                self.state, forcings[0], forcings_rest, tinfos[0], tinfos_rest,
                nest0, nests_rest,
            )
            self.last_forcing = forcings[-1]
        self.timer.tock("device_step")
        self.pcpt += k

        if self.coupler is not None:
            # in-scan coupler sums -> host running means; put/get when the
            # window closes (k divides it; reference: fe.cpp:8226-8265)
            from nextsim_tpu.parallel.multihost import gather_to_host

            cpl = gather_to_host(
                {kk[6:]: v for kk, v in acc.items() if kk.startswith("__cpl_")}
            )
            acc = {
                kk: v for kk, v in acc.items() if not kk.startswith("__cpl_")
            }
            last_ex = {
                kk: v for kk, v in last_ex.items()
                if not kk.startswith("__cpl_")
            }
            self.coupler.add_sums(cpl, k)
            self.coupler.maybe_exchange(self.current_time)  # pcpt already += k

        if self.moorings is not None and acc:
            if self.moorings.snapshot:
                self.moorings._accum = dict(last_ex)
                self.moorings._count = 1
            else:
                for kk, v in acc.items():
                    self.moorings._accum[kk] = self.moorings._accum.get(kk, 0.0) + v
                self.moorings._count += k

        self.timer.tick("outputs")
        self._check_outputs(skip_moorings_means=True)
        self.timer.tock("outputs")

        if self.check_fast:
            prev = getattr(self, "_pending_viol", None)
            self._pending_viol = viol if prev is None else jnp.maximum(prev, viol)
            interval = max(self.cfg["tpu.check_interval"], k)
            # boundary-crossing (pcpt strides by k and k need not divide the
            # interval); finalise() flushes the final partial window
            if self.pcpt - getattr(self, "_last_check_pcpt", 0) >= interval:
                self._last_check_pcpt = self.pcpt
                self._flush_pending_viol()
        if self.cfg["debugging.check_fields"]:
            self._check_fields_detailed()
        self.timer.tock("step")

    def _flush_pending_viol(self) -> None:
        """Read the accumulated device-side violation bitmask and crash-dump
        on any hit (reference: checkFieldsFast throw, fe.cpp:14647-14654)."""
        pv = getattr(self, "_pending_viol", None)
        if pv is None:
            return
        self._pending_viol = None
        flags = np.asarray(pv)
        if flags.any():
            self._crash_dump(checks.describe(flags, self.dyn.use_young_ice))

    # lazily-built parameter bundles for thermo/transport (set in phase 3/4)
    @functools.cached_property
    def _thermo_params(self):
        from nextsim_tpu.model.params_thermo import thermo_params

        return thermo_params(self.cfg)

    @functools.cached_property
    def _transport_params(self):
        from nextsim_tpu.ops.transport import TransportParams

        return TransportParams.from_config(self.cfg)

    # ------------------------------------------------------------------
    @property
    def current_time(self) -> float:
        """Model time in days since 1900-01-01 (reference M_current_time)."""
        return self.time_init + self.pcpt * self.dt * dates.DAYS_IN_SEC

    def time_info(self):
        """Per-step scalar time flags for the thermo tracers (reference:
        fe.cpp:5655-5660 step_in_day; 5999, 6061, 6050 date checks)."""
        return self.time_info_at(self.current_time)

    def time_info_at(self, t: float):
        """time_info evaluated at an arbitrary model time (chunked stepping
        threads one per fused step through the scan)."""
        num_steps_in_day = max(1, round(phys.days_in_sec / self.dt))
        step_in_day = 1 + round(num_steps_in_day * (t % 1.0))
        md = dates.datenum_to_string(t, "%m%d")
        midnight = abs(t % 1.0) < 1e-9
        reset_md = self.cfg["age.reset_date"]
        mk = lambda b: jnp.asarray(1.0 if b else 0.0, self.dtype)
        return {
            "is_day_start": mk(step_in_day == 1),
            "is_day_end": mk(step_in_day == num_steps_in_day),
            "is_0915": mk(md == "0915" and midnight),
            "is_0801": mk(md == "0801" and midnight),
            "is_myi_reset_date": mk(md == reset_md and midnight),
        }

    def _wim_due(self) -> bool:
        """WIM coupling cadence, shared by the per-step and fused-chunk
        paths (reference: exact-step WIM coupling, nextwim.couplingfreq;
        modules/wim/src/wimdiscr.cpp:822-1210). Boundary-crossing on pcpt:
        with the run() clamp forcing k to divide couplingfreq this fires at
        exactly steps 0, f, 2f, ... on both paths; a direct step_chunk
        caller with a non-dividing k still never exchanges MORE often than
        configured (the old modulo-of-quotients test aliased
        couplingfreq=10, k=4 to every 8 steps). A fresh/restarted
        simulator anchors on the absolute 0, f, 2f grid — a resume at a
        non-multiple pcpt (restart intervals need not align) waits for the
        next multiple exactly like the unbroken run, so restart
        continuation stays deterministic."""
        f = self.wim_couplingfreq
        last = getattr(self, "_wim_last_pcpt", None)
        if last is None:
            last = ((self.pcpt - 1) // f) * f if self.pcpt > 0 else -f
        if self.pcpt - last >= f:
            self._wim_last_pcpt = self.pcpt
            return True
        self._wim_last_pcpt = last
        return False

    def _wim_exchange(self, forcing=None) -> None:
        """Run the WIM over the next coupling window and harvest wave stress
        + floe breakage (reference WAVES coupling: nextwim.coupling-option
        break_on_mesh — breaking applied directly to the sea-ice state;
        collapsed onto one grid here since the model grid is structured)."""
        import jax.numpy as jnp

        from nextsim_tpu.ops.stencil import cells_to_node_sum

        cfg = self.cfg
        p = self.wim.p
        rg = self._wim_regrid
        conc = self.state.conc + self.state.conc_young
        vol = self.state.thick + self.state.h_young  # effective thickness = volume
        if rg is not None:
            # WIM on its own grid: ice fields over, stress/breakage back
            # (reference gridinfo.cpp mesh<->grid interpolation)
            conc, vol = rg.to_wim(conc), rg.to_wim(vol)
        if self._wim_nfloes is None:
            # unbroken pack on first call (dfloepackinit, iceinfo.hpp:61)
            self._wim_nfloes = jnp.where(
                conc >= p.cice_min, conc / p.dfloe_pack_init**2, 0.0
            )
        self.wim.set_ice_fields(conc, vol, self._wim_nfloes)
        # incident waves: from the wave forcing dataset when present
        # (wimsetup.wave-type=ww3a/eraiw_1deg), else the configured constant
        # sea state over open water (wave-type=set_in_wim)
        if forcing is not None and getattr(forcing, "swh", None) is not None:
            if rg is not None:
                self.wim.set_wave_fields(
                    rg.to_wim(forcing.swh), rg.to_wim(forcing.mwp),
                    rg.to_wim(forcing.mwd),
                )
            else:
                self.wim.set_wave_fields(forcing.swh, forcing.mwp, forcing.mwd)
        else:
            ones = jnp.ones_like(conc)
            self.wim.set_wave_fields(
                ones * p.hs_inc, ones * p.tp_inc, ones * p.mwd_inc
            )
        diag = self.wim.run(self.wim_couplingfreq * self.dt)
        self._wim_nfloes = self.wim.ice["nfloes"]
        broken = self.wim.ice["broken"]
        dfloe = self.wim.ice["dfloe"]
        tau_x, tau_y = diag["tau_x"], diag["tau_y"]
        if rg is not None:
            tau_x, tau_y = rg.to_model(tau_x), rg.to_model(tau_y)
            broken = rg.to_model(broken)
            # blend the broken-zone floe size only where breakage reached the
            # model grid, so pack-size bleed from bilinear edges can't dilute
            # the breaking wavelength below
            dfloe = jnp.where(broken > 0.0, rg.to_model(dfloe), p.dfloe_pack_init)

        if cfg["nextwim.applywavestress"]:
            # cell stress -> node average for the momentum solver
            ones_m = jnp.ones(self.grid.shape, self.dtype)
            cnt = jnp.maximum(cells_to_node_sum(ones_m), 1.0)
            self._wim_stress = (
                cells_to_node_sum(tau_x) / cnt,
                cells_to_node_sum(tau_y) / cnt,
            )
        if self.fsd_params is not None:
            # feed breakage into the FSD pipeline through the wlbk entry
            # point (same one the WW3-coupled wave field uses). wlbk is a
            # breaking WAVELENGTH in metres with >=499 meaning "no breaking
            # waves" (fsd.wave_breakup); WIM breaking sets dfloe = lam/2, so
            # the wavelength over the broken zone is 2*dfloe.
            self._wim_wlbk = jnp.where(broken > 0.0, 2.0 * dfloe, 500.0)
        elif cfg["nextwim.wim_damage_mesh"]:
            # no FSD: raise damage directly where floes broke
            # (nextwim.wim_damage_value, options_wim.cpp)
            dmg = jnp.maximum(
                self.state.damage, broken * cfg["nextwim.wim_damage_value"]
            )
            self.state = self.state.replace(damage=dmg)
        self.wim_diag = diag

    def _apply_wim_forcing(self, forcing):
        """Overlay the last WIM exchange (wave stress, FSD breaking
        wavelength) onto the forcing bundle; each is independent of the
        other (applywavestress may be off while FSD breakup is on)."""
        import dataclasses as _dc

        repl = {}
        if self._wim_stress is not None:
            repl["tau_wi_u"] = self._wim_stress[0]
            repl["tau_wi_v"] = self._wim_stress[1]
        if self._wim_wlbk is not None:
            repl["wlbk"] = self._wim_wlbk
        return _dc.replace(forcing, **repl) if repl else forcing

    def _nest_bundle(self, outer):
        """(outer_fields, on) with a stable pytree structure for the
        in-program nesting relaxation. Steps with no outer data get the
        zero template with on=0 (a no-op relax) so chunked scans see one
        structure; None is returned only before any outer data exists.
        A record carrying NEW fields extends the template (one recompile
        at that boundary); a record missing templated fields turns the
        whole step off (a partial bundle would wrongly relax the missing
        fields toward zero) with a one-time warning."""
        keys = getattr(self, "_nest_keys", None)
        if outer:
            if keys is None or any(kk not in keys for kk in outer):
                if keys is not None:
                    self.log.info(
                        "nesting: outer data gained fields "
                        f"{sorted(set(outer) - set(keys))}; extending the "
                        "relaxation template (recompile)"
                    )
                self._nest_keys = keys = tuple(
                    sorted(set(outer) | set(keys or ()))
                )
                zeros = getattr(self, "_nest_zeros", {})
                self._nest_zeros = {
                    kk: zeros.get(kk, jnp.zeros_like(jnp.asarray(outer[kk])))
                    for kk in keys
                }
            if any(kk not in outer for kk in keys):
                if not getattr(self, "_nest_partial_warned", False):
                    self._nest_partial_warned = True
                    self.log.info(
                        "nesting: outer record missing fields "
                        f"{sorted(set(keys) - set(outer))}; relaxation "
                        "skipped for such steps"
                    )
                return (self._nest_zeros, jnp.asarray(0.0, self.dtype))
            return (
                {kk: outer[kk] for kk in keys}, jnp.asarray(1.0, self.dtype)
            )
        if keys is not None:
            return (self._nest_zeros, jnp.asarray(0.0, self.dtype))
        return None

    def step(self) -> None:
        self.timer.tick("step")
        self.timer.tick("forcing")
        forcing = self.forcing_provider(self.current_time + self.dt * dates.DAYS_IN_SEC, self.time_init)
        if self.coupler is not None:
            forcing = self.coupler.apply_received(forcing)
        self._nesting_outer = None
        if self.nesting is not None:
            _, _, source = self.nesting
            self._nesting_outer = source.fields_at(
                self.current_time + self.dt * dates.DAYS_IN_SEC
            )
            if self.cfg["nesting.use_ocean_nesting"] and self._nesting_outer:
                # outer-run SST/SSS become the slab-ocean nudging targets
                # (reference: forcingOcean ocean-nesting branch,
                # fe.cpp:11133-11143)
                o = self._nesting_outer
                if "sst" in o and "sss" in o:
                    forcing = forcing.replace(ocean_temp=o["sst"], ocean_salt=o["sss"])
        if self.wim is not None and self._wim_due():
            self.timer.tick("wim")
            self._wim_exchange(forcing)
            self.timer.tock("wim")
        if self.wim is not None:
            forcing = self._apply_wim_forcing(forcing)
        forcing = self._shard_forcing(forcing)
        tinfo = self.time_info()
        nest = None
        if self.nesting is not None:
            nest = self._nest_bundle(self._nesting_outer)
            if nest is not None and self.device_mesh is not None:
                from nextsim_tpu.parallel.sharding import shard_tree

                nest = shard_tree(nest, self.device_mesh)
        self.timer.tock("forcing")

        self.timer.tick("device_step")
        self.state, self.diag, viol = self._step_fn(
            self.state, forcing, tinfo, nest
        )
        self.timer.tock("device_step")
        self.last_forcing = forcing  # for output.save_forcing_fields
        if self.wim is not None:
            # WIM diagnostics for moorings (held constant between couplings)
            if self._wim_stress is not None:
                self.diag.setdefault("tauwix", self._wim_stress[0])
                self.diag.setdefault("tauwiy", self._wim_stress[1])
            if self.fsd_params is None and self.wim.ice is not None:
                dfloe = self.wim.ice["dfloe"]
                if self._wim_regrid is not None:
                    dfloe = self._wim_regrid.to_model(dfloe)
                self.diag.setdefault("dmax", dfloe)

        self.pcpt += 1

        if self.coupler is not None:
            # (reference: OASIS put block, fe.cpp:8226-8265)
            from nextsim_tpu.parallel.multihost import gather_to_host

            self.coupler.accumulate(
                self.host_state(), gather_to_host(self._crop(self.diag))
            )
            self.coupler.maybe_exchange(self.current_time)

        self.timer.tick("outputs")
        self._check_outputs()
        self.timer.tock("outputs")

        if self.check_fast:
            self.timer.tick("checks")
            # device-side check runs every step; the host readback (a sync)
            # is batched by tpu.check_interval, accumulating the window's
            # violations on device so nothing is missed
            import jax.numpy as jnp

            prev = getattr(self, "_pending_viol", None)
            self._pending_viol = viol if prev is None else jnp.maximum(prev, viol)
            interval = self.cfg["tpu.check_interval"]
            # boundary-crossing, not modulo: chunked pcpt strides can step
            # over a multiple of the interval; finalise() flushes the tail
            if interval <= 1 or self.pcpt - getattr(self, "_last_check_pcpt", 0) >= interval:
                self._last_check_pcpt = self.pcpt
                self._flush_pending_viol()
            self.timer.tock("checks")
        if self.cfg["debugging.check_velocity_fields"]:
            n_rogue, max_rel = checks.check_velocity_fields(
                self.host_state(), self.grid_arrays["node_mask"]
            )
            if int(n_rogue) > 0:
                self.log.debug(
                    f"Rogue velocity step={self.pcpt}: {int(n_rogue)} nodes, "
                    f"max rel_error={float(max_rel):.2f}"
                )
        if self.cfg["debugging.check_fields"]:
            self._check_fields_detailed()
        self.timer.tock("step")

    def _check_fields_detailed(self) -> None:
        """Slow per-element audit behind debugging.check_fields (reference:
        checkFields, fe.cpp:14661-14860), incl. the targeted single-cell
        printout behind debugging.test_element_number."""
        from nextsim_tpu.parallel.multihost import gather_to_host

        hstate = self.host_state()
        lf = gather_to_host(self._crop(getattr(self, "last_forcing", None)))
        itest = self.cfg["debugging.test_element_number"]
        if itest >= 0:
            j, i = divmod(int(itest), self.grid.nx)
            self.log.debug(checks.detailed_report(hstate, j, i, lf))
        msgs = checks.check_fields(hstate, lf, self.dyn.use_young_ice)
        if msgs:
            self._crash_dump(msgs)

    def data_assimilation(self) -> None:
        """Full restart-time data assimilation (reference: DataAssimilation,
        fe.cpp:509-525): assimilateSlabOcean then assimilateIce (the OSISAF/
        AMSR2/NIC blends, fe.cpp:12124-12404), then checkConsistency."""
        from nextsim_tpu.model.init_ice_datasets import (
            assimilate_ice,
            assimilate_slab_ocean,
        )

        if self.device_mesh is not None:
            # the blend kernels are host-numpy: gather the sharded state to
            # the logical global view first, re-shard after (reference: the
            # assimilation paths run on gathered fields too)
            self.state = self.host_state()
        mask = np.asarray(self.grid.mask, dtype=np.dtype(self.dtype))
        forcing = self.forcing_provider(self.current_time, self.time_init)
        mu = self.cfg["thermo.freezingpoint_mu"]
        fp = lambda sss: -mu * sss  # noqa: E731  (linear freezing point)
        self.state = assimilate_slab_ocean(
            self.cfg, self.state, forcing.ocean_temp, forcing.ocean_salt, fp
        )
        self.state = assimilate_ice(
            self.cfg, self.grid, self.state, mask, self.time_init,
        )
        self.state = init_state.check_consistency(self.cfg, self.state, mask)
        if self.device_mesh is not None:
            from nextsim_tpu.parallel.sharding import shard_tree

            self.state = shard_tree(self.state, self.device_mesh)

    def assimilate(self, obs_conc) -> None:
        """Assimilate an observed concentration analysis into the state
        (reference: DataAssimilation/assimilateIce, fe.cpp:509-525,
        11634-11662): replace conc, track conc_upd, re-check consistency."""
        from nextsim_tpu.model.init_ice_datasets import assimilate_conc

        if self.device_mesh is not None:
            self.state = self.host_state()  # see data_assimilation
        mask = np.asarray(self.grid.mask, dtype=np.dtype(self.dtype))
        self.state = assimilate_conc(
            self.state, obs_conc, mask,
            min_h=self.cfg["dynamics.min_h"],
        )
        self.state = init_state.check_consistency(self.cfg, self.state, mask)
        if self.device_mesh is not None:
            from nextsim_tpu.parallel.sharding import shard_tree

            self.state = shard_tree(self.state, self.device_mesh)

    def _check_outputs(self, skip_moorings_means: bool = False) -> None:
        """Per-step output handling (reference: checkOutputs, fe.cpp:
        8316-8450: moorings means/append, drifters move/IO, snapshots,
        interval restarts)."""
        t = self.current_time
        if self.moorings is not None:
            if not skip_moorings_means:
                # accumulate on DEVICE (sharded-safe eager ops); the one
                # host gather happens at write time (_write_record) — a
                # host_state() here would transfer the full state per step
                self.moorings.update_means(
                    self._crop(self.state), self._crop(self.diag),
                    self._crop(getattr(self, "last_forcing", None)),
                )
            self.moorings.maybe_output(self)
        if self.drifters:
            # move drifters with the accumulated displacement (UT) at the
            # finest drifter cadence — one host sync per update, as in the
            # reference (buoys ride M_UT between outputs)
            cadence = min(d.output_dt_days for d in self.drifters)
            cadence = max(cadence, self.dt * dates.DAYS_IN_SEC)
            if t - self._drifter_last_move >= cadence - 1e-9:
                # gather ONLY the three planes drifters need (displacement +
                # conc), not the whole state
                from nextsim_tpu.parallel.multihost import gather_to_host

                cs = self._crop(self.state)
                ut_u, ut_v, conc = gather_to_host(
                    (cs.ut_u, cs.ut_v, cs.conc)
                )
                if self._drifter_ut_prev is None:
                    self._drifter_ut_prev = (np.zeros_like(ut_u), np.zeros_like(ut_v))
                du = ut_u - self._drifter_ut_prev[0]
                dv = ut_v - self._drifter_ut_prev[1]
                self._drifter_ut_prev = (ut_u, ut_v)
                self._drifter_last_move = t
                for d in self.drifters:
                    if t < getattr(d, "active_from", 0.0) - 1e-9:
                        continue  # fixed-init drifters (RGPS/SIDFEx) wait
                    if d.maybe_reseed(t, conc):
                        continue  # fresh 48 h window: seeded at t, no move
                    d.move_by_displacement(du, dv)
                    if hasattr(d, "update_transient"):
                        d.update_transient(t, conc)
                    d.mask_by_conc(conc)
                    d.maybe_output(t)
        # interval checks by boundary-crossing, not modulo: with fused
        # stepping (tpu.steps_per_call=k) pcpt advances k at a time, and a
        # modulo test silently skips intervals k doesn't divide; this fires
        # at the first step/chunk boundary at or past each due point
        if (
            self.export_interval_steps
            and self.pcpt - self._last_export_pcpt >= self.export_interval_steps
        ):
            from nextsim_tpu.output.exporter import export_snapshot

            self._last_export_pcpt = self.pcpt
            export_snapshot(self)
        if (
            self.restart_interval_steps
            and self.pcpt - self._last_restart_pcpt >= self.restart_interval_steps
        ):
            from nextsim_tpu.output.restart import write_restart

            self._last_restart_pcpt = self.pcpt
            write_restart(self)

    def finalise(self) -> None:
        """End-of-run outputs (reference: fe.cpp:8497-8508 + finalise)."""
        # violations accumulated since the last batched readback must be
        # checked BEFORE the final artifacts are written — otherwise a NaN
        # tail window would persist a corrupt "final" restart with exit 0
        if self.check_fast:
            self._flush_pending_viol()
        cfg = self.cfg
        if cfg["output.export_fields"] and self.export_interval_steps:
            from nextsim_tpu.output.exporter import export_snapshot

            export_snapshot(self, name="final")
        if cfg["restart.write_final_restart"]:
            from nextsim_tpu.output.restart import write_restart

            write_restart(self, name="final")
        import os

        from nextsim_tpu.parallel.multihost import is_writer

        for d in self.drifters:
            # drifter state is identical on every process (moved from the
            # gathered displacement); process 0 writes the trajectory file
            if d.records and is_writer():
                d.write_netcdf(
                    os.path.join(cfg["output.exporter_path"], f"Drifters_{d.tag}.nc")
                )
        # every asynchronously-submitted snapshot/restart must be on disk
        # (and any worker IO error surfaced) before the run is declared done
        from nextsim_tpu.utils import async_writer

        async_writer.flush()
        self.log.info("\n" + self.timer.print_all())

    def _crash_dump(self, msgs: List[str]) -> None:
        """Export a crash snapshot then raise (reference: fe.cpp:14647-14654)."""
        try:
            from nextsim_tpu.output.exporter import export_snapshot

            export_snapshot(self, name="crash")
            from nextsim_tpu.utils import async_writer

            async_writer.flush()  # the dump must land before the raise kills us
        except Exception as e:  # noqa: BLE001 - best-effort crash dump
            self.log.error(f"crash export failed: {e}")
        stats = checks.field_stats(self.host_state())
        raise RuntimeError("; ".join(msgs) + f"; field stats: {stats}")

    def run(self, callbacks: Optional[List[Callable]] = None) -> State:
        """Main loop (reference: FiniteElement::run, fe.cpp:8450-8509)."""
        n_steps = int(self.duration_days * phys.days_in_sec / self.dt)
        if self.maxiteration > 0:
            n_steps = min(n_steps, self.maxiteration)
        k = self._chunk_k
        if k > 1:
            # Joint clamp: every exact-cadence event fires at chunk
            # boundaries, so k must DIVIDE each cadence in steps — a k that
            # merely stays under a cadence still stretches it (cadence 3
            # with k=2 samples every 4 steps; ADVICE r4). One gcd collects
            # them all: the coupler put window (reference: coupler.timestep,
            # fe.cpp:8226-8265), the finest drifter move/record cadence
            # (checkMoveDrifters timing, fe.cpp:8375-8403), the WIM coupling
            # frequency (nextwim.couplingfreq; wimdiscr.cpp:822-1210), the
            # moorings output window and the snapshot interval (exact output
            # cadences, gridoutput.cpp + fe.cpp:8316-8450). Interval
            # restarts stay boundary-crossing (operational checkpoints, not
            # timestamped scientific records — a late restart is still an
            # exact state).
            import math as _math

            step_days = self.dt * dates.DAYS_IN_SEC
            cadences = {}
            if self.coupler is not None:
                cadences["coupler window"] = max(
                    1, round(self.coupler.dt_cpl / self.dt)
                )
            if self.drifters:
                cad_days = min(d.output_dt_days for d in self.drifters)
                cadences["finest drifter cadence"] = max(
                    1, round(cad_days / step_days)
                )
            if self.wim is not None:
                cadences["WIM coupling frequency"] = self.wim_couplingfreq
            if self.moorings is not None:
                cadences["moorings output window"] = max(
                    1, round(self.moorings.output_dt_days / step_days)
                )
            if self.export_interval_steps:
                cadences["snapshot interval"] = self.export_interval_steps
            if cadences:
                g = 0
                for v in cadences.values():
                    g = _math.gcd(g, v)
                k_new = min(k, g)
                while g % k_new:
                    k_new -= 1
                if k_new != k:
                    detail = ", ".join(
                        f"{name}={v} steps" for name, v in cadences.items()
                    )
                    self.log.info(
                        f"tpu.steps_per_call clamped {k}->{k_new}: k must "
                        f"divide every exact cadence ({detail})"
                    )
                    k = self._chunk_k = k_new
                    self._chunk_fn = None
        self.log.info(f"run: {n_steps} steps of {self.dt}s" + (f" ({k}/call)" if k > 1 else ""))
        ptime = max(1, n_steps * self.cfg["debugging.ptime_percent"] // 100)
        profile_dir = self.cfg["debugging.profile_dir"]
        if profile_dir:
            # xprof trace of the whole main loop (device + host timelines) —
            # the analog of the reference's gperftools hook (run.sh:64-78)
            jax.profiler.start_trace(profile_dir)
        try:
            i = 0
            steady = None  # (time, step) at the end of the first call
            while i < n_steps:
                if k > 1 and i + k <= n_steps:
                    self.step_chunk()
                    i += k
                else:
                    self.step()
                    i += 1
                if steady is None:
                    jax.block_until_ready(self.state)
                    steady = (time.perf_counter(), i)
                if callbacks:
                    for cb in callbacks:
                        cb(self)
                if i % ptime < (k if k > 1 else 1) and i >= ptime:
                    self.log.info(
                        f"---------------------- TIME STEP {self.pcpt} : "
                        f"{dates.datenum_to_string(self.current_time)} "
                        f"({100*i//n_steps}%)"
                    )
            jax.block_until_ready(self.state)
            if steady is not None and i > steady[1]:
                jax.monitoring.record_event_duration_secs(
                    STEADY_LOOP_EVENT, time.perf_counter() - steady[0],
                    steps=i - steady[1],
                )
        finally:
            if profile_dir:
                jax.profiler.stop_trace()
        self.finalise()
        return self.state
