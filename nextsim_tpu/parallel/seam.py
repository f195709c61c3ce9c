"""Hand-scheduled multi-chip substep loop: shard_map over seam blocks.

The default multi-chip schedule (parallel/sharding.py) is GSPMD: XLA inserts
the halo collective-permutes for the stencils' shifted reads. This module is
the *explicit* schedule — the structured-grid equivalent of the reference's
per-substep MPI ghost exchange (FiniteElement::updateGhosts,
model/finiteelement.cpp:13963-14105, called from the momentum hot loop at
fe.cpp:10534): the substep loop runs inside `shard_map`, each device owns one
block, and explicit ppermute ring exchanges of the two velocity planes move
data — everything else is shard-local.

Layout. With a ('y','x') device mesh of shape (dpy, dpx), global cells
(ny, nx) (mesh-divisible; the Simulator enforces this) and halo depth H,
device (a, b) holds

* an *ext node block* of shape (By+2H+1, Bx+2H+1), By = ny//dpy: global node
  rows a*By-H .. a*By+By+H — H ring rows each side of the owned range
  a*By .. a*By+By. Seam rows (a*By) are OWNED BY BOTH adjacent devices and
  computed redundantly with bit-identical inputs, so no reconciliation is
  ever needed (the reference instead sums partial FE assemblies across the
  ghost ring; on a structured grid redundant compute is cheaper than the
  extra message).
* an *ext cell block* of shape (By+2H, Bx+2H): global cell rows a*By-H ..
  a*By+By+H-1. Ring cells are recomputed locally each substep from the
  exchanged velocity rings (their inputs equal the neighbour's interior
  inputs, so carried ring stress/damage stay consistent without ever being
  sent).

Communication-avoiding depth (tpu.halo_depth = H > 1): one ring exchange
refreshes H layers, after which H substeps run with ZERO communication — the
correct-data frontier erodes inward exactly one node+cell layer per substep
(strain consumes a node layer, the stress-divergence/solve consumes a cell
layer), so after H substeps the owned region is still exact and the next
exchange resets the frontier. Redundant compute grows as ~2H/B per axis;
messages shrink by H. The classic latency trade for when interconnect
round-trips dominate the per-substep critical path (the reference has no equivalent —
it pays one MPI exchange every substep, fe.cpp:10534).

Ring values beyond the global domain are zero-filled in the STATIC fields at
layout construction (conc=0, volume=0 there annihilate any wrapped velocity
garbage the periodic ppermute brings — same invariant as parallel/halo.py:
the outermost global cells are land), so no special-casing at mesh edges.

Equivalence with the GSPMD path and the single-device step is pinned by
tests/test_parallel.py for H=1 and H>1.

LAYOUT CONVERSION (round 5 — the round-4 cost note's fix, implemented).
The original conversions were global gathers (jnp.pad + fancy index): on a
sharded operand GSPMD lowers them as all-gather-shaped reshuffles, paid for
every const and carry plane every dynamics step. They are now shard-local
strip exchanges (`*_ring` functions below):

* CELL planes align exactly with their GSPMD shards (device a's (ny, nx)
  shard IS its seam-block interior), so global->ext is one H-row/col ring
  ppermute per plane and ext->global is a communication-free crop.
* NODE planes are misaligned by a cumulative one row/col per device (the
  end-padded shard-divisible layout holds By+1 rows per device while seam
  blocks overlap at a*By), so the conversion exchanges one strip of
  dpy-1+H rows with each neighbour and takes a device-dependent
  `dynamic_slice` — O((dpy+H)*nx) bytes per plane instead of O(ny*nx).
  Requires dpy-1+H <= By+1 per axis (checked; the gather path remains as
  the documented fallback and as the independent oracle for the
  equivalence tests in tests/test_parallel.py).

In the same spirit the open-water velocity smoother (reference:
fe.cpp:10576-10611, one updateGhosts per sweep) runs INSIDE the
hand-scheduled region (`dynamics_loop`), so the velocity carries stay in
the ext layout across the substeps AND the 50 smoother sweeps and cross
layouts exactly once per dynamics step; smoother exchanges are batched by
the same communication-avoiding halo depth H.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from nextsim_tpu.parallel.halo import _shift_from


# ---------------------------------------------------------------------------
# layout conversion (host-computed gather indices; traced once per jit)
# ---------------------------------------------------------------------------

def _ext_idx_cells(d: int, B: int, H: int) -> np.ndarray:
    """Row indices into the H-padded global cell array for the stacked ext
    cell blocks: block a covers global rows a*B-H .. a*B+B+H-1."""
    return np.concatenate([a * B + np.arange(B + 2 * H) for a in range(d)])


def _ext_idx_nodes(d: int, B: int, H: int) -> np.ndarray:
    """Row indices into the H-padded global node array for the stacked ext
    node blocks: block a covers global rows a*B-H .. a*B+B+H."""
    return np.concatenate([a * B + np.arange(B + 2 * H + 1) for a in range(d)])


def _own_idx_cells(d: int, B: int, H: int, n: int) -> np.ndarray:
    """Inverse: for each global cell row, its position in the stacked ext
    layout (owning block a = j//B, local offset +H for the ring)."""
    j = np.arange(n)
    a = j // B
    return a * (B + 2 * H) + (j - a * B) + H


def _own_idx_nodes(d: int, B: int, H: int, n: int) -> np.ndarray:
    """Inverse for node rows; the seam row a*B is read from the lower owner
    (both owners hold identical values by construction)."""
    r = np.arange(n)
    a = np.minimum(r // B, d - 1)
    return a * (B + 2 * H + 1) + (r - a * B) + H


def to_ext_cells(g, dpy: int, dpx: int, By: int, Bx: int, H: int = 1):
    """Global (ny, nx) cell plane -> stacked ext blocks
    (dpy*(By+2H), dpx*(Bx+2H)), out-of-domain ring zero-filled."""
    gp = jnp.pad(g, ((H, H), (H, H)))
    return gp[
        _ext_idx_cells(dpy, By, H)[:, None], _ext_idx_cells(dpx, Bx, H)[None, :]
    ]


def to_ext_nodes(g, dpy: int, dpx: int, By: int, Bx: int, H: int = 1):
    """Global (ny+1, nx+1) node plane -> stacked ext blocks
    (dpy*(By+2H+1), dpx*(Bx+2H+1)), out-of-domain ring zero-filled."""
    gp = jnp.pad(g, ((H, H), (H, H)))
    return gp[
        _ext_idx_nodes(dpy, By, H)[:, None], _ext_idx_nodes(dpx, Bx, H)[None, :]
    ]


def from_ext_cells(e, dpy, dpx, By, Bx, ny, nx, H: int = 1):
    return e[
        _own_idx_cells(dpy, By, H, ny)[:, None],
        _own_idx_cells(dpx, Bx, H, nx)[None, :],
    ]


def from_ext_nodes(e, dpy, dpx, By, Bx, ny, nx, H: int = 1):
    return e[
        _own_idx_nodes(dpy, By, H, ny + 1)[:, None],
        _own_idx_nodes(dpx, Bx, H, nx + 1)[None, :],
    ]


# ---------------------------------------------------------------------------
# ring exchange (inside shard_map)
# ---------------------------------------------------------------------------

def exchange_seam_ring(ext, B_y: int, B_x: int, H: int = 1, axes=("y", "x")):
    """Refresh the H-wide rings of a seam-overlapped ext node block.

    The seam row duplicates the neighbour's edge row, so the strips differ
    from parallel/halo.exchange_halo: the south ring (rows 0..H-1, global
    a*B-H..a*B-1) is the south neighbour's interior rows B-H..B-1 = its ext
    indices B..B+H-1; the north ring is the north neighbour's interior rows
    1..H = its ext indices H+1..2H. y before x so the x-pass payload carries
    refreshed y-rings and corners get the diagonal neighbour's value in two
    hops (reference updateGhosts moves the same velocity ghost ring,
    fe.cpp:13963-14105)."""
    y_axis, x_axis = axes
    from_south = _shift_from(ext[B_y : B_y + H, :], y_axis, reverse=False)
    from_north = _shift_from(ext[H + 1 : 2 * H + 1, :], y_axis, reverse=True)
    ext = ext.at[:H, :].set(from_south)
    ext = ext.at[-H:, :].set(from_north)
    from_west = _shift_from(ext[:, B_x : B_x + H], x_axis, reverse=False)
    from_east = _shift_from(ext[:, H + 1 : 2 * H + 1], x_axis, reverse=True)
    ext = ext.at[:, :H].set(from_west)
    ext = ext.at[:, -H:].set(from_east)
    return ext


def exchange_cell_ring(ext, B_y: int, B_x: int, H: int, axes=("y", "x")):
    """Refresh the H-wide rings of an ext CELL block (carried stress/damage).

    Needed only for halo_depth H>1: the vt exchange restores the velocity
    frontier, but a carried ring cell at depth k erodes after k substeps and
    is never recomputed correctly from local data — its value must come from
    the owner. Cell blocks are not seam-overlapped, so the strips differ
    from the node exchange: the south ring (global a*B-H..a*B-1) is the
    south neighbour's ext indices B..B+H-1; the north ring is the north
    neighbour's ext indices H..2H-1."""
    y_axis, x_axis = axes
    from_south = _shift_from(ext[B_y : B_y + H, :], y_axis, reverse=False)
    from_north = _shift_from(ext[H : 2 * H, :], y_axis, reverse=True)
    ext = ext.at[:H, :].set(from_south)
    ext = ext.at[-H:, :].set(from_north)
    from_west = _shift_from(ext[:, B_x : B_x + H], x_axis, reverse=False)
    from_east = _shift_from(ext[:, H : 2 * H], x_axis, reverse=True)
    ext = ext.at[:, :H].set(from_west)
    ext = ext.at[:, -H:].set(from_east)
    return ext


# ---------------------------------------------------------------------------
# shard-local layout conversion (strip exchanges; see module docstring).
# These run INSIDE shard_map: each takes/returns one device's local block.
# The gather-based to_ext_*/from_ext_* above remain the independent oracle
# (tests/test_parallel.py pins bitwise equality).
# ---------------------------------------------------------------------------


def ring_conversion_supported(dpy: int, dpx: int, By: int, Bx: int, H: int) -> bool:
    """The node strip exchange reaches at most one neighbour per side, which
    needs dp-1+H rows to fit in a neighbour's By+1-row shard."""
    return (dpy - 1 + H <= By + 1) and (dpx - 1 + H <= Bx + 1)


def _axis_zero_outside(block, first_global, n_valid, axis):
    """Zero block entries whose global index along `axis` falls outside
    [0, n_valid) — the out-of-domain ring zero-fill of the gather path."""
    n = block.shape[axis]
    ids = first_global + jnp.arange(n)
    ok = (ids >= 0) & (ids < n_valid)
    shape = [1] * block.ndim
    shape[axis] = n
    return block * ok.reshape(shape).astype(block.dtype)


def _local_cells_to_ext(L, a, b, B_y, B_x, ny, nx, H, axes=("y", "x")):
    """Local (By, Bx) cell shard -> (By+2H, Bx+2H) ext block: H-deep strips
    from each face neighbour (cell shards align exactly with seam blocks)."""
    y_axis, x_axis = axes
    prev = _shift_from(L[-H:, :], y_axis, reverse=False)
    nxt = _shift_from(L[:H, :], y_axis, reverse=True)
    L = jnp.concatenate([prev, L, nxt], axis=0)
    L = _axis_zero_outside(L, a * B_y - H, ny, 0)
    prev = _shift_from(L[:, -H:], x_axis, reverse=False)
    nxt = _shift_from(L[:, :H], x_axis, reverse=True)
    L = jnp.concatenate([prev, L, nxt], axis=1)
    return _axis_zero_outside(L, b * B_x - H, nx, 1)


def _local_ext_to_cells(E, H):
    """Inverse: crop the ring — zero communication."""
    return E[H:-H, H:-H]


def _local_nodes_to_ext(L, a, b, dpy, dpx, B_y, B_x, ny, nx, H,
                        axes=("y", "x")):
    """Local (By+1, Bx+1) END-PADDED node shard (padded row r = logical row
    r, device a holds rows a*(By+1)..a*(By+1)+By) -> seam ext block
    (By+2H+1, Bx+2H+1) covering logical rows a*By-H..a*By+By+H. The shard
    and seam layouts are misaligned by a cumulative row per device, so the
    strip is dp-1+H deep and the start is a device-dependent
    dynamic_slice."""
    y_axis, x_axis = axes

    def one_axis(L, pos, dp, B, n_nodes, axis):
        P = dp - 1 + H
        prev = _shift_from(lax.slice_in_dim(L, L.shape[axis] - P, L.shape[axis], axis=axis), y_axis if axis == 0 else x_axis, reverse=False)
        nxt = _shift_from(lax.slice_in_dim(L, 0, H, axis=axis), y_axis if axis == 0 else x_axis, reverse=True)
        cat = jnp.concatenate([prev, L, nxt], axis=axis)
        start = dp - 1 - pos
        out = lax.dynamic_slice_in_dim(cat, start, B + 2 * H + 1, axis=axis)
        return _axis_zero_outside(out, pos * B - H, n_nodes, axis)

    L = one_axis(L, a, dpy, B_y, ny + 1, 0)
    return one_axis(L, b, dpx, B_x, nx + 1, 1)


def _local_ext_to_nodes(E, a, b, dpy, dpx, B_y, B_x, ny, nx, H,
                        axes=("y", "x")):
    """Inverse: seam ext node block -> this device's END-PADDED (By+1, Bx+1)
    shard. Rows beyond the own ext range live at the next device's ext
    offset 2H+1 (duplicated rows are bit-identical, so either owner
    serves); padding rows (logical index > n) are zeroed to match
    pad_to_mesh."""
    y_axis, x_axis = axes

    def one_axis(E, pos, dp, B, n_nodes, axis):
        K = dp - 1
        nxt = _shift_from(
            lax.slice_in_dim(E, 2 * H + 1, 2 * H + 1 + K, axis=axis),
            y_axis if axis == 0 else x_axis, reverse=True,
        )
        cat = jnp.concatenate([E, nxt], axis=axis)
        out = lax.dynamic_slice_in_dim(cat, pos + H, B + 1, axis=axis)
        # own padded rows start at logical pos*(B+1); zero true padding
        return _axis_zero_outside(out, pos * (B + 1), n_nodes, axis)

    E = one_axis(E, a, dpy, B_y, ny + 1, 0)
    return one_axis(E, b, dpx, B_x, nx + 1, 1)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def substep_loop(mesh, p, dyn_type, dte, dt, dx, consts, carry, steps,
                 halo_depth: int = 1):
    """Run the momentum substep loop hand-scheduled over `mesh` with
    GATHER-based layout conversions — since round 5 this is the fallback
    (strip reach exceeded) and the independent oracle the layout-resident
    `dynamics_loop` is pinned against; production shard_map runs go through
    dynamics_loop.

    `consts` / `carry` are the global-layout planes from
    ops/momentum.explicit_solve (carry order: vt_u, vt_v, ut_u, ut_v, sxx,
    syy, sxy, damage — first four node planes, last four cell planes).
    Returns the carry in global layout. The physics body is the same
    _build_substep the GSPMD path runs — one source of truth.

    ``halo_depth`` = substeps per exchange (communication-avoiding; must
    divide `steps` and stay well under the block size)."""
    from jax import shard_map

    from nextsim_tpu.ops.momentum import _build_substep

    H = int(halo_depth)
    dpy, dpx = mesh.devices.shape
    ny, nx = consts.conc.shape[-2:]
    By, Bx = ny // dpy, nx // dpx
    if By * dpy != ny or Bx * dpx != nx:
        raise ValueError(
            f"grid {ny}x{nx} is not divisible by the ({dpy},{dpx}) device "
            "mesh (the Simulator pads to divisibility; direct callers must "
            "pass mesh-divisible planes)"
        )
    if H < 1:
        raise ValueError(f"tpu.halo_depth={H} must be >= 1")
    if steps % H:
        raise ValueError(
            f"tpu.halo_depth={H} must divide dynamics.substeps={steps}"
        )
    if H >= min(By, Bx):
        raise ValueError(
            f"tpu.halo_depth={H} must be < the per-device block "
            f"({By}x{Bx} cells on the ({dpy},{dpx}) mesh)"
        )

    node_shape = (ny + 1, nx + 1)

    def to_ext(v):
        if getattr(v, "ndim", 0) != 2:
            return v
        if v.shape == node_shape:
            return to_ext_nodes(v, dpy, dpx, By, Bx, H)
        return to_ext_cells(v, dpy, dpx, By, Bx, H)

    cdict = {k: v for k, v in vars(consts).items() if v is not None}
    none_keys = [k for k, v in vars(consts).items() if v is None]
    ext_consts = {k: to_ext(v) for k, v in cdict.items()}
    ext_carry = tuple(to_ext(v) for v in carry)

    def spec_of(v):
        return P("y", "x") if getattr(v, "ndim", 0) == 2 else P()

    in_specs = (
        tuple(spec_of(v) for v in ext_carry),
        {k: spec_of(v) for k, v in ext_consts.items()},
    )
    out_specs = tuple(spec_of(v) for v in ext_carry)

    def run(carry_l, consts_l):
        cl = SimpleNamespace(**consts_l, **{k: None for k in none_keys})
        body = _build_substep(p, dyn_type, dte, dt, dx, cl)

        def group(_, cr):
            vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage = cr
            vt_u = exchange_seam_ring(vt_u, By, Bx, H)
            vt_v = exchange_seam_ring(vt_v, By, Bx, H)
            if H > 1:
                # carried ring stress/damage at depth k erode after k
                # substeps; restore them from their owners each group (for
                # H=1 they stay exact by induction — skip the messages)
                sxx = exchange_cell_ring(sxx, By, Bx, H)
                syy = exchange_cell_ring(syy, By, Bx, H)
                sxy = exchange_cell_ring(sxy, By, Bx, H)
                damage = exchange_cell_ring(damage, By, Bx, H)
            cr = (vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage)
            # H communication-free substeps per exchange (compile-time
            # unrolled; the correct-data frontier erodes one layer each)
            for _ in range(H):
                cr = body(cr)
            return cr

        unroll = max(1, p.substep_unroll // H)
        return lax.fori_loop(0, steps // H, group, carry_l, unroll=unroll)

    out = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs)(
        ext_carry, ext_consts
    )

    def from_ext(v, is_node):
        if is_node:
            return from_ext_nodes(v, dpy, dpx, By, Bx, ny, nx, H)
        return from_ext_cells(v, dpy, dpx, By, Bx, ny, nx, H)

    return tuple(from_ext(v, i < 4) for i, v in enumerate(out))


def dynamics_loop(mesh, p, dyn_type, dte, dt, dx, consts, carry, steps,
                  halo_depth: int = 1, smoother=None):
    """The layout-resident hand-scheduled dynamics step: ONE shard_map
    region that converts every plane global->ext with shard-local strip
    exchanges, runs the substep loop (ring exchange every H substeps), runs
    the open-water velocity smoother on the resident ext carries (reference
    fe.cpp:10576-10611 with its per-sweep updateGhosts, batched by the same
    H), and converts back once. Replaces substep_loop + a GSPMD-scheduled
    smoother on the shard_map path; substep_loop (gather conversions)
    remains the equivalence oracle.

    ``smoother``: optional (ow_mask, nbr_rden, nit_ow) node planes + sweep
    count. Returns the carry tuple in global layout (same contract as
    substep_loop).
    """
    from jax import shard_map

    from nextsim_tpu.ops.momentum import _build_substep

    H = int(halo_depth)
    dpy, dpx = mesh.devices.shape
    ny, nx = consts.conc.shape[-2:]
    By, Bx = ny // dpy, nx // dpx
    if By * dpy != ny or Bx * dpx != nx:
        raise ValueError(
            f"grid {ny}x{nx} is not divisible by the ({dpy},{dpx}) device mesh"
        )
    if H < 1:
        raise ValueError(f"tpu.halo_depth={H} must be >= 1")
    if steps % H:
        raise ValueError(f"tpu.halo_depth={H} must divide dynamics.substeps={steps}")
    if H >= min(By, Bx):
        raise ValueError(
            f"tpu.halo_depth={H} must be < the per-device block "
            f"({By}x{Bx} cells on the ({dpy},{dpx}) mesh)"
        )
    if not ring_conversion_supported(dpy, dpx, By, Bx, H):
        # strip exchange cannot reach past one neighbour: fall back to the
        # gather-based loop (correct, just not layout-resident); the caller
        # must run the smoother itself (flag False)
        carry = substep_loop(
            mesh, p, dyn_type, dte, dt, dx, consts, carry, steps,
            halo_depth=H,
        )
        return carry, False

    from nextsim_tpu.parallel.sharding import pad_to_mesh

    node_shape = (ny + 1, nx + 1)
    pad_node = lambda v: pad_to_mesh(v, mesh)  # noqa: E731 — logical -> shard-divisible

    cdict = {k: v for k, v in vars(consts).items() if v is not None}
    none_keys = [k for k, v in vars(consts).items() if v is None]
    is_node = {
        k: getattr(v, "ndim", 0) == 2 and v.shape == node_shape
        for k, v in cdict.items()
    }
    cin = {
        k: (pad_node(v) if is_node[k] else v) for k, v in cdict.items()
    }
    carry_in = tuple(
        pad_node(v) if i < 4 else v for i, v in enumerate(carry)
    )
    if smoother is not None:
        ow_mask, nbr_rden, nit_ow = smoother
        cin["__ow"] = pad_node(ow_mask.astype(carry[0].dtype))
        cin["__rden"] = pad_node(nbr_rden)
        is_node["__ow"] = is_node["__rden"] = True

    def spec_of(v):
        return P("y", "x") if getattr(v, "ndim", 0) == 2 else P()

    in_specs = (
        tuple(spec_of(v) for v in carry_in),
        {k: spec_of(v) for k, v in cin.items()},
    )
    out_specs = tuple(spec_of(v) for v in carry_in)

    def run(carry_l, consts_l):
        a = lax.axis_index("y")
        b = lax.axis_index("x")

        def to_ext_local(v, node):
            if getattr(v, "ndim", 0) != 2:
                return v
            if node:
                return _local_nodes_to_ext(v, a, b, dpy, dpx, By, Bx, ny, nx, H)
            return _local_cells_to_ext(v, a, b, By, Bx, ny, nx, H)

        ext_c = {
            k: to_ext_local(v, is_node.get(k, False))
            for k, v in consts_l.items()
        }
        ow = ext_c.pop("__ow", None)
        rden = ext_c.pop("__rden", None)
        cl = SimpleNamespace(**ext_c, **{k: None for k in none_keys})
        cr = tuple(
            to_ext_local(v, i < 4) for i, v in enumerate(carry_l)
        )
        body = _build_substep(p, dyn_type, dte, dt, dx, cl)

        def group(_, cr):
            vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage = cr
            vt_u = exchange_seam_ring(vt_u, By, Bx, H)
            vt_v = exchange_seam_ring(vt_v, By, Bx, H)
            if H > 1:
                sxx = exchange_cell_ring(sxx, By, Bx, H)
                syy = exchange_cell_ring(syy, By, Bx, H)
                sxy = exchange_cell_ring(sxy, By, Bx, H)
                damage = exchange_cell_ring(damage, By, Bx, H)
            cr = (vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage)
            for _ in range(H):
                cr = body(cr)
            return cr

        unroll = max(1, p.substep_unroll // H)
        cr = lax.fori_loop(0, steps // H, group, cr, unroll=unroll)

        if dyn_type == "mevp" and ow is not None:
            # mEVP accumulates displacement from the PRE-smoother velocity
            # (reference: mesh move at fe.cpp:10563-10567 happens before the
            # OW smoother); done here so the caller's accumulation is not
            # re-applied on the smoothed field
            cr = (
                cr[0], cr[1],
                cr[2] + dt * cr[0], cr[3] + dt * cr[1],
            ) + cr[4:]

        if ow is not None:
            vt_u, vt_v = cr[0], cr[1]
            ow_b = ow > 0.5

            def sweep(uv):
                u, v = uv
                up = jnp.pad(u, 1)
                vp = jnp.pad(v, 1)
                u_bar = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]) * rden
                v_bar = (vp[:-2, 1:-1] + vp[2:, 1:-1] + vp[1:-1, :-2] + vp[1:-1, 2:]) * rden
                return (jnp.where(ow_b, u_bar, u), jnp.where(ow_b, v_bar, v))

            def smooth_group(_, uv):
                u, v = uv
                u = exchange_seam_ring(u, By, Bx, H)
                v = exchange_seam_ring(v, By, Bx, H)
                uv = (u, v)
                for _ in range(H):
                    uv = sweep(uv)
                return uv

            n_groups, tail = divmod(int(nit_ow), H)
            uv = lax.fori_loop(0, n_groups, smooth_group, (vt_u, vt_v))
            if tail:
                u, v = uv
                u = exchange_seam_ring(u, By, Bx, H)
                v = exchange_seam_ring(v, By, Bx, H)
                uv = (u, v)
                for _ in range(tail):
                    uv = sweep(uv)
            cr = (uv[0], uv[1]) + cr[2:]

        # refresh the node rings before converting out: _local_ext_to_nodes
        # reads up to H own-ring rows for the shard/seam misalignment, and
        # those are stale after the last exchange-free substep/sweep group
        # (the gather oracle reads owners' interiors and never sees this)
        cr = tuple(
            exchange_seam_ring(v, By, Bx, H) if i < 4 else v
            for i, v in enumerate(cr)
        )

        def from_ext_local(v, node):
            if node:
                return _local_ext_to_nodes(
                    v, a, b, dpy, dpx, By, Bx, ny, nx, H
                )
            return _local_ext_to_cells(v, H)

        return tuple(from_ext_local(v, i < 4) for i, v in enumerate(cr))

    out = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs)(
        carry_in, cin
    )
    crop = lambda v: v[: ny + 1, : nx + 1]  # noqa: E731 — shard-local slice
    return (
        tuple(crop(v) if i < 4 else v for i, v in enumerate(out)),
        smoother is not None,
    )
