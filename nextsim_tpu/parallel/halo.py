"""Explicit halo exchange for shard_map kernels.

The GSPMD path (parallel/sharding.py) lets XLA insert halo collectives for
the shifted stencil reads automatically — that is the default production
path. This module provides the *explicit* primitives for hand-scheduled
shard_map kernels; the full hand-scheduled momentum substep loop built on
the same ppermute transport lives in parallel/seam.py and is selectable via
tpu.partition_mode=shard_map; XLA hands the ppermutes to NCCL.

It is the structured-grid equivalent of the reference's updateGhosts
point-to-point exchange that runs every dynamics substep (reference:
FiniteElement::updateGhosts / initUpdateGhosts, model/finiteelement.cpp:
13963-14105).

Convention: the device mesh axes are ('y', 'x'); each local block is
extended by `halo` rows/cols on each side. `exchange_halo` refreshes those
rings from the face neighbors. Mesh-edge halos receive wrapped (periodic)
data, which is safe under the same convention as the single-device code:
the outermost global cells are land/masked, so wrapped values are never
read with nonzero weight.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _shift_from(x, axis_name: str, reverse: bool):
    """Value of x from the previous (reverse=False) or next (True) device
    along `axis_name` (periodic)."""
    n = lax.axis_size(axis_name)
    if reverse:
        perm = [(i, (i - 1) % n) for i in range(n)]
    else:
        perm = [(i, (i + 1) % n) for i in range(n)]
    return lax.ppermute(x, axis_name, perm)


def exchange_halo(local: jnp.ndarray, halo: int = 1, axes=("y", "x")) -> jnp.ndarray:
    """Refresh the halo rings of a halo-extended local block.

    ``local`` has shape (ny_loc + 2*halo, nx_loc + 2*halo); its interior is
    authoritative, its rings are overwritten from the neighbors' interiors.
    """
    h = halo
    y_axis, x_axis = axes

    # --- y direction: send interior edge strips -------------------------
    south_strip = local[h : 2 * h, :]  # our bottom interior rows
    north_strip = local[-2 * h : -h, :]  # our top interior rows
    from_south = _shift_from(north_strip, y_axis, reverse=False)  # prev dev's top
    from_north = _shift_from(south_strip, y_axis, reverse=True)  # next dev's bottom
    local = local.at[:h, :].set(from_south)
    local = local.at[-h:, :].set(from_north)

    # --- x direction (after y so corners propagate) ----------------------
    west_strip = local[:, h : 2 * h]
    east_strip = local[:, -2 * h : -h]
    from_west = _shift_from(east_strip, x_axis, reverse=False)
    from_east = _shift_from(west_strip, x_axis, reverse=True)
    local = local.at[:, :h].set(from_west)
    local = local.at[:, -h:].set(from_east)
    return local


def extend_with_halo(local_interior: jnp.ndarray, halo: int = 1) -> jnp.ndarray:
    """Pad a local interior block with zero halos (to be filled by
    exchange_halo)."""
    return jnp.pad(local_interior, halo)


def strip_halo(local: jnp.ndarray, halo: int = 1) -> jnp.ndarray:
    return local[halo:-halo, halo:-halo]


def sharded_stencil_apply(fn, global_x: jnp.ndarray, mesh, halo: int = 1):
    """Reference harness: apply a stencil `fn` (operating on a halo-extended
    block, returning the interior result) over a 2-D device mesh with
    explicit halo exchange. Used by tests to prove equivalence with the
    global single-device stencil."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def local_fn(block):
        ext = extend_with_halo(block, halo)
        ext = exchange_halo(ext, halo)
        return fn(ext)

    return shard_map(
        local_fn, mesh=mesh, in_specs=P("y", "x"), out_specs=P("y", "x"),
    )(global_x)
