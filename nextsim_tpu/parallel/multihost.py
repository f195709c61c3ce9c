"""Multi-process (multi-host) host-side data movement.

The reference is an MPI program whose export/restart/drifter paths gather the
distributed fields to rank 0 before touching the filesystem (reference:
gatherFieldsElement/gatherFieldsNode, model/finiteelement.cpp:2901-3557;
Exporter written on rank 0, fe.cpp:14111-14325). The jax analog: under
`jax.distributed` a sharded `jax.Array` spans non-addressable devices, so
`np.asarray` on it raises. Every host consumer (restart, exporter, drifters,
moorings means, crash dumps) therefore routes through :func:`gather_to_host`,
which is a no-op-cost `np.asarray` on a single process and a collective
`process_allgather` across processes — all hosts receive the global value
(cheaper to keep every host in lockstep for output decisions than to
special-case a root, and an allgather costs about what a gather does).

File writes are still gated to one process via :func:`is_writer` — the
rank-0 analog — except per-process patch outputs (moorings.parallel_output).

IMPORTANT: gather_to_host is COLLECTIVE when process_count > 1: every
process must call it with the same tree, in the same order (SPMD host code
guarantees this — the Simulator runs identical host logic everywhere).
"""

from __future__ import annotations

import numpy as np


def process_count() -> int:
    import jax

    return jax.process_count()


def is_writer() -> bool:
    """True on the process that owns scalar file output (the rank-0 analog;
    reference: Exporter/restart written on rank 0, fe.cpp:14111-14325)."""
    import jax

    return jax.process_index() == 0


def gather_to_host(tree):
    """Host-numpy tree of the GLOBAL value of every leaf.

    Single process: plain ``np.asarray`` per leaf — bit-identical to the
    pre-multihost behaviour. Multi process: fully-addressable and
    fully-replicated leaves convert directly; block-sharded leaves are
    all-gathered (collective — see module docstring). ``None`` leaves pass
    through.
    """
    import jax

    if jax.process_count() == 1:
        # pipeline the D2H copies: issue every leaf's transfer before the
        # first blocking convert, so N leaves can overlap instead of
        # serialising; values are bit-identical to plain per-leaf
        # np.asarray.
        for v in jax.tree_util.tree_leaves(tree):
            if isinstance(v, jax.Array):
                try:
                    v.copy_to_host_async()
                except Exception:  # noqa: BLE001 — backend may not support it
                    break
        return jax.tree.map(
            lambda v: None if v is None else np.asarray(v), tree
        )

    from jax.experimental import multihost_utils

    def g(v):
        if v is None:
            return None
        if not isinstance(v, jax.Array):
            return np.asarray(v)
        if v.is_fully_addressable or v.is_fully_replicated:
            return np.asarray(v)
        return np.asarray(multihost_utils.process_allgather(v, tiled=True))

    return jax.tree.map(g, tree)
