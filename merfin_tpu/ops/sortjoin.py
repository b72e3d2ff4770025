"""Sorted-join probes: exact (key -> value) lookups by binary search.

run_completeness and the mesh shards in parallel/sharded.py probe a
device-resident sorted key array with ``jnp.searchsorted`` and one
equality-checked value gather; XLA compiles the search.  Queries may
arrive in any order; completeness streams the already sorted read DB,
which makes the search a coherent gather stream.

Absent keys, and u64::MAX sentinel queries, read as value 0.
"""

from __future__ import annotations

import numpy as np


def probe_sorted(keys, vals, q, method: str = "scan"):
    """Values of ``q`` in the sorted table (keys, vals); 0 where absent.
    Traceable; ``q`` may have any shape.  ``method`` is jnp.searchsorted's
    lowering ("scan", JAX's default binary search, measured fastest on
    the H100 — PERF.md)."""
    import jax.numpy as jnp

    n = keys.shape[0]
    if n == 0:
        return jnp.zeros(q.shape, vals.dtype)
    idx = jnp.searchsorted(keys, q, method=method)
    idx_c = jnp.minimum(idx, n - 1)
    return jnp.where(keys[idx_c] == q, vals[idx_c], jnp.zeros((), vals.dtype))


class SortedTable:
    """One device-resident sorted (keys u64, vals u32) table.  keys/vals
    are HOST arrays; ``tree()`` rides through jit as an argument."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray):
        import jax.numpy as jnp

        self.n = int(keys.size)
        self.keys = jnp.asarray(np.ascontiguousarray(keys, np.uint64))
        self.vals = jnp.asarray(np.ascontiguousarray(vals, np.uint32))

    def tree(self):
        return (self.keys, self.vals)

    def lookup_sorted_with(self, tree, q):
        return probe_sorted(*tree, q)
