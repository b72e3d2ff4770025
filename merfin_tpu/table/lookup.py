"""Exact k-mer lookup tables — the device replacement for merylExactLookup.

The reference keeps a prefix-indexed bit-packed table in host RAM and does
one pointer-chasing probe per k-mer (kmers-exact.C via merfin-globals.C:
107-108).  Here the table is two flat device arrays (sorted canonical keys
uint64 + values uint32) plus a prefix-bucket offset index; a batched
bucketized binary search answers millions of queries per dispatch, fully
vectorized (gathers) with no host round-trips.

``value(mer) == 0`` for absent mers, matching merylExactLookup.  -min/-max
filtering (read DB only, merfin-globals.C:136) happens at build by
dropping rows, so filtered mers read as absent.

Sharding across a mesh lives in merfin_tpu/parallel/sharded.py; this
module is the single-device core.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from merfin_tpu.config import ensure_x64
from merfin_tpu.io.mkdb import KmerDB


@dataclasses.dataclass
class HostLookup:
    """Numpy fallback with identical semantics (used by tests/tools)."""

    keys: np.ndarray   # uint64 sorted
    vals: np.ndarray   # uint32

    def __call__(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        if self.keys.size == 0:
            return np.zeros(q.shape, dtype=np.uint64)
        idx = np.searchsorted(self.keys, q)
        idx_c = np.minimum(idx, self.keys.size - 1)
        hit = self.keys[idx_c] == q
        return np.where(hit, self.vals[idx_c].astype(np.uint64), np.uint64(0))


def _pick_bucket_bits(n: int, k: int) -> int:
    if n <= 0:
        return 1
    b = int(math.ceil(math.log2(n + 1)))
    return max(1, min(b, 22, 2 * k))


class DeviceLookup:
    """Sorted-array + prefix-bucket exact lookup, resident in device HBM.

    Hot-path strategy ("block"): one scalar gather of the bucket offset,
    a gather of the few W-wide contiguous key blocks that hold the
    bucket, an equality compare across them, and the matching value
    blocks — a fixed number of dependent memory round trips, where a
    binary search pays one per step.  Bucket bits are grown until every
    bucket fits in the window; pathological skew falls back to the
    iterative binary-search path ("bsearch").

    Correctness note: candidates for query q all live in [off[b],
    off[b+1]) where b is q's prefix; entries outside that range have a
    different prefix and can never compare equal, so an equality-only
    window test needs no span check (clipped windows included).
    """

    WINDOW = 16          # block width; lookups fetch 2 adjacent blocks
    STRATEGY = "block"   # "block" | "slice" | "bsearch"

    def __init__(self, keys: np.ndarray, vals: np.ndarray, k: int, device=None,
                 window: int | None = None, strategy: str | None = None):
        ensure_x64()
        import jax
        import jax.numpy as jnp

        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.uint32)
        assert keys.shape == vals.shape
        self.k = int(k)
        self.n = int(keys.size)
        self.window = int(window or self.WINDOW)
        self.strategy = strategy or self.STRATEGY

        bits = _pick_bucket_bits(self.n, self.k)
        prefixes = (keys >> np.uint64(max(0, 2 * self.k - bits))).astype(np.int64)
        offsets, max_bucket = self._build_offsets(prefixes, bits)
        # grow the bucket index until buckets fit a small number of blocks
        while max_bucket > 2 * self.window and bits < min(24, 2 * self.k):
            bits += 1
            prefixes = (keys >> np.uint64(max(0, 2 * self.k - bits))).astype(np.int64)
            offsets, max_bucket = self._build_offsets(prefixes, bits)
        self.bits = bits
        self.shift = max(0, 2 * self.k - bits)
        # rows to fetch so W*R >= (W-1) + max_bucket (worst alignment)
        self.rows = max(2, -(-(max_bucket + self.window - 1) // self.window))
        self.windowed = self.rows <= 4
        if not self.windowed:
            self.strategy = "bsearch"
        self.search_iters = (
            max(1, math.ceil(math.log2(max_bucket + 1))) if max_bucket else 0
        )

        self._jit_lookup = None
        put = (lambda x: jax.device_put(x, device)) if device is not None else jnp.asarray
        # Pad so clipped/overhanging gathers stay in-bounds (pad keys are 0,
        # whose prefix can only be queried by prefix-0 mers at the array
        # START, so they never produce false hits; a true q==0 hit sums its
        # real value + zeros).
        W = max(1, self.window)
        pad_to = ((self.n + W - 1) // W + 4) * W   # spare blocks for row fetch
        # quantize to a power of two so compiled programs are shared
        # across tables of similar size (persistent-cache friendly)
        pad_to = max(4 * W, 1 << (pad_to - 1).bit_length())
        keys_p = np.zeros(pad_to, np.uint64)
        vals_p = np.zeros(pad_to, np.uint32)
        if self.n:
            keys_p[: self.n] = keys
            vals_p[: self.n] = vals
        # Single resident copy: the block strategy's [nblocks, W] view is
        # a free row-major reshape inside the jitted probe (keeping a
        # separate 2-D device copy doubled the table's HBM footprint).
        # Placement is LAZY: the table reaches the device on first use.
        self._put_fn = put
        self._keys_host = keys_p
        self._vals_host = vals_p
        self._offsets_host = offsets
        self._keys_dev = None
        self._vals_dev = None
        self._offsets_dev = None
        self.nblocks = pad_to // W

    # Once placed, the padded host copy is DROPPED (~12 bytes/key of
    # host RSS on billion-kmer tables).

    @property
    def keys(self):
        if self._keys_dev is None:
            self._keys_dev = self._put_fn(self._keys_host)
            self._keys_host = None
        return self._keys_dev

    @property
    def vals(self):
        if self._vals_dev is None:
            self._vals_dev = self._put_fn(self._vals_host)
            self._vals_host = None
        return self._vals_dev

    @property
    def offsets(self):
        if self._offsets_dev is None:
            self._offsets_dev = self._put_fn(self._offsets_host)
            self._offsets_host = None
        return self._offsets_dev

    @staticmethod
    def _build_offsets(prefixes: np.ndarray, bits: int):
        offsets = np.searchsorted(
            prefixes, np.arange((1 << bits) + 1, dtype=np.int64)
        ).astype(np.int32)
        max_bucket = int(np.max(offsets[1:] - offsets[:-1])) if prefixes.size else 0
        return offsets, max_bucket

    def memory_bytes(self) -> int:
        return self.n * 12 + ((1 << self.bits) + 1) * 4

    def tree(self):
        """Table arrays as a pytree — pass through jit boundaries as
        ARGUMENTS so device programs don't bake the table in as a
        constant (a closure-captured table forces a recompile per table
        and bloats the executable)."""
        return (self.keys, self.vals, self.offsets)

    def lookup_with(self, tree, q):
        """lookup() with table arrays supplied explicitly (see tree())."""
        return self._lookup_impl(tree, q)

    def lookup_np(self, q: np.ndarray) -> np.ndarray:
        """Numpy-in/numpy-out batched lookup for host-driven pipelines.

        Queries are padded to the next power of two (>= 4096) so repeated
        calls reuse a small set of compiled shapes.
        """
        import jax
        import jax.numpy as jnp

        if self._jit_lookup is None:
            self._jit_lookup = jax.jit(self._lookup_impl)
        q = np.ascontiguousarray(q, dtype=np.uint64)
        n = q.size
        if n == 0:
            return np.zeros(0, dtype=np.uint64)
        p = max(4096, 1 << (n - 1).bit_length())
        qp = np.zeros(p, dtype=np.uint64)
        qp[:n] = q.reshape(-1)
        out = np.asarray(self._jit_lookup(self.tree(), jnp.asarray(qp)))[:n]
        return out.astype(np.uint64).reshape(q.shape)

    def lookup(self, q):
        """Values for queried mers (uint64 array) — 0 where absent.

        Traceable under jit; q may be any shape.  NOTE: inside an outer
        jit, prefer lookup_with(tree(), q) so the table rides as an
        argument, not a baked-in constant.
        """
        return self._lookup_impl(self.tree(), q)

    def _lookup_impl(self, tree, q):
        import jax
        import jax.numpy as jnp

        keys, vals, offsets = tree

        if self.n == 0:
            return jnp.zeros(q.shape, dtype=jnp.uint32)

        qs = q.reshape(-1)
        b = (qs >> np.uint64(self.shift)).astype(jnp.int32)

        if self.strategy == "block":
            # A bucket spans at most `rows` consecutive window-wide blocks
            # (sized at build); fetch them and equality-select.
            keys2d = keys.reshape(-1, self.window)
            vals2d = vals.reshape(-1, self.window)
            base = offsets[b]
            r = jnp.minimum(base // self.window, self.nblocks - self.rows)
            rows = r[:, None] + jnp.arange(self.rows, dtype=jnp.int32)[None, :]
            kwin = jnp.take(keys2d, rows, axis=0)        # [M, R, W]
            vwin = jnp.take(vals2d, rows, axis=0)
            match = kwin == qs[:, None, None]
            out = jnp.sum(jnp.where(match, vwin, jnp.uint32(0)), axis=(1, 2),
                          dtype=jnp.uint32)
            return out.reshape(q.shape)

        if self.strategy == "slice":
            base = offsets[b]
            win = jax.lax.gather(
                keys,
                base[:, None],
                jax.lax.GatherDimensionNumbers(
                    offset_dims=(1,), collapsed_slice_dims=(),
                    start_index_map=(0,),
                ),
                slice_sizes=(self.window,),
                mode=jax.lax.GatherScatterMode.CLIP,
            )
            match = win == qs[:, None]
            found = jnp.any(match, axis=1)
            pos = jnp.argmax(match, axis=1).astype(jnp.int32)
            idx = jnp.minimum(base + pos, keys.shape[0] - 1)
            out = jnp.where(found, vals[idx], jnp.uint32(0))
            return out.reshape(q.shape)

        lo = offsets[b]
        hi = offsets[b + 1]

        def body(_, state):
            lo, hi = state
            mid = (lo + hi) >> 1
            km = keys[mid]
            go_right = km < qs
            return (jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid))

        lo, hi = jax.lax.fori_loop(0, max(self.search_iters, 1), body, (lo, hi))
        idx = jnp.minimum(lo, self.n - 1)
        hit = (keys[idx] == qs) & (lo < offsets[b + 1])
        out = jnp.where(hit, vals[idx], jnp.uint32(0))
        return out.reshape(q.shape)


def build_lookup(
    db: KmerDB,
    min_v: int = 0,
    max_v: int = 2**64 - 1,
    device=None,
    host: bool = False,
) -> DeviceLookup | HostLookup:
    """Load an MKDB into a lookup table, applying value filters.

    Mirrors merylExactLookup::load(db, mem, 0, minV, maxV)
    (merfin-globals.C:156-159): entries outside [min_v, max_v] are absent.
    """
    keys = np.asarray(db.keys)
    vals = np.asarray(db.vals)
    if min_v > 0 or max_v < 2**64 - 1:
        m = (vals >= min_v) & (vals <= max_v)
        keys, vals = keys[m], vals[m]
    if host:
        return HostLookup(keys.astype(np.uint64), vals.astype(np.uint32))
    return DeviceLookup(keys, vals, db.k, device=device)
