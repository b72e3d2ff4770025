"""Sharded k-mer lookup across a device mesh.

The reference duplicates the full ~150-200 GB lookup table in host RAM on
every cluster node (scripts/parallel1/run.sh budgets; SURVEY.md §2.3).
Here the table is hash-partitioned by sorted key range across the mesh's
"t" (table) axis, each device holding ~1/D of the rows in HBM.  A lookup
broadcasts the query batch along "t"; every device probes its local
sorted shard (misses cost one clipped binary search) and the per-device
partial values — zero everywhere except the owner shard — combine with a
single psum over the device interconnect.  Queries sharded along the "d"
(data) axis stay sharded: the collective only rides the table axis.

This expresses merfin's whole parallel inventory (sweatShop pipeline,
OpenMP slices, Slurm scatter — SURVEY.md §2.3) as one pjit'able program.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

from merfin_tpu.config import ensure_x64
from merfin_tpu.io.mkdb import KmerDB

PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def make_mesh(n_devices: int | None = None, data: int | None = None):
    """A ("d", "t") mesh over the available devices."""
    ensure_x64()
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if data is None:
        # favor table sharding; data axis takes what divides evenly
        data = 1
        for cand in (4, 2, 1):
            if n % cand == 0 and n // cand >= 1:
                data = cand
                break
    table = n // data
    arr = np.asarray(devs).reshape(data, table)
    return Mesh(arr, ("d", "t"))


def partition_rows(keys: np.ndarray, vals: np.ndarray, shards: int):
    """Split sorted rows into `shards` contiguous, equal-padded blocks.

    Returns (keys[D, M], vals[D, M], starts[D]) with u64::MAX key padding
    (matches no real k-mer, which need <= 62 bits for k <= 31).
    """
    n = keys.shape[0]
    bounds = [round(i * n / shards) for i in range(shards + 1)]
    m = max(1, max(bounds[i + 1] - bounds[i] for i in range(shards)))
    out_k = np.full((shards, m), PAD_KEY, dtype=np.uint64)
    out_v = np.zeros((shards, m), dtype=np.uint32)
    for i in range(shards):
        a, b = bounds[i], bounds[i + 1]
        out_k[i, : b - a] = keys[a:b]
        out_v[i, : b - a] = vals[a:b]
    return out_k, out_v


@dataclasses.dataclass
class ShardedLookup:
    """Device-mesh resident exact lookup (value 0 for absent keys).

    Each "t" shard holds raw sorted (keys u64, vals u32) rows, padded
    with u64::MAX keys, probed in place with the binary search of
    ops/sortjoin.py; queries may arrive in any order.
    """

    mesh: object
    arrays: tuple  # (keys[T, M], vals[T, M])
    n: int
    k: int
    _jit_lookup: object = dataclasses.field(default=None, repr=False,
                                            compare=False)

    @classmethod
    def build(cls, db_or_arrays, mesh, min_v: int = 0, max_v: int = 2**64 - 1):
        """Build the sharded table over ``mesh`` (single- or multi-host).

        Each shard row is materialized lazily in the device_put callback,
        so on a multi-host mesh every host only touches the table rows
        its local devices own (the memmapped MKDB serves the slices) —
        no host ever holds the padded [T, ...] arrays, which is the
        point: a 150-200 GB read table splits across the slice's HBM
        instead of duplicating per node (SURVEY §2.3).
        """
        ensure_x64()
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        if isinstance(db_or_arrays, KmerDB):
            keys = db_or_arrays.keys   # memmap: slices read lazily
            vals = db_or_arrays.vals
            k = db_or_arrays.k
        else:
            keys, vals, k = db_or_arrays

        # -min/-max (read DB only, merfin-globals.C:136): applied PER
        # SHARD ROW inside the callback — shards stay range-partitioned
        # by the raw row bounds (uneven filtered sizes are fine, every
        # probe psums across all shards), so no host ever materializes
        # the filtered table.  Only the value stream is scanned once,
        # in bounded chunks, for the filtered row count.
        filt = min_v > 0 or max_v < 2**64 - 1

        t = mesh.shape["t"]
        n_raw = keys.shape[0]
        bounds = [round(i * n_raw / t) for i in range(t + 1)]

        if filt:
            # one chunked pass over the value stream: per-shard FILTERED
            # row counts, so the padded device arrays shrink with the
            # filter (a -min that halves the table halves its HBM)
            kept = np.zeros(t, dtype=np.int64)
            for r in range(t):
                a, b = bounds[r], bounds[r + 1]
                for lo in range(a, b, 1 << 24):
                    vv = np.asarray(vals[lo: min(lo + (1 << 24), b)])
                    kept[r] += int(np.count_nonzero(
                        (vv >= min_v) & (vv <= max_v)))
            n = int(kept.sum())
            m_pad = max(1, int(kept.max()))
        else:
            n = n_raw
            m_pad = max(1, max(bounds[i + 1] - bounds[i] for i in range(t)))

        # Each shard's rows feed TWO make_array_from_callback calls
        # (keys, vals); memoize the filtered read so a
        # shard's memmap is touched once, freed after its second use
        # (the design-target tables are 150-200 GB of host I/O).
        src_memo: dict[int, tuple] = {}
        src_seen: dict[int, int] = {}

        def shard_src(r):
            """Filtered (keys, vals) numpy rows of shard r (memoized)."""
            if r in src_memo:
                out = src_memo[r]
                src_seen[r] += 1
                if src_seen[r] >= 2:
                    del src_memo[r], src_seen[r]
                return out
            a, b = bounds[r], bounds[r + 1]
            kk = np.asarray(keys[a:b])
            vv = np.asarray(vals[a:b])
            if filt:
                sel = (vv >= min_v) & (vv <= max_v)
                kk, vv = kk[sel], vv[sel]
            src_memo[r] = (kk, vv)
            src_seen[r] = 1
            return kk, vv

        def shard_rows(which, fill, dtype):
            def cb(index):
                rows = range(*index[0].indices(t))
                cols = index[1].indices(m_pad)
                assert cols[0] == 0 and cols[1] == m_pad
                out = np.full((len(rows), m_pad), fill, dtype=dtype)
                for j, r in enumerate(rows):
                    row = shard_src(r)[which]
                    out[j, : row.shape[0]] = row
                return out
            return cb

        sh = NamedSharding(mesh, P("t", None))
        arrays = (
            jax.make_array_from_callback(
                (t, m_pad), sh, shard_rows(0, PAD_KEY, np.uint64)),
            jax.make_array_from_callback(
                (t, m_pad), sh, shard_rows(1, 0, np.uint32)),
        )

        return cls(mesh=mesh, arrays=arrays, n=int(n), k=int(k))

    # -- shard_map plumbing ------------------------------------------------

    def in_specs(self):
        """PartitionSpecs of ``arrays`` for a shard_map over ("d", "t")."""
        from jax.sharding import PartitionSpec as P

        return (P("t", None), P("t", None))

    def probe_local(self, tree_local, q):
        """Probe THIS device's shard with a u64 query array (any order,
        any shape); misses/pad return 0, so callers psum over "t".
        ``tree_local`` is the per-device view of ``arrays`` inside
        shard_map (leading axis 1)."""
        from merfin_tpu.ops.sortjoin import probe_sorted

        keys, vals = tree_local
        return probe_sorted(keys[0], vals[0], q)

    def _probe_psum(self, tree_local, q):
        """Any-shape probe inside shard_map, combined over "t"."""
        import jax

        return jax.lax.psum(self.probe_local(tree_local, q), "t")

    def lookup(self, q):
        """Replicated-in, replicated-out lookup of a query array."""
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        @partial(
            shard_map,
            mesh=self.mesh,
            check_vma=False,
            in_specs=(*self.in_specs(), P()),
            out_specs=P(),
        )
        def f(*args):
            return self._probe_psum(args[:-1], args[-1])

        return f(*self.arrays, q)

    def lookup_np(self, q: np.ndarray) -> np.ndarray:
        """Numpy-in/numpy-out lookup for host-driven pipelines (the
        variant scorer's contract, variants/score.py).  Queries pad to a
        power of two (>= 4096) so repeated calls reuse a small set of
        compiled shapes; the replicated batch probes every "t" shard and
        combines with one psum."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        if self._jit_lookup is None:
            @partial(
                shard_map,
                mesh=self.mesh,
                check_vma=False,
                in_specs=(*self.in_specs(), P()),
                out_specs=P(),
            )
            def f(*args):
                return self._probe_psum(args[:-1], args[-1])

            self._jit_lookup = jax.jit(f)

        q = np.ascontiguousarray(q, dtype=np.uint64)
        n = q.size
        if n == 0:
            return np.zeros(0, dtype=np.uint64)
        p = max(4096, 1 << (n - 1).bit_length())
        qp = np.zeros(p, dtype=np.uint64)
        qp[:n] = q.reshape(-1)
        out = np.asarray(self._jit_lookup(*self.arrays, jnp.asarray(qp)))
        return out[:n].astype(np.uint64).reshape(q.shape)

    def lookup_sharded(self, q, qspec):
        """Lookup with queries sharded along the "d" axis (qspec P("d"))."""
        from jax import shard_map

        @partial(
            shard_map,
            mesh=self.mesh,
            check_vma=False,
            in_specs=(*self.in_specs(), qspec),
            out_specs=qspec,
        )
        def f(*args):
            return self._probe_psum(args[:-1], args[-1])

        return f(*self.arrays, q)


def dual_probe_local(read_lookup: ShardedLookup, asm_lookup: ShardedLookup,
                     r_tree, a_tree, fmer, rmer, valid, k: int):
    """Dual sharded-table probe inside a shard_map body.

    Returns FLAT (read_v u64, asm_v u64, valid) in window order after the
    psum over "t", with fmer+rmer palindrome doubling applied for even k
    (merfin-globals.C:101-110).
    """
    import jax
    import jax.numpy as jnp

    flat = lambda x: x.reshape(-1)
    canon = flat(jnp.minimum(fmer, rmer))
    read_v = jax.lax.psum(read_lookup.probe_local(r_tree, canon), "t")
    asm_v = jax.lax.psum(asm_lookup.probe_local(a_tree, canon), "t")
    read_v = read_v.astype(jnp.uint64)
    asm_v = asm_v.astype(jnp.uint64)
    if k % 2 == 0:
        mult = flat(jnp.where(fmer == rmer, jnp.uint64(2), jnp.uint64(1)))
        read_v = read_v * mult
        asm_v = asm_v * mult
    return read_v, asm_v, flat(valid)


def put_global(arr: np.ndarray, mesh, spec):
    """Place a host array onto the mesh with ``spec`` — works on single-
    AND multi-host meshes (each process serves its addressable shards
    from its local copy of the array; every process must hold the same
    values)."""
    import jax
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])


def mesh_spans_hosts(mesh) -> bool:
    """True when the mesh includes devices of more than one process."""
    import jax

    return any(d.process_index != jax.process_index()
               for d in mesh.devices.flat)
