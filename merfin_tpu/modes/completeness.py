"""-completeness mode: k-mer completeness from the two databases.

The reference streams both DBs 64 ways and merge-joins sorted k-mer
streams per slice under OpenMP (merfin-completeness.C:49-143).  Here the
merge-join becomes a sorted-join: MKDB read slices are ALREADY globally
sorted on disk (io/mkdb.py), so the read stream needs no device sort at
all — blocks of (key, value) rows stream straight through the sorted
probe (ops/sortjoin.py) against the device-resident assembly table;
asm-only k-mers are skipped exactly as in the reference
(merfin-completeness.C:100-109).

Per-slice accounting ("thread ii" lines) costs no extra dispatches: a
block's contributions split at the 64 prefix boundaries with one f64
cumsum + a 65-entry searchsorted, so blocks are occupancy-sized (pow2,
at least _MIN_BLOCK) independent of slice geometry.  Dispatches stay
in flight (bounded deque) — the host never syncs per block.

Accumulation is float64 per slice; readK/asmK are integer-valued
(score/value_map.py), so the cumsum prefix differences and host adds
are exact and the output is bit-identical to per-slice direct sums.
"""

from __future__ import annotations

import sys
from collections import deque

import numpy as np

from merfin_tpu.config import ensure_x64
from merfin_tpu.io.mkdb import KmerDB, SLICES
from merfin_tpu.score.kstar import ProbTable

_MAX_INFLIGHT = 8
_MIN_BLOCK = 1024   # smallest (pow2) block: bounds the compiled shapes


def build_asm_table(asm_db: KmerDB):
    """The device-resident sorted table over the FULL assembly DB
    (slices are contiguous, so the concatenation is globally sorted)."""
    from merfin_tpu.ops.sortjoin import SortedTable

    return SortedTable(np.asarray(asm_db.keys), np.asarray(asm_db.vals))


_RED = 512   # two-level reduction row width


def _block_stats_jit(table):
    """The jitted block program, cached ON the table instance: a fresh
    jax.jit wrapper per run_completeness call would re-load the
    executable each run; reusing the table reuses the program."""
    fn = getattr(table, "_compl_block_stats", None)
    if fn is not None:
        return fn

    import jax
    import jax.numpy as jnp

    @jax.jit
    def block_stats(tr, bounds, q_lo, q_hi, q_readk):
        """One read-stream block -> per-slice (total readK, undr copies)
        as int64 [64] pairs (f64 on the exotic-value-map fallback).

        Keys arrive as (lo u32, hi u8/u16/u32) planes — 5-8 B/key
        instead of 8 — and reconstruct with one shift+or; q_readk ships
        in the narrowest dtype covering the value map (u8 for typical
        peaks), so host->device bytes per key stay small.  A padding key
        is the hi-plane dtype max concatenated with u32 max (e.g.
        ~2^40-1 for k<=16) — it sorts past every real key < 2^2k,
        matches nothing, and lands past bounds[64] — and padding readK
        is 0, so padding contributes nothing.  Per-slice split: row
        sums [B/512] + a tiny cumsum + 65 boundary-row prefix
        corrections instead of a full-block f64 cumsum."""
        q_keys = (q_hi.astype(jnp.uint64) << jnp.uint64(32)) | \
            q_lo.astype(jnp.uint64)
        asm_v = table.lookup_sorted_with(tr, q_keys)
        if jnp.issubdtype(q_readk.dtype, jnp.integer):
            rk_c = q_readk.astype(jnp.uint32)   # narrow wire dtype -> u32
            asm_c = asm_v
        else:
            rk_c = q_readk                       # exotic-map f64 fallback
            asm_c = asm_v.astype(jnp.float64)
        zero = jnp.zeros((), rk_c.dtype)
        # integer path: readk > asm so the subtraction never underflows
        und = jnp.where(rk_c > asm_c, rk_c - asm_c, zero)

        def per_slice(x):
            acc = (jnp.int64 if jnp.issubdtype(x.dtype, jnp.integer)
                   else jnp.float64)
            x2 = x.reshape(-1, _RED)
            rows = x2.shape[0]
            crow = jnp.pad(jnp.cumsum(
                jnp.sum(x2, axis=1, dtype=acc)), (1, 0))
            bpos = jnp.searchsorted(q_keys, bounds).astype(jnp.int32)
            r_idx = jnp.minimum(bpos // _RED, rows - 1)
            c_idx = bpos - r_idx * _RED   # == _RED when bpos hits the end
            brow = x2[r_idx]              # [65, _RED] gather
            in_row = jnp.sum(jnp.where(
                jnp.arange(_RED, dtype=jnp.int32)[None, :] < c_idx[:, None],
                brow.astype(acc), jnp.zeros((), acc)), axis=1)
            prefix = crow[r_idx] + in_row
            return prefix[1:] - prefix[:-1]

        return per_slice(q_readk), per_slice(und)

    table._compl_block_stats = block_stats
    return block_stats


def _slice_bounds(k: int) -> np.ndarray:
    """The 65 prefix-boundary keys: slice i holds bounds[i] <= key <
    bounds[i+1] (io/mkdb.py's top-6-bit partition)."""
    shift = max(0, 2 * k - 6)
    return (np.arange(SLICES + 1, dtype=np.uint64) << np.uint64(shift))


def run_completeness(
    read_db: KmerDB,
    asm_db: KmerDB,
    peak: float,
    prob_table: ProbTable | None = None,
    log=sys.stderr,
    block: int = 1 << 22,
    mesh=None,
    asm_table=None,
):
    """-completeness driver; with ``mesh`` the assembly table shards over
    the "t" axis and read-DB row batches ride the "d" axis (the
    reference's 64-way OpenMP merge-join, merfin-completeness.C:65, as
    one collective program).  ``asm_table`` reuses a prebuilt
    build_asm_table result (the CLI/bench build once per process)."""
    ensure_x64()
    import jax
    import jax.numpy as jnp

    from merfin_tpu.score.value_map import ValueMap

    max_v = int(np.asarray(read_db.vals).max()) if read_db.distinct else 1
    # max_v is the scanned TRUE maximum (and completeness feeds raw DB
    # values, never palindrome-doubled), so the fallback compiles away
    vmap = ValueMap(peak, prob_table, max_v, exact_max=True)

    if mesh is not None:
        return _run_completeness_mesh(read_db, asm_db, vmap, mesh,
                                      log=log, block=block)

    from merfin_tpu.parallel import multihost as mh

    multi = mh.is_active()
    pid, pcount = mh.process_info() if multi else (0, 1)

    table = asm_table if asm_table is not None else build_asm_table(asm_db)
    tree = table.tree()
    bounds_dev = jnp.asarray(_slice_bounds(read_db.k))

    # readK precomputed on the HOST: the read stream's raw values are
    # host data, so getK costs one numpy gather per block (overlapped
    # with device compute) instead of a device f64 gather.  readK is
    # integer-valued and bounded by vcap/peak < 2^32 whenever peak > 0
    # (score/value_map.py), so the whole device program runs in u32/i64
    # integer math — exact on any backend by construction.
    rk_host = vmap.read_k_host
    int_ok = bool(np.isfinite(rk_host).all()) and float(rk_host.max()) < 2**32
    if int_ok:
        rk_max = int(rk_host.max())
        rk_dtype = (np.uint8 if rk_max < 2**8
                    else np.uint16 if rk_max < 2**16 else np.uint32)
        rk_map32 = rk_host.astype(rk_dtype)
    else:
        rk_dtype = np.float64
        rk_map32 = None
    # hi-plane dtype: enough for bits above 32 (u64::MAX padding needs
    # all-ones representable, hence the unsigned ceil to 8/16/32)
    hi_bits = max(1, 2 * read_db.k - 32)
    hi_dtype = (np.uint8 if hi_bits <= 8
                else np.uint16 if hi_bits <= 16 else np.uint32)
    block_stats = _block_stats_jit(table)

    compl_total = np.zeros(SLICES, dtype=np.float64)
    compl_undrc = np.zeros(SLICES, dtype=np.float64)

    # contiguous row ranges to stream: the whole DB single-host, the
    # rank's slice stripe multi-host (reference: OpenMP dynamic over 64)
    offs = read_db.slice_offsets
    owned = [ii for ii in range(SLICES) if not multi or ii % pcount == pid]
    ranges = []
    for ii in owned:
        a, b = int(offs[ii]), int(offs[ii + 1])
        if ranges and ranges[-1][1] == a:
            ranges[-1][1] = b
        else:
            ranges.append([a, b])

    def fetch(handle):
        t, u = handle
        compl_total[:] += np.asarray(t)
        compl_undrc[:] += np.asarray(u)

    def host_readk(rv: np.ndarray) -> np.ndarray:
        idx = np.minimum(rv, np.uint32(min(vmap.vcap, 2**32 - 1)))
        if int_ok:
            return rk_map32[idx]
        return rk_host[idx.astype(np.int64)]   # exotic value maps
        # (e.g. peak 0): exact host f64 readK, device sums stay f64

    def blocks():
        """Pack + START the host->device transfer of each block.  Runs
        on the prefetch thread with explicit jax.device_put, so the
        transfer overlaps device compute; keys ship as (lo u32, hi
        u8/u16) planes + narrow readK to cut transfer bytes ~2x."""
        for a, b in ranges:
            lo = a
            while lo < b:
                rem = b - lo
                # occupancy-sized: full blocks stream at `block`, the
                # tail shrinks to the next pow2 (>= _MIN_BLOCK) — a
                # handful of compiled shapes, bounded padding waste
                bs = min(block, max(_MIN_BLOCK, 1 << (rem - 1).bit_length()))
                n = min(rem, bs)
                kk = np.asarray(read_db.keys[lo: lo + n])
                # padding = (hi-plane max << 32 | u32 max): sorted past
                # every real key (< 2^2k <= 2^62), matches nothing,
                # lands past bounds[64]
                k_lo = np.full(bs, 0xFFFFFFFF, dtype=np.uint32)
                k_hi = np.full(bs, np.iinfo(hi_dtype).max, dtype=hi_dtype)
                k_lo[:n] = (kk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                k_hi[:n] = (kk >> np.uint64(32)).astype(hi_dtype)
                qk = np.zeros(bs, dtype=rk_dtype)
                qk[:n] = host_readk(np.asarray(read_db.vals[lo: lo + n]))
                yield (jax.device_put(k_lo), jax.device_put(k_hi),
                       jax.device_put(qk))
                lo += n

    from merfin_tpu.utils.prefetch import prefetch_iter

    inflight: deque = deque()
    for lo_d, hi_d, qk_d in prefetch_iter(blocks(), depth=2):
        inflight.append(block_stats(tree, bounds_dev, lo_d, hi_d, qk_d))
        if len(inflight) > _MAX_INFLIGHT:
            fetch(inflight.popleft())
    while inflight:
        fetch(inflight.popleft())

    for ii in owned:
        # python-float division: inf/inf -> nan without numpy warnings
        c = (1.0 - float(compl_undrc[ii]) / float(compl_total[ii])
             if compl_total[ii] else float("nan"))
        print(f"thread {ii:2d} total {compl_total[ii]:12.2f} underc "
              f"{compl_undrc[ii]:15.5f} completeness {c:0.8f}", file=log)

    if multi:
        compl_total = mh.merge_array_across_hosts(compl_total)
        compl_undrc = mh.merge_array_across_hosts(compl_undrc)
    return _report(compl_total, compl_undrc, log if pid == 0 else None)


def _report(compl_total: np.ndarray, compl_undrc: np.ndarray, log):
    total = float(np.sum(compl_total))
    undrc = float(np.sum(compl_undrc))
    completeness = 1.0 - undrc / total if total else float("nan")

    if log is not None:   # rank 0 only under multi-host
        print("", file=log)
        print(f"TOTAL readK:   {total:15.2f}", file=log)
        print(f"TOTAL undrcpy:    {undrc:15.5f}", file=log)
        print(f"COMPLETENESS:             {completeness:0.5f}", file=log)

    return {"total": total, "undrc": undrc, "completeness": completeness}


def _run_completeness_mesh(read_db: KmerDB, asm_db: KmerDB, vmap, mesh,
                           log=sys.stderr, block: int = 1 << 20):
    from jax.sharding import PartitionSpec as P

    from merfin_tpu.parallel.multichip import make_completeness_step
    from merfin_tpu.parallel.sharded import (ShardedLookup, mesh_spans_hosts,
                                             put_global)

    # On a host-spanning mesh every process drives the same slices and
    # the psums produce replicated results — only rank 0 reports.
    pid = 0
    if mesh_spans_hosts(mesh):
        import jax

        pid = jax.process_index()

    asm_sharded = ShardedLookup.build(asm_db, mesh)
    step = make_completeness_step(mesh, asm_sharded, vmap)
    D = mesh.shape["d"]
    spec = P("d", None)

    # one compiled shape: per-device block sized to the largest slice
    # (pow2, floor 4096) so small databases don't pay 64 full-size
    # zero-padded dispatches
    max_slice = int(np.max(np.diff(read_db.slice_offsets))) if read_db.distinct else 0
    per_dev = (max_slice + D - 1) // D
    if per_dev:
        block = min(block, max(4096, 1 << (per_dev - 1).bit_length()))

    compl_total = np.zeros(SLICES, dtype=np.float64)
    compl_undrc = np.zeros(SLICES, dtype=np.float64)

    for ii in range(SLICES):
        r_keys, r_vals = read_db.slice(ii)
        n_slice = r_keys.shape[0]
        for lo in range(0, n_slice, D * block):
            # pad keys u64::MAX: rows stay SORTED per device row (they
            # are masked out of the sums either way)
            rk = np.full((D, block), 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
            rv = np.zeros((D, block), dtype=np.uint32)
            mask = np.zeros((D, block), dtype=bool)
            piece_k = np.asarray(r_keys[lo: lo + D * block], dtype=np.uint64)
            piece_v = np.asarray(r_vals[lo: lo + D * block], dtype=np.uint32)
            n = piece_k.size
            rk.reshape(-1)[:n] = piece_k
            rv.reshape(-1)[:n] = piece_v
            mask.reshape(-1)[:n] = True
            t, u = step(put_global(rk, mesh, spec), put_global(rv, mesh, spec),
                        put_global(mask, mesh, spec))
            compl_total[ii] += float(t)
            compl_undrc[ii] += float(u)

        if pid == 0:
            # python-float division: inf/inf -> nan without numpy warnings
            c = (1.0 - float(compl_undrc[ii]) / float(compl_total[ii])
                 if compl_total[ii] else float("nan"))
            print(f"thread {ii:2d} total {compl_total[ii]:12.2f} underc "
                  f"{compl_undrc[ii]:15.5f} completeness {c:0.8f}", file=log)

    return _report(compl_total, compl_undrc, log if pid == 0 else None)
