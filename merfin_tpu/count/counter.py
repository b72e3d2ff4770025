"""Device k-mer counting — the `meryl count` replacement.

merfin shells out `meryl count k=K <fasta> output <db>` to build the
assembly database when -seqmers is missing (merfin-globals.C:166-189).
Here counting is a batched array program: chunked 2-bit k-merization
(device), canonicalization, sort, and run-length reduction, with
hierarchical sorted merges on the host as chunks stream through.

The result is an MKDB (canonical, sorted, 64-way prefix-partitioned).
"""

from __future__ import annotations

import os
import sys
from typing import Iterable

import numpy as np

from merfin_tpu.io.fasta import SeqFile, Sequence
from merfin_tpu.io.mkdb import KmerDB
from merfin_tpu.kcore.pack import kmers_from_codes_np


def _merge_sorted(a_keys, a_vals, b_keys, b_vals):
    """Merge two sorted unique (key, val) arrays, summing duplicates.

    Native path: one linear two-pointer C pass (mt_merge_counts) — the
    O(n log n) argsort merge was the counter's host wall (r4 verdict
    item 7); numpy fallback keeps the pure-python install working."""
    from merfin_tpu.native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "mt_merge_counts"):
        import ctypes

        na, nb = int(a_keys.size), int(b_keys.size)
        ak = np.ascontiguousarray(a_keys, np.uint64)
        av = np.ascontiguousarray(a_vals, np.uint64)
        bk = np.ascontiguousarray(b_keys, np.uint64)
        bv = np.ascontiguousarray(b_vals, np.uint64)
        ok = np.empty(na + nb, np.uint64)
        ov = np.empty(na + nb, np.uint64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        m = lib.mt_merge_counts(
            ak.ctypes.data_as(u64p), av.ctypes.data_as(u64p), na,
            bk.ctypes.data_as(u64p), bv.ctypes.data_as(u64p), nb,
            ok.ctypes.data_as(u64p), ov.ctypes.data_as(u64p))
        return ok[:m], ov[:m]

    keys = np.concatenate([a_keys, b_keys])
    vals = np.concatenate([a_vals, b_vals])
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    if keys.size == 0:
        return keys, vals
    boundary = np.empty(keys.size, dtype=bool)
    boundary[0] = True
    boundary[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(boundary)
    sums = np.add.reduceat(vals, starts)
    return keys[starts], sums


class _Accumulator:
    """Hierarchical merger; spills sorted runs to disk past a byte budget.

    Without a budget all distinct k-mers stay in host RAM (binary-counter
    merging).  With one, whenever the resident levels exceed it they merge
    into a single sorted run written to a SpillStore — the out-of-core
    property meryl's counter has (SURVEY.md §2.2) — and the final database
    is produced by a slice-by-slice merge (spill.merge_to_mkdb).
    """

    def __init__(self, k: int | None = None, budget_bytes: int | None = None,
                 spill_dir: str | None = None):
        self.levels: list[tuple[np.ndarray, np.ndarray] | None] = []
        self.total = 0
        self.k = k
        self.budget = budget_bytes
        self.spill_dir = spill_dir
        self.store = None

    def add(self, keys: np.ndarray, vals: np.ndarray) -> None:
        self.total += int(vals.sum())
        cur = (keys, vals.astype(np.uint64))
        # binary-counter merging: level i holds ~2^i chunks worth
        i = 0
        while i < len(self.levels) and self.levels[i] is not None:
            cur = _merge_sorted(*self.levels[i], *cur)
            self.levels[i] = None
            i += 1
        if i == len(self.levels):
            self.levels.append(None)
        self.levels[i] = cur
        if self.budget is not None and self._resident_bytes() > self.budget:
            self._spill()

    def _resident_bytes(self) -> int:
        return sum(lv[0].size * 16 for lv in self.levels if lv is not None)

    def _spill(self) -> None:
        from merfin_tpu.count.spill import SpillStore

        keys = np.zeros(0, np.uint64)
        vals = np.zeros(0, np.uint64)
        for lv in self.levels:
            if lv is not None:
                keys, vals = _merge_sorted(keys, vals, *lv)
        if self.store is None:
            assert self.k is not None, "spilling needs k for slice offsets"
            self.store = SpillStore(self.spill_dir, self.k)
        self.store.spill(keys, vals)
        self.levels = []

    def mem_parts(self) -> list[tuple[np.ndarray, np.ndarray]]:
        return [lv for lv in self.levels if lv is not None]

    def result(self) -> tuple[np.ndarray, np.ndarray, int]:
        assert self.store is None, "spilled accumulator: merge via spill.merge_to_mkdb"
        keys = np.zeros(0, np.uint64)
        vals = np.zeros(0, np.uint64)
        for lv in self.levels:
            if lv is not None:
                keys, vals = _merge_sorted(keys, vals, *lv)
        return keys, vals, self.total


class _DeviceCountAcc:
    """Device-RESIDENT count accumulation.

    The old device path fetched every chunk's full sorted window array
    (8 B/base) — on any link that dwarfs the compute (meryl streams
    bases and keeps counts in RAM; fetching windows inverts that).
    Here each chunk reduces to sorted (unique key, count) runs ON
    DEVICE in fixed shapes (sentinel-padded, so every chunk reuses one
    compiled program); every ``collapse_runs`` same-capacity runs merge
    in one device sort program whose output COMPACTS to the next power
    of two above its live uniques (collapse sorts never re-pay input
    padding); and only the FINAL unique set crosses the link, as
    (lo u32, hi, val) planes — wire bytes scale with distinct k-mers,
    not bases.
    """

    _MAX = 0xFFFFFFFFFFFFFFFF
    _MIN_CAP = 1 << 18

    def __init__(self, k: int, chunk: int, collapse_runs: int = 8):
        from merfin_tpu.config import ensure_x64

        ensure_x64()
        import jax
        import jax.numpy as jnp

        from merfin_tpu.ops.kmer_ops import kmer_windows, unpack_transfer

        self.k = k
        self.chunk = chunk
        self.R = collapse_runs
        # capacity-keyed buckets: buckets[cap] holds < R runs of ``cap``
        # padded entries; R same-cap runs collapse into one compacted run
        self.buckets: dict[int, list] = {}
        # runs whose collapse would exceed max_entries are fetched and
        # merged on the host instead (keeps device memory bounded on huge
        # inputs; 2^27 entries = ~2 GB of sort operands)
        self.max_entries = 1 << 27
        self._host_keys = np.zeros(0, np.uint64)
        self._host_vals = np.zeros(0, np.uint64)
        self._totals: list = []  # device scalars (summed at drain)
        self._slice_fns: dict = {}
        L = chunk + k - 1
        MAX = jnp.uint64(self._MAX)

        def runlength(sk):
            """Sorted keys [W] -> (unique keys padded with MAX, bp, nxt).
            Fixed-shape: boundary positions sort to the front, count of
            run j = bp[j+1] - bp[j]; pads produce count 0 / key MAX."""
            W = sk.shape[0]
            pos = jnp.arange(W, dtype=jnp.int32)
            b = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]])
            bp = jnp.sort(jnp.where(b, pos, np.int32(W)))
            nxt = jnp.append(bp[1:], jnp.int32(W))
            keys = jnp.where(bp < W, sk[jnp.minimum(bp, W - 1)], MAX)
            return keys, bp, nxt

        p4 = (L + 3) // 4

        @jax.jit
        def chunk_count(wire):
            # one fused wire buffer = one device_put per chunk (each
            # transfer pays a host->device round trip)
            planes = wire[:, :p4]
            vbits = wire[:, p4:]
            codes = unpack_transfer(planes, vbits, L)[0]
            fmer, rmer, valid = kmer_windows(codes, k)
            canon = jnp.where(valid, jnp.minimum(fmer, rmer), MAX)
            sk = jnp.sort(canon)
            keys, bp, nxt = runlength(sk)
            counts = (nxt - bp).astype(jnp.uint32)
            counts = jnp.where(keys == MAX, jnp.uint32(0), counts)
            return keys, counts, jnp.sum(valid)

        @jax.jit
        def collapse(ks, vs):
            """ks [R, W] u64 / vs [R, W] uint -> merged padded run +
            live-unique count.  Pad keys are MAX with value 0, so their
            sums vanish and they sort to the tail — sortedness and
            shape are preserved; n_uniq lets the host compact."""
            k2 = ks.reshape(-1)
            v2 = vs.reshape(-1).astype(jnp.uint64)
            sk, sv = jax.lax.sort((k2, v2), num_keys=1)
            keys, bp, nxt = runlength(sk)
            cv = jnp.concatenate([jnp.zeros(1, jnp.uint64), jnp.cumsum(sv)])
            sums = cv[nxt] - cv[bp]
            n_uniq = jnp.sum(keys != MAX)
            return keys, sums, n_uniq

        self._chunk_fn = chunk_count
        self._collapse_fn = collapse
        import jax as _jax

        self._jnp = jnp
        self._jax = _jax

    def add_codes(self, buf: np.ndarray) -> None:
        """Dispatch one packed chunk (codes u8 [chunk + k - 1], code 4
        separators/pads) — returns without syncing the device.  Inputs
        go to the device by explicit device_put."""
        import jax

        from merfin_tpu.kcore.pack import pack_transfer_np

        planes, vbits = pack_transfer_np(buf.reshape(1, -1))
        wire = np.concatenate([planes, vbits], axis=1)
        keys, vals, n_valid = self._chunk_fn(jax.device_put(wire))
        self._totals.append(n_valid)
        self._push((keys, vals))

    def _push(self, run) -> None:
        cap = int(run[0].shape[0])
        bucket = self.buckets.setdefault(cap, [])
        bucket.append(run)
        if len(bucket) >= self.R:
            self.buckets[cap] = []
            self._collapse(bucket)

    def _collapse(self, runs) -> None:
        cap = int(runs[0][0].shape[0])
        if len(runs) * cap > self.max_entries:
            # HBM-bounded: overflow these (already deduped) runs to the
            # host accumulator via the native linear merge
            for r in runs:
                rk, rv = self._fetch_run(*r)
                self._host_keys, self._host_vals = _merge_sorted(
                    self._host_keys, self._host_vals, rk, rv)
            return
        jnp = self._jnp
        ks = jnp.stack([r[0] for r in runs])
        vs = jnp.stack([r[1] for r in runs])
        keys, vals, n_uniq = self._collapse_fn(ks, vs)
        # compact: uniques sit at the front; capacity = pow2 above the
        # live count so later collapse sorts never re-pay this padding
        n = int(n_uniq)
        full = int(keys.shape[0])
        new_cap = max(self._MIN_CAP, 1 << max(0, (n - 1).bit_length()))
        if new_cap < full:
            keys, vals = self._sliced(keys, vals, new_cap)
        self._push((keys, vals))

    def _sliced(self, keys, vals, q: int):
        W = int(keys.shape[0])
        fn = self._slice_fns.get(("cut", W, q))
        if fn is None:
            fn = self._jax.jit(lambda a, b: (a[:q], b[:q]))
            self._slice_fns[("cut", W, q)] = fn
        return fn(keys, vals)

    def _fetch_run(self, keys, vals):
        """Fetch one padded run's live prefix as (lo u32, hi, val)
        planes — the hi plane is u16 for k <= 24 and the value plane
        narrows to the run's max count (u8 at typical coverages), so
        the wire carries ~7-10 B/key instead of 16.  Slice sizes
        quantize to 2^18 so the link never carries the full pad and the
        compiled-slice set stays tiny."""
        jnp = self._jnp
        W = int(keys.shape[0])
        stat = self._slice_fns.get(("stat", W))
        if stat is None:
            stat = self._jax.jit(lambda a, b: (
                jnp.sum(a != jnp.uint64(self._MAX)), jnp.max(b)))
            self._slice_fns[("stat", W)] = stat
        n_d, vmax_d = stat(keys, vals)
        n, vmax = int(n_d), int(vmax_d)
        if n == 0:
            return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
        Q = self._MIN_CAP
        q = min(W, ((n + Q - 1) // Q) * Q)
        hi_dt = jnp.uint16 if self.k <= 24 else jnp.uint32
        v_dt = (jnp.uint8 if vmax < 256 else
                jnp.uint16 if vmax < 65536 else
                jnp.uint32 if vmax <= 0xFFFFFFFF else jnp.uint64)
        fn = self._slice_fns.get(("fetch", W, q, str(v_dt)))
        if fn is None:
            def planes(a, b):
                lo = a[:q].astype(jnp.uint32)
                hi = (a[:q] >> jnp.uint64(32)).astype(hi_dt)
                return lo, hi, b[:q].astype(v_dt)

            fn = self._jax.jit(planes)
            self._slice_fns[("fetch", W, q, str(v_dt))] = fn
        lo, hi, v = fn(keys, vals)
        rk = (np.asarray(hi)[:n].astype(np.uint64) << np.uint64(32)) | \
            np.asarray(lo)[:n].astype(np.uint64)
        return rk, np.asarray(v)[:n].astype(np.uint64)

    def drain(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Device-collapse leftover same-capacity runs, then fetch +
        host-merge what remains (native linear merge)."""
        for cap in sorted(self.buckets):
            runs = self.buckets[cap]
            if len(runs) >= 2 and len(runs) * cap <= self.max_entries:
                self.buckets[cap] = []
                self._collapse(runs)   # re-pushed compacted (maybe new cap)
        keys, vals = self._host_keys, self._host_vals
        for cap in sorted(self.buckets, reverse=True):
            for r in self.buckets[cap]:
                rk, rv = self._fetch_run(*r)
                keys, vals = _merge_sorted(keys, vals, rk, rv)
        if self._totals:
            # fold totals on device in fixed-arity groups (one compiled
            # 129-operand program regardless of chunk count — an
            # n_chunks-operand add chain would recompile per run and
            # grow its signature unboundedly), then ONE scalar fetch
            jnp = self._jnp
            CH = 128
            fn = self._slice_fns.get(("tot", CH))
            if fn is None:
                fn = self._jax.jit(lambda carry, *ts: carry + sum(ts))
                self._slice_fns[("tot", CH)] = fn
            zero = jnp.int64(0)
            carry = zero
            for i in range(0, len(self._totals), CH):
                grp = list(self._totals[i: i + CH])
                grp += [zero] * (CH - len(grp))
                carry = fn(carry, *grp)
            total = int(carry)
        else:
            total = 0
        self.buckets, self._totals = {}, []
        self._host_keys = np.zeros(0, np.uint64)
        self._host_vals = np.zeros(0, np.uint64)
        return keys, vals, total


def _chunk_canonical_counts_np(codes: np.ndarray, k: int):
    fmer, rmer, valid = kmers_from_codes_np(codes, k)
    canon = np.minimum(fmer, rmer)[valid]
    if canon.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    keys, counts = np.unique(canon, return_counts=True)
    return keys.astype(np.uint64), counts.astype(np.uint64)


def _chunk_canonical_counts_device(codes: np.ndarray, k: int, step):
    """Device path: pack + canonicalize + sort on device, reduce on host."""
    canon_sorted, valid_count = step(codes)
    canon = np.asarray(canon_sorted)[: int(valid_count)]
    if canon.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    boundary = np.empty(canon.size, dtype=bool)
    boundary[0] = True
    boundary[1:] = canon[1:] != canon[:-1]
    starts = np.flatnonzero(boundary)
    counts = np.diff(np.append(starts, canon.size)).astype(np.uint64)
    return canon[starts], counts


def _make_device_step(k: int, chunk_len: int):
    from merfin_tpu.config import ensure_x64

    ensure_x64()
    import jax
    import jax.numpy as jnp

    from merfin_tpu.ops.kmer_ops import kmer_windows

    @jax.jit
    def step(codes):
        fmer, rmer, valid = kmer_windows(codes, k)
        canon = jnp.minimum(fmer, rmer)
        # push invalid windows to the end as u64::MAX, sort, count valid
        canon = jnp.where(valid, canon, jnp.uint64(0xFFFFFFFFFFFFFFFF))
        return jnp.sort(canon), jnp.sum(valid)

    return step


def _packed_chunks(seqs: Iterable[Sequence], k: int, chunk: int):
    """Pack sequences into fixed-size chunks with k-1 invalid separators
    so that windows never span two sequences — one device dispatch per
    full chunk regardless of read length (a per-read dispatch would be
    10^6 host round-trips for a read set).  Yields u8 [chunk + k - 1]
    buffers padded with code 4; a sequence split across chunks carries a
    k-1 overlap so every window is counted exactly once."""

    def fresh():
        return np.full(chunk + k - 1, 4, dtype=np.uint8)

    buf = fresh()
    fill = 0
    for seq in seqs:
        codes = seq.codes()
        n = codes.shape[0]
        if n < k:
            continue
        pos = 0
        while pos < n:
            if fill >= chunk:   # keep >= k codes of space before writing
                yield buf
                buf, fill = fresh(), 0
            space = chunk + k - 1 - fill
            take = min(n - pos, space)
            buf[fill : fill + take] = codes[pos : pos + take]
            fill += take
            if pos + take >= n:
                # end of sequence: leave a k-1 separator gap
                fill = min(fill + k - 1, chunk + k - 1)
                break
            # continue the same sequence in the next chunk with k-1 overlap
            yield buf
            buf, fill = fresh(), 0
            pos += take - (k - 1)
    if fill:
        yield buf


def _make_device_acc(k: int, chunk: int, log):
    try:
        return _DeviceCountAcc(k, chunk)
    except Exception as e:  # pragma: no cover - device unavailable
        print(f"count: device-resident path unavailable ({e}); "
              "falling back", file=log)
        return None


def count_sequences(
    seqs: Iterable[Sequence],
    k: int,
    chunk: int = 1 << 22,
    use_device: bool = True,
    log=sys.stderr,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Count canonical k-mers; returns (sorted keys, values, total).

    Device path: fully device-resident accumulation (_DeviceCountAcc) —
    per-chunk sort+reduce and run collapses stay on HBM; only the final
    unique set is fetched."""
    if use_device:
        dacc = _make_device_acc(k, chunk, log)
        if dacc is not None:
            for buf in _packed_chunks(seqs, k, chunk):
                dacc.add_codes(buf)
            return dacc.drain()
    acc = _Accumulator()
    _count_into(acc, seqs, k, chunk, use_device=False, log=log)
    return acc.result()


def _count_into(
    acc: _Accumulator,
    seqs: Iterable[Sequence],
    k: int,
    chunk: int = 1 << 22,
    use_device: bool = True,
    log=sys.stderr,
) -> None:
    """Feed chunked canonical-count batches into a HOST accumulator
    (the spill/out-of-core path; the in-RAM path uses _DeviceCountAcc)."""
    step = None
    if use_device:
        try:
            step = _make_device_step(k, chunk)
        except Exception as e:  # pragma: no cover - device unavailable
            print(f"count: device path unavailable ({e}); using numpy", file=log)

    for buf in _packed_chunks(seqs, k, chunk):
        if step is not None:
            keys, vals = _chunk_canonical_counts_device(buf, k, step)
        else:
            keys, vals = _chunk_canonical_counts_np(buf, k)
        acc.add(keys, vals)


def pack_stream(codes: np.ndarray, offsets: np.ndarray, k: int) -> np.ndarray:
    """Concatenate per-sequence code ranges with k-1 invalid separators —
    fully vectorized (one fancy-index copy instead of a python loop per
    read; a 30x-coverage read set is tens of millions of sequences)."""
    n_seq = offsets.shape[0] - 1
    total = int(offsets[-1])
    out = np.full(total + (n_seq + 1) * (k - 1), 4, dtype=np.uint8)
    lengths = np.diff(offsets)
    seq_of_base = np.repeat(np.arange(n_seq, dtype=np.int64), lengths)
    idx_out = np.arange(total, dtype=np.int64) + (k - 1) * seq_of_base
    out[idx_out] = codes[:total]
    return out


def count_files(
    paths: list[str],
    k: int,
    out_db: str,
    chunk: int = 1 << 22,
    use_device: bool = True,
    log=sys.stderr,
    window: int | None = None,
    memory_gb: float | None = None,
    spill_dir: str | None = None,
) -> KmerDB:
    """Count k-mers of FASTA/FASTQ files into a new MKDB.

    Streaming host data plane: each input file flows through fixed byte
    windows (SeqFile.iter_packed), so a 100+ GB FASTQ.gz counts in
    O(window + accumulator budget) memory — the whole file is never
    materialized (the reference streams too, merfin.C:30-53).  When the
    distinct-kmer set exceeds ``memory_gb`` the accumulator spills sorted
    runs to disk and the database is produced by a 64-slice out-of-core
    merge (meryl's out-of-core counting role, SURVEY.md §2.2).
    """

    from merfin_tpu.parallel import multihost as mh

    multi = mh.is_active()
    pid, pcount = mh.process_info() if multi else (0, 1)

    def all_blocks():
        for p in paths:
            # packed blocks: records joined with k-1 separators + window
            # overlap; each block counts as an independent sequence
            yield from SeqFile(p).iter_packed(k, window=window)

    def all_seqs():
        # Multi-host: block stripe per process (exact: the overlap carry
        # makes every block independently countable).  Prefetch overlaps
        # the host parse/pack of the next window with device counting.
        from merfin_tpu.utils.prefetch import prefetch_iter

        blocks = mh.host_sequences(all_blocks()) if multi else all_blocks()
        return prefetch_iter(blocks)

    budget = int(memory_gb * 1024**3) if memory_gb is not None else None
    if not multi and budget is None and use_device:
        # in-RAM single-host build: device-resident accumulation (the
        # spill/out-of-core and multi-host paths keep host runs)
        dacc = _make_device_acc(k, chunk, log)
        if dacc is not None:
            for buf in _packed_chunks(all_seqs(), k, chunk):
                dacc.add_codes(buf)
            keys, vals, total = dacc.drain()
            if keys.size and int(vals.max()) > 0xFFFFFFFF:
                raise ValueError("k-mer count exceeds uint32 (unsupported)")
            return KmerDB.create(out_db, k, keys, vals.astype(np.uint32),
                                 total=total)
    spill_base = None
    if multi:
        # per-rank spill dirs on the shared filesystem (an explicit
        # spill_dir is treated as the shared base, not a single dir —
        # ranks would overwrite each other's run files)
        spill_base = spill_dir or f"{out_db}.spill"
        spill_dir = os.path.join(spill_base, f"rank{pid}")
    acc = _Accumulator(k=k, budget_bytes=budget, spill_dir=spill_dir)
    _count_into(acc, all_seqs(), k, chunk=chunk, use_device=use_device, log=log)

    if multi:
        # every rank spills its stripe's counts to the shared filesystem;
        # rank 0 merges all runs into the database (64-slice out-of-core)
        from merfin_tpu.count.spill import SpillStore, merge_to_mkdb

        if acc.mem_parts() or acc.store is None:
            acc._spill()
        total = int(mh.merge_scalar_across_hosts(acc.total))
        mh.barrier("count-spilled")
        if pid == 0:
            import shutil

            dirs = [os.path.join(spill_base, f"rank{r}")
                    for r in range(pcount)]
            store = SpillStore.gather(dirs, k)
            print(f"count: merging {len(store.runs)} spilled runs "
                  f"from {pcount} hosts", file=log)
            merge_to_mkdb(out_db, k, store, [], total)
            shutil.rmtree(spill_base, ignore_errors=True)
        mh.barrier("count-merged")
        return KmerDB(out_db)

    if acc.store is not None:
        from merfin_tpu.count.spill import merge_to_mkdb

        print(f"count: merging {len(acc.store.runs)} spilled runs", file=log)
        return merge_to_mkdb(out_db, k, acc.store, acc.mem_parts(), acc.total)

    keys, vals, total = acc.result()
    if keys.size and int(vals.max()) > 0xFFFFFFFF:
        raise ValueError("k-mer count exceeds uint32 (unsupported)")
    return KmerDB.create(out_db, k, keys, vals.astype(np.uint32), total=total)
