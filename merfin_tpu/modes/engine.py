"""The streaming K* engine shared by -hist and -dump.

Replaces the reference's sweatShop loader→worker→writer pipeline
(merfin.C:366-413): sequences are chunked into fixed-size windows with
k-1 overlap, batches of chunks run through one jitted device program
(k-mer extraction → dual-table lookup → getK → classify/bin), and the
tiny per-chunk aggregates return to the host, which keeps exact per-
sequence and global accumulators in float64/ints.

Out-of-sequence tail positions are padded with code 4 (invalid), so their
windows are skipped exactly like windows containing N.
"""

from __future__ import annotations

import dataclasses


import numpy as np

from merfin_tpu.config import ensure_x64
from merfin_tpu.ops.kmer_ops import kmer_windows, canonical_and_mult
from merfin_tpu.score.kstar import ProbTable

NBINS = 1 << 14          # default k* bins per side (ratio up to ~3277)
PAD_CODE = 4
SEG_MAX = 1024           # max sequences packed into one -hist dispatch


class BinOverflow(RuntimeError):
    """A k* histogram bin exceeded the engine's current nbins.  The
    reference grows its undr/over arrays dynamically (increaseArray,
    merfin-histogram.C:105-124); run_hist catches this, grows the
    engine's bins (recompile) and retries the failed sequence/group."""

    def __init__(self, max_idx: int, nbins: int):
        super().__init__(
            f"k* histogram bin {max_idx} exceeds nbins={nbins}")
        self.max_idx = int(max_idx)


@dataclasses.dataclass
class SeqStats:
    kasm: int = 0
    kmissing: int = 0
    kover_cpy: float = 0.0


def zero_hist_state(nbins: int = NBINS, amax: int = 8192,
                    vmaxp: int = 0):
    """Initial device state for hist accumulation (single-device and
    sharded engines share this layout — keep the fold in sync via
    fold_hist_state).  Layout: (kasm, kmissing, kover_fb, undr, over,
    max_idx, overflow, bin_fallbacks, kover_C, kover_N, kover_R,
    kover_fbc) — the kover_* integer parts feed the exact host finish
    (score/kover.py); kover_fb is the counted float fallback only."""
    import jax.numpy as jnp

    return (jnp.int64(0), jnp.int64(0), jnp.float64(0.0),
            jnp.zeros(nbins, jnp.int64), jnp.zeros(nbins, jnp.int64),
            jnp.int64(0), jnp.int64(0), jnp.int64(0),
            jnp.zeros(vmaxp * (amax + 1), jnp.int64),
            jnp.zeros(amax + 1, jnp.int64),
            jnp.zeros(amax + 1, jnp.int64), jnp.int64(0))


def pack_group(seqs, k: int, chunk: int, rows: int, capacity: int):
    """Pack small sequences into batch rows with a segment-id plane.

    Shared by the single-device and sharded engines' hist_group /
    dump_group: codes with k-1 separators, seg id per window start
    (SEG_MAX = none), chunked into [rows, chunk + k - 1].  Returns
    (codes_b, seg_b, starts) where starts[i] is sequence i's stream
    offset (== the row-major [rows, chunk] flat index of its first
    window).
    """
    assert len(seqs) <= SEG_MAX

    total = sum(c.shape[0] + k - 1 for c in seqs)
    stream = np.full(total, PAD_CODE, dtype=np.uint8)
    n_pos = max(0, total - k + 1)
    seg_win = np.full(n_pos, SEG_MAX, dtype=np.int32)
    starts = []
    pos = 0
    for i, c in enumerate(seqs):
        stream[pos: pos + c.shape[0]] = c
        starts.append(pos)
        nwin = c.shape[0] - k + 1
        if nwin > 0:
            seg_win[pos: pos + nwin] = i
        pos += c.shape[0] + k - 1
    assert n_pos <= capacity

    codes_b = np.full((rows, chunk + k - 1), PAD_CODE, dtype=np.uint8)
    seg_b = np.full((rows, chunk), SEG_MAX, dtype=np.int32)
    for row, start in enumerate(range(0, n_pos, chunk)):
        piece = stream[start: start + chunk + k - 1]
        codes_b[row, : piece.shape[0]] = piece
        sw = seg_win[start: start + chunk]
        seg_b[row, : sw.shape[0]] = sw
    return codes_b, seg_b, starts


def pack_group_transfer(seqs, k: int, chunk: int, rows: int, capacity: int):
    """pack_group + host->device transfer packing.

    Returns (planes, vbits, marks_bits, base, starts): the 2-bit code
    planes + validity bitmask (kcore.pack.pack_transfer_np) and the seg
    plane reduced to a boundary-mark bitmask + per-row mark-count offsets
    (ops.kmer_ops.seg_from_marks reconstructs seg on device) — ~10x
    fewer input bytes per packed-group dispatch than (codes, seg int32).
    """
    from merfin_tpu.kcore.pack import pack_transfer_np

    codes_b, _, starts = pack_group(seqs, k, chunk, rows, capacity)
    planes, vbits = pack_transfer_np(codes_b)
    flat = np.zeros(rows * chunk, np.uint8)
    idx = np.asarray(starts, dtype=np.int64)
    flat[idx[idx < flat.shape[0]]] = 1   # marks past the stream end mark
    marks = flat.reshape(rows, chunk)    # nothing (no windows there)
    base = np.zeros(rows, np.int64)
    base[1:] = np.cumsum(marks.sum(axis=1, dtype=np.int64))[:-1]
    marks_bits = np.packbits(marks, axis=-1, bitorder="little")
    return planes, vbits, marks_bits, base.astype(np.int32), starts


def counts_by_sort(comp, domain: int):
    """Value histogram of ``comp`` (ints in [0, domain)) — one sort +
    boundary searchsorted (default), or a run-length compaction of the
    sorted stream behind MERFIN_HIST_BOUNDS=runs.

    Both avoid a per-window scatter-add (jnp.bincount over the full
    stream); whether that trade still pays on the current accelerator
    is not measured.  Runs are value-bounded: at most ``domain`` distinct
    runs exist, so the boundary-position sort compacts to [domain] rows
    and the final scatter-add touches ``domain`` elements, not the
    stream."""
    import jax.numpy as jnp

    import os

    W = comp.size
    dt = jnp.uint16 if domain - 1 <= 0xFFFF else jnp.int32
    s = jnp.sort(comp.reshape(-1).astype(dt))
    if os.environ.get("MERFIN_HIST_BOUNDS") != "runs":
        bounds = jnp.searchsorted(s, jnp.arange(domain, dtype=dt))
        counts = jnp.diff(jnp.append(bounds, jnp.int64(W))).astype(jnp.int64)
        return counts
    pos = jnp.arange(W, dtype=jnp.int32)
    b = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    bp = jnp.sort(jnp.where(b, pos, np.int32(W)))
    M = min(domain, W)
    runs_pos = bp[:M]
    runs_next = bp[1: M + 1] if M < W else jnp.append(bp[1:M], np.int32(W))
    lens = (runs_next - runs_pos).astype(jnp.int64)   # pads: W - W = 0
    vals = s[jnp.minimum(runs_pos, W - 1)].astype(jnp.int32)
    return jnp.zeros(domain, jnp.int64).at[vals].add(lens)


def two_hist_by_sort(undr_idx, over_idx, is_undr, is_over,
                     nbins: int = NBINS):
    """The two k* histograms via ONE device sort + compacted-run scatter.

    Windows are undr XOR over XOR neither, so both histograms pack into
    one composite index space [0, 2*nbins] counted by counts_by_sort.
    """
    import jax.numpy as jnp

    comp = jnp.where(
        is_undr, jnp.clip(undr_idx, 0, nbins - 1),
        jnp.where(is_over, nbins + jnp.clip(over_idx, 0, nbins - 1),
                  2 * nbins))
    counts = counts_by_sort(comp.reshape(-1), 2 * nbins + 1)
    return counts[:nbins], counts[nbins: 2 * nbins]


def seg_counts_by_sort(seg, valid, missing):
    """Per-slot (kasm, kmissing) via one composite sort + compacted-run
    scatter (counts_by_sort).

    seg: window slot ids (any order — the helper sorts); valid/missing:
    classification masks aligned with seg.  Same sort-vs-scatter trade
    as two_hist_by_sort.
    """
    import jax.numpy as jnp

    S = SEG_MAX + 1
    comp = jnp.where(missing, S + seg,
                     jnp.where(valid, seg, 2 * S))
    c = counts_by_sort(comp.reshape(-1), 2 * S + 1)
    kmis_seg = c[S: S + SEG_MAX]
    kasm_seg = c[:SEG_MAX] + kmis_seg
    return kasm_seg, kmis_seg


def fold_hist_state(state, out):
    """Fold one hist-chunk output tuple into the running state."""
    import jax.numpy as jnp

    (kasm, kmissing, kover, undr_hist, over_hist, max_idx,
     overflow, fallbacks, kc, kn, kr, kfbc) = out
    return (state[0] + kasm, state[1] + kmissing, state[2] + kover,
            state[3] + undr_hist, state[4] + over_hist,
            jnp.maximum(state[5], max_idx), state[6] + overflow,
            state[7] + fallbacks, state[8] + kc, state[9] + kn,
            state[10] + kr, state[11] + kfbc)


class KstarEngine:
    def __init__(
        self,
        read_lookup,
        asm_lookup,
        k: int,
        peak: float,
        prob_table: ProbTable | None = None,
        chunk: int = 1 << 19,
        batch: int | None = None,
        max_value: int | None = None,
        pack_transfer: bool = True,
        exact_max: bool = False,
        asm_max_value: int | None = None,
    ):
        ensure_x64()
        import jax

        from merfin_tpu.score.value_map import ValueMap

        self.read_lookup = read_lookup
        self.asm_lookup = asm_lookup
        self.k = k
        self.peak = float(peak)
        self.chunk = chunk
        # Default batch (windows per dispatch = batch x chunk): 4.  Not
        # tuned on the current accelerator.
        self.batch = 4 if batch is None else batch
        from merfin_tpu.score.bin_table import BinTable

        # getK evaluated exactly on host per raw value (see
        # merfin_tpu/score/value_map.py); same for histogram bins
        # exact_max: caller asserts max_value is the scanned DB maximum
        # (the CLI does); the overflow fallback then compiles away
        self.value_map = ValueMap(peak, prob_table, max_value or (1 << 19),
                                  exact_max=exact_max)
        self.bin_table = BinTable()
        self.prob_table = prob_table
        from merfin_tpu.score.kover import kover_vmaxp

        self.kover_vmaxp = kover_vmaxp(prob_table)
        # trace-time kover fallback bounds: largest possible readK from
        # the value map and asmK from the DB (doubled for even-k
        # palindromes, merfin-globals.C:101-110); None = unknown
        self._kover_rmax = self.value_map.readk_bound()
        self._kover_amax = (asm_max_value * (2 if k % 2 == 0 else 1)
                            if asm_max_value is not None else None)
        self.overflow_values = 0
        self.bin_fallbacks = 0
        self.kover_fallbacks = 0

        # Table/value-map arrays flow through jit as ARGUMENTS so the
        # compiled programs are table-independent (closure-captured
        # tables bake into the executable: huge compiles, zero cache
        # reuse across databases).
        # The hist step ACCUMULATES into a device-resident state (donated
        # buffers): the host loop never syncs mid-sequence, so dispatches
        # pipeline instead of round-tripping per batch.
        # Transfer packing (pack_transfer, the default): codes cross the
        # host->device link as 2-bit planes + validity bits (2.7x fewer
        # input bytes) and group seg planes as boundary-mark bitmasks
        # (32x) — the device programs unpack first, bit-exactly.
        self.pack_transfer = bool(pack_transfer)
        self.nbins = NBINS
        self._make_jits()
        # packed-group capacity (positions) for fragmented assemblies
        self.group_capacity = self.batch * self.chunk
        # dump_group's positional output and [windows, R] take
        # temporaries grow with the batch: cap its packed rows at 4
        # batches whatever self.batch is.
        self.dump_batch = min(self.batch, 4)
        self.dump_group_capacity = self.dump_batch * self.chunk

    def _make_jits(self):
        import jax

        if self.pack_transfer:
            self._hist_step_impl = jax.jit(self._hist_chunk_acc_packed,
                                           donate_argnums=0)
            self._hist_group_impl = jax.jit(self._hist_group_chunk_packed)
            self._dump_step_impl = jax.jit(self._dump_chunk_packed)
            self._dump_group_impl = jax.jit(self._dump_group_chunk_packed)
        else:
            self._hist_step_impl = jax.jit(self._hist_chunk_acc,
                                           donate_argnums=0)
            self._hist_group_impl = jax.jit(self._hist_group_chunk)
            self._dump_step_impl = jax.jit(self._dump_chunk)
            self._dump_group_impl = jax.jit(self._dump_group_chunk)

    def grow_bins(self, min_bins: int) -> None:
        """Grow the k* histogram bin count (power of two >= min_bins) and
        recompile the hist programs — increaseArray semantics
        (merfin-histogram.C:105-124); run_hist retries the failed
        sequence/group after calling this."""
        self.nbins = max(self.nbins * 2, 1 << (min_bins - 1).bit_length())
        self._make_jits()

    def _step_args(self):
        """(tables, value-map arrays): tables = (read, asm) trees."""
        tables = (self.read_lookup.tree(), self.asm_lookup.tree())
        return (tables, self.value_map.device_arrays())

    def _hist_step(self, state, codes):
        if self.pack_transfer:
            from merfin_tpu.kcore.pack import pack_transfer_np

            planes, vbits = pack_transfer_np(codes)
            return self._hist_step_impl(state, planes, vbits,
                                        *self._step_args(),
                                        self.bin_table.device_arrays())
        return self._hist_step_impl(state, codes, *self._step_args(),
                                    self.bin_table.device_arrays())

    def _zero_hist_state(self):
        return zero_hist_state(self.nbins, self.bin_table.amax,
                               self.kover_vmaxp)

    def _finish_kover(self, kover_fb, kc, kn, kr, kfbc) -> float:
        """Exact host finish of the device integer kover parts."""
        from merfin_tpu.score.kover import finish_kover

        self.kover_fallbacks += int(kfbc)
        return finish_kover(np.asarray(kc), np.asarray(kn), np.asarray(kr),
                            float(kover_fb), self.prob_table,
                            self.kover_vmaxp, self.bin_table.amax)

    def _dump_step(self, codes):
        if self.pack_transfer:
            from merfin_tpu.kcore.pack import pack_transfer_np

            planes, vbits = pack_transfer_np(codes)
            return self._dump_step_impl(
                planes, vbits, self.read_lookup.tree(),
                self.asm_lookup.tree(), self.value_map.device_arrays())
        return self._dump_step_impl(
            codes, self.read_lookup.tree(), self.asm_lookup.tree(),
            self.value_map.device_arrays())

    # ---- device programs ----

    def _lookup_kvals(self, codes, r_tree, a_tree, vm):
        """codes [..., C + k - 1] -> (readK, asmK, prob, valid, overflow,
        raw read_v) — the raw value feeds the exact kover parts."""
        import jax.numpy as jnp

        fmer, rmer, valid = kmer_windows(codes, self.k)
        canon, mult = canonical_and_mult(fmer, rmer)
        read_v = self.read_lookup.lookup_with(r_tree, canon).astype(np.uint64) * mult
        asm_v = self.asm_lookup.lookup_with(a_tree, canon).astype(np.uint64) * mult
        read_k, prob, overflow = self.value_map.lookup_jnp(read_v, vm)
        asm_k = asm_v.astype(jnp.float64)
        read_k = jnp.where(valid, read_k, 0.0)
        asm_k = jnp.where(valid, asm_k, 0.0)
        return read_k, asm_k, prob, valid, overflow, read_v

    def _hist_chunk(self, codes, tables, vm, bins):
        """codes uint8 [B, C + k - 1] -> per-batch reduced hist stats.

        Mirrors processHistogram (merfin-histogram.C:36-92): invalid
        windows are skipped entirely; missing (readK==0) counted; undr
        k-mers binned by trunc((asmK/readK-1+0.1)/0.2) and accumulate the
        QV* excess term (1-readK/asmK)*prob; everything else binned in
        over[].
        """
        import jax.numpy as jnp

        from merfin_tpu.score.kover import kover_parts

        (read_k, asm_k, prob, valid, overflow,
         read_v) = self._lookup_kvals(codes, *tables, vm)

        missing = valid & (read_k == 0)
        is_undr = valid & (read_k > 0) & (asm_k > read_k)
        is_over = valid & (read_k > 0) & ~is_undr

        kasm = jnp.sum(valid)
        kmissing = jnp.sum(missing)
        kc, kn, kr, kover_fb, kfbc = kover_parts(
            read_v, read_k, asm_k, prob, is_undr, self.kover_vmaxp,
            self.bin_table.amax, r_max=self._kover_rmax,
            a_max=self._kover_amax)

        undr_idx, over_idx, bin_exact = self.bin_table.lookup_jnp(
            read_k, asm_k, bins)
        fallbacks = jnp.sum((is_undr | is_over) & ~bin_exact)

        max_idx = jnp.maximum(
            jnp.max(jnp.where(is_undr, undr_idx, 0)),
            jnp.max(jnp.where(is_over, over_idx, 0)),
        )
        undr_hist, over_hist = two_hist_by_sort(
            undr_idx, over_idx, is_undr, is_over, self.nbins)
        return (kasm, kmissing, kover_fb, undr_hist, over_hist, max_idx,
                overflow, fallbacks, kc, kn, kr, kfbc)

    def _hist_group_chunk(self, codes, seg, tables, vm, bins):
        """Packed-group -hist step: codes [B, C + k - 1] with SEG_MAX
        sequences packed per dispatch (k-1 separators), seg [B, C] giving
        each window's sequence slot (SEG_MAX = none).  Returns per-slot
        (kasm, kmissing) plus the global hist reductions — thousands of
        short scaffolds cost one dispatch instead of one each (the
        sweatShop granularity problem, SURVEY §2.3 note on imbalance).
        """
        import jax.numpy as jnp

        from merfin_tpu.score.kover import kover_parts

        (read_k, asm_k, prob, valid, overflow,
         read_v) = self._lookup_kvals(codes, *tables, vm)

        missing = valid & (read_k == 0)
        is_undr = valid & (read_k > 0) & (asm_k > read_k)
        is_over = valid & (read_k > 0) & ~is_undr

        kasm_seg, kmis_seg = seg_counts_by_sort(seg, valid, missing)

        kc, kn, kr, kover_fb, kfbc = kover_parts(
            read_v, read_k, asm_k, prob, is_undr, self.kover_vmaxp,
            self.bin_table.amax, r_max=self._kover_rmax,
            a_max=self._kover_amax)

        undr_idx, over_idx, bin_exact = self.bin_table.lookup_jnp(
            read_k, asm_k, bins)
        fallbacks = jnp.sum((is_undr | is_over) & ~bin_exact)
        max_idx = jnp.maximum(
            jnp.max(jnp.where(is_undr, undr_idx, 0)),
            jnp.max(jnp.where(is_over, over_idx, 0)),
        )
        undr_hist, over_hist = two_hist_by_sort(
            undr_idx, over_idx, is_undr, is_over, self.nbins)
        return (kasm_seg, kmis_seg, kover_fb, undr_hist, over_hist, max_idx,
                overflow, fallbacks, kc, kn, kr, kfbc)

    def _unpack(self, planes, vbits):
        from merfin_tpu.ops.kmer_ops import unpack_transfer

        return unpack_transfer(planes, vbits, self.chunk + self.k - 1)

    def _hist_chunk_acc_packed(self, state, planes, vbits,
                               tables, vm, bins):
        return fold_hist_state(
            state, self._hist_chunk(self._unpack(planes, vbits),
                                    tables, vm, bins))

    def _dump_chunk_packed(self, planes, vbits, r_tree, a_tree, vm):
        return self._dump_chunk(self._unpack(planes, vbits),
                                r_tree, a_tree, vm)

    def _hist_group_chunk_packed(self, planes, vbits, marks, base,
                                 tables, vm, bins):
        from merfin_tpu.ops.kmer_ops import seg_from_marks

        return self._hist_group_chunk(
            self._unpack(planes, vbits),
            seg_from_marks(marks, base, self.chunk),
            tables, vm, bins)

    def _dump_group_chunk_packed(self, planes, vbits, marks, base,
                                 r_tree, a_tree, vm):
        from merfin_tpu.ops.kmer_ops import seg_from_marks

        return self._dump_group_chunk(
            self._unpack(planes, vbits),
            seg_from_marks(marks, base, self.chunk),
            r_tree, a_tree, vm)

    def _group_inputs(self, seqs, batch=None, capacity=None):
        """Transfer arrays for one packed group + per-seq starts."""
        batch = self.batch if batch is None else batch
        capacity = self.group_capacity if capacity is None else capacity
        if self.pack_transfer:
            planes, vbits, marks, base, starts = pack_group_transfer(
                seqs, self.k, self.chunk, batch, capacity)
            return (planes, vbits, marks, base), starts
        codes_b, seg_b, starts = pack_group(seqs, self.k, self.chunk,
                                            batch, capacity)
        return (codes_b, seg_b), starts

    def hist_group_dispatch(self, seqs):
        """Dispatch one packed-group -hist step; returns an opaque handle
        of in-flight device results.  The caller overlaps the next
        group's host packing/transfer with this one's device compute and
        fetches via hist_group_finalize (modes/hist.py keeps 2 in
        flight — the sweatShop loader-queue analog: without it the fetch
        round trip serializes every dispatch)."""
        n_seq = len(seqs)
        inputs, _ = self._group_inputs(seqs)
        out = self._hist_group_impl(*inputs, *self._step_args(),
                                    self.bin_table.device_arrays())
        # the handle carries its dispatch-time nbins: with 2 groups in
        # flight, grow_bins() may run between a group's dispatch and its
        # finalize, and the overflow check must compare against the bin
        # count the group was actually CLIPPED to
        return n_seq, self.nbins, out

    def hist_group_finalize(self, handle):
        """Fetch one hist_group_dispatch's results:
        (stats_list, undr, over, kover_total)."""
        n_seq, nbins_d, (kasm_seg, kmis_seg, kover_fb, uh, oh, max_idx,
                         overflow, fallbacks, kc, kn, kr, kfbc) = handle
        if int(max_idx) >= nbins_d:
            raise BinOverflow(int(max_idx), nbins_d)
        # count diagnostics only for dispatches that survive: a retried
        # group re-counts its windows exactly once
        self.overflow_values += int(overflow)
        self.bin_fallbacks += int(fallbacks)
        kover = self._finish_kover(kover_fb, kc, kn, kr, kfbc)
        kasm_seg = np.asarray(kasm_seg)
        kmis_seg = np.asarray(kmis_seg)
        stats = [SeqStats(kasm=int(kasm_seg[i]), kmissing=int(kmis_seg[i]))
                 for i in range(n_seq)]
        return stats, np.asarray(uh), np.asarray(oh), float(kover)

    def hist_group(self, seqs):
        """-hist for a PACKED group of small sequences (one dispatch).

        seqs: list of code arrays; the caller guarantees
        sum(len(c) + k - 1) - (k-1) window positions fit group_capacity
        and len(seqs) <= SEG_MAX.  Returns (stats_list, undr, over,
        kover_total) — kover/histograms are global quantities
        (merfin-histogram.C accumulates them globally), per-sequence QV
        needs only kasm/kmissing.
        """
        return self.hist_group_finalize(self.hist_group_dispatch(seqs))

    def _dump_group_chunk(self, codes, seg, r_tree, a_tree, vm):
        """Packed-group -dump step: positional readK/asmK for a batch of
        packed small sequences plus per-slot (kasm, kmissing) via the
        same segment reduction as _hist_group_chunk."""
        import jax.numpy as jnp

        read_k, asm_k, prob, valid, overflow, _ = self._lookup_kvals(
            codes, r_tree, a_tree, vm)
        kasm_seg, kmis_seg = seg_counts_by_sort(
            seg, valid, valid & (read_k == 0))
        return (*self._dump_out(read_k, asm_k), kasm_seg, kmis_seg, overflow)

    def dump_group(self, seqs):
        """-dump for a PACKED group of small sequences (one dispatch).

        Returns (per-seq list of (readK, asmK, kmetric, kasm, kmissing)).
        Same packing/capacity contract as hist_group.
        """
        from merfin_tpu.score.kstar import k_metric_np

        k = self.k
        inputs, starts = self._group_inputs(
            seqs, batch=self.dump_batch, capacity=self.dump_group_capacity)

        rk, ak, kasm_seg, kmis_seg, overflow = self._dump_group_impl(
            *inputs, self.read_lookup.tree(), self.asm_lookup.tree(),
            self.value_map.device_arrays())
        self.overflow_values += int(overflow)
        # window at stream pos p -> p; u32 wire format -> exact f64
        rk = np.asarray(rk).reshape(-1).astype(np.float64, copy=False)
        ak = np.asarray(ak).reshape(-1).astype(np.float64, copy=False)
        kasm_seg = np.asarray(kasm_seg)
        kmis_seg = np.asarray(kmis_seg)

        out = []
        for i, c in enumerate(seqs):
            nwin = max(0, c.shape[0] - k + 1)
            # row-major [B, C] flattening maps stream window p to index p
            r = rk[starts[i]: starts[i] + nwin]
            a = ak[starts[i]: starts[i] + nwin]
            out.append((r, a, k_metric_np(r, a),
                        int(kasm_seg[i]), int(kmis_seg[i])))
        return out

    def _hist_chunk_acc(self, state, codes, tables, vm, bins):
        """_hist_chunk folded into a running device state (accumulation
        order matches the old per-batch host adds: batch order)."""
        return fold_hist_state(
            state, self._hist_chunk(codes, tables, vm, bins))

    def _fetch32(self) -> bool:
        """True when readK/asmK provably fit uint32 (halves the
        positional fetch vs f64).  Gate shared with the mesh dump path:
        ValueMap.fits_u32."""
        return self.value_map.fits_u32(self.k)

    def _dump_out(self, read_k, asm_k):
        import jax.numpy as jnp

        if self._fetch32():
            return read_k.astype(jnp.uint32), asm_k.astype(jnp.uint32)
        return read_k, asm_k

    def _dump_chunk(self, codes, r_tree, a_tree, vm):
        """codes uint8 [C + k - 1] -> per-position readK/asmK + counts.

        Mirrors processDump (merfin-dump.C:21-68).  K* is computed on the
        host from the fetched readK/asmK (k_metric_np): one less array
        to fetch, and %.2f output is host-f64 exact.  Both are
        integer-valued, so they cross to the host as uint32 (half the
        f64 fetch bytes).
        """
        import jax.numpy as jnp

        read_k, asm_k, prob, valid, overflow, _ = self._lookup_kvals(
            codes, r_tree, a_tree, vm)
        kasm = jnp.sum(valid)
        kmissing = jnp.sum(valid & (read_k == 0))
        return (*self._dump_out(read_k, asm_k), kasm, kmissing, overflow)

    # ---- host streaming ----

    def chunks_of(self, codes: np.ndarray):
        """Yield (start, padded_chunk[C + k - 1]) covering every window."""
        C, k = self.chunk, self.k
        n_pos = max(0, codes.shape[0] - k + 1)
        for start in range(0, max(n_pos, 1), C):
            buf = np.full(C + k - 1, PAD_CODE, dtype=np.uint8)
            piece = codes[start : start + C + k - 1]
            buf[: piece.shape[0]] = piece
            yield start, buf

    def _put_hist_inputs(self, codes_b: np.ndarray):
        """Pack one batch and START its host->device transfer
        (jax.device_put).  Runs on the prefetch thread so the transfer
        of batch i+1 overlaps batch i's device compute."""
        import jax

        if self.pack_transfer:
            from merfin_tpu.kcore.pack import pack_transfer_np

            planes, vbits = pack_transfer_np(codes_b)
            return (jax.device_put(planes), jax.device_put(vbits))
        return (jax.device_put(codes_b),)

    def hist_sequence(self, codes: np.ndarray) -> tuple[SeqStats, np.ndarray, np.ndarray]:
        """Full -hist stats for one sequence's code array.

        The per-batch results fold into a device-resident state and the
        host fetches ONCE per sequence; input packing + transfer runs 2
        batches ahead on a prefetch thread.  Together the dispatch loop
        never blocks on the link: transfer(i+1) || compute(i), no fetch
        round trip per batch.
        """
        stats = SeqStats()
        undr = np.zeros(self.nbins, dtype=np.int64)
        over = np.zeros(self.nbins, dtype=np.int64)
        if codes.shape[0] < self.k:
            return stats, undr, over

        def packed_batches():
            batch_buf = []
            for _, buf in self.chunks_of(codes):
                batch_buf.append(buf)
                if len(batch_buf) == self.batch:
                    yield self._put_hist_inputs(np.stack(batch_buf))
                    batch_buf = []
            if batch_buf:
                # pad with all-invalid rows to keep one compiled shape
                while len(batch_buf) < self.batch:
                    batch_buf.append(np.full(self.chunk + self.k - 1,
                                             PAD_CODE, np.uint8))
                yield self._put_hist_inputs(np.stack(batch_buf))

        from merfin_tpu.utils.prefetch import prefetch_iter

        state = self._zero_hist_state()
        step_args = self._step_args()
        bins = self.bin_table.device_arrays()
        for inputs in prefetch_iter(packed_batches(), depth=2):
            state = self._hist_step_impl(state, *inputs, *step_args, bins)

        (kasm, kmissing, kover_fb, uh, oh, max_idx,
         overflow, fallbacks, kc, kn, kr, kfbc) = state
        if int(max_idx) >= self.nbins:
            raise BinOverflow(int(max_idx), self.nbins)
        # diagnostics counted only on success (grow-and-retry re-runs
        # the sequence; counting before the raise would double it)
        self.overflow_values += int(overflow)
        self.bin_fallbacks += int(fallbacks)
        stats.kasm = int(kasm)
        stats.kmissing = int(kmissing)
        stats.kover_cpy = self._finish_kover(kover_fb, kc, kn, kr, kfbc)
        undr += np.asarray(uh)
        over += np.asarray(oh)
        return stats, undr, over

    def dump_sequence(self, codes: np.ndarray):
        """Yield (start, readK, asmK, kmetric, kasm, kmissing) per chunk.

        Keeps 2 dispatches in flight: chunk i+1's transfer + device
        compute overlaps chunk i's result fetch (the dump analog of the
        hist pipelining; without it every chunk pays the full device
        round trip)."""
        from collections import deque

        from merfin_tpu.score.kstar import k_metric_np

        if codes.shape[0] < self.k:
            return
        n_pos = codes.shape[0] - self.k + 1

        def finalize(start, out):
            rk, ak, kasm, kmis, overflow = out
            self.overflow_values += int(overflow)
            n = min(self.chunk, n_pos - start)
            rk = np.asarray(rk)[:n].astype(np.float64, copy=False)
            ak = np.asarray(ak)[:n].astype(np.float64, copy=False)
            return (start, rk, ak, k_metric_np(rk, ak), int(kasm), int(kmis))

        pending: deque = deque()
        for start, buf in self.chunks_of(codes):
            pending.append((start, self._dump_step(buf)))
            if len(pending) > 2:
                yield finalize(*pending.popleft())
        while pending:
            yield finalize(*pending.popleft())
