"""Device-fused variant-path scoring with on-device reduction.

The host scorer runs table lookups on device and the per-kmer K*/delta
math in exact IEEE f64 numpy (variants/score.py).  This module fuses the
WHOLE per-path pipeline — k-mer extraction, dual exact lookup, getK, the
new-kmer asmK+1 adjustment, |K*|, delta-multiplicity AND the per-path
reduction — into one jitted dispatch over the packed path stream
(varMer::score semantics, varMer.C:76-135, as a flat array program).
Selectors stay on the host.

The selectors never consume per-window values: they need only each
path's missing count numM and (for -polish ties) the delta sum totdk
(varMer.C:150-467,648-659).  So the device program reduces to TWO
scalars per path with sorted segment sums and ships [P] arrays back —
16 bytes/path instead of 16 bytes/WINDOW (a 32768-path comb=15 cluster
returns 512 KB instead of ~270 MB).

Exactness: numM is exact on every backend — it is an integer segment
count, with the always-missing separator/tail windows subtracted on the
host from known span arithmetic.  The -filter/-better/-strict/-loose
selectors consume ONLY numM and sequence lengths, so fused device
scoring is byte-identical for those modes and is the default there.
-polish tie-breaks compare (int-truncated) f64 sums of dkstr
(varMer.C:427-447): with a -prob table the device segment sum may
differ from the host scorer's np.sum in final ulps (another summation
order), so -polish with -prob keeps the host scorer unless -devscore is
given; without one the sums are integers and exact.

DeviceScorer probes single-device gather tables; ShardedScorer runs the
same program under shard_map over a ("d", "t") mesh, probing table
shards resident across the mesh's HBM and combining with one psum over
the "t" axis (the lookup tables never exist on any single chip).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from merfin_tpu.config import ensure_x64
from merfin_tpu.ops.kmer_ops import kmer_windows, canonical_and_mult
from merfin_tpu.score.kstar import ProbTable
from merfin_tpu.score.value_map import ValueMap


def _planes_from_bits(adj_bits, mark_bits, n, need_start: bool):
    """Unpack the adjust bitmask and path-start marks shipped across the
    link (1 bit/window each instead of 1+8 bytes).  Returns (adjust
    bool [n], path_start int64 [n] | None): path_start[i] is the window
    index of i's path start (the stale-prob forward-fill reset
    boundary) — only materialized when a -prob table makes the fill
    necessary (need_start), its cummax scan is the single most
    expensive op of the no-prob program otherwise."""
    import jax
    import jax.numpy as jnp

    bsh = jnp.arange(8, dtype=jnp.uint8)
    adjust = ((adj_bits[:, None] >> bsh) & jnp.uint8(1)
              ).reshape(-1)[:n].astype(bool)
    if not need_start:
        return adjust, None
    mk = ((mark_bits[:, None] >> bsh) & jnp.uint8(1)).reshape(-1)[:n]
    midx = jnp.arange(n, dtype=jnp.int64)
    path_start = jax.lax.cummax(jnp.where(mk == 1, midx, jnp.int64(-1)))
    return adjust, path_start


def _stream_math(value_map, vm, read_v, asm_v, valid, adjust, path_start):
    """getK + K*/delta math on the flat window axis (device mirror of
    score._flat_math).

    Integer fast path (vm[0] is an i32 readK map — see
    ValueMap.device_arrays_scorer): missing and the delta-multiplicity
    difference |readK-asmK| - |readK-asmK'| are pure i64 arithmetic,
    exactly the host scorer's values (its f64 holds the same integers),
    and skip the f64 elementwise chain entirely."""
    import jax
    import jax.numpy as jnp

    rk_map = vm[0]
    if jnp.issubdtype(rk_map.dtype, jnp.integer):
        idx = jnp.minimum(read_v.astype(jnp.int64), value_map.vcap)
        read_i = jnp.where(valid, rk_map[idx].astype(jnp.int64),
                           jnp.int64(0))
        asm_i = jnp.where(valid, asm_v.astype(jnp.int64), jnp.int64(0))
        missing = read_i == 0
        o_delta = jnp.abs(read_i - asm_i)
        n_delta = jnp.abs(read_i - asm_i - adjust.astype(jnp.int64))
        return missing, o_delta - n_delta, jnp.int64(0)

    read_k, prob, overflow = value_map.lookup_jnp(read_v, vm)
    asm_k = asm_v.astype(jnp.float64)
    read_k = jnp.where(valid, read_k, 0.0)
    asm_k = jnp.where(valid, asm_k, 0.0)

    if value_map.has_prob:
        # stale-prob forward fill, reset at path starts (varMer.C:60,84
        # semantics; see score._flat_math)
        n = read_k.shape[0]
        idx = jnp.arange(n, dtype=jnp.int64)
        vi = jnp.where(valid, idx, jnp.int64(-1))
        last = jax.lax.cummax(vi)
        prob_f = jnp.where(last >= path_start,
                           prob[jnp.clip(last, 0, None)], 1.0)
    else:
        # prob is identically 1.0: the fill (and path_start's cummax,
        # now unconsumed) dead-code-eliminates out of the program
        prob_f = 1.0

    missing = read_k == 0
    o_delta = jnp.abs(read_k - asm_k) * prob_f
    asm_adj = asm_k + adjust.astype(jnp.float64)
    n_delta = jnp.abs(read_k - asm_adj) * prob_f
    return missing, o_delta - n_delta, overflow


_RED = 512   # row width of the two-level prefix reduction


def _boundary_reduce(missing, dkstr, b_start, b_end):
    """Per-path (missing count, dkstr sum) as prefix differences at the
    path boundaries — scatter-free and EXACTLY the host scorer's slice
    sums on the integer path: num_m is
    an integer prefix difference, and integer dkstr (no -prob table)
    sums exactly in any association.  With a prob table totdk may
    differ from a direct slice sum in final ulps (device f64 either
    way).

    Prefixes are two-level: a cumsum WITHIN 512-wide rows (vectorized
    across rows, scan depth 9) + a tiny row-total cumsum + 2 small
    gathers per boundary, instead of one full-stream cumsum."""
    import jax.numpy as jnp

    def prefix_fn(x, acc_dtype):
        x2 = x.reshape(-1, _RED).astype(acc_dtype)
        rcs = jnp.cumsum(x2, axis=1)
        crow = jnp.pad(jnp.cumsum(rcs[:, -1]), (1, 0))
        rows = x2.shape[0]

        def at(pos):
            r = jnp.minimum(pos // _RED, rows - 1)
            c = pos - r * _RED   # == _RED at the clamped stream end
            within = jnp.where(c > 0, rcs[r, jnp.maximum(c - 1, 0)],
                               jnp.zeros((), acc_dtype))
            return crow[r] + within

        return at

    d_acc = (jnp.int64 if jnp.issubdtype(dkstr.dtype, jnp.integer)
             else jnp.float64)
    m_at = prefix_fn(missing, jnp.int32)
    d_at = prefix_fn(dkstr, d_acc)
    return m_at(b_end) - m_at(b_start), d_at(b_end) - d_at(b_start)


def _pack_inputs(codes: np.ndarray, adjust: np.ndarray,
                 starts: np.ndarray, nis: np.ndarray, k: int):
    """Host-side transfer packing shared by both scorers: pad the stream
    to a power of two (compiled-shape reuse), 2-bit code planes +
    validity bits, 1-bit adjust/path-start-mark planes, and the padded
    [p_seg] path-boundary index arrays for the device reduction."""
    from merfin_tpu.kcore.pack import pack_transfer_np

    n = max(0, codes.shape[0] - k + 1)
    p = max(4096, 1 << (n - 1).bit_length())
    codes_p = np.full(p + k - 1, 4, dtype=np.uint8)
    codes_p[: codes.shape[0]] = codes
    planes, vbits = pack_transfer_np(codes_p)
    adj_p = np.zeros(p, dtype=bool)
    adj_p[:n] = adjust[:n]
    marks = np.zeros(p, dtype=bool)
    s = starts[:-1]
    marks[s[s < n]] = True
    P = nis.shape[0]
    p_seg = max(64, 1 << (P - 1).bit_length()) if P else 64
    b_start = np.zeros(p_seg, dtype=np.int32)
    b_end = np.zeros(p_seg, dtype=np.int32)
    b_start[:P] = starts[:-1]
    b_end[:P] = starts[:-1] + nis
    return (p, n, planes, vbits,
            np.packbits(adj_p, bitorder="little"),
            np.packbits(marks, bitorder="little"),
            b_start, b_end)


class _FusedScorer:
    """Shared span-chunking driver for DeviceScorer/ShardedScorer.

    One dispatch gathers [windows, rows, W] candidate blocks per table
    (the block lookup strategy, table/lookup.py), so windows per
    dispatch are capped like the engine's gather path (batch x chunk =
    2^21; the take temporaries grow ~4 KB per window).  Streams split
    at PATH boundaries — paths are independent, so per-span
    (num_m, totdk) stitch exactly.
    """

    MAX_WINDOWS = 1 << 21

    def _span_dispatch(self, codes, adjust, starts, nis):
        """Pack + transfer + ASYNC dispatch of one span (no fetch).
        Inputs go to the device by explicit device_put on the calling
        (possibly worker) thread, so the transfer overlaps other work."""
        import jax

        p, n, planes, vbits, adj_bits, mark_bits, b_start, b_end = \
            _pack_inputs(codes, adjust, starts, nis, self.k)
        args = [jax.device_put(a) for a in
                (planes, vbits, adj_bits, mark_bits, b_start, b_end)]
        return nis.shape[0], self._dispatch(p, *args)

    def _span_fetch(self, handle):
        P, (num_m, totdk, overflow) = handle
        self.overflow_values += int(overflow)
        return (np.asarray(num_m)[:P].astype(np.int64),
                np.asarray(totdk)[:P])

    # DeviceScorer overlaps span pack+transfer on worker threads; the
    # sharded scorer must keep collective dispatch order, so it stays
    # serial (shard_map psums from racing threads could interleave)
    _THREADED_SPANS = False
    _span_ex = None

    def _get_span_ex(self):
        if self._span_ex is None:
            from concurrent.futures import ThreadPoolExecutor

            self._span_ex = ThreadPoolExecutor(max_workers=2)
        return self._span_ex

    def dispatch_paths(self, codes: np.ndarray, adjust: np.ndarray,
                       starts: np.ndarray, nis: np.ndarray):
        """ASYNC half of score_paths: pack + dispatch every span, return
        an opaque token for fetch_paths.  Lets callers keep whole
        batches in flight while the host prepares the next one
        (score.dispatch_blocks / modes.variants pipelining).  On the
        threaded path the per-span host pack + device_put runs on a
        small executor, so span i+1's transfer prep overlaps span i's
        dispatch AND the caller's other host work."""
        P = nis.shape[0]
        n = max(0, codes.shape[0] - self.k + 1)
        if n == 0 or P == 0:
            return (P, [])
        spans = []
        i = 0
        while i < P:
            j = i + 1
            while j < P and starts[j + 1] - starts[i] <= self.MAX_WINDOWS:
                j += 1
            spans.append((i, j, int(starts[i]), int(starts[j])))
            i = j
        if self._THREADED_SPANS and len(spans) > 1:
            ex = self._get_span_ex()
            handles = [(i, j, ex.submit(
                self._span_dispatch, codes[a:b], adjust[a:b],
                starts[i: j + 1] - a, nis[i:j]))
                for i, j, a, b in spans]
            return (P, handles)
        handles = [(i, j, self._span_dispatch(
            codes[a:b], adjust[a:b], starts[i: j + 1] - a, nis[i:j]))
            for i, j, a, b in spans]
        return (P, handles)

    def fetch_paths(self, token):
        """Blocking half: (num_m int64 [P], totdk f64 [P]).

        Multi-span tokens on the threaded path fuse every span's padded
        results into ONE u64 stream on device and fetch it with a
        single transfer: per-span np.asarray calls each pay a device
        round trip, a fused fetch pays one.  totdk crosses as its raw
        64-bit pattern (i64 on the integer path, f64 otherwise) and is
        converted to f64 on the host."""
        P, handles = token
        resolved = []
        for i, j, h in handles:
            if hasattr(h, "result"):   # threaded span dispatch
                h = h.result()
            resolved.append((i, j, h))
        num_m = np.zeros(P, np.int64)
        totdk = np.zeros(P)
        if len(resolved) > 1 and self._THREADED_SPANS:
            import jax
            import jax.numpy as jnp

            parts = []
            for _, _, (Pn, (nm, td, ov)) in resolved:
                parts += [nm.astype(jnp.uint64),
                          jax.lax.bitcast_convert_type(td, jnp.uint64),
                          ov.astype(jnp.uint64).reshape(1)]
            flat = np.asarray(jnp.concatenate(parts))   # ONE fetch
            off = 0
            for i, j, (Pn, (nm, td, ov)) in resolved:
                w = int(nm.shape[0])
                num_m[i:j] = flat[off: off + Pn].astype(np.int64)
                totdk[i:j] = flat[off + w: off + w + Pn].view(
                    np.dtype(td.dtype)).astype(np.float64)
                self.overflow_values += int(flat[off + 2 * w])
                off += 2 * w + 1
            return num_m, totdk
        for i, j, h in resolved:
            nm, td = self._span_fetch(h)
            num_m[i:j] = nm
            totdk[i:j] = td
        return num_m, totdk

    def score_paths(self, codes: np.ndarray, adjust: np.ndarray,
                    starts: np.ndarray, nis: np.ndarray):
        """Numpy-in/numpy-out: (num_m int64 [P], totdk f64 [P]).
        All spans dispatch before the first fetch, so span i+1's
        transfer + compute overlaps span i's result round trip."""
        return self.fetch_paths(self.dispatch_paths(codes, adjust,
                                                    starts, nis))


class DeviceScorer(_FusedScorer):
    """Scores packed candidate-path streams in one device dispatch."""

    _THREADED_SPANS = True

    def __init__(self, read_lookup, asm_lookup, k: int, peak: float,
                 prob_table: ProbTable | None, max_value: int | None = None,
                 exact_max: bool = False):
        ensure_x64()
        import jax

        self.k = k
        self.read_lookup = read_lookup
        self.asm_lookup = asm_lookup
        self.value_map = ValueMap(peak, prob_table, max_value or (1 << 19),
                                  exact_max=exact_max)
        self.overflow_values = 0
        self._impl = jax.jit(self._score_stream, static_argnums=0)

    def _score_stream(self, n, trees, vm, planes, vbits,
                      adj_bits, mark_bits, b_start, b_end):
        """Packed path stream -> (num_m [p_seg], totdk [p_seg], overflow).

        planes/vbits: 2-bit codes + validity of the packed path stream
        (kcore.pack.pack_transfer_np of codes u8 [n + k - 1], paths
        separated by k-1 invalid bases); adj_bits/mark_bits: 1-bit
        planes (see _planes_from_bits); b_start/b_end: padded [p_seg]
        window-index boundaries of each path.  With the 2-bit codes this
        is ~16x fewer input bytes than u8 codes + i64 path_start, and
        the per-path reduction ships ~windows/paths x fewer bytes back.
        """
        from merfin_tpu.ops.kmer_ops import unpack_transfer

        codes = unpack_transfer(planes, vbits, n + self.k - 1)
        adjust, path_start = _planes_from_bits(adj_bits, mark_bits, n,
                                               self.value_map.has_prob)
        fmer, rmer, valid = kmer_windows(codes, self.k)
        canon, mult = canonical_and_mult(fmer, rmer)
        r_tree, a_tree = trees
        read_v = self.read_lookup.lookup_with(
            r_tree, canon).astype(np.uint64) * mult
        asm_v = self.asm_lookup.lookup_with(
            a_tree, canon).astype(np.uint64) * mult
        missing, dkstr, overflow = _stream_math(
            self.value_map, vm, read_v, asm_v, valid, adjust, path_start)
        num_m, totdk = _boundary_reduce(missing, dkstr, b_start, b_end)
        return num_m, totdk, overflow

    def _dispatch(self, p, planes, vbits, adj_bits, mark_bits,
                  b_start, b_end):
        trees = (self.read_lookup.tree(), self.asm_lookup.tree())
        return self._impl(
            p, trees,
            self.value_map.device_arrays_scorer(), planes, vbits,
            adj_bits, mark_bits, b_start, b_end)


class ShardedScorer(_FusedScorer):
    """Fused scoring over mesh-sharded lookup tables (-devscore -mesh).

    The query stream is replicated across the mesh; every device probes
    its local sorted table shard and the partial values combine with one
    psum over the "t" axis (exactly parallel.sharded.ShardedLookup's
    probe), then the K*/delta math and per-path reduction run
    replicated.  The "d" axis adds table memory headroom, not variant
    throughput — matching the spans design where every rank evaluates
    every cluster (modes/variants.py)."""

    def __init__(self, mesh, read_sharded, asm_sharded, k: int, peak: float,
                 prob_table: ProbTable | None, max_value: int | None = None,
                 exact_max: bool = False):
        ensure_x64()
        self.k = k
        self.mesh = mesh
        self.read_sharded = read_sharded
        self.asm_sharded = asm_sharded
        self.value_map = ValueMap(peak, prob_table, max_value or (1 << 19),
                                  exact_max=exact_max)
        self.overflow_values = 0
        self._runs: dict[int, object] = {}  # padded window count -> step

    def _build(self, p: int):
        """Jitted shard_map step for padded window count ``p`` (cached:
        _pack_inputs quantizes to powers of two, so a run compiles a
        handful of shapes)."""
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from merfin_tpu.parallel.sharded import dual_probe_local
        from merfin_tpu.ops.kmer_ops import unpack_transfer

        value_map = self.value_map
        k = self.k
        rs, As = self.read_sharded, self.asm_sharded

        @partial(
            shard_map, mesh=self.mesh, check_vma=False,
            in_specs=(*rs.in_specs(), *As.in_specs(),
                      P(), P(), P(), P(), P(), P(), P(), P()),
            out_specs=(P(), P(), P()),
        )
        def step(rt0, rt1, at0, at1, vm_rk, vm_pr, planes, vbits,
                 adj_bits, mark_bits, b_start, b_end):
            codes = unpack_transfer(planes, vbits, p + k - 1)
            adjust, path_start = _planes_from_bits(adj_bits, mark_bits, p,
                                                   value_map.has_prob)
            fmer, rmer, valid = kmer_windows(codes, k)
            # window-ordered: the per-window math (adjust plane,
            # stale-prob fill, path boundaries) needs positions
            read_v, asm_v, valid = dual_probe_local(
                rs, As, (rt0, rt1), (at0, at1), fmer, rmer, valid, k)
            missing, dkstr, overflow = _stream_math(
                value_map, (vm_rk, vm_pr), read_v, asm_v, valid, adjust,
                path_start)
            num_m, totdk = _boundary_reduce(missing, dkstr, b_start, b_end)
            return num_m, totdk, overflow

        rk_dev, pr_dev = value_map.device_arrays_scorer()
        jstep = jax.jit(step)

        def run(planes, vbits, adj_bits, mark_bits, b_start, b_end):
            return jstep(*rs.arrays, *As.arrays,
                         rk_dev, pr_dev, planes, vbits, adj_bits, mark_bits,
                         b_start, b_end)

        return run

    def _dispatch(self, p, planes, vbits, adj_bits, mark_bits,
                  b_start, b_end):
        run = self._runs.get(p)
        if run is None:
            run = self._runs[p] = self._build(p)
        return run(planes, vbits, adj_bits, mark_bits, b_start, b_end)
