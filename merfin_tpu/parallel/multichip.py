"""The full multi-chip -hist/-dump step: data-parallel chunks over the
"d" mesh axis, table-parallel lookups over "t", collective-merged
accumulators — one collective program for merfin's entire parallel stack
(sweatShop pipeline + OpenMP + Slurm scatter-gather, SURVEY.md §2.3).

Each device holds one table shard and one slice of the chunk batch.
Per-(chunk, kmer) values come from a psum over "t"; per-device partial
histograms/counters then psum over BOTH axes into replicated globals —
exactly the reference's writer-thread merge (merfin-histogram.C:110-124)
as a collective reduction.

Correctness contract: the sharded steps compute the SAME function as the
single-device engine (modes/engine.py) on hostile inputs too — raw values
above the ValueMap cap take the counted device-float fallback, and
histogram bins outside the exact tables take the counted float fallback
with the NBINS guard surfaced to the caller.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from merfin_tpu.modes.engine import (NBINS, fold_hist_state,  # noqa: F401  (zero_hist_state re-exported for step callers)
                                     two_hist_by_sort, zero_hist_state)
from merfin_tpu.ops.kmer_ops import (kmer_windows, canonical_and_mult,  # noqa: F401  (canonical_and_mult re-exported for step callers)
                                     unpack_transfer, seg_from_marks)
from merfin_tpu.parallel.sharded import ShardedLookup, dual_probe_local
from merfin_tpu.score.kover import kover_parts


def make_hist_step(
    mesh,
    read_lookup: ShardedLookup,
    asm_lookup: ShardedLookup,
    k: int,
    value_map,
    asm_max_value: int | None = None,
    bin_table=None,
    pack_chunk: int | None = None,
    nbins: int = NBINS,
    kover_vmaxp: int = 0,
):
    """Build a jitted step: codes uint8 [B, C + k - 1] (B sharded over
    "d") -> replicated hist-state increments (zero_hist_state layout:
    counts, histograms, exact-kover integer parts + counted fallbacks).

    value_map: merfin_tpu.score.value_map.ValueMap — getK precomputed on
    the host (exact) and gathered on device; raw values above the cap use
    the counted device-float fallback (value_map.lookup_jnp), identical to
    the single-device path (modes/engine.py:_lookup_kvals).

    pack_chunk: when set (= the engine's chunk C), the step takes
    transfer-packed (planes, vbits) instead of codes (see
    kcore.pack.pack_transfer_np) and unpacks per shard — bit-exact,
    2.7x fewer host->device bytes.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from merfin_tpu.score.bin_table import BinTable

    bin_table = bin_table or BinTable()
    # even-k palindromes double the probed values (merfin-globals.C:101-110)
    a_max_eff = (asm_max_value * (2 if k % 2 == 0 else 1)
                 if asm_max_value is not None else None)
    data_specs = (P("d", None),) if pack_chunk is None else (
        P("d", None), P("d", None))

    @partial(
        shard_map,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            *read_lookup.in_specs(),      # read table shard
            *asm_lookup.in_specs(),       # asm table shard
            P(), P(),                     # value map (replicated)
            P(), P(),                     # bin tables (replicated)
            *data_specs,                  # chunk batch sharded on d
        ),
        out_specs=(P(),) * 12,
    )
    def step(rt0, rt1, at0, at1, rk_map, pr_map,
             undr_t, over_t, *data):
        if pack_chunk is None:
            codes, = data
        else:
            codes = unpack_transfer(data[0], data[1], pack_chunk + k - 1)
        fmer, rmer, valid = kmer_windows(codes, k)
        read_v, asm_v, valid = dual_probe_local(
            read_lookup, asm_lookup, (rt0, rt1), (at0, at1),
            fmer, rmer, valid, k)

        read_k, prob, overflow = value_map.lookup_jnp(read_v, (rk_map, pr_map))
        asm_k = asm_v.astype(jnp.float64)
        read_k = jnp.where(valid, read_k, 0.0)
        asm_k = jnp.where(valid, asm_k, 0.0)

        missing = valid & (read_k == 0)
        is_undr = valid & (read_k > 0) & (asm_k > read_k)
        is_over = valid & (read_k > 0) & ~is_undr

        kasm = jnp.sum(valid)
        kmissing = jnp.sum(missing)
        kc, kn, kr, kover_fb, kfbc = kover_parts(
            read_v, read_k, asm_k, prob, is_undr, kover_vmaxp,
            bin_table.amax, r_max=value_map.readk_bound(),
            a_max=a_max_eff)

        undr_idx, over_idx, bin_exact = bin_table.lookup_jnp(
            read_k, asm_k, (undr_t, over_t))
        fallbacks = jnp.sum((is_undr | is_over) & ~bin_exact)
        max_idx = jnp.maximum(
            jnp.max(jnp.where(is_undr, undr_idx, 0)),
            jnp.max(jnp.where(is_over, over_idx, 0)),
        )
        undr_hist, over_hist = two_hist_by_sort(
            undr_idx, over_idx, is_undr, is_over, nbins)

        # Merge the data-parallel partials.  After the value psum over
        # "t", every t-shard of a d-row computed identical partials, so a
        # psum over "d" alone yields the global value, already replicated
        # across "t" (satisfying the replicated out_specs).
        return (jax.lax.psum(kasm, "d"), jax.lax.psum(kmissing, "d"),
                jax.lax.psum(kover_fb, "d"),
                jax.lax.psum(undr_hist, "d"), jax.lax.psum(over_hist, "d"),
                jax.lax.pmax(max_idx, "d"), jax.lax.psum(overflow, "d"),
                jax.lax.psum(fallbacks, "d"), jax.lax.psum(kc, "d"),
                jax.lax.psum(kn, "d"), jax.lax.psum(kr, "d"),
                jax.lax.psum(kfbc, "d"))

    rk_dev, pr_dev = value_map.device_arrays()
    undr_dev, over_dev = bin_table.device_arrays()

    # Table arrays ride as jit ARGUMENTS, never closure constants: on a
    # host-spanning mesh a shard may live on another process (closing
    # over a non-addressable jax.Array is an error).
    jrun = jax.jit(
        lambda rk_k, rk_v, as_k, as_v, state, *data: fold_hist_state(
            state, step(rk_k, rk_v, as_k, as_v,
                        rk_dev, pr_dev, undr_dev, over_dev, *data)),
        donate_argnums=4)

    def run(state, *data):
        return jrun(*read_lookup.arrays, *asm_lookup.arrays, state, *data)

    return run


def make_hist_group_step(
    mesh,
    read_lookup: ShardedLookup,
    asm_lookup: ShardedLookup,
    k: int,
    value_map,
    asm_max_value: int | None = None,
    bin_table=None,
    pack_chunk: int | None = None,
    nbins: int = NBINS,
    kover_vmaxp: int = 0,
):
    """Packed-group -hist over the mesh: codes [B, C + k - 1] and seg
    [B, C] sharded over "d" -> replicated (kasm_seg[SEG_MAX],
    kmis_seg[SEG_MAX], kover, undr, over, max_idx, overflow, fallbacks)
    — the fragmented-assembly packing (modes/engine.py:hist_group) on
    the sharded table.

    pack_chunk (= C): the step takes transfer-packed (planes, vbits,
    marks_bits, base) from modes.engine.pack_group_transfer instead of
    (codes, seg) — bit-exact, ~10x fewer host->device bytes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from merfin_tpu.modes.engine import SEG_MAX
    from merfin_tpu.score.bin_table import BinTable

    bin_table = bin_table or BinTable()
    a_max_eff = (asm_max_value * (2 if k % 2 == 0 else 1)
                 if asm_max_value is not None else None)
    data_specs = (P("d", None), P("d", None)) if pack_chunk is None else (
        P("d", None), P("d", None), P("d", None), P("d"))

    @partial(
        shard_map,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            *read_lookup.in_specs(),
            *asm_lookup.in_specs(),
            P(), P(), P(), P(),
            *data_specs,
        ),
        out_specs=(P(),) * 12,
    )
    def step(rt0, rt1, at0, at1, rk_map, pr_map,
             undr_t, over_t, *data):
        if pack_chunk is None:
            codes, seg = data
        else:
            codes = unpack_transfer(data[0], data[1], pack_chunk + k - 1)
            seg = seg_from_marks(data[2], data[3], pack_chunk)
        fmer, rmer, valid = kmer_windows(codes, k)
        read_v, asm_v, valid = dual_probe_local(
            read_lookup, asm_lookup, (rt0, rt1), (at0, at1),
            fmer, rmer, valid, k)
        seg = seg.reshape(-1)

        read_k, prob, overflow = value_map.lookup_jnp(read_v, (rk_map, pr_map))
        asm_k = asm_v.astype(jnp.float64)
        read_k = jnp.where(valid, read_k, 0.0)
        asm_k = jnp.where(valid, asm_k, 0.0)

        missing = valid & (read_k == 0)
        is_undr = valid & (read_k > 0) & (asm_k > read_k)
        is_over = valid & (read_k > 0) & ~is_undr

        # shared sort-based seg reduction (modes/engine.py)
        from merfin_tpu.modes.engine import seg_counts_by_sort

        kasm_seg, kmis_seg = seg_counts_by_sort(
            seg.astype(jnp.int32), valid, missing)

        kc, kn, kr, kover_fb, kfbc = kover_parts(
            read_v, read_k, asm_k, prob, is_undr, kover_vmaxp,
            bin_table.amax, r_max=value_map.readk_bound(),
            a_max=a_max_eff)

        undr_idx, over_idx, bin_exact = bin_table.lookup_jnp(
            read_k, asm_k, (undr_t, over_t))
        fallbacks = jnp.sum((is_undr | is_over) & ~bin_exact)
        max_idx = jnp.maximum(
            jnp.max(jnp.where(is_undr, undr_idx, 0)),
            jnp.max(jnp.where(is_over, over_idx, 0)),
        )
        undr_hist, over_hist = two_hist_by_sort(
            undr_idx, over_idx, is_undr, is_over, nbins)

        return (jax.lax.psum(kasm_seg, "d"), jax.lax.psum(kmis_seg, "d"),
                jax.lax.psum(kover_fb, "d"), jax.lax.psum(undr_hist, "d"),
                jax.lax.psum(over_hist, "d"), jax.lax.pmax(max_idx, "d"),
                jax.lax.psum(overflow, "d"), jax.lax.psum(fallbacks, "d"),
                jax.lax.psum(kc, "d"), jax.lax.psum(kn, "d"),
                jax.lax.psum(kr, "d"), jax.lax.psum(kfbc, "d"))

    rk_dev, pr_dev = value_map.device_arrays()
    undr_dev, over_dev = bin_table.device_arrays()

    # table as jit args (host-spanning shards are non-addressable)
    jrun = jax.jit(lambda rk_k, rk_v, as_k, as_v, *data: step(
        rk_k, rk_v, as_k, as_v, rk_dev, pr_dev, undr_dev, over_dev,
        *data))

    def run(*data):
        return jrun(*read_lookup.arrays, *asm_lookup.arrays, *data)

    return run


def make_completeness_step(mesh, asm_lookup: ShardedLookup, value_map):
    """Build a jitted -completeness step: read-DB rows (keys, vals, mask)
    [D, B] sharded over "d", assembly table sharded over "t" ->
    replicated (total readK, undr copies).

    The reference merge-joins 64 sorted DB streams under OpenMP
    (merfin-completeness.C:65-121); here each batch of read-DB rows looks
    up its assembly value against the t-sharded table (asm-only k-mers
    are never visited, matching the reference's skip at :100-109) and the
    partial sums ride one psum.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    @partial(
        shard_map,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            *asm_lookup.in_specs(),       # asm table shard
            P(), P(),                     # value map (replicated)
            P("d", None), P("d", None), P("d", None),
        ),
        out_specs=(P(), P()),
    )
    def step(at0, at1, rk_map, pr_map, rkeys, rvals, rmask):
        # read-DB rows arrive ALREADY sorted per device (MKDB slices are
        # sorted on disk, padding keys are u64::MAX): a coherent search
        asm_v = jax.lax.psum(asm_lookup.probe_local(
            (at0, at1), rkeys.reshape(-1)), "t").reshape(rkeys.shape)
        read_k, _, _ = value_map.lookup_jnp(
            rvals.astype(jnp.uint64), (rk_map, pr_map))
        asm_k = asm_v.astype(jnp.float64)
        read_k = jnp.where(rmask, read_k, 0.0)
        asm_k = jnp.where(rmask, asm_k, 0.0)
        total = jnp.sum(read_k)
        undrc = jnp.sum(jnp.where(read_k > asm_k, read_k - asm_k, 0.0))
        return jax.lax.psum(total, "d"), jax.lax.psum(undrc, "d")

    rk_dev, pr_dev = value_map.device_arrays()

    # table as jit args (host-spanning shards are non-addressable)
    jrun = jax.jit(lambda as_k, as_v, rkeys, rvals, rmask: step(
        as_k, as_v, rk_dev, pr_dev, rkeys, rvals, rmask))

    def run(rkeys, rvals, rmask):
        return jrun(*asm_lookup.arrays, rkeys, rvals, rmask)

    return run


def make_dump_step(
    mesh,
    read_lookup: ShardedLookup,
    asm_lookup: ShardedLookup,
    k: int,
    value_map,
    pack_chunk: int | None = None,
):
    """Build a jitted -dump step: codes uint8 [B, C + k - 1] (B sharded
    over "d") -> per-position (readK, asmK, K*) arrays [B, C] sharded over
    "d" plus replicated (kasm, kmissing, overflow).

    Positional outputs stay sharded along "d": the host gathers rows in
    order, so the in-order writer contract of -dump (merfin.C:384) holds.
    kasm/kmissing come back PER ROW (a batch spans several chunks of one
    sequence and the writer needs per-chunk counts).

    pack_chunk: when set (= C), takes transfer-packed (planes, vbits)
    instead of codes — bit-exact, 2.7x fewer host->device bytes.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    data_specs = (P("d", None),) if pack_chunk is None else (
        P("d", None), P("d", None))

    @partial(
        shard_map,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            *read_lookup.in_specs(),
            *asm_lookup.in_specs(),
            P(), P(),
            *data_specs,
        ),
        out_specs=(P("d", None), P("d", None),
                   P("d"), P("d"), P()),
    )
    def step(rt0, rt1, at0, at1, rk_map, pr_map, *data):
        if pack_chunk is None:
            codes, = data
        else:
            codes = unpack_transfer(data[0], data[1], pack_chunk + k - 1)
        fmer, rmer, valid = kmer_windows(codes, k)
        shape = fmer.shape
        # positional: dump emits per-position rows (merfin.C:384)
        read_v, asm_v, valid_f = dual_probe_local(
            read_lookup, asm_lookup, (rt0, rt1), (at0, at1),
            fmer, rmer, valid, k)
        read_v = read_v.reshape(shape)
        asm_v = asm_v.reshape(shape)
        valid = valid_f.reshape(shape)

        read_k, prob, overflow = value_map.lookup_jnp(read_v, (rk_map, pr_map))
        asm_k = asm_v.astype(jnp.float64)
        read_k = jnp.where(valid, read_k, 0.0)
        asm_k = jnp.where(valid, asm_k, 0.0)

        kasm = jnp.sum(valid, axis=1)
        kmissing = jnp.sum(valid & (read_k == 0), axis=1)

        overflow = jax.lax.psum(overflow, "d")
        # K* is computed on the host from readK/asmK (see the
        # single-device _dump_chunk): less traffic, host-f64 exact.
        # Integer-valued positional planes fetch as uint32 when they
        # provably fit (shared gate: ValueMap.fits_u32).
        if value_map.fits_u32(k):
            read_k = read_k.astype(jnp.uint32)
            asm_k = asm_k.astype(jnp.uint32)
        return read_k, asm_k, kasm, kmissing, overflow

    rk_dev, pr_dev = value_map.device_arrays()

    # table as jit args (host-spanning shards are non-addressable)
    jrun = jax.jit(lambda rk_k, rk_v, as_k, as_v, *data: step(
        rk_k, rk_v, as_k, as_v, rk_dev, pr_dev, *data))

    def run(*data):
        return jrun(*read_lookup.arrays, *asm_lookup.arrays, *data)

    return run
