"""Benchmark: merfin-tpu throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}, "extra": {...}}

Headline: exact k-mer lookups/second through DeviceLookup's block
gather (the probe every merfin mode runs by default, SURVEY.md §3.2),
vs a single-core numpy searchsorted
baseline (the reference engine's probe is a comparable single-threaded
memory-latency-bound lookup; the reference publishes no numbers,
BASELINE.md).  It refuses to run without a GPU.

extra carries the mode-level numbers:
  join_<form>_lookups_per_sec   each kept probe form (sort + searchsorted,
                                DeviceLookup block), device-resident
                                queries, best of rounds
  hist_bases_per_sec            end-to-end -hist engine throughput
  variant_clusters_per_sec      end-to-end variant evaluation (host
                                scorer)
  variant_clusters_per_sec_devscore  the CLI's -polish default (fused
                                device scoring)
  cpu_lookups_per_sec           the baseline probe rate

Env knobs: BENCH_LOG_TABLE/BENCH_LOG_QUERY (default 23), BENCH_SKIP_MODES=1
to print only the headline.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np


def _bench_join(keys, vals, k, q_np, iters=8, rounds=2):
    """Best-of-``rounds`` lookups/s per kept probe form on device-resident
    queries; each form is checked for exact equality with HostLookup."""
    import jax
    import jax.numpy as jnp

    from merfin_tpu.ops.sortjoin import probe_sorted
    from merfin_tpu.table.lookup import DeviceLookup, HostLookup

    want = HostLookup(keys, vals)(q_np)
    kd, vd = jnp.asarray(keys), jnp.asarray(vals)
    dl = DeviceLookup(keys, vals, k)
    forms = {
        # sort + probe: a sorted probe's whole cost on unsorted queries
        "searchsorted": (jax.jit(lambda a, b, q: probe_sorted(a, b,
                                                              jnp.sort(q))),
                         (kd, vd), np.sort(q_np)),
        "block": (jax.jit(dl.lookup_with), (dl.tree(),), want),
    }
    q = jnp.asarray(q_np)
    rates, spread = {}, {}
    for name, (fn, tabs, expect) in forms.items():
        got = np.asarray(fn(*tabs, q)).astype(np.uint64)   # compile + check
        if name != "block":
            expect = HostLookup(keys, vals)(expect)
        if not np.array_equal(got, expect):
            raise AssertionError(f"join {name}: values differ from host")
        rs = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*tabs, q)
            jax.block_until_ready(out)
            rs.append(q_np.size * iters / (time.perf_counter() - t0))
        rates[name] = max(rs)
        spread[name] = (min(rs), max(rs))
    return rates, spread


def _best_of(fn, rounds=3):
    """max / (min, max) of ``rounds`` calls of a rate-returning fn."""
    rs = [fn() for _ in range(rounds)]
    return max(rs), (min(rs), max(rs))


def _bench_hist(keys, read_vals, asm_vals, k, n_bases=1 << 25):
    """End-to-end -hist engine rate (bases/s) on a synthetic chunk set,
    in the CLI's default configuration (cli.py:make_engine).  Returns a
    closure so the caller can best-of-N it."""
    from merfin_tpu.modes.engine import KstarEngine
    from merfin_tpu.table.lookup import DeviceLookup

    # max_value/exact_max mirror the CLI (cli.py:make_engine): the
    # scanned DB max compiles the value-map overflow fallback away
    engine = KstarEngine(DeviceLookup(keys, read_vals, k),
                         DeviceLookup(keys, asm_vals, k),
                         k, peak=12.0, chunk=1 << 19,
                         max_value=int(read_vals.max()), exact_max=True,
                         asm_max_value=int(asm_vals.max()))
    rng = np.random.default_rng(3)
    # pipelined dispatches: the rate reflects steady-state throughput
    # with transfer/compute overlap, not one dispatch's round trip
    codes = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    engine.hist_sequence(codes[: (1 << 21) + k])   # warmup/compile

    def run():
        t0 = time.perf_counter()
        engine.hist_sequence(codes)
        return n_bases / (time.perf_counter() - t0)

    return run


def _bench_completeness(keys, read_vals, asm_vals, k):
    """-completeness rate (read-DB k-mers/s): the sorted read stream
    probes the device-resident assembly table (merfin-completeness.C:
    49-143 as a sorted-join, no device sort — MKDB slices are sorted on
    disk).  The asm table is
    built once outside the timer (the CLI's per-process load phase,
    like every other mode bench)."""
    import io

    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.modes.completeness import build_asm_table, run_completeness

    import jax

    from merfin_tpu.modes.completeness import (_block_stats_jit,
                                               _slice_bounds)

    with tempfile.TemporaryDirectory() as td:
        rdb = KmerDB.create(os.path.join(td, "r"), k, keys, read_vals)
        adb = KmerDB.create(os.path.join(td, "a"), k, keys, asm_vals)
        table = build_asm_table(adb)
        run_completeness(rdb, adb, peak=12.0, log=io.StringIO(),
                         asm_table=table)  # warm

        def run():
            t0 = time.perf_counter()
            run_completeness(rdb, adb, peak=12.0, log=io.StringIO(),
                             asm_table=table)
            return keys.size / (time.perf_counter() - t0)

        rate, spread = _best_of(run)

        # resident-stream rate: the same block program on device-resident
        # inputs; the gap to the e2e rate above is host work + transfer
        import jax.numpy as jnp

        B = 1 << 23
        n = keys.size
        k_lo = np.full(B, 0xFFFFFFFF, np.uint32)
        k_hi = np.full(B, 0xFFFF, np.uint16)
        k_lo[:n] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        k_hi[:n] = (keys >> np.uint64(32)).astype(np.uint16)
        qk = np.zeros(B, np.uint8)
        qk[:n] = np.minimum(np.maximum(read_vals // 12, 1), 255)  # readK-like
        lo_d, hi_d, qk_d = map(jax.device_put, (k_lo, k_hi, qk))
        bounds_dev = jnp.asarray(_slice_bounds(k))
        bs_fn = _block_stats_jit(table)
        r = bs_fn(table.tree(), bounds_dev, lo_d, hi_d, qk_d)
        np.asarray(r[0])

        def run_res():
            t0 = time.perf_counter()
            r = bs_fn(table.tree(), bounds_dev, lo_d, hi_d, qk_d)
            np.asarray(r[0]), np.asarray(r[1])
            return n / (time.perf_counter() - t0)

        resident, _ = _best_of(run_res)
    return rate, spread, resident


def _bench_count(k=21, genome_bases=1 << 22, coverage=16, chunk=1 << 23):
    """Device k-mer counting rate (the meryl-count replacement):
    device-RESIDENT accumulation — per-chunk sort+reduce and run
    collapses stay on HBM, only final uniques cross the link.

    The workload is coverage-realistic (a genome read at ``coverage``x
    in 64 kb reads): meryl counts read SETS, where bases >> distinct
    k-mers; counting 1x random bases (the old workload) makes every
    window distinct and measures nothing but the result fetch."""
    from merfin_tpu.count.counter import count_sequences
    from merfin_tpu.io.fasta import CodedSequence

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=genome_bases).astype(np.uint8)
    read_len = 1 << 16
    reads = [CodedSequence(f"r{c}_{o}", genome[o: o + read_len])
             for c in range(coverage)
             for o in range(0, genome_bases, read_len)]
    n_bases = sum(r.codes().shape[0] for r in reads)

    def run():
        t0 = time.perf_counter()
        keys, vals, total = count_sequences(iter(reads), k, chunk=chunk)
        dt = time.perf_counter() - t0
        assert total == sum(r.codes().shape[0] - k + 1 for r in reads)
        assert int(vals.sum()) == total
        return n_bases / dt

    run()                       # warm: compiles chunk/collapse/slice programs
    rate, _ = _best_of(run, rounds=2)
    return rate


def _bench_variants(k=21, n_clusters=1500, spacing=120, devscore=False):
    """End-to-end variant evaluation: clusters/s through run_variants
    (enumeration + scoring + selection, -polish policy).

    devscore=False keeps the host-scorer configuration; devscore=True
    measures the CLI's -polish default (fused device scoring, no -prob),
    whose 1500-cluster world fits ONE span.
    """
    import io
    import random

    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.io.vcf import VcfFile
    from merfin_tpu.modes.variants import run_variants
    from merfin_tpu.table.lookup import DeviceLookup
    from merfin_tpu.variants.device_score import DeviceScorer
    from merfin_tpu.kcore.pack import kmers_from_codes_np, encode_bases

    rng = random.Random(9)
    alt_of = {"A": "C", "C": "G", "G": "T", "T": "A"}
    n = n_clusters * spacing + 2 * k
    genome = "".join(rng.choice("ACGT") for _ in range(n))
    asm = list(genome)
    positions = [spacing * i + k for i in range(n_clusters)]
    for p in positions:
        asm[p] = alt_of[asm[p]]
    asm = "".join(asm)

    def canon_counts(s, mult):
        codes = encode_bases(s)
        f, r, valid = kmers_from_codes_np(codes, k)
        canon = np.minimum(f, r)[valid]
        ks, cs = np.unique(canon, return_counts=True)
        return ks.astype(np.uint64), (cs * mult).astype(np.uint32)

    rk, rv = canon_counts(genome, 30)
    ak, av = canon_counts(asm, 1)
    read_lookup = DeviceLookup(rk, rv, k)
    asm_lookup = DeviceLookup(ak, av, k)
    scorer = DeviceScorer(read_lookup, asm_lookup, k, 30.0, None,
                          max_value=int(rv.max()), exact_max=True) \
        if devscore else None

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "asm.fasta")
        with open(fasta, "w") as f:
            f.write(">c\n" + asm + "\n")
        vcfp = os.path.join(td, "c.vcf")
        with open(vcfp, "w") as f:
            f.write("##fileformat=VCFv4.2\n##contig=<ID=c>\n"
                    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
            for p in positions:
                f.write(f"c\t{p + 1}\t.\t{asm[p]}\t{genome[p]}\t30\tPASS\t.\tGT\t1/1\n")
        # warmup: one full pass primes every compiled shape the timed
        # pass will dispatch (the timed workload's own padded query
        # sizes, not a subset's) so the rate measures steady-state
        # evaluation, not one-time remote compiles
        wv = VcfFile(vcfp, log=io.StringIO())
        wv.merge_clusters(k, 15, False, log=io.StringIO())
        run_variants("polish", SeqFile(fasta), wv, k,
                     read_lookup.lookup_np, asm_lookup.lookup_np,
                     peak=30.0, prob_table=None,
                     out_name=os.path.join(td, "warm"), log=io.StringIO(),
                     scorer=scorer)

        vcf = VcfFile(vcfp, log=io.StringIO())
        vcf.merge_clusters(k, 15, False, log=io.StringIO())
        n_real = sum(len(v) for v in vcf.by_chrom.values())
        t0 = time.perf_counter()
        res = run_variants("polish", SeqFile(fasta), vcf, k,
                           read_lookup.lookup_np, asm_lookup.lookup_np,
                           peak=30.0, prob_table=None,
                           out_name=os.path.join(td, "out"),
                           log=io.StringIO(), scorer=scorer)
        dt = time.perf_counter() - t0
        assert res["records"] == n_clusters, res
    return n_real / dt


def _bench_variants_heavy(k=21, n_clusters=3, n_vars=15, spacing=8):
    """Heavy variant evaluation: clusters of 15 variants (SNPs,
    multiallelic sites, insertions) merged into ONE cluster each
    (spacing < 2k), enumerating 2^11 x 3^4 = 165,888 candidate paths
    per cluster (~24M k-mer windows each) — past the reference's worst
    case before the -comb split (merfin-globals.H:241,
    merfin-variants.C:213-217).

    Measures -polish clusters/s through run_variants twice on the same
    input: with the fused device scorer (device-reduced num_m/totdk),
    and with the host scorer on all cores (2-cluster subset — it runs
    ~10x longer per cluster).  Output equality is checked on the
    common subset.  Returns (device_rate, host_rate, identical).
    """
    import io
    import random

    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.io.vcf import VcfFile
    from merfin_tpu.modes.variants import run_variants
    from merfin_tpu.table.lookup import DeviceLookup
    from merfin_tpu.variants.device_score import DeviceScorer
    from merfin_tpu.kcore.pack import kmers_from_codes_np, encode_bases

    rng = random.Random(17)
    alt_of = {"A": "C", "C": "G", "G": "T", "T": "A"}
    gap = 400                                  # between-cluster spacing > 2k
    n = n_clusters * (n_vars * spacing + gap) + 2 * k
    genome = "".join(rng.choice("ACGT") for _ in range(n))
    asm = list(genome)

    rows = []   # (pos0, REF, ALT-field, GT) in assembly coordinates
    for c in range(n_clusters):
        base = c * (n_vars * spacing + gap) + k
        for v in range(n_vars):
            p = base + v * spacing
            kind = v % 4
            if kind == 0:      # true correction: asm error, ALT = truth
                asm[p] = alt_of[asm[p]]
                rows.append((p, asm[p], genome[p], "1/1"))
            elif kind == 1:    # spurious SNP
                rows.append((p, asm[p], alt_of[asm[p]], "1/1"))
            elif kind == 2:    # multiallelic spurious site (3 alleles)
                a1 = alt_of[asm[p]]
                rows.append((p, asm[p], f"{a1},{alt_of[a1]}", "1/2"))
            else:              # 1-bp insertion (spurious)
                rows.append((p, asm[p], asm[p] + rng.choice("ACGT"), "1/1"))
    asm = "".join(asm)

    def canon_counts(s, mult):
        f, r, valid = kmers_from_codes_np(encode_bases(s), k)
        canon = np.minimum(f, r)[valid]
        ks, cs = np.unique(canon, return_counts=True)
        return ks.astype(np.uint64), (cs * mult).astype(np.uint32)

    rk, rv = canon_counts(genome, 30)
    ak, av = canon_counts(asm, 1)
    read_lookup = DeviceLookup(rk, rv, k)
    asm_lookup = DeviceLookup(ak, av, k)
    scorer = DeviceScorer(read_lookup, asm_lookup, k, 30.0, None,
                          max_value=int(rv.max()), exact_max=True)

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "asm.fasta")
        with open(fasta, "w") as f:
            f.write(">c\n" + asm + "\n")
        vcfp = os.path.join(td, "c.vcf")
        with open(vcfp, "w") as f:
            f.write("##fileformat=VCFv4.2\n##contig=<ID=c>\n"
                    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
            for p, ref, alt, gt in rows:
                f.write(f"c\t{p + 1}\t.\t{ref}\t{alt}\t30\tPASS\t.\tGT\t{gt}\n")

        def once(scorer_arg, out, threads=0):
            vcf = VcfFile(vcfp, log=io.StringIO())
            vcf.merge_clusters(k, 15, False, log=io.StringIO())
            n_real = sum(len(v) for v in vcf.by_chrom.values())
            t0 = time.perf_counter()
            run_variants("polish", SeqFile(fasta), vcf, k,
                         read_lookup.lookup_np, asm_lookup.lookup_np,
                         peak=30.0, prob_table=None,
                         out_name=os.path.join(td, out),
                         log=io.StringIO(), threads=threads,
                         scorer=scorer_arg,
                         query_budget=1 << 22)   # one cluster per dispatch
            return n_real / (time.perf_counter() - t0)

        once(scorer, "warm_dev")                 # compile every shape
        dev_rate = max(once(scorer, "dev"), once(scorer, "devb"))
        once(None, "warm_host")                  # compile host-path shapes
        host_rate = once(None, "host")           # all-cores host scorer
        a = open(os.path.join(td, "dev.polish.vcf"), "rb").read()
        b = open(os.path.join(td, "host.polish.vcf"), "rb").read()
        ident = a == b
    return dev_rate, host_rate, ident


def _device_stamp() -> dict:
    """platform/kind/count as JAX reports them + the card's name and
    power limit; refuses to measure anything but a GPU."""
    import subprocess

    import jax

    d = jax.devices()
    if d[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{d[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card}


def main() -> None:
    from merfin_tpu.config import setup_runtime

    setup_runtime()   # x64 + the compile-cache rule (config.py)
    device = _device_stamp()

    k = 21
    n_table = 1 << int(os.environ.get("BENCH_LOG_TABLE", 23))
    n_query = 1 << int(os.environ.get("BENCH_LOG_QUERY", 23))
    rng = np.random.default_rng(0)

    keys = np.unique(rng.integers(0, 1 << (2 * k), size=n_table).astype(np.uint64))
    vals = rng.integers(1, 1000, size=keys.size).astype(np.uint32)
    asm_vals = rng.integers(1, 3, size=keys.size).astype(np.uint32)

    # queries: half hits, half misses
    hit_idx = rng.integers(0, keys.size, size=n_query // 2)
    misses = rng.integers(0, 1 << (2 * k), size=n_query // 2).astype(np.uint64)
    q_np = np.concatenate([keys[hit_idx], misses])
    rng.shuffle(q_np)

    # CPU baseline: single-threaded numpy searchsorted (reference-style probe)
    cpu_n = 1 << 20
    qc = q_np[:cpu_n]
    t0 = time.perf_counter()
    idx = np.searchsorted(keys, qc)
    idx = np.minimum(idx, keys.size - 1)
    hit = keys[idx] == qc
    _ = np.where(hit, vals[idx], 0)
    cpu_rate = cpu_n / (time.perf_counter() - t0)

    def mm(pair):
        return [round(pair[0]), round(pair[1])]

    extra = {"cpu_lookups_per_sec": round(cpu_rate)}
    rates, spread = _bench_join(keys, vals, k, q_np)
    for name, rate in rates.items():
        extra[f"join_{name}_lookups_per_sec"] = round(rate)
        extra[f"join_{name}_spread"] = mm(spread[name])

    if os.environ.get("BENCH_SKIP_MODES") != "1":
        hv_dev, hv_host, hv_ident = _bench_variants_heavy()
        extra["variant_clusters_per_sec_heavy"] = round(hv_dev, 2)
        extra["variant_clusters_per_sec_heavy_hostcores"] = round(hv_host, 2)
        extra["variant_heavy_outputs_identical"] = hv_ident

        extra["count_bases_per_sec"] = round(_bench_count())

        compl_rate, compl_spread, compl_res = _bench_completeness(
            keys, vals, asm_vals, k)
        extra["completeness_kmers_per_sec"] = round(compl_rate)
        extra["completeness_spread"] = mm(compl_spread)
        extra["completeness_kmers_per_sec_resident"] = round(compl_res)

        hist_rate, hist_spread = _best_of(_bench_hist(keys, vals, asm_vals, k))
        extra["hist_bases_per_sec"] = round(hist_rate)
        extra["hist_spread"] = mm(hist_spread)

        # even k: palindromic windows double their value
        k_even = 20
        rng_e = np.random.default_rng(4)
        keys_e = np.unique(rng_e.integers(
            0, 1 << (2 * k_even), size=n_table).astype(np.uint64))
        vals_e = rng_e.integers(1, 1000, size=keys_e.size).astype(np.uint32)
        asm_e = rng_e.integers(1, 3, size=keys_e.size).astype(np.uint32)
        extra["hist_bases_per_sec_even_k"] = round(_bench_hist(
            keys_e, vals_e, asm_e, k_even, n_bases=1 << 24)())

        rate, vspread = _best_of(_bench_variants, rounds=2)
        extra["variant_clusters_per_sec"] = round(rate, 1)
        extra["variant_clusters_spread"] = [round(vspread[0], 1),
                                            round(vspread[1], 1)]
        extra["variant_clusters_per_sec_devscore"] = round(
            _bench_variants(devscore=True), 1)

    best = rates["block"]
    print(json.dumps({
        "metric": "kmer_exact_lookups_per_sec_per_chip",
        "value": round(best),
        "unit": "lookups/s",
        "vs_baseline": round(best / cpu_rate, 2),
        "device": device,
        "extra": extra,
    }), flush=True)


if __name__ == "__main__":
    main()
