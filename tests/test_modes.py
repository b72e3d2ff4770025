"""End-to-end -hist / -dump / -completeness vs the oracle on tiny genomes."""

import io
import math
import random

import numpy as np
import pytest

from merfin_tpu.io.fasta import SeqFile
from merfin_tpu.io.mkdb import KmerDB
from merfin_tpu.modes.engine import KstarEngine, NBINS
from merfin_tpu.modes.hist import run_hist
from merfin_tpu.modes.dump import run_dump
from merfin_tpu.modes.completeness import run_completeness
from merfin_tpu.score.kstar import ProbTable
from merfin_tpu.table.lookup import build_lookup
from tests import refmodel
from tests.util import db_from_dict, random_dna

K = 9
PEAK = 2.0


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("modes")
    rng = random.Random(42)
    # an "assembly" of 3 scaffolds incl. N runs, and "reads" = assembly
    # plus extra copies of a segment plus novel sequence
    scaf = [random_dna(rng, 400, with_n=0.01) for _ in range(3)]
    reads = scaf + [scaf[0][100:300]] * 2 + [random_dna(rng, 150)]

    read_counts = refmodel.count_canonical(reads, K)
    asm_counts = refmodel.count_canonical(scaf, K)

    read_db = db_from_dict(read_counts, K, str(tmp / "read"))
    asm_db = db_from_dict(asm_counts, K, str(tmp / "asm"))

    fasta = tmp / "asm.fasta"
    with open(fasta, "w") as f:
        for i, s in enumerate(scaf):
            f.write(f">scaf{i} extra comment\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60] + "\n")

    prob = ProbTable(np.asarray([1, 1, 2], np.uint32), np.asarray([0.9, 0.8, 0.7]))
    return dict(tmp=tmp, scaf=scaf, reads=reads, read_counts=read_counts,
                asm_counts=asm_counts, read_db=read_db, asm_db=asm_db,
                fasta=str(fasta), prob=prob)


def _engine(setup, prob=None, chunk=128):
    rl = build_lookup(setup["read_db"])
    al = build_lookup(setup["asm_db"])
    return KstarEngine(rl, al, K, PEAK, prob_table=prob, chunk=chunk, batch=2)


@pytest.mark.parametrize("use_prob", [False, True])
def test_hist_matches_oracle(setup, tmp_path, use_prob):
    prob = setup["prob"] if use_prob else None
    engine = _engine(setup, prob=prob)
    out = tmp_path / f"hist{use_prob}.txt"
    log = io.StringIO()
    res = run_hist(engine, SeqFile(setup["fasta"]), str(out), log=log)

    ck = list(prob.copy_k) if prob else []
    cp = list(prob.copy_p) if prob else []
    seqs = [(f"scaf{i}", s) for i, s in enumerate(setup["scaf"])]
    per_seq, undr, over, kasm, kmissing, kover = refmodel.hist_mode(
        seqs, setup["read_counts"], setup["asm_counts"], K, PEAK, ck, cp)

    assert res["kasm"] == kasm
    assert res["missing"] == kmissing
    assert math.isclose(res["kover_cpy"], kover, rel_tol=1e-12, abs_tol=1e-12)

    # histogram file parity with the oracle bins
    lines = out.read_text().splitlines()
    expect = []
    for ii in sorted(undr, reverse=True):
        if ii > 0 and undr[ii] > 0:
            expect.append(f"{ii * -0.2:.1f}\t{undr[ii]}")
    expect.append(f"{0.0:.1f}\t{undr.get(0, 0) + over.get(0, 0)}")
    for ii in sorted(over):
        if ii > 0 and over[ii] > 0:
            expect.append(f"{ii * 0.2:.1f}\t{over[ii]}")
    assert lines == expect

    # per-seq stderr lines
    stderr = log.getvalue()
    cum = 0
    for (ident, _), (pkasm, pmiss, _) in zip(seqs, per_seq):
        cum += pmiss
        qv = refmodel.histo_qv(pmiss, pkasm, K)
        assert f"{ident}\t{pmiss}\t{cum}\t{pkasm}\t{qv:.2f}" in stderr


def test_hist_even_k_palindromes_match_oracle(tmp_path):
    """Even k: palindromic fmer==rmer windows double their value
    (value(fmer)+value(rmer) summing, merfin-globals.C:101-110); -hist
    through the engine == the reference model."""
    k = 10
    rng = random.Random(11)
    # guarantee palindromic k-mers: embed reverse-complement stems
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    stem = random_dna(rng, k // 2)
    pal = stem + "".join(comp[c] for c in reversed(stem))
    scaf = [random_dna(rng, 300) + pal + random_dna(rng, 300),
            random_dna(rng, 250)]
    reads = scaf * 3 + [random_dna(rng, 200)]
    read_counts = refmodel.count_canonical(reads, k)
    asm_counts = refmodel.count_canonical(scaf, k)
    read_db = db_from_dict(read_counts, k, str(tmp_path / "r"))
    asm_db = db_from_dict(asm_counts, k, str(tmp_path / "a"))
    fasta = tmp_path / "asm.fasta"
    fasta.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(scaf)))

    engine = KstarEngine(build_lookup(read_db), build_lookup(asm_db), k,
                         PEAK, chunk=512, batch=2)
    res = run_hist(engine, SeqFile(str(fasta)), str(tmp_path / "h"),
                   log=io.StringIO())
    _, undr, over, kasm, kmissing, kover = refmodel.hist_mode(
        [(f"s{i}", s) for i, s in enumerate(scaf)], read_counts,
        asm_counts, k, PEAK)
    assert res["kasm"] == kasm and res["missing"] == kmissing
    assert math.isclose(res["kover_cpy"], kover, rel_tol=1e-12,
                        abs_tol=1e-12)
    expect = [f"{ii * -0.2:.1f}\t{undr[ii]}"
              for ii in sorted(undr, reverse=True) if ii > 0 and undr[ii]]
    expect.append(f"{0.0:.1f}\t{undr.get(0, 0) + over.get(0, 0)}")
    expect += [f"{ii * 0.2:.1f}\t{over[ii]}"
               for ii in sorted(over) if ii > 0 and over[ii]]
    assert (tmp_path / "h").read_text().splitlines() == expect
    # the palindrome really fired (lookup doubles fmer==rmer)
    assert refmodel.revcomp(pal) == pal
    assert min(pal, refmodel.revcomp(pal)) in asm_counts


@pytest.mark.parametrize("chunk", [4096, 8192])
def test_hist_bin_growth_high_copy_repeat(tmp_path, chunk):
    """A 10^4-copy repeat overflows the default bin count; run_hist
    grows the engine's bins (increaseArray semantics, merfin-histogram.C:
    105-124) and produces the reference's histogram instead of dying.
    chunk=4096 routes through hist_sequence, 8192 through the packed
    group path (group_capacity = batch * chunk)."""
    rng = random.Random(7)
    flank1, flank2 = random_dna(rng, 120), random_dna(rng, 120)
    asm = flank1 + "A" * (10_000 + K - 1) + flank2
    collapsed = flank1 + "A" * K + flank2
    reads = [collapsed] * 4                      # A^K readK = 4/2 = 2

    read_db = db_from_dict(refmodel.count_canonical(reads, K), K,
                           str(tmp_path / "read"))
    asm_db = db_from_dict(refmodel.count_canonical([asm], K), K,
                          str(tmp_path / "asm"))
    fasta = tmp_path / "asm.fasta"
    fasta.write_text(">chr\n" + asm + "\n")

    engine = KstarEngine(build_lookup(read_db), build_lookup(asm_db),
                         K, PEAK, chunk=chunk, batch=2)
    log = io.StringIO()
    out = tmp_path / "out.hist"
    res = run_hist(engine, SeqFile(str(fasta)), str(out), log=log)
    assert engine.nbins > NBINS
    assert "Growing k* histogram" in log.getvalue()

    per_seq, undr, over, kasm, kmissing, kover = refmodel.hist_mode(
        [("chr", asm)], refmodel.count_canonical(reads, K),
        refmodel.count_canonical([asm], K), K, PEAK)
    assert max(undr) >= NBINS                    # the overflow is real
    assert res["kasm"] == kasm and res["missing"] == kmissing
    assert math.isclose(res["kover_cpy"], kover, rel_tol=1e-12)
    lines = out.read_text().splitlines()
    expect = []
    for ii in sorted(undr, reverse=True):
        if ii > 0 and undr[ii] > 0:
            expect.append(f"{ii * -0.2:.1f}\t{undr[ii]}")
    expect.append(f"{0.0:.1f}\t{undr.get(0, 0) + over.get(0, 0)}")
    for ii in sorted(over):
        if ii > 0 and over[ii] > 0:
            expect.append(f"{ii * 0.2:.1f}\t{over[ii]}")
    assert lines == expect


def test_hist_group_finalize_checks_dispatch_time_nbins(tmp_path):
    """A pipelined group dispatched BEFORE grow_bins() was clipped to
    the old bin count; its finalize must raise BinOverflow against the
    dispatch-time nbins, not silently pass the grown engine's check
    (regression: 2-in-flight hist pipelining + growth)."""
    from merfin_tpu.modes.engine import BinOverflow

    rng = random.Random(7)
    flank1, flank2 = random_dna(rng, 120), random_dna(rng, 120)
    asm = flank1 + "A" * (10_000 + K - 1) + flank2
    collapsed = flank1 + "A" * K + flank2
    reads = [collapsed] * 4

    read_db = db_from_dict(refmodel.count_canonical(reads, K), K,
                           str(tmp_path / "read"))
    asm_db = db_from_dict(refmodel.count_canonical([asm], K), K,
                          str(tmp_path / "asm"))
    engine = KstarEngine(build_lookup(read_db), build_lookup(asm_db),
                         K, PEAK, chunk=8192, batch=2)
    from merfin_tpu.kcore.pack import encode_bases

    codes = encode_bases(asm)
    handle = engine.hist_group_dispatch([codes])
    engine.grow_bins(1 << 16)                 # grow while in flight
    with pytest.raises(BinOverflow):
        engine.hist_group_finalize(handle)
    # counters only count successful finalizes (no double-count on the
    # grow-and-retry loop)
    assert engine.overflow_values == 0 and engine.bin_fallbacks == 0
    # the retried dispatch under the grown bins succeeds and matches
    stats, uh, oh, kover = engine.hist_group_finalize(
        engine.hist_group_dispatch([codes]))
    _, undr, _, kasm, kmissing, _ = refmodel.hist_mode(
        [("chr", asm)], refmodel.count_canonical(reads, K),
        refmodel.count_canonical([asm], K), K, PEAK)
    assert stats[0].kasm == kasm and stats[0].kmissing == kmissing
    for ii, n in undr.items():
        assert uh[ii] == n


def test_dump_matches_oracle(setup, tmp_path):
    engine = _engine(setup, chunk=64)
    out = tmp_path / "dump.tsv"
    log = io.StringIO()
    run_dump(engine, SeqFile(setup["fasta"]), str(out), log=log)

    seqs = [(f"scaf{i}", s) for i, s in enumerate(setup["scaf"])]
    rows = refmodel.dump_mode(seqs, setup["read_counts"], setup["asm_counts"], K, PEAK)
    expect = [f"{ident}\t{pos}\t{rk:.2f}\t{ak:.2f}\t{km:.2f}"
              for ident, pos, rk, ak, km in rows]
    assert out.read_text().splitlines() == expect


def test_dump_skip_missing_writes_nothing(setup, tmp_path):
    engine = _engine(setup)
    out = tmp_path / "nodump.tsv"
    run_dump(engine, SeqFile(setup["fasta"]), str(out), skip_missing=True,
             log=io.StringIO())
    assert not out.exists()


@pytest.mark.parametrize("use_prob", [False, True])
def test_completeness_matches_oracle(setup, use_prob):
    prob = setup["prob"] if use_prob else None
    res = run_completeness(setup["read_db"], setup["asm_db"], PEAK,
                           prob_table=prob, log=io.StringIO(), block=1 << 12)
    ck = list(prob.copy_k) if prob else []
    cp = list(prob.copy_p) if prob else []
    total, undrc, compl = refmodel.completeness_mode(
        setup["read_counts"], setup["asm_counts"], PEAK, ck, cp)
    assert math.isclose(res["total"], total, rel_tol=1e-12)
    assert math.isclose(res["undrc"], undrc, rel_tol=1e-12, abs_tol=1e-12)
    assert math.isclose(res["completeness"], compl, rel_tol=1e-12)


def test_hist_grouped_packing_matches_per_seq(setup, tmp_path):
    """Fragmented-assembly packing: many small sequences in one dispatch
    (engine.hist_group) must reproduce the per-sequence path exactly —
    hist file, per-seq stderr lines, and result dict."""
    import random as _random

    rng = _random.Random(7)
    seqs = [random_dna(rng, rng.randint(30, 200), with_n=0.02)
            for _ in range(40)]
    read_db = db_from_dict(refmodel.count_canonical(
        seqs + seqs[:10], K), K, str(tmp_path / "r"))
    asm_db = db_from_dict(refmodel.count_canonical(seqs, K), K,
                          str(tmp_path / "a"))
    fasta = tmp_path / "frag.fasta"
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">frag{i}\n{s}\n")

    rl, al = build_lookup(read_db), build_lookup(asm_db)

    # grouped: capacity fits many sequences per dispatch
    eng_g = KstarEngine(rl, al, K, PEAK, chunk=1024, batch=2)
    log_g = io.StringIO()
    res_g = run_hist(eng_g, SeqFile(str(fasta)), str(tmp_path / "g.hist"),
                     log=log_g)

    # per-sequence: grouping disabled
    eng_s = KstarEngine(rl, al, K, PEAK, chunk=1024, batch=2)
    eng_s.group_capacity = 0
    log_s = io.StringIO()
    res_s = run_hist(eng_s, SeqFile(str(fasta)), str(tmp_path / "s.hist"),
                     log=log_s)

    assert res_g == res_s
    assert (tmp_path / "g.hist").read_text() == (tmp_path / "s.hist").read_text()
    # per-seq QV lines identical (cumulative columns included)
    lines_g = [l for l in log_g.getvalue().splitlines() if l.startswith("frag")]
    lines_s = [l for l in log_s.getvalue().splitlines() if l.startswith("frag")]
    assert lines_g == lines_s and len(lines_g) == 40
    # and the grouped engine really grouped (a sequence > capacity would
    # fall back silently otherwise)
    assert all(len(s) + K - 1 <= eng_g.group_capacity for s in seqs)


def test_dump_grouped_packing_matches_per_seq(setup, tmp_path):
    """Grouped -dump (one dispatch for many small sequences) must emit a
    byte-identical file and identical stderr lines vs the per-seq path."""
    import random as _random

    rng = _random.Random(17)
    seqs = [random_dna(rng, rng.randint(20, 180), with_n=0.03)
            for _ in range(30)]
    read_db = db_from_dict(refmodel.count_canonical(
        seqs + seqs[:7], K), K, str(tmp_path / "r"))
    asm_db = db_from_dict(refmodel.count_canonical(seqs, K), K,
                          str(tmp_path / "a"))
    fasta = tmp_path / "frag.fasta"
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">d{i}\n{s}\n")

    rl, al = build_lookup(read_db), build_lookup(asm_db)

    eng_g = KstarEngine(rl, al, K, PEAK, chunk=1024, batch=2)
    log_g = io.StringIO()
    res_g = run_dump(eng_g, SeqFile(str(fasta)), str(tmp_path / "g.dump"),
                     log=log_g)

    eng_s = KstarEngine(rl, al, K, PEAK, chunk=1024, batch=2)
    eng_s.group_capacity = 0
    log_s = io.StringIO()
    res_s = run_dump(eng_s, SeqFile(str(fasta)), str(tmp_path / "s.dump"),
                     log=log_s)

    assert res_g == res_s
    assert (tmp_path / "g.dump").read_bytes() == (tmp_path / "s.dump").read_bytes()
    lines_g = [l for l in log_g.getvalue().splitlines() if l.startswith("d")
               and "\t" in l]
    lines_s = [l for l in log_s.getvalue().splitlines() if l.startswith("d")
               and "\t" in l]
    assert lines_g == lines_s and len(lines_g) == 30


def test_completeness_wide_readk_u16_path(tmp_path):
    """Tiny peak pushes readK past 255: the wire readK dtype widens to
    u16 and totals stay exact."""
    import io as _io

    from tests.util import db_from_dict
    from merfin_tpu.modes.completeness import run_completeness

    k = 5
    kmers = ["ACGTA", "GGATC", "TTACG"]
    canon = [min(s, refmodel.revcomp(s)) for s in kmers]
    assert len(set(canon)) == 3
    rdb = db_from_dict(dict(zip(canon, [50, 100, 7])), k, str(tmp_path / "r"))
    adb = db_from_dict(dict(zip(canon, [1, 1, 1])), k, str(tmp_path / "a"))
    # peak 0.1: readK = round(v/0.1) = 500, 1000, 70 -> needs u16
    res = run_completeness(rdb, adb, peak=0.1, log=_io.StringIO())
    assert res["total"] == 500 + 1000 + 70
    assert res["undrc"] == 499 + 999 + 69


def test_completeness_peak_zero_inf_fallback(tmp_path):
    """peak=0 (CLI-rejected, library-reachable): getK yields inf readK
    (merfin-globals.C:84-97 division); the f64 wire fallback must not
    crash.  COMPLETENESS is nan exactly as the reference's inf/inf;
    the per-slice prefix split turns cross-slice totals nan rather
    than inf (documented fallback-only divergence)."""
    import io as _io
    import math

    from tests.util import db_from_dict
    from merfin_tpu.modes.completeness import run_completeness

    k = 5
    s = min("ACGTA", refmodel.revcomp("ACGTA"))
    rdb = db_from_dict({s: 9}, k, str(tmp_path / "r"))
    adb = db_from_dict({s: 1}, k, str(tmp_path / "a"))
    res = run_completeness(rdb, adb, peak=0.0, log=_io.StringIO())
    assert math.isinf(res["total"]) or math.isnan(res["total"])
    assert math.isnan(res["completeness"])
