"""Fuzz merfin_tpu/variants/select.py against the INDEPENDENT refmodel
selector oracle (tests/refmodel.py, transcribed from varMer.C:150-467
alone).  This is the structural guard the round-4 verdict asked for:
select.py's scalar scans, array closed forms, and record emitters must
all agree with a from-the-C++ transcription on randomized clusters —
a shared misreading of the reference can no longer hide behind
scalar-vs-array self-consistency.

dkstr values are dyadic rationals so np.sum and scalar accumulation are
bit-identical (the oracle sums in C++ order; fp association noise would
otherwise produce spurious double-tie differences).
"""

import io
import random

import numpy as np

from tests import refmodel
from merfin_tpu.io.vcf import VcfRecord, PosGT, GtAllele
from merfin_tpu.variants.enumerate import VarPath
from merfin_tpu.variants.score import PathScore
from merfin_tpu.variants import select

K = 7

_QUALS = [0.0, 5.0, 30.5, 42.9, 7.7, 100.25]
_DK = [-2.5, -1.25, 0.0, 0.25, 0.5, 1.75, 2.25, 2.75, 3.5, -0.5]
_LENS = [3, 20, 25, 30, 21]
_BASES = "ACGT"
_ALT_STRS = ["T", "G", "C", "A", "TT", "GA", "CCC"]


def _rand_cluster(rng):
    """Random 1-3 variant cluster; returns (PosGT, plain gts tuples)."""
    n_vars = rng.randint(1, 3)
    recs = []
    gts_plain = []
    for i in range(n_vars):
        ref = rng.choice(_BASES)
        n_alts = rng.randint(1, 2)
        alts = []
        for a in rng.sample(_ALT_STRS, 4):
            if a != ref and a not in alts:
                alts.append(a)
            if len(alts) == n_alts:
                break
        qual = rng.choice(_QUALS)
        pos = 10 + i * 30
        gt = "1/1" if n_alts == 1 else "1/2"
        line = (f"chr1\t{pos}\t.\t{ref}\t{','.join(alts)}\t{qual}\t"
                f"PASS\t.\tGT\t{gt}")
        recs.append(VcfRecord.load(line))
        gts_plain.append((pos - 1, qual, [ref] + alts))
    pg = PosGT(recs[0])
    for r in recs[1:]:
        pg.add_gt(GtAllele(r))
    return pg, gts_plain


def _rand_paths(rng, gts_plain):
    """Random path set: path 0 is usually the REF path (like traverse)."""
    n_vars = len(gts_plain)
    P = rng.randint(1, 10)
    seqs, num_ms, gt_paths, dkstrs = [], [], [], []
    for p in range(P):
        L = rng.choice(_LENS)
        seqs.append("A" * L)
        # make all-missing paths reachable: L=20 -> 14 is the magic count
        num_ms.append(rng.choice([0, 0, 1, 2, 3, 14, max(0, L - K + 1)]))
        if p == 0 and rng.random() < 0.7:
            gt_paths.append([0] * n_vars)
        else:
            gt_paths.append([rng.randrange(len(g[2])) for g in gts_plain])
        dkstrs.append([rng.choice(_DK) for _ in range(rng.randint(0, 3))])
    return seqs, num_ms, gt_paths, dkstrs


def _to_objs(seqs, num_ms, gt_paths, dkstrs):
    paths = [VarPath(s, list(g), [K] * len(g), [1] * len(g))
             for s, g in zip(seqs, gt_paths)]
    scores = [PathScore(m, np.zeros(0), np.asarray(dk, np.float64))
              for m, dk in zip(num_ms, dkstrs)]
    return paths, scores


def _block_args(seqs, num_ms, gt_paths, dkstrs):
    nm = np.asarray(num_ms, np.int64)
    td = np.asarray([float(np.sum(np.asarray(dk, np.float64))) if dk else 0.0
                     for dk in dkstrs])
    lens = np.asarray([len(s) for s in seqs], np.int64)
    gtp = np.asarray(gt_paths, np.int64)
    return nm, td, lens, gtp


def test_polish_matches_oracle_fuzz():
    rng = random.Random(20260821)
    for trial in range(600):
        pg, gts_plain = _rand_cluster(rng)
        seqs, num_ms, gt_paths, dkstrs = _rand_paths(rng, gts_plain)
        paths, scores = _to_objs(seqs, num_ms, gt_paths, dkstrs)
        want = refmodel.ref_best_variant(seqs, num_ms, gt_paths, dkstrs,
                                         "chr1", gts_plain, K)
        got = select.best_variant(paths, scores, pg, K)
        assert got == want, (trial, num_ms, dkstrs, got, want)
        nm, td, lens, gtp = _block_args(seqs, num_ms, gt_paths, dkstrs)
        got_b = select.select_block("polish", nm, td, lens, gtp, pg, K)
        assert got_b == want, (trial, num_ms, dkstrs, got_b, want)


def test_filter_matches_oracle_fuzz():
    rng = random.Random(20260822)
    for trial in range(400):
        pg, gts_plain = _rand_cluster(rng)
        seqs, num_ms, gt_paths, dkstrs = _rand_paths(rng, gts_plain)
        paths, scores = _to_objs(seqs, num_ms, gt_paths, dkstrs)
        want_idx = refmodel.ref_best_filter(seqs, num_ms, gt_paths, K)
        want = [pg.gts[i].record for i in want_idx]
        got = select.best_filter(paths, scores, pg, K)
        assert got == want, (trial, num_ms, want_idx)
        nm, td, lens, gtp = _block_args(seqs, num_ms, gt_paths, dkstrs)
        got_b = select.select_block("filter", nm, td, lens, gtp, pg, K)
        assert got_b == want


def test_better_strict_match_oracle_fuzz():
    rng = random.Random(20260823)
    for trial in range(400):
        pg, gts_plain = _rand_cluster(rng)
        seqs, num_ms, gt_paths, dkstrs = _rand_paths(rng, gts_plain)
        paths, scores = _to_objs(seqs, num_ms, gt_paths, dkstrs)
        want = refmodel.ref_better_variant(seqs, num_ms, gt_paths,
                                           "chr1", gts_plain)
        assert select.better_variant(paths, scores, pg, K) == want
        assert select.strict_polish(paths, scores, pg, K) == \
            refmodel.ref_strict_polish(seqs, num_ms, gt_paths, "chr1", gts_plain)
        nm, td, lens, gtp = _block_args(seqs, num_ms, gt_paths, dkstrs)
        assert select.select_block("better", nm, td, lens, gtp, pg, K) == want
        assert select.select_block("strict", nm, td, lens, gtp, pg, K) == want


def test_loose_matches_oracle_fuzz():
    rng = random.Random(20260824)
    for trial in range(400):
        pg, gts_plain = _rand_cluster(rng)
        seqs, num_ms, gt_paths, dkstrs = _rand_paths(rng, gts_plain)
        paths, scores = _to_objs(seqs, num_ms, gt_paths, dkstrs)
        first = pg.gts[0].record.save()
        ref_log = io.StringIO()
        want = refmodel.ref_loose_polish(seqs, num_ms, gt_paths, "chr1",
                                         gts_plain, first, ref_log)
        log = io.StringIO()
        got = select.loose_polish(paths, scores, pg, K, log=log)
        assert got == want, (trial, num_ms, got, want)
        assert log.getvalue() == ref_log.getvalue()
        nm, td, lens, gtp = _block_args(seqs, num_ms, gt_paths, dkstrs)
        log_b = io.StringIO()
        got_b = select.select_block("loose", nm, td, lens, gtp, pg, K,
                                    log=log_b)
        assert got_b == want
        assert log_b.getvalue() == ref_log.getvalue()


def test_het_record_all_branches_vs_oracle():
    """Pin the four getHetRecord branches (1/1, 0/1, 1/2, 1/0) against
    the oracle on a multiallelic cluster."""
    rec = VcfRecord.load("chr1\t10\t.\tA\tT,G\t42.9\tPASS\t.\tGT\t1/2")
    pg = PosGT(rec)
    gts_plain = [(9, 42.9, ["A", "T", "G"])]
    for g1, g2 in [([1], [1]), ([0], [1]), ([1], [2]), ([2], [0])]:
        want = refmodel.ref_het_record("chr1", gts_plain, g1, g2)
        got = select.get_het_record(pg, g1, g2)
        assert got == want, (g1, g2, got, want)
