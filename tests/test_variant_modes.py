"""End-to-end variant modes: polishing picks true corrections; filter
replays original records; output files match reference conventions."""

import io
import random

import pytest

from merfin_tpu.io.fasta import SeqFile
from merfin_tpu.io.vcf import VcfFile
from merfin_tpu.modes.variants import run_variants
from merfin_tpu.table.lookup import build_lookup
from tests import refmodel
from tests.util import db_from_dict, random_dna

K = 11
ALT_OF = {"A": "C", "C": "G", "G": "T", "T": "A"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A true genome, an assembly with 2 errors, and a VCF with 3 calls:
    two true corrections and one spurious call."""
    tmp = tmp_path_factory.mktemp("varmodes")
    rng = random.Random(123)
    true_genome = random_dna(rng, 600)

    err_pos = [150, 400]       # substitution errors in the assembly
    spurious_pos = 250
    asm = list(true_genome)
    for p in err_pos:
        asm[p] = ALT_OF[asm[p]]
    asm = "".join(asm)

    reads = [true_genome] * 30  # 30x perfect coverage
    read_counts = refmodel.count_canonical(reads, K)
    asm_counts = refmodel.count_canonical([asm], K)

    read_db = db_from_dict(read_counts, K, str(tmp / "read"))
    asm_db = db_from_dict(asm_counts, K, str(tmp / "asm"))

    fasta = tmp / "asm.fasta"
    fasta.write_text(">chr1\n" + asm + "\n")

    # VCF: corrections at err_pos (ALT = true base), spurious at 250
    rows = []
    for p in err_pos:
        rows.append((p + 1, asm[p], true_genome[p], 40.7))
    rows.append((spurious_pos + 1, asm[spurious_pos],
                 ALT_OF[asm[spurious_pos]], 13.2))
    rows.sort()
    vcf = tmp / "calls.vcf"
    body = "".join(
        f"chr1\t{pos}\t.\t{ref}\t{alt}\t{q}\tPASS\t.\tGT\t1/1\n"
        for pos, ref, alt, q in rows
    )
    vcf.write_text(
        "##fileformat=VCFv4.2\n##contig=<ID=chr1>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n" + body
    )
    return dict(tmp=tmp, fasta=str(fasta), vcf=str(vcf), read_db=read_db,
                asm_db=asm_db, err_pos=err_pos, spurious_pos=spurious_pos,
                asm=asm, true_genome=true_genome, rows=rows)


def _run(world, mode, tmp_path, debug=False):
    vcf = VcfFile(world["vcf"], log=io.StringIO())
    vcf.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])
    out = tmp_path / f"out_{mode}"
    run_variants(
        mode, SeqFile(world["fasta"]), vcf, K, rl.lookup_np, al.lookup_np,
        peak=30.0, prob_table=None, out_name=str(out), debug=debug,
        log=io.StringIO(),
    )
    suffix = "polish" if mode == "polish" else "filter"
    path = out.parent / f"{out.name}.{suffix}.vcf"
    lines = path.read_text().splitlines()
    headers = [l for l in lines if l.startswith("#")]
    recs = [l for l in lines if not l.startswith("#")]
    return headers, recs


@pytest.mark.parametrize("mode", ["polish", "better", "strict", "loose"])
def test_polishing_selects_true_corrections(world, tmp_path, mode):
    headers, recs = _run(world, mode, tmp_path)
    assert len(headers) == 3
    got_pos = sorted(int(r.split("\t")[1]) for r in recs)
    assert got_pos == sorted(p + 1 for p in world["err_pos"])
    for r in recs:
        f = r.split("\t")
        pos = int(f[1]) - 1
        assert f[3] == world["asm"][pos]          # REF = assembly base
        assert f[4] == world["true_genome"][pos]  # ALT = true base
        assert f[6] == "PASS" and f[9] == "1/1"
        assert f[5] == "40"                       # int-cast qual (40.7 -> 40)


def test_filter_replays_original_records(world, tmp_path):
    headers, recs = _run(world, "filter", tmp_path)
    # -filter keeps records whose application reduces missing k-mers:
    # the two true corrections, with ORIGINAL record text (qual %.1f)
    expected = [
        f"chr1\t{pos}\t.\t{ref}\t{alt}\t{q:.1f}\tPASS\t.\tGT\t1/1"
        for pos, ref, alt, q in world["rows"]
        if pos - 1 in world["err_pos"]
    ]
    assert recs == expected


def test_debug_log_written(world, tmp_path):
    vcf = VcfFile(world["vcf"], log=io.StringIO())
    vcf.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])
    out = tmp_path / "dbg"
    run_variants(
        "polish", SeqFile(world["fasta"]), vcf, K, rl.lookup_np, al.lookup_np,
        peak=30.0, prob_table=None, out_name=str(out), debug=True,
        log=io.StringIO(),
    )
    import gzip

    dbg = tmp_path / "dbg.00.debug.gz"
    assert dbg.exists()
    with gzip.open(dbg, "rt") as f:
        lines = f.read().splitlines()
    # 3 clusters x 2 paths (ref + alt) = 6 candidate lines, ids 0..5
    assert len(lines) == 6
    assert [int(l.split("\t")[0]) for l in lines] == list(range(6))
    # each line has the 10 tab-separated scoring fields
    for l in lines:
        assert len(l.split("\t")) >= 10


def test_nonexistent_chrom_vcf_makes_empty_output(world, tmp_path):
    vcf_path = tmp_path / "other.vcf"
    vcf_path.write_text(
        "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "chrX\t10\t.\tA\tT\t5\tPASS\t.\tGT\t1/1\n"
    )
    vcf = VcfFile(str(vcf_path), log=io.StringIO())
    vcf.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])
    out = tmp_path / "empty"
    run_variants(
        "polish", SeqFile(world["fasta"]), vcf, K, rl.lookup_np, al.lookup_np,
        peak=30.0, prob_table=None, out_name=str(out), log=io.StringIO(),
    )
    # headers-only output (file IS opened for the first sequence)
    lines = (tmp_path / "empty.polish.vcf").read_text().splitlines()
    assert all(l.startswith("#") for l in lines) and len(lines) == 2


def test_device_scorer_matches_host(world, tmp_path):
    """Fused device scoring (-devscore) is bit-identical to the host
    scorer on CPU: same selected records across modes, with and without
    a prob table."""
    import numpy as np

    from merfin_tpu.score.kstar import ProbTable
    from merfin_tpu.variants.device_score import DeviceScorer

    prob = ProbTable(np.asarray([1, 1, 2], np.uint32),
                     np.asarray([0.9, 0.8, 0.7]))
    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])
    for mode in ("polish", "filter", "loose"):
        for pt in (None, prob):
            vcf = VcfFile(world["vcf"], log=io.StringIO())
            vcf.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
            host_out = tmp_path / f"h_{mode}_{pt is not None}"
            run_variants(mode, SeqFile(world["fasta"]), vcf, K,
                         rl.lookup_np, al.lookup_np, peak=30.0,
                         prob_table=pt, out_name=str(host_out),
                         log=io.StringIO())

            vcf2 = VcfFile(world["vcf"], log=io.StringIO())
            vcf2.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
            scorer = DeviceScorer(rl, al, K, 30.0, pt)
            dev_out = tmp_path / f"d_{mode}_{pt is not None}"
            run_variants(mode, SeqFile(world["fasta"]), vcf2, K,
                         rl.lookup_np, al.lookup_np, peak=30.0,
                         prob_table=pt, out_name=str(dev_out),
                         log=io.StringIO(), scorer=scorer)

            suffix = "polish" if mode == "polish" else "filter"
            a = (host_out.parent / f"{host_out.name}.{suffix}.vcf").read_bytes()
            b = (dev_out.parent / f"{dev_out.name}.{suffix}.vcf").read_bytes()
            assert a == b, (mode, pt is not None)


def test_device_scorer_span_chunking(world, monkeypatch):
    """Streams larger than MAX_WINDOWS split at path boundaries into
    multiple dispatches; per-path results stitch exactly."""
    import numpy as np

    from merfin_tpu.variants.device_score import DeviceScorer
    from merfin_tpu.variants.enumerate import enumerate_paths
    from merfin_tpu.variants.score import score_path_groups

    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])
    asm = world["asm"]
    groups = [
        enumerate_paths(asm[140:170], [10, 15], [1, 1],
                        [[asm[150], "T", ""], [asm[155], "A", "C"]]),
        enumerate_paths(asm[390:420], [10, 14], [1, 1],
                        [[asm[400], "A"], [asm[404], "GG"]]),
    ]
    scorer = DeviceScorer(rl, al, K, 30.0, None)
    one = score_path_groups(groups, K, rl.lookup_np, al.lookup_np,
                            30.0, None, False, scorer=scorer)
    monkeypatch.setattr(DeviceScorer, "MAX_WINDOWS", 64)
    scorer2 = DeviceScorer(rl, al, K, 30.0, None)
    many = score_path_groups(groups, K, rl.lookup_np, al.lookup_np,
                             30.0, None, False, scorer=scorer2)
    for g1, g2 in zip(one, many):
        for a, b in zip(g1, g2):
            assert a.num_m == b.num_m
            assert a.totdk == b.totdk or \
                np.isclose(a.totdk, b.totdk, rtol=1e-12)


def test_sharded_scorer_matches_host(world, tmp_path):
    """Fused scoring over mesh-sharded tables (-devscore -mesh) is
    bit-identical to the host scorer on the virtual CPU mesh."""
    import numpy as np

    from merfin_tpu.parallel.sharded import ShardedLookup, make_mesh
    from merfin_tpu.score.kstar import ProbTable
    from merfin_tpu.variants.device_score import ShardedScorer

    mesh = make_mesh(8)   # 2x4: "d" headroom axis + 4-way table shards
    rs = ShardedLookup.build(world["read_db"], mesh)
    As = ShardedLookup.build(world["asm_db"], mesh)
    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])
    prob = ProbTable(np.asarray([1, 1, 2], np.uint32),
                     np.asarray([0.9, 0.8, 0.7]))
    for mode, pt in (("polish", None), ("filter", prob), ("strict", None)):
        vcf = VcfFile(world["vcf"], log=io.StringIO())
        vcf.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
        host_out = tmp_path / f"h_{mode}"
        run_variants(mode, SeqFile(world["fasta"]), vcf, K,
                     rl.lookup_np, al.lookup_np, peak=30.0,
                     prob_table=pt, out_name=str(host_out),
                     log=io.StringIO())

        vcf2 = VcfFile(world["vcf"], log=io.StringIO())
        vcf2.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
        scorer = ShardedScorer(mesh, rs, As, K, 30.0, pt)
        sh_out = tmp_path / f"s_{mode}"
        run_variants(mode, SeqFile(world["fasta"]), vcf2, K,
                     rs.lookup_np, As.lookup_np, peak=30.0,
                     prob_table=pt, out_name=str(sh_out),
                     log=io.StringIO(), scorer=scorer)

        suffix = "polish" if mode == "polish" else "filter"
        a = (host_out.parent / f"{host_out.name}.{suffix}.vcf").read_bytes()
        b = (sh_out.parent / f"{sh_out.name}.{suffix}.vcf").read_bytes()
        assert a == b, mode


def test_device_scorer_raw_scores_match(world):
    """Device-reduced per-path results (num_m exactly, totdk to f64
    roundoff) match the host scorer's — not just the selected records.
    Includes a zero-length-window path (ref shorter than k after a
    deletion) to exercise the nis==0 host-side correction."""
    import numpy as np

    from merfin_tpu.variants.device_score import DeviceScorer
    from merfin_tpu.variants.score import score_path_groups
    from merfin_tpu.variants.enumerate import enumerate_paths
    from merfin_tpu.variants import select

    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])
    asm = world["asm"]
    # clusters incl. indel paths (idx shifts) and a window shorter than k
    g1 = enumerate_paths(asm[140:170], [10], [1],
                         [[asm[150], "T", ""]])
    g2 = enumerate_paths(asm[390:420], [10, 14], [1, 1],
                         [[asm[400], "A"], [asm[404], "GG"]])
    g3 = enumerate_paths(asm[200:208], [2], [5], [[asm[202:207], "C"]])
    host = score_path_groups([g1, g2, g3], K, rl.lookup_np, al.lookup_np,
                             30.0, None, False)
    scorer = DeviceScorer(rl, al, K, 30.0, None)
    dev = score_path_groups([g1, g2, g3], K, rl.lookup_np, al.lookup_np,
                            30.0, None, False, scorer=scorer)
    for hg, dg in zip(host, dev):
        assert len(hg) == len(dg)
        for h, d in zip(hg, dg):
            assert h.num_m == d.num_m
            np.testing.assert_allclose(select.tot_dk(d), select.tot_dk(h),
                                       rtol=1e-12, atol=1e-12)


def test_device_scorer_pooled_imap_matches_host(world, tmp_path, monkeypatch):
    """threads=2 + fused scorer: heavy clusters route through the
    spawned pool's ordered imap (PathBlocks pickled back as numpy
    buffers, modes/variants.py use_blocks pipeline) — output must be
    byte-identical to the serial host scorer.  _POOL_MIN_PATHS is
    lowered so this world's small clusters actually count as heavy."""
    from merfin_tpu.modes import variants as mv
    from merfin_tpu.variants.device_score import DeviceScorer

    rl = build_lookup(world["read_db"])
    al = build_lookup(world["asm_db"])

    vcf = VcfFile(world["vcf"], log=io.StringIO())
    vcf.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
    host_out = tmp_path / "h_pool"
    run_variants("polish", SeqFile(world["fasta"]), vcf, K,
                 rl.lookup_np, al.lookup_np, peak=30.0, prob_table=None,
                 out_name=str(host_out), log=io.StringIO())

    monkeypatch.setattr(mv, "_POOL_MIN_PATHS", 1)
    vcf2 = VcfFile(world["vcf"], log=io.StringIO())
    vcf2.merge_clusters(K, comb=15, nosplit=False, log=io.StringIO())
    scorer = DeviceScorer(rl, al, K, 30.0, None)
    dev_out = tmp_path / "d_pool"
    run_variants("polish", SeqFile(world["fasta"]), vcf2, K,
                 rl.lookup_np, al.lookup_np, peak=30.0, prob_table=None,
                 out_name=str(dev_out), log=io.StringIO(), scorer=scorer,
                 threads=3)

    a = (tmp_path / "h_pool.polish.vcf").read_bytes()
    b = (tmp_path / "d_pool.polish.vcf").read_bytes()
    assert a == b
