"""Real 2-process jax.distributed end-to-end: every CLI mode family runs
as two coordinated processes (sequence/slice stripes, collective merges,
rank-0 output) and must produce byte-identical output files vs the
single-process CLI (VERDICT round 1, item 4)."""

import io
import os
import random
import socket
import subprocess
import sys

import pytest

from merfin_tpu.io.fasta import SeqFile
from merfin_tpu.modes.completeness import run_completeness
from tests import refmodel
from tests.util import db_from_dict, random_dna

K = 11
ALT_OF = {"A": "C", "C": "G", "G": "T", "T": "A"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    rng = random.Random(31)
    scaffolds = []
    err_positions = []
    for i in range(3):          # 3 scaffolds so both ranks get stripes
        g = random_dna(rng, 500)
        asm = list(g)
        p = 100 + 60 * i
        asm[p] = ALT_OF[asm[p]]
        scaffolds.append(("".join(asm), g, p))
    reads = [g for _, g, _ in scaffolds] * 20
    asms = [a for a, _, _ in scaffolds]

    db_from_dict(refmodel.count_canonical(reads, K), K, str(tmp / "read.mkdb"))
    db_from_dict(refmodel.count_canonical(asms, K), K, str(tmp / "asm.mkdb"))

    (tmp / "asm.fasta").write_text(
        "".join(f">s{i}\n{a}\n" for i, (a, _, _) in enumerate(scaffolds)))

    rows = []
    for i, (a, g, p) in enumerate(scaffolds):
        rows.append((f"s{i}", p + 1, a[p], g[p]))
    (tmp / "calls.vcf").write_text(
        "##fileformat=VCFv4.2\n"
        + "".join(f"##contig=<ID=s{i}>\n" for i in range(3))
        + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        + "".join(f"{c}\t{p}\t.\t{r}\t{a}\t30\tPASS\t.\tGT\t1/1\n"
                  for c, p, r, a in rows))
    return tmp


DRIVER = """
import sys
from merfin_tpu.cli import merfin_main

tmp, tag = sys.argv[1], sys.argv[2]
base = ["-sequence", f"{tmp}/asm.fasta", "-readmers", f"{tmp}/read.mkdb",
        "-seqmers", f"{tmp}/asm.mkdb", "-peak", "20"]
assert merfin_main(["-hist"] + base + ["-output", f"{tmp}/{tag}.hist"]) == 0
assert merfin_main(["-completeness", "-readmers", f"{tmp}/read.mkdb",
                    "-seqmers", f"{tmp}/asm.mkdb", "-peak", "20"]) == 0
assert merfin_main(["-dump"] + base + ["-output", f"{tmp}/{tag}.dump"]) == 0
assert merfin_main(["-polish"] + base + ["-vcf", f"{tmp}/calls.vcf",
                    "-output", f"{tmp}/{tag}.pol"]) == 0
print("ALLDONE")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_driver_src(tmp, tag, src, extra_env):
    env = {**os.environ,
           "PYTHONPATH": REPO,
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "",
           "JAX_COMPILATION_CACHE_DIR": str(tmp / "jaxcache"),
           **extra_env}
    return subprocess.Popen(
        [sys.executable, "-c", src, str(tmp), tag],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _run_driver(tmp, tag, extra_env):
    return _run_driver_src(tmp, tag, DRIVER, extra_env)


def test_two_process_matches_single(world):
    tmp = world
    port = _free_port()

    # single-process reference outputs
    p = _run_driver(tmp, "one", {})
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err.decode()[-3000:]
    assert b"ALLDONE" in out
    single_err = err.decode()

    procs = [
        _run_driver(tmp, "two", {
            "MERFIN_NUM_PROCESSES": "2",
            "MERFIN_PROCESS_ID": str(i),
            "MERFIN_COORDINATOR": f"127.0.0.1:{port}",
        })
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
        assert b"ALLDONE" in out

    # -hist and -dump and -polish outputs byte-identical
    for suffix in ("hist", "dump", "pol.polish.vcf"):
        a = (tmp / f"one.{suffix}").read_bytes()
        b = (tmp / f"two.{suffix}").read_bytes()
        assert a == b, f"{suffix} differs between 1- and 2-process runs"
    # no leftover part files
    assert not list(tmp.glob("*.part*"))

    # -completeness summary identical and correct (only rank 0 prints it)
    err0 = outs[0][1].decode()
    err1 = outs[1][1].decode()
    want = next(l for l in single_err.splitlines() if "COMPLETENESS" in l)
    assert want in err0
    assert "COMPLETENESS" not in err1

    # polish still picks exactly the 3 corrections
    recs = [l for l in (tmp / "two.pol.polish.vcf").read_text().splitlines()
            if not l.startswith("#")]
    assert len(recs) == 3
    assert [r.split("\t")[0] for r in recs] == ["s0", "s1", "s2"]


RESUME_DRIVER = """
import os, sys

# simulated crash: exit hard after N checkpoint saves (N=0: run to end)
die_after = int(os.environ.get("MERFIN_TEST_DIE_AFTER_SAVES", "0"))
if die_after:
    from merfin_tpu.utils import checkpoint as _C
    _n = [0]
    _orig = _C.Checkpoint.save
    def _save(self, *a, **kw):
        _orig(self, *a, **kw)
        if self.enabled and self.writer:
            _n[0] += 1
            if _n[0] >= die_after:
                os._exit(7)
    _C.Checkpoint.save = _save

from merfin_tpu.cli import merfin_main

tmp, tag, mode = sys.argv[1], sys.argv[2], sys.argv[3]
args = ["-resume",
        "-sequence", f"{tmp}/asm.fasta", "-readmers", f"{tmp}/read.mkdb",
        "-seqmers", f"{tmp}/asm.mkdb", "-peak", "20"]
if mode == "-polish":
    args = ["-polish"] + args + ["-vcf", f"{tmp}/calls.vcf",
                                 "-output", f"{tmp}/{tag}.pol"]
elif mode == "-dump-mesh":
    args = ["-dump", "-mesh", "2x4"] + args + ["-output", f"{tmp}/{tag}.dump"]
else:
    args = [mode] + args + ["-output", f"{tmp}/{tag}.dump"]
assert merfin_main(args) == 0
print("ALLDONE")
"""


def _run_driver_src_mode(tmp, tag, mode, extra_env):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "",
           "JAX_COMPILATION_CACHE_DIR": str(tmp / "jaxcache"), **extra_env}
    return subprocess.Popen(
        [sys.executable, "-c", RESUME_DRIVER, str(tmp), tag, mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_striped_polish_kill_and_restart(world):
    """VERDICT r2 item 7: per-rank checkpoints — kill both ranks after
    their first save, restart with -resume, output byte-identical to the
    single-process run."""
    tmp = world
    outs = _striped_resume(tmp, "rs", "-polish")
    # the resumed ranks actually resumed (not silently restarted)
    assert any("Resuming after" in e for e in outs)
    a = (tmp / "one.pol.polish.vcf").read_bytes()
    b = (tmp / "rs.pol.polish.vcf").read_bytes()
    assert a == b
    assert not list(tmp.glob("*.part*"))
    assert not list(tmp.glob("*.ckpt.json*"))


def test_striped_dump_kill_and_restart(world):
    tmp = world
    outs = _striped_resume(tmp, "rs", "-dump")
    assert any("Resuming after" in e for e in outs)
    assert (tmp / "one.dump").read_bytes() == (tmp / "rs.dump").read_bytes()
    assert not list(tmp.glob("*.part*"))
    assert not list(tmp.glob("*.ckpt.json*"))


def _striped_resume(tmp, tag, mode):
    """Kill-and-restart a striped 2-process run of `mode`; returns the
    restart phase's stderr texts."""
    port = _free_port()
    env = {"MERFIN_NUM_PROCESSES": "2",
           "MERFIN_COORDINATOR": f"127.0.0.1:{port}"}
    procs = [_run_driver_src_mode(tmp, tag, mode, {
        **env, "MERFIN_PROCESS_ID": str(i),
        "MERFIN_TEST_DIE_AFTER_SAVES": "1"}) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    # the rank that saves first exits 7; jax's coordination service then
    # kills the peer wherever it happens to be (whole-job failure) —
    # resume must work regardless of where each rank stopped
    rcs = [p.returncode for p in procs]
    assert 7 in rcs and 0 not in rcs, \
        f"expected a simulated whole-job crash, got {rcs}: " \
        f"{outs[0][1].decode()[-1000:]}"
    port = _free_port()
    env["MERFIN_COORDINATOR"] = f"127.0.0.1:{port}"
    procs = [_run_driver_src_mode(tmp, tag, mode, {
        **env, "MERFIN_PROCESS_ID": str(i)}) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
        assert b"ALLDONE" in out
    return [err.decode() for _, err in outs]


def test_spans_dump_kill_and_restart(world):
    """Host-spanning mesh -dump resume: ranks checkpoint in lockstep
    (saves follow a per-sequence collective); kill both after the first
    save, restart, byte-identical output."""
    tmp = world
    mesh_env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    port = _free_port()
    env = {"MERFIN_NUM_PROCESSES": "2",
           "MERFIN_COORDINATOR": f"127.0.0.1:{port}", **mesh_env}
    procs = [_run_driver_src_mode(tmp, "sp", "-dump-mesh", {
        **env, "MERFIN_PROCESS_ID": str(i),
        "MERFIN_TEST_DIE_AFTER_SAVES": "1"}) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    rcs = [p.returncode for p in procs]
    assert 7 in rcs and 0 not in rcs, \
        f"expected a simulated whole-job crash, got {rcs}: " \
        f"{outs[0][1].decode()[-1000:]}"
    port = _free_port()
    env["MERFIN_COORDINATOR"] = f"127.0.0.1:{port}"
    procs = [_run_driver_src_mode(tmp, "sp", "-dump-mesh", {
        **env, "MERFIN_PROCESS_ID": str(i)}) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
        assert b"ALLDONE" in out
    # either both ranks resumed in lockstep, or the consensus check saw
    # skewed checkpoints and restarted fresh — both must converge
    errs = [err.decode() for _, err in outs]
    assert any("Resuming after" in e or "restarting -dump fresh" in e
               for e in errs)
    assert (tmp / "one.dump").read_bytes() == (tmp / "sp.dump").read_bytes()
    assert not list(tmp.glob("*.part*"))
    assert not list(tmp.glob("*.ckpt.json*"))


DEBUG_DRIVER = """
import sys
from merfin_tpu.cli import merfin_main

tmp, tag = sys.argv[1], sys.argv[2]
assert merfin_main(["-polish", "-debug",
                    "-sequence", f"{tmp}/asm.fasta",
                    "-readmers", f"{tmp}/read.mkdb",
                    "-seqmers", f"{tmp}/asm.mkdb", "-peak", "20",
                    "-vcf", f"{tmp}/calls.vcf",
                    "-output", f"{tmp}/{tag}.pol"]) == 0
print("ALLDONE")
"""


def _debug_rows(path):
    """Debug gz rows with the (writer-local sequential) varMerId column
    stripped — the reference's per-thread ids are thread-local too."""
    import gzip

    with gzip.open(path, "rt") as f:
        return sorted(l.split("\t", 1)[1] for l in f if l.strip())


def test_striped_debug_writes_per_rank_gz(world):
    """-debug under a striped 2-process run writes one gz per rank (the
    reference's per-thread debug split, merfin-variants.C:146-151); the
    union of rows equals the single-process debug log."""
    tmp = world
    p = _run_driver_src(tmp, "dbg1", DEBUG_DRIVER, {})
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err.decode()[-3000:]
    single = _debug_rows(tmp / "dbg1.pol.00.debug.gz")
    assert single

    port = _free_port()
    procs = [_run_driver_src(tmp, "dbg2", DEBUG_DRIVER, {
        "MERFIN_NUM_PROCESSES": "2",
        "MERFIN_PROCESS_ID": str(i),
        "MERFIN_COORDINATOR": f"127.0.0.1:{port}",
    }) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    rows = sorted(_debug_rows(tmp / "dbg2.pol.00.debug.gz")
                  + _debug_rows(tmp / "dbg2.pol.01.debug.gz"))
    assert rows == single
    # the polish output itself still matches the single-process run
    assert (tmp / "dbg1.pol.polish.vcf").read_bytes() == \
        (tmp / "dbg2.pol.polish.vcf").read_bytes()


COUNT_DRIVER = """
import sys
from merfin_tpu.cli import db_tool_main

tmp, tag = sys.argv[1], sys.argv[2]
assert db_tool_main(["count", "k=11", f"{tmp}/reads.fq",
                     f"output={tmp}/{tag}.mkdb"]) == 0
print("ALLDONE")
"""


def test_two_process_count_matches_single(world):
    """Multi-host counting: block stripes + shared-FS spill gather must
    reproduce the single-process database exactly."""
    import gzip
    import random as _random

    import numpy as np

    from merfin_tpu.io.mkdb import KmerDB

    tmp = world
    rng = _random.Random(3)
    with open(tmp / "reads.fq", "w") as f:
        for i in range(400):
            r = "".join(rng.choice("ACGT")
                        for _ in range(rng.randint(30, 120)))
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")

    p = _run_driver_src(tmp, "c1", COUNT_DRIVER, {})
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err.decode()[-3000:]

    port = _free_port()
    procs = [
        _run_driver_src(tmp, "c2", COUNT_DRIVER, {
            "MERFIN_NUM_PROCESSES": "2",
            "MERFIN_PROCESS_ID": str(i),
            "MERFIN_COORDINATOR": f"127.0.0.1:{port}",
        })
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]

    a = KmerDB(str(tmp / "c1.mkdb"))
    b = KmerDB(str(tmp / "c2.mkdb"))
    assert a.total == b.total and a.distinct == b.distinct
    assert np.array_equal(np.asarray(a.keys), np.asarray(b.keys))
    assert np.array_equal(np.asarray(a.vals), np.asarray(b.vals))
    assert a.slice_offsets.tolist() == b.slice_offsets.tolist()
    assert not list(tmp.glob("*.spill.rank*"))


MESH_DRIVER = """
import sys
from merfin_tpu.cli import merfin_main

# outputs share one name across ranks (multi-host contract: one output
# on the shared filesystem, written/merged by rank 0)
tmp, tag = sys.argv[1], "gm"
base = ["-sequence", f"{tmp}/asm.fasta", "-readmers", f"{tmp}/read.mkdb",
        "-seqmers", f"{tmp}/asm.mkdb", "-peak", "20", "-mesh", "2x4"]
assert merfin_main(["-hist"] + base + ["-output", f"{tmp}/{tag}.hist"]) == 0
assert merfin_main(["-completeness", "-mesh", "2x4",
                    "-readmers", f"{tmp}/read.mkdb",
                    "-seqmers", f"{tmp}/asm.mkdb", "-peak", "20"]) == 0
assert merfin_main(["-dump"] + base + ["-output", f"{tmp}/{tag}.dump"]) == 0
assert merfin_main(["-polish"] + base + ["-vcf", f"{tmp}/calls.vcf",
                    "-output", f"{tmp}/{tag}.pol"]) == 0
print("ALLDONE")
"""


def test_global_mesh_spans_two_processes(world):
    """The SURVEY §2.3 centerpiece: one 2x4 mesh spanning two processes
    (4 virtual CPU devices each) — the table shards across both hosts'
    memory, both drive the same collective program, rank 0 reports."""
    tmp = world
    port = _free_port()
    env = {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "MERFIN_NUM_PROCESSES": "2",
        "MERFIN_COORDINATOR": f"127.0.0.1:{port}",
    }
    procs = []
    for i in range(2):
        e = {**env, "MERFIN_PROCESS_ID": str(i)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_DRIVER, str(tmp), f"gm{i}"],
            env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
                 "JAX_COMPILATION_CACHE_DIR": str(tmp / "jaxcache"), **e},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
        assert b"ALLDONE" in out

    # rank 0 wrote the outputs; identical to the single-process run from
    # test_two_process_matches_single (module-scoped world)
    assert (tmp / "gm.hist").read_bytes() == (tmp / "one.hist").read_bytes()
    # -dump: chunk rows from both hosts merged back in order
    assert (tmp / "gm.dump").read_bytes() == (tmp / "one.dump").read_bytes()
    # -polish: replicated evaluation through the host-spanning table
    assert (tmp / "gm.pol.polish.vcf").read_bytes() == \
        (tmp / "one.pol.polish.vcf").read_bytes()
    assert not list(tmp.glob("*.part*"))

    err0, err1 = outs[0][1].decode(), outs[1][1].decode()
    assert "COMPLETENESS" in err0 and "COMPLETENESS" not in err1
    assert "process 0 of 2" in err0 and "process 1 of 2" in err1


DUMP_1XN_DRIVER = """
import sys
from merfin_tpu.cli import merfin_main

tmp, tag = sys.argv[1], "g1n"
assert merfin_main(["-dump", "-mesh", "1x8",
                    "-sequence", f"{tmp}/asm.fasta",
                    "-readmers", f"{tmp}/read.mkdb",
                    "-seqmers", f"{tmp}/asm.mkdb", "-peak", "20",
                    "-output", f"{tmp}/{tag}.dump"]) == 0
print("ALLDONE")
"""


def test_dump_1xn_mesh_no_duplicate_rows(world):
    """A 1xT mesh spanning two processes replicates every d-row on both
    hosts; only the replica-0 owner may emit a chunk (regression: rows
    were duplicated and stats double-counted)."""
    tmp = world
    port = _free_port()
    procs = [
        _run_driver_src(tmp, "g1n", DUMP_1XN_DRIVER, {
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "MERFIN_NUM_PROCESSES": "2",
            "MERFIN_PROCESS_ID": str(i),
            "MERFIN_COORDINATOR": f"127.0.0.1:{port}",
        })
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    assert (tmp / "g1n.dump").read_bytes() == (tmp / "one.dump").read_bytes()
    # per-seq stat lines must not double-count kasm: the world has three
    # 500 bp scaffolds, so the final cumulative kasm column is 3*(500-K+1)
    err0 = outs[0][1].decode()
    stat_lines = [l for l in err0.splitlines()
                  if l.startswith("s") and l.count("\t") == 3]
    assert len(stat_lines) == 3
    assert int(stat_lines[-1].split("\t")[3]) == 3 * (500 - K + 1)
