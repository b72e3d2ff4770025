#!/usr/bin/env python3
"""End-to-end smoke run of merfin-tpu on an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the -mesh phase only

Phases (the first failure exits non-zero):
  setup   rebuild the native helper, print the card's name and power limit
          (nvidia-smi), require jax.devices()[0].platform == "gpu";
  probe   time the searchsorted probe and DeviceLookup on 2^23- and
          2^26-key tables, each checked for exact equality with HostLookup;
  parity  an adversarial world (round-half ties, a -prob table, a
          bin-overflowing repeat, N runs, packed short scaffolds,
          multiallelic sites, indels) through the CLI on the card and on
          the CPU backend: -hist, -dump, -completeness, -polish -prob,
          -strict, -filter must give byte-identical outputs and
          deterministic stderr lines;
  scale   a bacterial -hist QV deployment (E. coli K-12 MG1655 length,
          k=21, 30x 150 bp reads at 0.001 error): count, -hist,
          -completeness, -dump, -polish on the card vs CPU;
  gpu     the GPU-marked tests (MERFIN_GPU_TESTS=1 pytest -m gpu);
  mesh    (--four) -mesh 1x4 and 2x2 vs one card in the same process,
          dryrun_multichip(4), and each table shard resident on its card.

Exactly one process uses the card at a time: this parent never imports
JAX; card work runs in one child at a time, CPU references run in
children pinned with JAX_PLATFORMS=cpu.  The last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
CLI = os.path.join(REPO, "bin", "merfin-tpu")
CPU_ENV = {"JAX_PLATFORMS": "cpu"}
ALT_OF = {"A": "C", "C": "G", "G": "T", "T": "A"}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
ECOLI_LEN = 4_641_652            # E. coli K-12 MG1655


class SmokeError(RuntimeError):
    pass


def phases(four: bool) -> list[str]:
    """The phases a run executes, in order."""
    if four:
        return ["setup", "mesh"]
    return ["setup", "probe", "parity", "scale", "gpu"]


def say(msg: str) -> None:
    print(msg, flush=True)


def child_env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def run_py(code: str, extra_env: dict | None = None, timeout: int = 900,
           capture: bool = False) -> str:
    """Run ``python -c code`` from the repo root; raise on failure."""
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=child_env(extra_env), timeout=timeout,
                       stdout=subprocess.PIPE if capture else None,
                       stderr=subprocess.PIPE if capture else None, text=True)
    if p.returncode != 0:
        tail = (p.stderr or "")[-3000:] if capture else ""
        raise SmokeError(f"child failed (rc={p.returncode}): {code[:80]}\n{tail}")
    return p.stdout if capture else ""


# ---------------- setup ----------------

def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeError(f"nvidia-smi unavailable: {e}") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return "; ".join(ln.strip() for ln in out.stdout.strip().splitlines())


DEVICE_CODE = ("import json, jax; d = jax.devices(); print(json.dumps("
               "{'platform': d[0].platform, 'kind': d[0].device_kind, "
               "'count': len(d)}))")


def device_info(extra_env: dict | None = None) -> dict:
    out = run_py(DEVICE_CODE, extra_env, timeout=300, capture=True)
    return json.loads(out.strip().splitlines()[-1])


def check_device(info: dict, count: int) -> None:
    if info.get("platform") != "gpu":
        raise SmokeError(f"no GPU: JAX reports platform "
                         f"{info.get('platform')!r} (no CPU fallback)")
    if info.get("count", 0) < count:
        raise SmokeError(f"need {count} GPUs, JAX sees {info.get('count')}")


def setup(count: int) -> tuple[dict, str]:
    if not os.path.isdir(os.path.join(REPO, "merfin_tpu")):
        raise SmokeError("run chip_smoke.py from a merfin-tpu checkout")
    subprocess.run(["make", "-C", os.path.join(REPO, "merfin_tpu", "native"),
                    "-B"], check=True, stdout=subprocess.DEVNULL)
    card = card_line()
    say(f"card: {card}")
    info = device_info()
    check_device(info, count)
    say(f"jax devices: {info}")
    return info, card


# ---------------- probe ----------------

def probe_phase(log_sizes=(23, 26), log_queries: int = 22,
                iters: int = 5) -> None:
    """Time every kept probe form on the card (runs in a child)."""
    import numpy as np

    from merfin_tpu.config import ensure_x64

    ensure_x64()
    import jax
    import jax.numpy as jnp

    from merfin_tpu.ops.sortjoin import probe_sorted
    from merfin_tpu.table.lookup import DeviceLookup, HostLookup

    card = card_line()
    k = 21
    m = 1 << log_queries
    sentinel = np.uint64(0xFFFFFFFFFFFFFFFF)
    for log_n in log_sizes:
        n = 1 << log_n
        rng = np.random.default_rng(log_n)
        # sorted unique keys without a sort: cumulative random gaps
        gap = (1 << (2 * k)) // n
        keys = np.cumsum(rng.integers(1, gap, size=n, dtype=np.uint64))
        vals = rng.integers(1, 1 << 16, size=n).astype(np.uint32)
        n_sent = m // 64
        hits = keys[rng.integers(0, n, size=m // 2)]
        miss = rng.integers(0, 1 << (2 * k), size=m - m // 2 - n_sent,
                            dtype=np.uint64)
        q = np.concatenate([hits, miss, np.full(n_sent, sentinel)])
        rng.shuffle(q)
        q_sorted = np.sort(q)
        want_u = HostLookup(keys, vals)(q)
        want_s = HostLookup(keys, vals)(q_sorted)

        kd, vd = jnp.asarray(keys), jnp.asarray(vals)
        qs_d, qu_d = jnp.asarray(q_sorted), jnp.asarray(q)
        steps = int(np.ceil(np.log2(n)))
        forms = []
        for method in ("scan", "sort"):
            f = jax.jit(lambda a, b, x, mm=method: probe_sorted(a, b, x,
                                                                method=mm))
            forms.append((f"searchsorted[{method}] sorted", f,
                          (kd, vd, qs_d), want_s, steps * 8))
        for strat in ("block", "bsearch"):
            dl = DeviceLookup(keys, vals, k, strategy=strat)
            if strat == "block" and dl.strategy != "block":
                raise SmokeError("block strategy unavailable for this table")
            fb = jax.jit(dl.lookup_with)
            per_q = (dl.rows * dl.window * 12 + 4 if strat == "block"
                     else dl.search_iters * 8 + 12)
            forms.append((f"DeviceLookup[{strat}] unsorted", fb,
                          (dl.tree(), qu_d), want_u, per_q))
        for name, fn, args, want, bytes_q in forms:
            got = jax.block_until_ready(fn(*args))           # compile + warm
            if not np.array_equal(np.asarray(got).astype(np.uint64), want):
                raise SmokeError(f"probe {name} n=2^{log_n}: values "
                                 f"differ from HostLookup")
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*args))
                ts.append(time.perf_counter() - t0)
            t = sorted(ts)[len(ts) // 2]
            rate = m / t
            share = m * bytes_q / t / HBM_BYTES_PER_S
            say(f"probe n=2^{log_n} q=2^{log_queries} {name}: exact, "
                f"{t * 1e3:.3f} ms, {rate / 1e6:.1f}M lookups/s, "
                f"{share:.4f} of 3.35 TB/s ({bytes_q} B/query) [{card}]")


# ---------------- CLI jobs ----------------

def stderr_signature(path: str) -> list[str]:
    """The deterministic stderr lines of a CLI run: drop banners that
    depend on the platform, memory or paths ("--" lines, JAX/XLA log
    lines, warnings)."""
    keep = []
    with open(path, errors="replace") as f:
        for ln in f.read().splitlines():
            if (ln.startswith("--") or re.match(r"^[IWEF]\d{4} ", ln)
                    or "WARNING" in ln or "Platform" in ln):
                continue
            keep.append(ln)
    return keep


def same_bytes(a: str, b: str) -> bool:
    """Byte identity of two files, or of two directories file by file."""
    if os.path.isdir(a):
        fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
        return fa == fb and all(same_bytes(os.path.join(a, x),
                                           os.path.join(b, x)) for x in fa)
    with open(a, "rb") as x, open(b, "rb") as y:
        return x.read() == y.read()


def cli(args: list[str], out_dir: str, tag: str, extra_env=None,
        timeout: int = 900) -> tuple[str, float]:
    """Run bin/merfin-tpu; return (stderr path, wall seconds)."""
    err = os.path.join(out_dir, f"{tag}.stderr")
    t0 = time.perf_counter()
    with open(err, "wb") as ef:
        rc = subprocess.run([sys.executable, CLI] + args, cwd=out_dir,
                            env=child_env(extra_env), stdout=ef, stderr=ef,
                            timeout=timeout).returncode
    dt = time.perf_counter() - t0
    if rc != 0:
        with open(err, errors="replace") as f:
            tail = f.read()[-3000:]
        raise SmokeError(f"{tag}: merfin-tpu {' '.join(args[:1])} rc={rc}\n"
                         f"{tail}")
    return err, dt


class Pair:
    """Runs each job once on the card (serially, in the caller) and once
    on the CPU backend (children pinned to CPU, overlapped on a small
    pool since they never touch the card)."""

    def __init__(self, out_dir: str, card_env=None, cpu_env=None,
                 cpu_workers: int = 2):
        self.out_dir = out_dir
        self.card_env = card_env or {}
        self.cpu_env = CPU_ENV if cpu_env is None else cpu_env
        self.pool = ThreadPoolExecutor(cpu_workers)

    def run(self, tag: str, args: list[str], out: str | None,
            sample_procs: bool = False):
        """args may hold "{out}"; returns (card stderr, card seconds,
        future of the CPU run, max compute processes seen or None)."""
        def argv(side):
            return [a.replace("{out}", f"{out}.{side}") for a in args]

        fut = self.pool.submit(cli, argv("cpu"), self.out_dir, f"{tag}.cpu",
                               self.cpu_env)
        sampler = ProcSampler() if sample_procs else None
        try:
            err, dt = cli(argv("card"), self.out_dir, f"{tag}.card",
                          self.card_env)
        finally:
            if sampler:
                sampler.halt()
        return err, dt, fut, sampler.checked_max() if sampler else None

    def close(self):
        self.pool.shutdown(wait=True)


class ProcSampler:
    """Samples the card's compute processes while a job runs.
    checked_max() fails unless a query answered and saw the job's own
    process."""

    def __init__(self, period: float = 0.5):
        self.max_seen = 0
        self.ok_samples = 0
        self.errors: list[str] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, args=(period,),
                                   daemon=True)
        self._t.start()

    def _loop(self, period):
        while not self._stop.is_set():
            try:
                p = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=30)
            except (OSError, subprocess.TimeoutExpired) as e:
                self.errors.append(str(e))
            else:
                if p.returncode != 0:
                    self.errors.append(p.stderr.strip())
                else:
                    self.ok_samples += 1
                    self.max_seen = max(self.max_seen, len(
                        {x.strip() for x in p.stdout.splitlines()
                         if x.strip()}))
            self._stop.wait(period)

    def halt(self) -> None:
        self._stop.set()
        self._t.join(timeout=60)

    def checked_max(self) -> int:
        """Most compute processes seen at once (call after halt())."""
        if self.ok_samples == 0:
            raise SmokeError(f"nvidia-smi --query-compute-apps never "
                             f"answered: {self.errors[-1:]}")
        if self.max_seen == 0:
            raise SmokeError(f"no compute process seen on the card in "
                             f"{self.ok_samples} samples")
        return self.max_seen


def compare(tag: str, out_card: str | None, out_cpu: str | None,
            err_card: str, err_cpu: str) -> None:
    if out_card is not None and not same_bytes(out_card, out_cpu):
        raise SmokeError(f"{tag}: output differs between card and CPU")
    if stderr_signature(err_card) != stderr_signature(err_cpu):
        raise SmokeError(f"{tag}: deterministic stderr lines differ "
                         f"between card and CPU")


# ---------------- parity ----------------

def build_parity_world(tmp: str, total_bases: int, k: int = 21):
    """Adversarial world: getK rounding ties (v/peak = x.5 for peak 2),
    a prob table, a high-copy repeat overflowing the default histogram
    bins, N runs, short scaffolds (packed-group path), a long scaffold
    (streaming path), a heavy multiallelic cluster, indels."""
    rng = random.Random(99)

    def dna(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    long_len = max(200_000, total_bases - 120_000)
    body = list(dna(long_len))
    rep_at = long_len // 3
    body[rep_at: rep_at + 30_000 + k - 1] = "A" * (30_000 + k - 1)
    body[long_len // 2: long_len // 2 + 50] = "N" * 50
    long_scaf = "".join(body)

    shorts = [dna(rng.randrange(150, 3000)) for _ in range(40)]
    scaffolds = [("chrL", long_scaf)] + [
        (f"scaf{i}", s) for i, s in enumerate(shorts)]

    # every scaffold at several coverages: raw values hit the
    # round-half ties for peak 2.0 (v in 1..12)
    reads = [s for _, s in scaffolds]
    collapsed = long_scaf.replace("A" * (30_000 + k - 1), "A" * k)
    for cov, frac in ((1, 1.0), (2, 0.8), (4, 0.6), (6, 0.4), (11, 0.2)):
        for _ in range(cov):
            reads.append(collapsed[: int(len(collapsed) * frac)])
    reads.append(dna(5_000))   # read-only k-mers (completeness path)

    asm = list(long_scaf)
    vcf_rows = []
    for i in range(30):
        # the first 7 variants merge into ONE cluster (288 paths: a
        # heavy cluster for the -threads worker pool); the rest stay
        # separate
        p = 1000 + i * 30 if i < 7 else 1200 + i * 101
        ref = asm[p]
        if ref == "N":
            continue
        if i % 3 == 0:
            asm[p] = ALT_OF[ref]
            vcf_rows.append((p, asm[p], ref, "1/1"))          # true fix
        elif i % 3 == 1:
            vcf_rows.append((p, ref, ALT_OF[ref], "1/1"))     # spurious
        else:
            a1 = ALT_OF[ref]
            vcf_rows.append((p, ref, f"{a1},{ALT_OF[a1]}", "1/2"))
    vcf_rows.append((5000, asm[5000], asm[5000] + "ACG", "1/1"))  # insertion
    vcf_rows.append((6000, asm[6000] + asm[6001] + asm[6002], asm[6000],
                     "1/1"))                                    # deletion
    vcf_rows.append((2, asm[2], ALT_OF[asm[2]], "1/1"))         # near start
    scaffolds[0] = ("chrL", "".join(asm))

    paths = {x: os.path.join(tmp, x) for x in
             ("asm.fasta", "reads.fasta", "calls.vcf", "probs.txt")}
    with open(paths["asm.fasta"], "w") as f:
        for name, s in scaffolds:
            f.write(f">{name}\n{s}\n")
    with open(paths["reads.fasta"], "w") as f:
        for i, s in enumerate(reads):
            f.write(f">r{i}\n{s}\n")
    with open(paths["calls.vcf"], "w") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=chrL>\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for p, ref, alt, gt in sorted(vcf_rows):
            f.write(f"chrL\t{p + 1}\t.\t{ref}\t{alt}\t31.7\tPASS\t.\t"
                    f"GT\t{gt}\n")
    with open(paths["probs.txt"], "w") as f:
        f.write("1,0.931\n1,0.871\n2,0.773\n2,0.597\n3,0.401\n")
    return paths


def parity_jobs(w: dict, rdb: str, adb: str, threads: int = 4):
    """(tag, args, output path template or None, sample processes)."""
    base = ["-sequence", w["asm.fasta"], "-readmers", rdb, "-seqmers", adb,
            "-peak", "2.0"]
    prob = ["-prob", w["probs.txt"]]
    vcf = ["-vcf", w["calls.vcf"]]
    return [
        ("hist", ["-hist"] + base + prob + ["-output", "{out}"], "{out}", False),
        ("dump", ["-dump"] + base + prob + ["-output", "{out}"], "{out}", False),
        ("completeness", ["-completeness", "-readmers", rdb, "-seqmers", adb,
                          "-peak", "2.0"] + prob, None, False),
        ("polish", ["-polish"] + base + prob + vcf
         + ["-threads", str(threads), "-output", "{out}"],
         "{out}.polish.vcf", True),
        ("strict", ["-strict"] + base + vcf + ["-output", "{out}"],
         "{out}.filter.vcf", False),
        ("filter", ["-filter", "-sequence", w["asm.fasta"], "-readmers", rdb,
                    "-seqmers", adb] + vcf + ["-output", "{out}"],
         "{out}.filter.vcf", False),
    ]


def run_pair_jobs(pair: Pair, jobs, tmp: str, label: str) -> dict:
    """Run each job on both sides, compare; returns card seconds."""
    times = {}
    pending = []
    for tag, args, out_t, sample in jobs:
        out = os.path.join(tmp, f"{label}.{tag}")
        err, dt, fut, n_procs = pair.run(f"{label}.{tag}", args, out,
                                         sample_procs=sample)
        times[tag] = dt
        if n_procs is not None:
            if n_procs > 1:
                raise SmokeError(f"{label} {tag}: {n_procs} processes "
                                 f"used the card at once")
            say(f"{label} {tag}: compute processes seen on the card: "
                f"{n_procs} (nvidia-smi --query-compute-apps)")
        pending.append((tag, out_t, out, err, fut))
    for tag, out_t, out, err, fut in pending:
        err_cpu, _ = fut.result()
        paths = (None, None) if out_t is None else tuple(
            out_t.replace("{out}", f"{out}.{side}") for side in ("card", "cpu"))
        compare(f"{label} {tag}", paths[0], paths[1], err, err_cpu)
        say(f"{label} {tag}: BYTE-IDENTICAL (card vs CPU)")
    return times


def parity_phase(tmp: str, card_env=None, cpu_env=None,
                 bases: int = 2_000_000) -> None:
    w = build_parity_world(tmp, bases)
    rdb, adb = os.path.join(tmp, "read.mkdb"), os.path.join(tmp, "asm.mkdb")
    cli(["count", "k=21", w["reads.fasta"], f"output={rdb}"], tmp,
        "parity.count.reads", card_env)
    cli(["count", "k=21", w["asm.fasta"], f"output={adb}"], tmp,
        "parity.count.asm", card_env)
    pair = Pair(tmp, card_env, cpu_env)
    try:
        run_pair_jobs(pair, parity_jobs(w, rdb, adb), tmp, "parity")
    finally:
        pair.close()


# ---------------- scale ----------------

def make_scale_world(tmp: str, length: int = ECOLI_LEN) -> None:
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "make_world.py"), tmp,
                    "--length", str(length), "--coverage", "30", "--k", "21",
                    "--seed", "0"], check=True, cwd=REPO,
                   env=child_env(CPU_ENV), stdout=subprocess.DEVNULL)


def true_corrections(tmp: str) -> set:
    """(1-based pos, ALT) of every assembly error in a make_world world."""
    import numpy as np

    err = np.load(os.path.join(tmp, "err_pos.npy"))
    genome = np.load(os.path.join(tmp, "true_genome_codes.npy"))
    return {(int(p) + 1, chr(int(genome[p]))) for p in err}


def read_supported_subs(tmp: str, k: int = 21) -> tuple[set, int]:
    """(supported, n_subs): the spurious 0/1 substitution calls of a
    make_world world whose ALT path has no missing k-mer — every k-mer
    spanning the ALT, on the true genome, is in the read DB because a
    read error spells it.  The ALT path then ties the REF at zero missing
    k-mers, and -polish's bestVariant ranks the tie by K* (varMer.C:
    400-467), so it may rightly select such a call."""
    import numpy as np

    from merfin_tpu.io.mkdb import KmerDB

    subs = []
    with open(os.path.join(tmp, "cand.vcf")) as f:
        for ln in f:
            c = ln.rstrip("\n").split("\t")
            if not ln.startswith("#") and c[9] == "0/1" and len(c[4]) == 1:
                subs.append((int(c[1]), c[4]))
    if not subs:
        return set(), 0
    lut = np.full(256, 255, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    genome = lut[np.load(os.path.join(tmp, "true_genome_codes.npy"))]
    pos = np.asarray([p - 1 for p, _ in subs])
    win = genome[pos[:, None] + np.arange(-(k - 1), k)[None, :]]
    win[:, k - 1] = lut[np.frombuffer("".join(a for _, a in subs).encode(),
                                      np.uint8)]
    shift = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    mers = np.stack([win[:, i: i + k] for i in range(k)], axis=1)
    fwd = (mers.astype(np.uint64) << shift).sum(axis=-1, dtype=np.uint64)
    rev = ((3 - mers[..., ::-1]).astype(np.uint64) << shift).sum(
        axis=-1, dtype=np.uint64)
    canon = np.minimum(fwd, rev)
    keys = np.asarray(KmerDB(os.path.join(tmp, "read.mkdb")).keys)
    at = np.minimum(np.searchsorted(keys, canon), keys.size - 1)
    full = (keys[at] == canon).all(axis=1)
    return {s for s, ok in zip(subs, full) if ok}, len(subs)


def polish_calls(path: str) -> set:
    calls = set()
    with open(path) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            c = ln.split("\t")
            calls.add((int(c[1]), c[4]))
    return calls


def scale_phase(tmp: str, card: str, card_env=None, cpu_env=None,
                length: int = ECOLI_LEN) -> None:
    make_scale_world(tmp, length)
    j = lambda x: os.path.join(tmp, x)  # noqa: E731
    t0 = time.perf_counter()
    cli(["count", "k=21", j("reads.fasta"), f"output={j('read.mkdb')}"],
        tmp, "scale.count.reads", card_env, timeout=1200)
    t_reads = time.perf_counter() - t0
    pair = Pair(tmp, card_env, cpu_env)
    try:
        err, t_asm, fut, _ = pair.run(
            "scale.count.asm", ["count", "k=21", j("asm.fasta"),
                                "output={out}"], j("asm.mkdb"))
        fut.result()
        if not same_bytes(j("asm.mkdb.card"), j("asm.mkdb.cpu")):
            raise SmokeError("scale count: assembly MKDB differs between "
                             "card and CPU")
        say("scale count asm: MKDB BYTE-IDENTICAL (card vs CPU)")
        with open(os.path.join(j("read.mkdb"), "mkdb.json")) as f:
            n_read_keys = json.load(f)["distinct"]
        say(f"scale count reads: {n_read_keys} distinct k-mers, "
            f"{t_reads:.3f} s wall [{card}]")
        rdb, adb = j("read.mkdb"), j("asm.mkdb.card")
        peak = "26.0"   # 30x * (150 - 21 + 1) / 150
        base = ["-sequence", j("asm.fasta"), "-readmers", rdb, "-seqmers",
                adb, "-peak", peak]
        jobs = [
            ("hist", ["-hist"] + base + ["-output", "{out}"], "{out}", False),
            ("completeness", ["-completeness", "-readmers", rdb, "-seqmers",
                              adb, "-peak", peak], None, False),
            ("dump", ["-dump"] + base + ["-output", "{out}"], "{out}", False),
            ("polish", ["-polish"] + base + ["-vcf", j("cand.vcf"),
                                             "-output", "{out}"],
             "{out}.polish.vcf", True),
        ]
        times = run_pair_jobs(pair, jobs, tmp, "scale")
    finally:
        pair.close()
    got = polish_calls(j("scale.polish.card.polish.vcf"))
    want = true_corrections(tmp)
    supported, n_subs = read_supported_subs(tmp)
    if got - supported != want:
        raise SmokeError(f"scale polish: {len(got & want)} of {len(want)} "
                         f"true corrections selected, "
                         f"{len(got - want - supported)} spurious")
    say(f"scale polish: selected exactly the {len(want)} true corrections; "
        f"of {n_subs} spurious substitutions, {len(got & supported)} of the "
        f"{len(supported)} whose ALT k-mers all have read support, none of "
        f"the rest, and no spurious insertion")
    times["count asm"] = t_asm
    for tag, dt in times.items():
        say(f"scale {tag}: {dt:.3f} s wall, {length / dt / 1e6:.3f}M "
            f"assembly bases/s (process start + compile included; "
            f"informational) [{card}]")


# ---------------- gpu-marked tests ----------------

def gpu_tests_phase() -> None:
    env = child_env({"MERFIN_GPU_TESTS": "1", "JAX_PLATFORMS": "cuda,cpu"})
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-m", "pytest", "tests", "-m", "gpu",
                        "-q", "-p", "no:cacheprovider", "-rs"], cwd=REPO,
                       env=env, timeout=900, capture_output=True, text=True)
    tail = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    if p.returncode != 0 or "skipped" in tail or "passed" not in tail:
        raise SmokeError(f"pytest -m gpu: rc={p.returncode}\n"
                         f"{p.stdout[-3000:]}{p.stderr[-2000:]}")
    say(f"pytest -m gpu: {tail}")


# ---------------- mesh (--four) ----------------

MESH_MODES = ("hist", "completeness", "dump", "strict")


def mesh_phase(tmp: str, n_dev: int = 4) -> None:
    """Runs in ONE child on all cards: one-card runs vs -mesh 1x4 and
    2x2 of the same modes, dryrun_multichip, shard residency."""
    import contextlib
    import gc
    import io

    from merfin_tpu.cli import main
    from merfin_tpu.config import ensure_x64

    ensure_x64()
    import jax

    j = lambda x: os.path.join(tmp, x)  # noqa: E731
    base = ["-sequence", j("asm.fasta"), "-readmers", j("read.mkdb"),
            "-seqmers", j("asm.mkdb"), "-peak", "26.0"]
    args = {
        "hist": ["-hist"] + base + ["-output", "{out}"],
        "completeness": ["-completeness", "-readmers", j("read.mkdb"),
                         "-seqmers", j("asm.mkdb"), "-peak", "26.0"],
        "dump": ["-dump"] + base + ["-output", "{out}"],
        "strict": ["-strict"] + base + ["-vcf", j("cand.vcf"),
                                        "-output", "{out}"],
    }
    suffix = {"hist": "", "completeness": None, "dump": "",
              "strict": ".filter.vcf"}

    def run(mode, tag, extra):
        out = j(f"mesh.{mode}.{tag}")
        err = j(f"mesh.{mode}.{tag}.stderr")
        argv = [a.replace("{out}", out) for a in args[mode]] + extra
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(buf):
            rc = main(argv)
        dt = time.perf_counter() - t0
        with open(err, "w") as f:
            f.write(buf.getvalue())
        if rc != 0:
            raise SmokeError(f"mesh {mode} {tag}: rc={rc}\n"
                             f"{buf.getvalue()[-2000:]}")
        path = None if suffix[mode] is None else out + suffix[mode]
        return path, err, dt

    for mode in MESH_MODES:
        ref_out, ref_err, t1 = run(mode, "one", [])
        for shape in ("1x4", "2x2"):
            out, err, dt = run(mode, shape, ["-mesh", shape])
            compare(f"mesh {mode} {shape}", out, ref_out, err, ref_err)
            say(f"mesh {mode} -mesh {shape}: BYTE-IDENTICAL to one card "
                f"({dt:.3f} s vs {t1:.3f} s wall)")

    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(n_dev)

    # each table shard resides on its own card
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.parallel.sharded import ShardedLookup, make_mesh

    devs = jax.devices()[:n_dev]

    def used():   # None where the backend keeps no statistics (CPU)
        return [(d.memory_stats() or {}).get("bytes_in_use") for d in devs]

    gc.collect()   # free earlier runs' buffers before the baseline
    before = used()
    sl = ShardedLookup.build(KmerDB(j("read.mkdb")), make_mesh(n_dev, data=1))
    jax.block_until_ready(sl.arrays)
    after = used()
    shard_bytes = sum(a.addressable_shards[0].data.nbytes for a in sl.arrays)
    homes = sorted(s.device.id for a in sl.arrays
                   for s in a.addressable_shards)
    if homes != sorted(d.id for d in devs for _ in sl.arrays):
        raise SmokeError(f"table shards on devices {homes}")
    for d, b0, b1 in zip(devs, before, after):
        grew = None if b0 is None else b1 - b0
        say(f"mesh shard residency: device {d.id} bytes_in_use +{grew} "
            f"(shard {shard_bytes} bytes)")
        if grew is not None and grew < shard_bytes:
            raise SmokeError(f"device {d.id} does not hold its table shard")
    say(f"mesh shard residency: one shard of each table on each of "
        f"{n_dev} devices")


def four_phase(tmp: str, card: str) -> None:
    make_scale_world(tmp)
    for db, fasta in (("read.mkdb", "reads.fasta"), ("asm.mkdb", "asm.fasta")):
        cli(["count", "k=21", os.path.join(tmp, fasta),
             f"output={os.path.join(tmp, db)}"], tmp, f"four.count.{db}",
            timeout=1200)
    run_py(f"import chip_smoke as s; s.mesh_phase({tmp!r})", timeout=1500)
    say(f"mesh phase done [{card}]")


# ---------------- main ----------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card -mesh phase")
    a = ap.parse_args(argv)
    count = 4 if a.four else 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t_start = time.perf_counter()
    try:
        info, card = setup(count)
        for ph in phases(a.four)[1:]:
            t0 = time.perf_counter()
            say(f"== phase {ph}")
            if ph == "probe":
                run_py("import chip_smoke as s; s.probe_phase()",
                       timeout=900)
            elif ph == "parity":
                os.makedirs(os.path.join(tmp, "parity"), exist_ok=True)
                parity_phase(os.path.join(tmp, "parity"))
            elif ph == "scale":
                os.makedirs(os.path.join(tmp, "scale"), exist_ok=True)
                scale_phase(os.path.join(tmp, "scale"), card)
            elif ph == "gpu":
                gpu_tests_phase()
            elif ph == "mesh":
                four_phase(tmp, card)
            say(f"== phase {ph}: ok in {time.perf_counter() - t0:.1f} s")
    except (SmokeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
