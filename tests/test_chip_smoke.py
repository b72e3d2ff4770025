"""CPU tests of chip_smoke.py's plumbing, the compile-cache rule, the
CPU-pinned worker pool and the absence of foreign Pallas backends."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_check_refuses_cpu():
    info = cs.device_info(cs.CPU_ENV)
    assert info["platform"] == "cpu" and info["count"] >= 1
    with pytest.raises(cs.SmokeError, match="no GPU"):
        cs.check_device(info, 1)
    cs.check_device({"platform": "gpu", "kind": "x", "count": 4}, 4)
    with pytest.raises(cs.SmokeError, match="need 4 GPUs"):
        cs.check_device({"platform": "gpu", "kind": "x", "count": 1}, 4)


def test_four_runs_only_the_mesh_phase(monkeypatch, capsys):
    assert cs.phases(True) == ["setup", "mesh"]
    assert "mesh" not in cs.phases(False)
    ran = []

    def refuse(*a, **k):
        raise AssertionError("a one-card phase ran under --four")

    monkeypatch.setattr(cs, "setup", lambda count: (
        {"platform": "gpu", "kind": "test card", "count": count}, "card"))
    monkeypatch.setattr(cs, "four_phase", lambda tmp, card: ran.append(tmp))
    for name in ("run_py", "parity_phase", "scale_phase", "gpu_tests_phase"):
        monkeypatch.setattr(cs, name, refuse)
    assert cs.main(["--four"]) == 0
    assert len(ran) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "test card", "count": 4}}


def test_failed_setup_prints_no_ok_line(monkeypatch, capsys):
    def no_card(count):
        raise cs.SmokeError("nvidia-smi unavailable")

    monkeypatch.setattr(cs, "setup", no_card)
    assert cs.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_stderr_signature_keeps_results_only(tmp_path):
    p = tmp_path / "e"
    p.write_text("-- Memory needed: 1.000 GB\n"
                 "I0000 00:00:1.0 123 cuda.cc:1] Platform 'cuda'\n"
                 "W0101 12:00:00.1 1 x.cc:2] slow\n"
                 "chr1\t45\t45\t1986\n"
                 "Merfin QV*: 40.1\n"
                 "Bye!\n")
    assert cs.stderr_signature(str(p)) == ["chr1\t45\t45\t1986",
                                           "Merfin QV*: 40.1", "Bye!"]


def _tiny_world(tmp):
    import random

    rng = random.Random(5)
    g = "".join(rng.choice("ACGT") for _ in range(2000))
    asm = list(g)
    for p in (300, 900, 1500):
        asm[p] = cs.ALT_OF[asm[p]]
    (tmp / "asm.fasta").write_text(">chr1\n" + "".join(asm) + "\n>s2\n"
                                   + g[:400] + "\n")
    (tmp / "reads.fasta").write_text(
        "".join(f">r{i}\n{g}\n" for i in range(20)))


def test_pair_runs_compare_on_tiny_world(tmp_path):
    """The card-vs-CPU job runner on a tiny world, both sides on the CPU
    backend: outputs compare byte-identical; a changed output or
    result line is caught."""
    _tiny_world(tmp_path)
    rdb, adb = str(tmp_path / "read.mkdb"), str(tmp_path / "asm.mkdb")
    for fa, db in (("reads.fasta", rdb), ("asm.fasta", adb)):
        cs.cli(["count", "k=15", str(tmp_path / fa), f"output={db}"],
               str(tmp_path), f"count.{fa}", cs.CPU_ENV)
    base = ["-sequence", str(tmp_path / "asm.fasta"), "-readmers", rdb,
            "-seqmers", adb, "-peak", "20"]
    jobs = [("hist", ["-hist"] + base + ["-output", "{out}"], "{out}", False),
            ("completeness", ["-completeness", "-readmers", rdb, "-seqmers",
                              adb, "-peak", "20"], None, False)]
    pair = cs.Pair(str(tmp_path), cs.CPU_ENV, cs.CPU_ENV)
    try:
        times = cs.run_pair_jobs(pair, jobs, str(tmp_path), "t")
    finally:
        pair.close()
    assert set(times) == {"hist", "completeness"}
    card, cpu = str(tmp_path / "t.hist.card"), str(tmp_path / "t.hist.cpu")
    err_card = str(tmp_path / "t.hist.card.stderr")
    err_cpu = str(tmp_path / "t.hist.cpu.stderr")
    assert any("QV" in ln for ln in cs.stderr_signature(err_card))
    cs.compare("hist", card, cpu, err_card, err_cpu)
    assert cs.same_bytes(rdb, rdb)

    with open(card, "a") as f:
        f.write("0\t1\n")
    with pytest.raises(cs.SmokeError, match="output differs"):
        cs.compare("hist", card, cpu, err_card, err_cpu)
    with open(err_card, "a") as f:
        f.write("Merfin QV*: 99\n")
    with pytest.raises(cs.SmokeError, match="stderr"):
        cs.compare("hist", None, None, err_card, err_cpu)


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c",
         "from merfin_tpu.config import setup_runtime, compile_cache_dir;"
         "setup_runtime(); import jax;"
         "print(compile_cache_dir()); "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True, cwd=REPO)
    return out.stdout.strip().splitlines()


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <repo>/.jax_cache (never a directory outside the checkout)."""
    if env_set:
        want = str(tmp_path / "cache")
        assert _cache_dir(want) == [want, want]
    else:
        want = os.path.join(REPO, ".jax_cache")
        assert _cache_dir(None) == [want, want]


def _worker_platforms():
    import jax

    return os.environ.get("JAX_PLATFORMS"), jax.config.jax_platforms


def test_pool_workers_pinned_to_cpu(monkeypatch):
    import multiprocessing as mp

    from merfin_tpu.modes.variants import pin_cpu_worker

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")   # what a worker inherits
    ctx = mp.get_context("spawn")
    with ctx.Pool(1, initializer=pin_cpu_worker) as pool:
        got = pool.apply(_worker_platforms)
    assert got == ("cpu", "cpu")


def test_no_foreign_pallas_backend_imports():
    """No source file imports the Pallas backend of another accelerator
    (jax.experimental.pallas.<t-p-u>, its usual alias, or its runtime)."""
    t = "t" + "pu"
    pat = re.compile(r"pallas(\s+import\s+|\.)" + t + r"|\bpl" + t
                     + r"\b|\blib" + t)
    me = os.path.abspath(__file__)
    hits = []
    for root, dirs, files in os.walk(REPO):
        dirs[:] = [d for d in dirs if not d.startswith(".")
                   and d not in ("__pycache__", "chiprun_out")]
        for name in files:
            path = os.path.join(root, name)
            if name.endswith((".py", ".cpp")) and path != me:
                with open(path, errors="replace") as f:
                    if pat.search(f.read()):
                        hits.append(os.path.relpath(path, REPO))
    assert hits == []


class _Ran:
    def __init__(self, rc, out):
        self.returncode, self.stdout, self.stderr = rc, out, "no device"


@pytest.mark.parametrize("answer,want", [
    (_Ran(0, "1234\n"), 1),
    (_Ran(0, "1234\n5678\n"), 2),
    (_Ran(0, ""), "no compute process"),
    (_Ran(9, ""), "never answered"),
    (OSError("nvidia-smi not found"), "never answered"),
])
def test_proc_sampler_needs_a_visible_process(monkeypatch, answer, want):
    """The one-process check proves something only when nvidia-smi
    answered and showed the job's own process."""
    def fake_run(*a, **k):
        if isinstance(answer, Exception):
            raise answer
        return answer

    monkeypatch.setattr(cs.subprocess, "run", fake_run)
    s = cs.ProcSampler(period=0.01)
    time.sleep(0.1)
    s.halt()
    if isinstance(want, int):
        assert s.checked_max() == want
    else:
        with pytest.raises(cs.SmokeError, match=want):
            s.checked_max()


@pytest.mark.parametrize("opt_in", [False, True])
def test_conftest_pins_cpu_unless_gpu_tests_asked(monkeypatch, opt_in):
    """An exported JAX_PLATFORMS never moves the suite off the CPU; only
    MERFIN_GPU_TESTS=1 hands the platform choice to JAX_PLATFORMS."""
    import runpy

    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    if opt_in:
        monkeypatch.setenv("MERFIN_GPU_TESTS", "1")
    else:
        monkeypatch.delenv("MERFIN_GPU_TESTS", raising=False)
    runpy.run_path(os.path.join(REPO, "tests", "conftest.py"))
    want = "cuda" if opt_in else "cpu"
    assert os.environ["JAX_PLATFORMS"] == want
    assert ("jax_platforms", want) in calls


def test_scale_polish_rule_on_small_world(tmp_path):
    """make_world's spurious calls through -polish on the CPU: every true
    correction is selected, and a spurious call only where
    read_supported_subs says an error read spells its ALT."""
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "make_world.py"),
                    str(tmp_path), "--length", "40000", "--spurious", "400",
                    "--seed", "0"], check=True, env=cs.child_env(cs.CPU_ENV),
                   stdout=subprocess.DEVNULL)
    j = lambda x: str(tmp_path / x)  # noqa: E731
    for fa, db in (("reads.fasta", "read.mkdb"), ("asm.fasta", "asm.mkdb")):
        cs.cli(["count", "k=21", j(fa), f"output={j(db)}"], str(tmp_path),
               f"count.{fa}", cs.CPU_ENV)
    cs.cli(["-polish", "-sequence", j("asm.fasta"), "-readmers",
            j("read.mkdb"), "-seqmers", j("asm.mkdb"), "-peak", "26.0",
            "-vcf", j("cand.vcf"), "-output", j("pol")], str(tmp_path),
           "polish", cs.CPU_ENV)
    got = cs.polish_calls(j("pol.polish.vcf"))
    supported, n_subs = cs.read_supported_subs(str(tmp_path))
    assert n_subs > 150 and supported
    assert got - supported == cs.true_corrections(str(tmp_path))
    assert got & supported == supported   # each tie went to the ALT here
