"""Tests that need an NVIDIA GPU (marker ``gpu``); elsewhere they skip.

Run on the card:  MERFIN_GPU_TESTS=1 python -m pytest tests -m gpu
(chip_smoke.py's last phase does this; without MERFIN_GPU_TESTS=1
tests/conftest.py pins the CPU and these tests skip).  Each test compares the GPU
result with HostLookup or with the same program on the CPU backend.
"""

import numpy as np
import pytest

from tests.test_sortjoin import _probe, _queries, _table
from merfin_tpu.table.lookup import HostLookup

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.parametrize("form", ["scan", "sort", "pair", "block",
                                  "bsearch"])
def test_probe_on_gpu_matches_host(gpu, form):
    import jax

    k = 21
    rng, keys, vals = _table(60000, k, seed=5)
    tabs = [(keys, vals)]
    if form == "pair":
        _, ak, av = _table(9000, k, seed=6, vmax=9)
        tabs.append((ak, av))
    q = np.sort(_queries(rng, [t[0] for t in tabs], 1 << 16, k, False))
    with jax.default_device(gpu):
        got = _probe(form, tabs, q, k)
    for g, (tk, tv) in zip(got, tabs):
        np.testing.assert_array_equal(g.astype(np.uint64),
                                      HostLookup(tk, tv)(q))


@pytest.mark.parametrize("k", [20, 21])
def test_hist_step_gpu_matches_cpu(gpu, k):
    """One -hist engine step on the GPU == the same step on the CPU
    backend, bit for bit (odd and even k)."""
    import jax

    from merfin_tpu.modes.engine import KstarEngine
    from merfin_tpu.table.lookup import DeviceLookup

    chunk = 4096
    rng, keys, rv = _table(40000, k, seed=7, vmax=60)
    av = rng.integers(1, 3, size=keys.size).astype(np.uint32)
    hit = keys[rng.integers(0, keys.size, size=2)]
    codes = rng.integers(0, 5, size=(2, chunk + k - 1)).astype(np.uint8)
    for row, key in enumerate(hit):   # plant one table k-mer per row
        codes[row, :k] = [(int(key) >> (2 * (k - 1 - j))) & 3
                          for j in range(k)]

    def run(dev):
        with jax.default_device(dev):
            eng = KstarEngine(DeviceLookup(keys, rv, k),
                              DeviceLookup(keys, av, k), k, peak=12.0,
                              chunk=chunk, batch=2)
            out = eng._hist_step(eng._zero_hist_state(), codes)
            return [np.asarray(x) for x in out]

    for g, c in zip(run(gpu), run(jax.devices("cpu")[0])):
        np.testing.assert_array_equal(g, c)
