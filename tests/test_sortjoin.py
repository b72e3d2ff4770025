"""The kept probes (ops/sortjoin.py searchsorted forms, DeviceLookup's
block and bsearch strategies, and the read+asm pair of DeviceLookups
that every engine probes with one stream) vs HostLookup, on sorted and
unsorted streams with u64::MAX sentinels."""

import numpy as np
import pytest

from merfin_tpu.table.lookup import HostLookup

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
SEG = 8192   # table sizes straddling 8192-entry segments


def _table(n, k, seed, vmax=70000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << (2 * k), size=n).astype(np.uint64))
    vals = rng.integers(1, vmax, size=keys.size).astype(np.uint32)
    return rng, keys, vals


def _queries(rng, tables, m, k, sentinel):
    """Half hits spread over ``tables``, the rest random misses — or,
    with ``sentinel``, the second half u64::MAX (sorted stream tail)."""
    if sentinel:
        keys = tables[0]
        return np.concatenate([np.sort(keys[: m // 2]),
                               np.full(m - m // 2, SENTINEL, np.uint64)])
    per = m // (len(tables) + 1)
    parts = [t[rng.integers(0, t.size, size=per)] for t in tables]
    parts.append(rng.integers(0, 1 << (2 * k),
                              size=m - per * len(tables)).astype(np.uint64))
    return np.concatenate(parts)


def _probe(form, tabs, q, k):
    import jax.numpy as jnp

    from merfin_tpu.ops.sortjoin import SortedTable, probe_sorted
    from merfin_tpu.table.lookup import DeviceLookup

    qd = jnp.asarray(q)
    if form in ("scan", "sort"):
        t = SortedTable(*tabs[0])
        return [np.asarray(probe_sorted(t.keys, t.vals, qd, method=form))]
    if form == "pair":
        return [np.asarray(DeviceLookup(*t, k).lookup(qd)) for t in tabs]
    t = DeviceLookup(*tabs[0], k, strategy=form)
    return [np.asarray(t.lookup(qd))]


# (form, table sizes, queries, sentinel stream)
CASES = [
    ("scan", (100,), 1024, False),
    ("scan", (5000,), 1024, False),
    ("scan", (40000,), 4096, False),
    ("scan", (60000,), 4096, False),
    ("scan", (3000,), 1024, True),
    ("sort", (100,), 2048, False),
    ("sort", (SEG * 3 + 17,), 2048, False),
    ("sort", (60000,), 4096, False),
    ("sort", (3000,), 1024, True),
    ("pair", (5000, 3000), 1024, False),
    ("pair", (60000, 2000), 4096, False),
    ("pair", (SEG * 3 + 17, SEG + 5), 2048, False),
    ("pair", (100, 80), 1024, False),
    ("pair", (3000, 3000), 1024, True),
    ("block", (5000,), 1024, False),
    ("block", (60000,), 4096, False),
    ("block", (3000,), 1024, True),
    ("bsearch", (40000,), 4096, False),
    ("bsearch", (3000,), 1024, True),
]


@pytest.mark.parametrize("form,sizes,m,sentinel", CASES)
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_probe_matches_host(form, sizes, m, sentinel, order):
    """Every probe form returns HostLookup's exact values (0 for misses
    and sentinels) on sorted and shuffled query streams."""
    k = 15 if sentinel else 21
    rng, keys, vals = _table(sizes[0], k, seed=sizes[0] + m)
    tabs = [(keys, vals)]
    if len(sizes) > 1:
        _, ak, av = _table(sizes[1], k, seed=sizes[1] * 7, vmax=9)
        if sentinel:
            ak, av = keys, vals + 1   # both tables hold the same keys
        tabs.append((ak, av))
    q = _queries(rng, [t[0] for t in tabs], m, k, sentinel)
    if order == "sorted":
        q = np.sort(q)
    else:
        rng.shuffle(q)
    got = _probe(form, tabs, q, k)
    for g, (tk, tv) in zip(got, tabs):
        np.testing.assert_array_equal(g.astype(np.uint64),
                                      HostLookup(tk, tv)(q))
        assert (g[q == SENTINEL] == 0).all()


@pytest.mark.parametrize("k", [21, 20])
def test_engine_hist_matches_oracle(k, tmp_path):
    """-hist through KstarEngine's probes == the reference model, with
    assembly-only and read-only k-mers and N codes (odd and even k)."""
    import random

    from merfin_tpu.kcore.pack import encode_bases
    from merfin_tpu.modes.engine import KstarEngine
    from merfin_tpu.table.lookup import build_lookup
    from tests import refmodel
    from tests.util import db_from_dict, random_dna

    rng = random.Random(k)
    asm = random_dna(rng, 3000, with_n=0.01)
    reads = [asm[:2000]] * 3 + [asm[1000:]] + [random_dna(rng, 500)]
    rc = refmodel.count_canonical(reads, k)
    ac = refmodel.count_canonical([asm], k)
    eng = KstarEngine(build_lookup(db_from_dict(rc, k, str(tmp_path / "r"))),
                      build_lookup(db_from_dict(ac, k, str(tmp_path / "a"))),
                      k, 2.0, chunk=512, batch=2)
    st, undr, over = eng.hist_sequence(encode_bases(asm))
    _, u_ref, o_ref, kasm, kmissing, kover = refmodel.hist_mode(
        [("s", asm)], rc, ac, k, 2.0)
    assert (st.kasm, st.kmissing) == (kasm, kmissing)
    assert abs(st.kover_cpy - kover) <= 1e-12 * max(1.0, abs(kover))
    assert {i: int(n) for i, n in enumerate(undr) if n} == \
        {i: n for i, n in u_ref.items() if n}
    assert {i: int(n) for i, n in enumerate(over) if n} == \
        {i: n for i, n in o_ref.items() if n}
