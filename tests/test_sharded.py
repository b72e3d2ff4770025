"""Sharded lookup + multichip hist step on the 8-device virtual CPU mesh:
bit-identical to the single-device path."""

import random

import numpy as np
import pytest

from merfin_tpu.modes.engine import KstarEngine
from merfin_tpu.ops.score_ops import prob_table_arrays
from merfin_tpu.parallel.sharded import ShardedLookup, make_mesh, partition_rows
from merfin_tpu.parallel.multichip import make_hist_step
from merfin_tpu.table.lookup import build_lookup
from merfin_tpu.kcore.pack import encode_bases
from tests import refmodel
from tests.util import db_from_dict, random_dna

K = 9


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    rng = random.Random(7)
    scaf = [random_dna(rng, 500) for _ in range(2)]
    reads = scaf * 3 + [random_dna(rng, 200)]
    read_db = db_from_dict(refmodel.count_canonical(reads, K), K, str(tmp / "r"))
    asm_db = db_from_dict(refmodel.count_canonical(scaf, K), K, str(tmp / "a"))
    return read_db, asm_db, scaf


def test_partition_rows_roundtrip():
    keys = np.sort(np.random.default_rng(0).choice(1000, size=37, replace=False)).astype(np.uint64)
    vals = (np.arange(37) + 1).astype(np.uint32)
    kk, vv = partition_rows(keys, vals, 4)
    assert kk.shape == vv.shape and kk.shape[0] == 4
    got_k = kk[kk != np.uint64(0xFFFFFFFFFFFFFFFF)]
    np.testing.assert_array_equal(got_k, keys)


def test_sharded_lookup_matches_host(dbs):
    read_db, _, _ = dbs
    import jax.numpy as jnp

    mesh = make_mesh(8)
    sl = ShardedLookup.build(read_db, mesh)
    hl = build_lookup(read_db, host=True)

    rng = np.random.default_rng(1)
    q = rng.integers(0, 1 << (2 * K), size=4096).astype(np.uint64)
    q = np.concatenate([q, np.asarray(read_db.keys)])[:8192]
    got = np.asarray(sl.lookup(jnp.asarray(q)))
    np.testing.assert_array_equal(got.astype(np.uint64), hl(q))


def test_multichip_hist_matches_single_device(dbs):
    read_db, asm_db, scaf = dbs
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(8, data=2)
    assert mesh.shape == {"d": 2, "t": 4}
    srl = ShardedLookup.build(read_db, mesh)
    sal = ShardedLookup.build(asm_db, mesh)

    from merfin_tpu.score.value_map import ValueMap

    peak = 3.0
    vmap = ValueMap(peak, None, int(np.asarray(read_db.vals).max()))
    step = make_hist_step(mesh, srl, sal, K, vmap)

    # one batch of 2 chunks (one per data shard) covering scaffold 0
    chunk = 256
    codes = encode_bases(scaf[0])
    b = np.full((2, chunk + K - 1), 4, dtype=np.uint8)
    b[0, :] = codes[: chunk + K - 1]
    piece = codes[chunk : 2 * chunk + K - 1]
    b[1, : piece.shape[0]] = piece
    b_sharded = jax.device_put(b, NamedSharding(mesh, P("d", None)))

    from merfin_tpu.parallel.multichip import zero_hist_state

    (kasm, kmissing, kover, undr, over, max_idx, overflow, fallbacks,
     *kov_parts) = step(zero_hist_state(), b_sharded)
    assert int(overflow) == 0 and int(fallbacks) == 0

    # single-device reference
    engine = KstarEngine(build_lookup(read_db), build_lookup(asm_db), K, peak,
                         chunk=chunk, batch=2)
    (kasm1, kmis1, kover1, undr1, over1,
     *_rest) = engine._hist_step(engine._zero_hist_state(), b)

    assert int(kasm) == int(kasm1)
    assert int(kmissing) == int(kmis1)
    assert float(kover) == pytest.approx(float(kover1), rel=1e-15)
    np.testing.assert_array_equal(np.asarray(undr), np.asarray(undr1))
    np.testing.assert_array_equal(np.asarray(over), np.asarray(over1))


@pytest.fixture(scope="module")
def hostile_world(tmp_path_factory):
    """DBs engineered to hit the fallback paths: read values above the
    ValueMap cap (vcap=2 via max_value=1) and an asm value above the
    BinTable exact range (AMAX=8192)."""
    tmp = tmp_path_factory.mktemp("hostile")
    rng = random.Random(11)
    scaf = random_dna(rng, 600)
    mers = sorted(refmodel.count_canonical([scaf], K))
    read_counts = {m: (5, 12, 200)[i % 3] for i, m in enumerate(mers)}
    asm_counts = {m: 1 for m in mers}
    asm_counts[mers[0]] = 9000            # > AMAX -> bin-table fallback
    read_counts[mers[0]] = 12             # readK=4, ratio 2250 < NBINS*0.2
    read_db = db_from_dict(read_counts, K, str(tmp / "r"))
    asm_db = db_from_dict(asm_counts, K, str(tmp / "a"))
    return read_db, asm_db, scaf


def test_sharded_engine_hostile_inputs_match_single_device(hostile_world):
    """VERDICT #3: sharded == single-device on raw values > vcap and bins
    outside the exact tables, with counted (not silent) fallbacks."""
    from merfin_tpu.parallel.engine import ShardedKstarEngine

    read_db, asm_db, scaf = hostile_world
    peak = 3.0
    codes = encode_bases(scaf)

    mesh = make_mesh(8, data=2)
    srl = ShardedLookup.build(read_db, mesh)
    sal = ShardedLookup.build(asm_db, mesh)
    sharded = ShardedKstarEngine(mesh, srl, sal, K, peak,
                                 chunk=256, max_value=1)
    single = KstarEngine(build_lookup(read_db), build_lookup(asm_db), K,
                         peak, chunk=256, batch=2, max_value=1)

    s_stats, s_undr, s_over = sharded.hist_sequence(codes)
    stats, undr, over = single.hist_sequence(codes)

    assert sharded.overflow_values == single.overflow_values > 0
    assert sharded.bin_fallbacks == single.bin_fallbacks > 0
    assert (s_stats.kasm, s_stats.kmissing) == (stats.kasm, stats.kmissing)
    assert s_stats.kover_cpy == pytest.approx(stats.kover_cpy, rel=1e-15)
    np.testing.assert_array_equal(s_undr, undr)
    np.testing.assert_array_equal(s_over, over)


def test_sharded_dump_matches_single_device(dbs):
    from merfin_tpu.parallel.engine import ShardedKstarEngine

    read_db, asm_db, scaf = dbs
    peak = 3.0
    codes = encode_bases(scaf[0] + "N" + scaf[1])

    mesh = make_mesh(8, data=2)
    srl = ShardedLookup.build(read_db, mesh)
    sal = ShardedLookup.build(asm_db, mesh)
    sharded = ShardedKstarEngine(mesh, srl, sal, K, peak, chunk=256)
    single = KstarEngine(build_lookup(read_db), build_lookup(asm_db), K,
                         peak, chunk=256, batch=2)

    got = list(sharded.dump_sequence(codes))
    want = list(single.dump_sequence(codes))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]                      # start
        np.testing.assert_array_equal(g[1], w[1])  # readK
        np.testing.assert_array_equal(g[2], w[2])  # asmK
        np.testing.assert_array_equal(g[3], w[3])  # k*
        assert g[4] == w[4] and g[5] == w[5]


def test_sharded_lookup_sorted_sentinel_stream(dbs):
    """A SORTED query stream padded with u64::MAX sentinels — the shape
    the sorted -completeness mesh step feeds its shards — probes
    exactly: real keys hit, misses and sentinels read 0."""
    read_db, _, _ = dbs
    import jax.numpy as jnp

    mesh = make_mesh(8)
    sl = ShardedLookup.build(read_db, mesh)
    hl = build_lookup(read_db, host=True)

    rng = np.random.default_rng(2)
    q = np.sort(np.concatenate([
        rng.integers(0, 1 << (2 * K), size=2048).astype(np.uint64),
        np.asarray(read_db.keys)[:2048]]))
    q = np.concatenate([q, np.full(8192 - q.size, 0xFFFFFFFFFFFFFFFF,
                                   np.uint64)])
    got = np.asarray(sl.lookup(jnp.asarray(q))).astype(np.uint64)
    n_real = int(np.count_nonzero(q != np.uint64(0xFFFFFFFFFFFFFFFF)))
    np.testing.assert_array_equal(got[:n_real], hl(q[:n_real]))
    assert (got[n_real:] == 0).all()
    got2 = sl.lookup_np(q[:3000][::-1])
    np.testing.assert_array_equal(got2, hl(q[:3000][::-1]))
