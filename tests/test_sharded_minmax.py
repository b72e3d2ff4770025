"""ShardedLookup value filtering + uneven partitions."""

import random

import numpy as np

from merfin_tpu.parallel.sharded import ShardedLookup, make_mesh
from merfin_tpu.table.lookup import build_lookup
from tests import refmodel
from tests.util import db_from_dict, random_dna

K = 9


def test_sharded_min_max_matches_host(tmp_path):
    import jax.numpy as jnp

    rng = random.Random(3)
    seqs = [random_dna(rng, 600) for _ in range(3)]
    db = db_from_dict(refmodel.count_canonical(seqs * 2, K), K, str(tmp_path / "d"))

    mesh = make_mesh(8)
    sl = ShardedLookup.build(db, mesh, min_v=2, max_v=3)
    hl = build_lookup(db, min_v=2, max_v=3, host=True)

    q = np.concatenate([
        np.asarray(db.keys),
        np.random.default_rng(0).integers(0, 1 << (2 * K), size=2048).astype(np.uint64),
    ])[:4096]
    got = np.asarray(sl.lookup(jnp.asarray(q))).astype(np.uint64)
    np.testing.assert_array_equal(got, hl(q))
