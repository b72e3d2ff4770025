"""Device counter vs the string oracle, incl. chunk-boundary packing."""

import random

import numpy as np
import pytest

from merfin_tpu.count.counter import count_sequences, count_files
from merfin_tpu.count import algebra
from merfin_tpu.io.fasta import SeqFile, Sequence
from merfin_tpu.io.meryl_text import decode_kmer
from tests import refmodel
from tests.util import random_dna


def _check(seq_strs, k, chunk, use_device):
    seqs = [Sequence(f"s{i}", s.encode()) for i, s in enumerate(seq_strs)]
    keys, vals, total = count_sequences(iter(seqs), k, chunk=chunk,
                                        use_device=use_device)
    expect = refmodel.count_canonical(seq_strs, k)
    got = {decode_kmer(int(key), k): int(v) for key, v in zip(keys, vals)}
    assert got == expect
    assert total == sum(expect.values())


@pytest.mark.parametrize("use_device", [True, False])
def test_count_many_short_reads(use_device):
    rng = random.Random(1)
    k = 9
    reads = [random_dna(rng, rng.randrange(5, 40)) for _ in range(300)]
    _check(reads, k, chunk=256, use_device=use_device)


@pytest.mark.parametrize("use_device", [True, False])
def test_count_long_sequence_chunked(use_device):
    rng = random.Random(2)
    k = 11
    _check([random_dna(rng, 5000, with_n=0.01)], k, chunk=512, use_device=use_device)


def test_count_mixed_and_files(tmp_path):
    rng = random.Random(3)
    k = 7
    seqs = [random_dna(rng, 900, with_n=0.02), random_dna(rng, 40),
            random_dna(rng, 6), random_dna(rng, 301)]
    p = tmp_path / "in.fasta"
    with open(p, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">q{i}\n{s}\n")
    db = count_files([str(p)], k, str(tmp_path / "db"), chunk=128)
    expect = refmodel.count_canonical(seqs, k)
    got = {decode_kmer(int(key), k): int(v)
           for key, v in zip(np.asarray(db.keys), np.asarray(db.vals))}
    assert got == expect
    st = algebra.statistics(db)
    assert st["present"] == sum(expect.values())
    assert st["distinct"] == len(expect)


def test_device_resident_acc_matches_host_with_collapses():
    """_DeviceCountAcc (device-resident runs + collapse programs +
    quantized-slice fetch) == the host accumulator, across enough small
    chunks to trigger level-0 AND level-1 collapses, with Ns and
    mid-sequence chunk splits."""
    import numpy as np

    from merfin_tpu.count.counter import (_Accumulator, _DeviceCountAcc,
                                          _count_into, _packed_chunks)
    from merfin_tpu.io.fasta import CodedSequence

    k = 9
    chunk = 256
    rng = np.random.default_rng(11)
    seqs = []
    for i in range(40):
        codes = rng.integers(0, 4, size=rng.integers(5, 900)).astype(np.uint8)
        if i % 3 == 0 and codes.size > 10:   # sprinkle invalid bases
            codes[rng.integers(0, codes.size, size=3)] = 4
        seqs.append(CodedSequence(f"s{i}", codes))

    dacc = _DeviceCountAcc(k, chunk, collapse_runs=2)   # force deep collapses
    for buf in _packed_chunks(iter(seqs), k, chunk):
        dacc.add_codes(buf)
    dk, dv, dt = dacc.drain()

    hacc = _Accumulator()
    _count_into(hacc, iter(seqs), k, chunk=chunk, use_device=False)
    hk, hv, ht = *hacc.result()[:2], hacc.total

    assert dt == ht
    np.testing.assert_array_equal(dk, hk)
    np.testing.assert_array_equal(dv.astype(np.uint64), hv.astype(np.uint64))


def test_device_acc_hbm_overflow_to_host():
    """When a collapse would exceed max_entries, runs overflow to the
    host accumulator via the native merge — totals and counts stay
    exact."""
    import numpy as np

    from merfin_tpu.count.counter import (_Accumulator, _DeviceCountAcc,
                                          _count_into, _packed_chunks)
    from merfin_tpu.io.fasta import CodedSequence

    k = 9
    chunk = 128
    rng = np.random.default_rng(21)
    seqs = [CodedSequence(f"s{i}",
                          rng.integers(0, 4, size=300).astype(np.uint8))
            for i in range(12)]

    dacc = _DeviceCountAcc(k, chunk, collapse_runs=2)
    dacc.max_entries = 256          # every collapse overflows to host
    for buf in _packed_chunks(iter(seqs), k, chunk):
        dacc.add_codes(buf)
    assert dacc._host_keys.size > 0  # the overflow branch actually ran
    dk, dv, dt = dacc.drain()

    hacc = _Accumulator()
    _count_into(hacc, iter(seqs), k, chunk=chunk, use_device=False)
    hk, hv, _ = hacc.result()
    assert dt == hacc.total
    np.testing.assert_array_equal(dk, hk)
    np.testing.assert_array_equal(dv.astype(np.uint64), hv.astype(np.uint64))
