"""MKDB — this engine's k-mer database format.

Replaces the on-disk meryl database (the reference links meryl's
kmers-files/reader/writer, src/main.mk:22-29; merfin consumes it through
merylFileReader at merfin-completeness.C:22-45 and merylExactLookup at
merfin-globals.C:135-159).  The meryl binary format is not recoverable
here (submodule not present), so MKDB is a clean design with the same
contract merfin relies on:

  * canonical k-mers (min of forward/reverse-complement, A<C<G<T packing),
  * one (key, value) pair per distinct k-mer, globally sorted by key,
  * 64-way prefix partitioning: slice i holds keys whose top 6 bits == i
    (the reference's 64 pieces, merfin-completeness.C:56-66) — the natural
    shard key for a device mesh.

Layout (a directory):
  mkdb.json     — {"format": "mkdb1", "k": K, "distinct": N, "total": M,
                   "slice_offsets": [65 ints]}
  keys.npy      — uint64[N], sorted ascending (slices are contiguous)
  vals.npy      — uint32[N]

Text interop with meryl (`meryl print` emits "KMER<tab>count") lives in
merfin_tpu/io/meryl_text.py.
"""

from __future__ import annotations

import json
import os

import numpy as np

SLICES = 64
FORMAT = "mkdb1"


class KmerDB:
    """A read-only handle on an MKDB directory (arrays are memmapped)."""

    def __init__(self, path: str):
        self.path = path
        meta_path = os.path.join(path, "mkdb.json")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"'{path}' is not an MKDB database (no mkdb.json)")
        with open(meta_path) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"'{path}': unsupported format {self.meta.get('format')}")
        self.k: int = int(self.meta["k"])
        self.distinct: int = int(self.meta["distinct"])
        self.total: int = int(self.meta["total"])
        self.slice_offsets = np.asarray(self.meta["slice_offsets"], dtype=np.int64)
        self.keys = np.load(os.path.join(path, "keys.npy"), mmap_mode="r")
        self.vals = np.load(os.path.join(path, "vals.npy"), mmap_mode="r")

    def slice(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Sorted (keys, vals) of prefix slice i (0..63)."""
        a, b = self.slice_offsets[i], self.slice_offsets[i + 1]
        return self.keys[a:b], self.vals[a:b]

    def estimate_memory_gb(self) -> float:
        """Bytes to hold the exact-lookup arrays in device HBM.

        Analog of merylExactLookup::estimateMemoryUsage
        (merfin-globals.C:136,141): keys (8 B) + values (4 B) + the
        prefix-bucket index used by the device lookup table.
        """
        n = self.distinct
        index_entries = min(max(2 * n, 1024), 1 << 26)
        return (n * 12 + index_entries * 4) / 1024**3

    @staticmethod
    def create(path: str, k: int, keys: np.ndarray, vals: np.ndarray, total: int | None = None) -> "KmerDB":
        """Write a new MKDB from sorted canonical (keys, vals)."""
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.uint32)
        assert keys.shape == vals.shape
        if keys.size > 1:
            assert bool(np.all(keys[1:] > keys[:-1])), "keys must be sorted and unique"

        shift = np.uint64(max(0, 2 * k - 6))
        prefixes = (keys >> shift).astype(np.int64) if keys.size else np.zeros(0, np.int64)
        offsets = np.searchsorted(prefixes, np.arange(SLICES + 1), side="left")

        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "keys.npy"), keys)
        np.save(os.path.join(path, "vals.npy"), vals)
        meta = {
            "format": FORMAT,
            "k": int(k),
            "distinct": int(keys.size),
            "total": int(total if total is not None else int(vals.sum())),
            "slice_offsets": [int(x) for x in offsets],
        }
        with open(os.path.join(path, "mkdb.json"), "w") as f:
            json.dump(meta, f)
        return KmerDB(path)


def is_mkdb(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "mkdb.json"))
