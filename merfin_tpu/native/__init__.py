"""ctypes bindings for the native host data plane (fastio.cpp).

Auto-builds the shared library with g++ on first use when missing;
falls back to None (callers use the pure-Python path) if no compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess


import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libmerfin_native.so")

_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src = os.path.join(_DIR, "fastio.cpp")
    stale = (not os.path.exists(_SO)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(_SO)))
    if stale:
        try:
            subprocess.run(
                ["make", "-C", _DIR, "-B"], check=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
        except Exception:
            if not os.path.exists(_SO):
                return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    try:
        _register(lib)
    except AttributeError as e:
        # a stale .so (the rebuild failed, e.g. no compiler) lacks newer
        # symbols: silently dropping every native helper would hide it
        raise RuntimeError(
            f"{_SO} is stale ({e}); rebuild it with "
            f"'make -C {_DIR} -B'") from e
    _lib = lib
    return _lib


def _register(lib) -> None:
    lib.mt_parse_seqs.restype = ctypes.c_int64
    lib.mt_parse_seqs.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.mt_parse_names.restype = ctypes.c_int64
    lib.mt_parse_names.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.mt_format_dump_rows.restype = ctypes.c_int64
    lib.mt_format_dump_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.mt_kmers_from_codes.restype = ctypes.c_int64
    lib.mt_kmers_from_codes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mt_stream_state_size.restype = ctypes.c_int64
    lib.mt_stream_state_size.argtypes = []
    lib.mt_stream_init.restype = None
    lib.mt_stream_init.argtypes = [ctypes.c_void_p]
    lib.mt_stream_parse.restype = ctypes.c_int64
    lib.mt_stream_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mt_assemble_paths.restype = ctypes.c_int64
    lib.mt_assemble_paths.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.mt_pack_transfer.restype = None
    lib.mt_pack_transfer.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mt_intervals_plane.restype = None
    lib.mt_intervals_plane.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mt_merge_counts.restype = ctypes.c_int64
    lib.mt_merge_counts.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]


class StreamParser:
    """Streaming FASTA/FASTQ parser over the native state machine.

    feed(block, is_final) -> (names, codes, piece_offsets, piece_new) for
    one byte window; state (mid-record position, partial header) carries
    between calls, so arbitrarily large files parse in bounded memory.
    Raises ValueError on non-FASTA/FASTQ input.
    """

    def __init__(self):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._state = ctypes.create_string_buffer(int(lib.mt_stream_state_size()))
        lib.mt_stream_init(self._state)

    def feed(self, block: bytes, is_final: bool = False):
        lib = self._lib
        n = len(block)
        codes = np.empty(max(n, 1), dtype=np.uint8)
        # records per window <= occurrences of the header char + 1 ('@' in
        # quality lines only inflates the bound), +1 window-spanning piece
        max_pieces = block.count(b">") + block.count(b"@") + 2
        piece_off = np.zeros(max_pieces + 1, dtype=np.int64)
        piece_new = np.zeros(max_pieces, dtype=np.uint8)
        name_buf = ctypes.create_string_buffer(n + 1040)
        name_bytes = ctypes.c_int64(0)
        np_ = lib.mt_stream_parse(
            block, n, 1 if is_final else 0, self._state,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            piece_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            piece_new.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            max_pieces, name_buf, n + 1040, ctypes.byref(name_bytes),
        )
        if np_ == -1:
            raise ValueError("not FASTA or FASTQ")
        if np_ < 0:
            raise RuntimeError(f"stream parse capacity error ({np_})")
        np_ = int(np_)
        raw = name_buf.raw[: name_bytes.value]
        names = [x.decode("ascii", "replace") for x in raw.split(b"\0")[:-1]] \
            if raw else []
        return (names, codes, piece_off[: np_ + 1], piece_new[:np_] != 0)


def kmers_from_codes(codes: np.ndarray, k: int):
    """Native rolling k-mer extraction: (fmer, rmer, valid) or None."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = max(0, codes.shape[0] - k + 1)
    fmer = np.empty(n, dtype=np.uint64)
    rmer = np.empty(n, dtype=np.uint64)
    valid = np.empty(n, dtype=np.uint8)
    if n:
        lib.mt_kmers_from_codes(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            codes.shape[0], k,
            fmer.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            rmer.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    return fmer, rmer, valid != 0


def parse_seqs(data: bytes):
    """Native FASTA/FASTQ parse: (names, codes uint8, offsets int64) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    codes = np.empty(max(n, 1), dtype=np.uint8)
    max_seqs = max(16, data.count(b"\n") + 2)
    offsets = np.zeros(max_seqs + 1, dtype=np.int64)
    nseq = lib.mt_parse_seqs(
        data, n,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_seqs,
    )
    if nseq < 0:
        return None
    name_buf = ctypes.create_string_buffer(n + 16)
    nn = lib.mt_parse_names(data, n, name_buf, n + 16)
    if nn != nseq:
        return None
    names = name_buf.raw.split(b"\0")[:nseq]
    return ([x.decode("ascii") for x in names], codes, offsets[: nseq + 1])


def format_dump_rows(ident: str, start: int, read_k, asm_k, km) -> bytes | None:
    """Native %.2f dump-row formatting; None when the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    read_k = np.ascontiguousarray(read_k, dtype=np.float64)
    asm_k = np.ascontiguousarray(asm_k, dtype=np.float64)
    km = np.ascontiguousarray(km, dtype=np.float64)
    n = read_k.shape[0]
    cap = (len(ident) + 64) * max(n, 1) + 64
    out = ctypes.create_string_buffer(cap)
    w = lib.mt_format_dump_rows(
        ident.encode("ascii"), start,
        read_k.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        asm_k.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        km.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, out, cap,
    )
    if w < 0:
        return None
    return out.raw[:w]
