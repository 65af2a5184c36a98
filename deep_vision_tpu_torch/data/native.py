"""ctypes binding to the native record-IO runtime (native/*.cc).

A port of deep_vision_tpu/data/native.py. The C++ reader
(native/record_reader.cc) parses record framing and crc32c off the GIL
and prefetches several shards with a thread pool; native/crc32c.cc
gives the masked crc32c that records.py frames and checks records with.
The reference loads a prebuilt native/libdvtpu.so and answers None
without one; here the library is compiled from the repository's
sources at first use (data/native_build.py), and a missing compiler
raises: there is no pure-Python crc path.
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, Sequence

from deep_vision_tpu_torch.data import native_build

_OK, _EOF, _CORRUPT, _IOERR, _TRUNCATED = 0, 1, 2, 3, 4


def load_library() -> ctypes.CDLL:
    """The native library, built on first use, its functions typed."""
    lib = native_build.load()
    if lib.dv_masked_crc32c.restype is not ctypes.c_uint32:
        lib.dv_reader_open.restype = ctypes.c_void_p
        lib.dv_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.dv_reader_next.restype = ctypes.c_int
        lib.dv_reader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.dv_reader_close.argtypes = [ctypes.c_void_p]
        lib.dv_pool_open.restype = ctypes.c_void_p
        lib.dv_pool_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.dv_pool_next.restype = ctypes.c_int
        lib.dv_pool_next.argtypes = lib.dv_reader_next.argtypes
        lib.dv_pool_close.argtypes = [ctypes.c_void_p]
        # c_char_p: a bytes object's own buffer, passed without a copy
        lib.dv_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.dv_masked_crc32c.restype = ctypes.c_uint32
    return lib


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked crc32c of `data` (bytes-like)."""
    if not isinstance(data, bytes):
        data = bytes(data)
    return load_library().dv_masked_crc32c(data, len(data))


def _drain(handle, next_fn, close_fn, what: str) -> Iterator[bytes]:
    data = ctypes.POINTER(ctypes.c_uint8)()
    length = ctypes.c_uint64()
    try:
        while True:
            rc = next_fn(handle, ctypes.byref(data), ctypes.byref(length))
            if rc == _EOF:
                return
            # exception parity with records.read_records: truncation is
            # EOFError, a crc mismatch IOError
            if rc == _TRUNCATED:
                raise EOFError(f"truncated record in {what}")
            if rc == _CORRUPT:
                raise IOError(f"corrupt record in {what}")
            if rc == _IOERR:
                raise IOError(f"io error reading {what}")
            yield ctypes.string_at(data, length.value)
    finally:
        close_fn(handle)


def read_records_native(path: str, verify: bool = True) -> Iterator[bytes]:
    """Native twin of records.read_records (same exceptions, same output)."""
    lib = load_library()
    handle = lib.dv_reader_open(path.encode(), int(verify))
    if not handle:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        raise IOError(f"cannot open {path}")
    yield from _drain(handle, lib.dv_reader_next, lib.dv_reader_close, path)


def pool_records_native(
    paths: Sequence[str], num_threads: int = 4, capacity: int = 256,
    verify: bool = True,
) -> Iterator[bytes]:
    """Multi-shard threaded prefetch. Records from different shards
    interleave nondeterministically (throughput mode; use
    read_records_native per file when order matters)."""
    lib = load_library()
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.dv_pool_open(arr, len(paths), num_threads, capacity,
                              int(verify))
    yield from _drain(handle, lib.dv_pool_next, lib.dv_pool_close,
                      f"pool of {len(paths)} shards")


#: TFRecord's crc mask: masked = rotr32(crc, 15) + MASK_DELTA (mod 2**32)
MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes) -> int:
    """The plain crc32c of `data`, the value `google_crc32c.value` gives:
    the native masked crc with TFRecord's mask undone (subtract the
    delta, then rotate right by 17, the inverse of the mask's rotate
    right by 15)."""
    rot = (masked_crc32c(data) - MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF
