"""Compile the native record library from native/*.cc at first use.

The sources are the repository's own (`native/crc32c.cc`,
`native/record_reader.cc` and the header `native/crc32c.h`), and the
flags are native/Makefile's: `-O3 -std=c++17 -fPIC -pthread`, with
`-msse4.2` on x86_64 for crc32c's hardware path. `g++` builds the
library into deep_vision_tpu_torch/build/ (git-ignored) under a name
hashed from the sources and the flags, through core/build.py's hashing,
compiling and loading, which the CUDA kernels' build shares, so an
edited source builds anew and an unchanged one is reused; with an
executable cache attached (core/excache.py) it is looked up and built
there instead.
"""
from __future__ import annotations

import ctypes
import platform
import shutil
from pathlib import Path

from deep_vision_tpu_torch.core import build as _build

NATIVE_DIR = _build.PACKAGE_DIR.parent / "native"
#: the library's name, in build/ and in an executable cache's journal
LIBRARY = "dvtpu_records"
SOURCES = ("crc32c.cc", "record_reader.cc")
HEADERS = ("crc32c.h",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared") + (
    ("-msse4.2",) if platform.machine() == "x86_64" else ())


def find_cxx() -> str:
    """`g++` on PATH; raises when there is none."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the port's record library is compiled "
            f"from {NATIVE_DIR}/*.cc at first use and needs a C++17 "
            "compiler")
    return cxx


def library_path() -> Path:
    return _build.hashed_path(
        _build.BUILD_DIR, LIBRARY,
        [NATIVE_DIR / f for f in SOURCES + HEADERS], CXX_FLAGS)


def library() -> _build.Library:
    """The record library as core/build.py builds and loads it."""
    return _build.Library(
        LIBRARY, find_cxx, CXX_FLAGS,
        tuple(str(NATIVE_DIR / s) for s in SOURCES),
        tuple(NATIVE_DIR / f for f in SOURCES + HEADERS), library_path())


def build() -> float:
    """Compile the library unless it is built (with an executable cache
    attached: load it through the cache); returns the seconds spent
    compiling (0.0 when nothing was compiled)."""
    return _build.build_libraries([library()])[LIBRARY]


def load() -> ctypes.CDLL:
    """The record library, built on first use."""
    return _build.load_shared(LIBRARY, library)
