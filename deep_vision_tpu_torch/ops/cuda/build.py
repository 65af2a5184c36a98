"""Build the CUDA sources under `deep_vision_tpu_torch/csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into its own shared library, which is loaded with `ctypes`. Its
source never includes PyTorch's headers, so a build takes seconds, not
minutes. Libraries go to `deep_vision_tpu_torch/build/` (git-ignored)
under a name that carries a hash of the source, of the headers beside it
(`csrc/*.cuh`, which any source may include) and of the flags, so an
edited source or header is rebuilt and an unchanged one is reused. `build()` starts
one `nvcc` per source, all at once, and waits for them together. With an
executable cache attached (core/excache.py, core/build.py
`attach_cache`), each library is looked up in the cache and a miss is
built into it instead.

Flags (`flags(name)`): `sm_90a` (Hopper), `-O3` and `-Xptxas -v`,
whose report of registers, shared memory and spills is kept beside the
library (`ptxas_report`, `ptxas_usage`), for every source; then each
source's own (`SOURCE_FLAGS`): `--fmad=false` for NMS, bn_act and norm,
whose kernels must round like their plain versions bit for bit, or in an
order a CPU model repeats (no fast math either). Flash attention is held
to tolerances, not bits, so its multiply-adds contract into FMAs.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from deep_vision_tpu_torch.core.build import (
    BUILD_DIR,
    PACKAGE_DIR,
    Library,
    build_count,  # noqa: F401  (compiler runs, read as build.build_count)
    build_libraries,
    hashed_path,
    load_shared,
)

CSRC_DIR = PACKAGE_DIR / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
#: flags of one source beyond NVCC_FLAGS
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "nms": ("--fmad=false",),
    "bn_act": ("--fmad=false",),
    "norm": ("--fmad=false",),
    "flash_attention": (),
}
_DEFAULT_CUDA_HOME = "/usr/local/cuda"


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else the toolkit's
    default install; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(_DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        f"{_DEFAULT_CUDA_HOME}/bin): the port's CUDA kernels are compiled "
        "from deep_vision_tpu_torch/csrc at first use and need the CUDA "
        "toolkit")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def headers() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC_DIR.glob("*.cuh")))


def flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for `csrc/<name>.cu`; a source without an entry in
    SOURCE_FLAGS raises, so none is built without a decision on FMA."""
    if name not in SOURCE_FLAGS:
        raise KeyError(f"no build flags for {name!r}: add it to "
                       f"SOURCE_FLAGS")
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def library_path(name: str) -> Path:
    """The library's path: its name carries a hash of the source, of
    every header in csrc/ and of its flags, so a change to any builds
    anew."""
    return hashed_path(BUILD_DIR, name, (sources()[name], *headers()),
                       flags(name))


def ptxas_report(name: str) -> str:
    """What `-Xptxas -v` said when `name` was built (registers, shared
    memory, spills); empty when the library predates this process's
    build directory, or was built into an executable cache."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_usage(report: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from a `-Xptxas -v` report."""
    usage: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = usage.setdefault(m.group(1), {
                "registers": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if entry is None:
            continue
        m = _SPILLS.search(line)
        if m:
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            entry["registers"] = int(m.group(1))
    return usage


def library(name: str) -> Library:
    """`csrc/<name>.cu` as core/build.py builds and loads it (through the
    attached executable cache, if any)."""
    src = sources()[name]
    return Library(name, find_nvcc, flags(name), (str(src),),
                   (src, *headers()), library_path(name))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    in parallel; with an executable cache attached, load them through it,
    compiling the misses. Returns seconds spent per name (0.0 = nothing
    compiled); raises with the compiler's output when a build fails.
    `build_count()` counts the compiler runs of this process."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = sorted(set(names) - set(srcs))
    if unknown:
        raise KeyError(f"no CUDA source for {unknown} in {CSRC_DIR}")
    return build_libraries([library(n) for n in names])


def load(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu`, built on first use."""
    return load_shared(name, lambda: library(name))

