"""Compile the port's shared libraries at first use, and load them.

The port builds two kinds of library from the repository's sources: the
CUDA kernels (`ops/cuda/build.py`, nvcc over `csrc/*.cu`) and the host's
record reader (`data/native_build.py`, g++ over `native/*.cc`). Each is
described by a `Library` (its compiler, flags, inputs and the files its
name is hashed from), compiled all at once (`compile_all`) and loaded
once a process (`load_shared`).

Without an executable cache a library goes to
`deep_vision_tpu_torch/build/` (git-ignored) under a name hashed from
its sources and flags (`hashed_path`). With one attached
(`attach_cache`, core/excache.py), a library is looked up there first,
under a key that also covers the compiler's version, torch, the driver
and the device, and a miss is compiled into the cache. A library loads
once a process, so one cache applies to a process: attaching a second,
different root raises. `build_count()` counts compiler runs,
`compile_seconds()` sums their seconds and `cache_load_count()` counts
the libraries loaded from the cache.

These are the port's compiles. The reference counts XLA's backend
compiles of its jitted steps (a jax.monitoring listener,
obs/stepclock.py); the port compiles no step, and the compilers it runs
are nvcc and g++, here. So obs/stepclock.py reads its `recompiles` and
`compile_ms` from this module: the same "compiler runs this process"
that the Engine's warm-up report and serve/swap.py's `compile_count()`
give.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import (
    Callable,
    Dict,
    Iterable,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR / "build"

_loaded: Dict[str, ctypes.CDLL] = {}
# reentrant: loading a library through the cache checks its crc32c with
# the record library, which may itself load through the cache then
_lock = threading.RLock()
_builds = 0
_compile_seconds = 0.0
_cache_loads = 0
_cache = None


class Library(NamedTuple):
    """One shared library: `compiler()` (which finds the compiler and
    raises without one) runs `compiler flags -o <out> inputs`; `files`
    are every file whose bytes its name or cache key covers (the inputs
    and the headers they may include); `path` is its uncached file."""
    name: str
    compiler: Callable[[], str]
    flags: Tuple[str, ...]
    inputs: Tuple[str, ...]
    files: Tuple[Path, ...]
    path: Path


def hashed_path(directory: Path, stem: str, files: Iterable[Path],
                flags: Sequence[str]) -> Path:
    """`<directory>/<stem>-<hash>.so`: the hash covers the bytes of every
    file and the flags, so a change to any of them builds anew."""
    text = b"".join(Path(f).read_bytes() for f in files)
    digest = hashlib.sha256(
        text + " ".join(flags).encode()).hexdigest()[:16]
    return Path(directory) / f"{stem}-{digest}.so"


def build_count() -> int:
    """Compiler runs this process has started (nvcc and g++)."""
    return _builds


def compile_seconds() -> float:
    """Seconds this process's compiler runs took, summed over the runs
    (runs of one `compile_all` overlap, so the sum can exceed the wall
    time they spanned)."""
    return _compile_seconds


def cache_load_count() -> int:
    """Libraries this process loaded from the attached executable cache."""
    return _cache_loads


def attach_cache(cache):
    """Make `cache` (a core/excache.ExecutableCache) the one this process
    loads and builds its libraries through; returns the attached cache.
    Attaching the attached root again is a no-op (the first object
    stays); a different root raises, since the libraries already loaded
    came from the first."""
    global _cache
    with _lock:
        if _cache is None:
            _cache = cache
        elif os.path.abspath(cache.root) != _cache.root:
            raise RuntimeError(
                f"an executable cache at {_cache.root} is attached to this "
                f"process: a library loads once a process, so a second "
                f"root ({cache.root}) cannot apply")
        return _cache


def detach_cache() -> None:
    """Forget the attached cache: later first loads build into build/
    again (libraries already loaded stay loaded)."""
    global _cache
    with _lock:
        _cache = None


def compile_all(jobs: Dict[str, Tuple[Sequence[str], Sequence[str], Path]]
                ) -> Dict[str, float]:
    """Run every job's compiler command, (compiler and flags, inputs,
    output), at once: `compiler flags -o <temporary> inputs`, whose file
    replaces the output when the command succeeds, with the compiler's
    report beside it (`.log`). Returns the seconds until each finished
    (each run's own seconds: all start at once), which `compile_seconds`
    adds up; raises with the report of every command that failed."""
    global _builds, _compile_seconds
    _builds += len(jobs)
    t0 = time.perf_counter()
    procs = {}
    for n, (cmd, inputs, out) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (out, tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp), *inputs], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, {}
    for n, (out, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            tool = Path(proc.args[0]).name
            failed[n] = f"--- {n} ({tool}) ---\n{text[-4000:]}"
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    _compile_seconds += sum(seconds.values())
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed.values()))
    return seconds


def _through_cache(libs: Sequence[Library]) -> Dict[str, float]:
    """Load each library not loaded yet from the attached cache; compile
    the misses together into a private directory under its root, store
    and load them. Returns the seconds spent compiling each (0.0 for a
    hit or a library already loaded). Called under _lock."""
    global _cache_loads
    cache = _cache
    seconds = {lib.name: 0.0 for lib in libs}
    misses = []
    for lib in libs:
        if lib.name in _loaded:
            continue
        compiler = lib.compiler()
        key = cache.key_for(lib.files, lib.flags, compiler)
        got = cache.load(key, compiler, name=lib.name)
        if got is not None:
            _loaded[lib.name] = got
            _cache_loads += 1
        else:
            misses.append((lib, compiler, key))
    if not misses:
        return seconds
    tmp = Path(cache.build_dir())
    try:
        seconds.update(compile_all({
            lib.name: ([compiler, *lib.flags], lib.inputs,
                       tmp / f"{lib.name}.so")
            for lib, compiler, key in misses}))
        for lib, compiler, key in misses:
            out = tmp / f"{lib.name}.so"
            stored = cache.store(key, out, compiler, name=lib.name)
            _loaded[lib.name] = ctypes.CDLL(
                cache.payload_path(key) if stored else str(out))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return seconds


def build_libraries(libs: Sequence[Library]) -> Dict[str, float]:
    """Without a cache: compile, in parallel, each library whose file
    does not exist yet. With one attached: load each library through it,
    compiling the misses in parallel. Returns the seconds spent per name
    (0.0 = nothing compiled); raises with the compiler's output when a
    build fails."""
    with _lock:
        if _cache is not None:
            return _through_cache(libs)
    todo = [lib for lib in libs if not lib.path.exists()]
    seconds = {lib.name: 0.0 for lib in libs}
    if todo:
        seconds.update(compile_all({
            lib.name: ([lib.compiler(), *lib.flags], lib.inputs, lib.path)
            for lib in todo}))
    return seconds


def load_shared(name: str, library: Callable[[], Library]) -> ctypes.CDLL:
    """The shared library `name`, loaded once a process: on the first
    call `library()` describes it (hashing its files: not on every call
    of a kernel's wrapper), and it loads through the attached cache,
    else from its path, built first when it does not exist. One lock
    serialises the first calls of every library of the port."""
    with _lock:
        got: Optional[ctypes.CDLL] = _loaded.get(name)
        if got is None:
            lib = library()
            if _cache is not None:
                _through_cache([lib])
            else:
                if not lib.path.exists():
                    build_libraries([lib])
                _loaded[name] = ctypes.CDLL(str(lib.path))
            got = _loaded[name]
        return got
