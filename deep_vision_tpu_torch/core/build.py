"""Compile the port's shared libraries at first use, and load them.

The port builds two kinds of library from the repository's sources: the
CUDA kernels (`ops/cuda/build.py`, nvcc over `csrc/*.cu`) and the host's
record reader (`data/native_build.py`, g++ over `native/*.cc`). Both go
to `deep_vision_tpu_torch/build/` (git-ignored) under a name hashed from
their sources and flags (`hashed_path`), are compiled all at once
(`compile_all`) and are loaded once a process (`load_shared`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR / "build"

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def hashed_path(directory: Path, stem: str, files: Iterable[Path],
                flags: Sequence[str]) -> Path:
    """`<directory>/<stem>-<hash>.so`: the hash covers the bytes of every
    file and the flags, so a change to any of them builds anew."""
    text = b"".join(Path(f).read_bytes() for f in files)
    digest = hashlib.sha256(
        text + " ".join(flags).encode()).hexdigest()[:16]
    return Path(directory) / f"{stem}-{digest}.so"


def compile_all(jobs: Dict[str, Tuple[Sequence[str], Sequence[str], Path]]
                ) -> Dict[str, float]:
    """Run every job's compiler command, (compiler and flags, inputs,
    output), at once: `compiler flags -o <temporary> inputs`, whose file
    replaces the output when the command succeeds, with the compiler's
    report beside it (`.log`). Returns the seconds until each finished;
    raises with the report of every command that failed."""
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
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed.values()))
    return seconds


def load_shared(key: str, path: Callable[[], Path],
                make: Callable[[], object]) -> ctypes.CDLL:
    """The shared library cached under `key`; on the first call, `make()`
    builds it when `path()` does not exist yet, and it is loaded. One
    lock serialises the first calls of every library of the port."""
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            if not path().exists():
                make()
            lib = ctypes.CDLL(str(path()))
            _loaded[key] = lib
        return lib
