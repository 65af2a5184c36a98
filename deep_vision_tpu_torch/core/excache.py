"""Persistent cache of the port's compiled libraries: pay the compiler
once (the port of deep_vision_tpu/core/excache.py).

The port traces nothing: what it compiles are its shared libraries, the
CUDA kernels (nvcc over `csrc/*.cu`, ops/cuda/build.py) and the host's
record reader (g++ over `native/*.cc`, data/native_build.py), both
through core/build.py. Without a cache they land in the git-ignored
`build/` under a name hashed from their sources and flags alone; a
fresh process, a respawned replica or a restarted server over a copied
tree then trusts whatever file carries that name. This module is the
content-addressed store a process attaches instead (core/build.py
`attach_cache`): one entry a library, keyed by

    sha256( the sources' and headers' bytes, the compiler's flags
          , torch version, the compiler's --version line
          , platform, platform_version (the driver), device kind
            (the card's name and sm_XX), device count, mesh shape )

so an entry made under another compiler, torch, driver or card never
satisfies a lookup: a skewed entry is a MISS by key construction, and an
entry whose *manifest* disagrees with the current environment (a cache
dir copied between machines, a tampered entry) journals a typed
`excache_invalid` and falls through to the compiler. A stale library is
never loaded.

Each entry is two files under `root`, written payload first, manifest
last, each to a tmp file, fsync'd and renamed::

    <key>.so     the compiled library
    <key>.json   manifest: the payload's crc32c, its bytes, the
                 fingerprint it was built under, its name, created ts

A payload whose crc32c disagrees with its manifest (`corrupt`), an
unreadable manifest (`corrupt`), or crc-valid bytes that `ctypes.CDLL`
refuses (`deserialize_failed`) are QUARANTINED to `<root>/quarantine/`
and rebuilt; skewed entries stay in place (they may be valid for the
environment that wrote them) and are overwritten by the rebuild.
Concurrent warmers over one dir are safe: stores race through
`os.replace` (identical content, last rename wins) and a reader keys
presence on the pair, so it never observes a torn entry.

The crc32c is the port's own (data/native.py), which lives in the record
library, itself an entry here: that one entry is checked with
`crc32c_py`, the same function in Python, since a library cannot vouch
for the bytes it is loaded from.

Observability as the reference's: typed `excache_hit` / `excache_miss` /
`excache_store` / `excache_invalid` journal events with the entry's
`key` and `name`, `excache_{hits,misses,stores,invalid}_total` counters,
and the reference's invalid reasons, so tools/check_journal.py accepts
the port's journals.

`install_jax_compilation_cache` has no counterpart: it points JAX's own
cache at the jit-traced compiles, and the port traces nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import platform
import re
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

from deep_vision_tpu_torch.obs import locksmith

__all__ = [
    "EXCACHE_ENV",
    "EXCACHE_INVALID_REASONS",
    "ExecutableCache",
    "compiler_version",
    "crc32c_py",
    "env_fingerprint",
]

#: environment variable the CLIs read when --executable-cache is absent
EXCACHE_ENV = "DVT_EXCACHE"

#: why a present entry was refused (journaled as excache_invalid.reason)
EXCACHE_INVALID_REASONS = ("version_skew", "topology_skew", "corrupt",
                           "deserialize_failed")

#: manifest fields that indicate a stale COMPILER when they disagree
_VERSION_FIELDS = ("torch", "compiler", "platform_version")
#: manifest fields that indicate the wrong TOPOLOGY when they disagree
_TOPOLOGY_FIELDS = ("platform", "device_kind", "device_count", "mesh_shape")

_VERSION_LINE = re.compile(r"\d+\.\d+")


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """The first line of `compiler --version` that carries a version
    number (nvcc: "Cuda compilation tools, release 12.9, V12.9.86";
    g++: "g++ (Debian 12.2.0-14) 12.2.0")."""
    out = subprocess.run([compiler, "--version"], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"{compiler} --version failed: "
                           f"{out.stderr.strip()[-400:]}")
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    for ln in lines:
        if _VERSION_LINE.search(ln):
            return ln
    return lines[0] if lines else ""


def _driver_version() -> str:
    """The NVIDIA driver's version: the kernel module's line, else what
    nvidia-smi reports, else "unknown"."""
    try:
        with open("/proc/driver/nvidia/version") as f:
            line = f.readline().strip()
        if line:
            return line
    except OSError:
        pass
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return "driver " + out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


def _device_fields() -> dict:
    import torch

    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"platform": "cuda", "platform_version": _driver_version(),
                "device_kind": f"{props.name} sm_{props.major}{props.minor}",
                "device_count": torch.cuda.device_count()}
    return {"platform": "cpu", "platform_version": "host",
            "device_kind": platform.machine(), "device_count": 1}


def env_fingerprint(compiler: str) -> dict:
    """The environment half of the cache key: everything that, if it
    changes, makes a compiled library unloadable or wrong. Versions
    (torch, the compiler's --version line, the driver; "host" on the
    CPU), then platform, device kind (the card's name and sm_XX, or the
    CPU's arch), device count and the mesh shape (always None: the port
    runs no mesh; the field keeps the reference's manifest)."""
    import torch

    return {
        "torch": torch.__version__,
        "compiler": compiler_version(compiler),
        **_device_fields(),
        "mesh_shape": None,
    }


def _crc_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc_table()


def crc32c_py(data: bytes) -> int:
    """crc32c (Castagnoli), table-driven in Python: the value
    data/native.py `crc32c` gives, for the one entry that cannot use it.
    About 10 MB/s: the record library's payload is tens of kB."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class ExecutableCache:
    """Content-addressed store of compiled shared libraries.

    Wire-up (what core/build.py does for every library once a cache is
    attached; Engine(excache=), Trainer(executable_cache=),
    ProcReplicaPool(excache_dir=) and train_cli --executable-cache
    attach one)::

        cache = ExecutableCache(root, journal=journal)
        key = cache.key_for(files, flags, compiler)
        lib = cache.load(key, compiler, name="nms")  # None: miss/invalid
        if lib is None:
            ...  # compile into cache.build_dir(), then
            cache.store(key, built_path, compiler, name="nms")
            lib = ctypes.CDLL(cache.payload_path(key))

    `load` re-validates the manifest against the CURRENT environment on
    every lookup, even though the fingerprint is hashed into the key.
    """

    def __init__(self, root: str, journal=None, registry=None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.journal = journal
        self._fps: dict = {}
        self._lock = locksmith.lock("core.excache")
        if registry is None:
            from deep_vision_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._c_hits = registry.counter(
            "excache_hits_total", "executable cache hits")
        self._c_misses = registry.counter(
            "excache_misses_total", "executable cache misses")
        self._c_stores = registry.counter(
            "excache_stores_total", "executable cache stores")
        self._c_invalid = registry.counter(
            "excache_invalid_total",
            "present-but-refused executable cache entries")

    # -- keys ---------------------------------------------------------------

    def fingerprint(self, compiler: str) -> dict:
        """env_fingerprint for `compiler`, computed once an object."""
        with self._lock:
            fp = self._fps.get(compiler)
            if fp is None:
                fp = self._fps[compiler] = env_fingerprint(compiler)
            return fp

    def key_for(self, files: Iterable[Path], flags: Sequence[str],
                compiler: str) -> str:
        """Content-addressed key: every file's name and bytes (sources
        and the headers they may include), the flags, and the
        fingerprint under `compiler`."""
        h = hashlib.sha256()
        for f in files:
            h.update(Path(f).name.encode() + b"\0")
            h.update(Path(f).read_bytes())
        h.update("\0".join(flags).encode())
        h.update(json.dumps(self.fingerprint(compiler),
                            sort_keys=True).encode())
        return h.hexdigest()[:32]

    def _paths(self, key: str) -> Tuple[str, str]:
        return (os.path.join(self.root, key + ".so"),
                os.path.join(self.root, key + ".json"))

    def payload_path(self, key: str) -> str:
        return self._paths(key)[0]

    # -- journal/counter plumbing -------------------------------------------

    def _event(self, event: str, key: str, **fields) -> None:
        if self.journal is not None:
            self.journal.write(event, key=key, **fields)

    def _invalid(self, key: str, name: str, reason: str, **fields) -> None:
        self._c_invalid.inc()
        self._event("excache_invalid", key, name=name, reason=reason,
                    **fields)

    def _quarantine(self, key: str, reason: str) -> None:
        """Move both files of a condemned entry aside, so the bad bytes
        stop matching lookups but stay inspectable. Best-effort: a
        warmer that loses the rename race leaves the same outcome."""
        qdir = os.path.join(self.root, "quarantine")
        try:
            os.makedirs(qdir, exist_ok=True)
        except OSError:
            return
        for p in self._paths(key):
            if os.path.exists(p):
                try:
                    os.replace(p, os.path.join(
                        qdir, f"{os.path.basename(p)}.{reason}"))
                except OSError:
                    pass

    @staticmethod
    def _crc32c(blob: bytes, name: str) -> int:
        from deep_vision_tpu_torch.data import native, native_build

        if name == native_build.LIBRARY:  # the library native.crc32c is in
            return crc32c_py(blob)
        return native.crc32c(blob)

    # -- load ---------------------------------------------------------------

    def _check_manifest(self, manifest: dict, compiler: str
                        ) -> Optional[str]:
        """None when the entry's recorded environment matches the current
        one, else the invalid reason; version skew is checked first, so
        a dir copied across both axes reports the one that never heals
        mid-run."""
        recorded = manifest.get("fingerprint")
        if not isinstance(recorded, dict):
            return "corrupt"
        current = self.fingerprint(compiler)
        if any(recorded.get(f) != current.get(f) for f in _VERSION_FIELDS):
            return "version_skew"
        if any(recorded.get(f) != current.get(f) for f in _TOPOLOGY_FIELDS):
            return "topology_skew"
        return None

    def load(self, key: str, compiler: str,
             name: str = "") -> Optional[ctypes.CDLL]:
        """The loaded library for `key`, or None (journaling why).

        miss     -> no entry on disk
        invalid  -> entry present but version/topology-skewed (refused,
                    left in place), or corrupt / unloadable (quarantined)
        """
        so_path, man_path = self._paths(key)
        if not (os.path.exists(so_path) and os.path.exists(man_path)):
            self._c_misses.inc()
            self._event("excache_miss", key, name=name)
            return None
        try:
            with open(man_path) as f:
                manifest = json.load(f)
            if not isinstance(manifest, dict):
                raise ValueError("manifest is not an object")
        except (OSError, ValueError):
            self._quarantine(key, "corrupt")
            self._invalid(key, name, "corrupt", detail="unreadable manifest")
            return None
        skew = self._check_manifest(manifest, compiler)
        if skew == "corrupt":
            self._quarantine(key, "corrupt")
            self._invalid(key, name, "corrupt",
                          detail="manifest carries no fingerprint")
            return None
        if skew is not None:
            current = self.fingerprint(compiler)
            self._invalid(key, name, skew, recorded={
                f: manifest["fingerprint"].get(f)
                for f in _VERSION_FIELDS + _TOPOLOGY_FIELDS
                if manifest["fingerprint"].get(f) != current.get(f)})
            return None
        try:
            with open(so_path, "rb") as f:
                blob = f.read()
        except OSError as e:
            self._c_misses.inc()
            self._event("excache_miss", key, name=name,
                        detail=f"{type(e).__name__}: {e}"[:200])
            return None
        if self._crc32c(blob, name) != manifest.get("crc32c"):
            self._quarantine(key, "corrupt")
            self._invalid(key, name, "corrupt",
                          detail="payload crc32c mismatch")
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            # crc-valid bytes the loader refuses: condemn and rebuild
            self._quarantine(key, "deserialize_failed")
            self._invalid(key, name, "deserialize_failed",
                          detail=f"{type(e).__name__}: {e}"[:200])
            return None
        self._c_hits.inc()
        self._event("excache_hit", key, name=name, bytes=len(blob))
        return lib

    # -- store --------------------------------------------------------------

    def store(self, key: str, payload: Path, compiler: str,
              name: str = "") -> bool:
        """Copy a freshly built library into the entry (payload first,
        manifest last, both tmp+fsync+rename). Never raises: a cache
        that cannot be written degrades to building every time, with a
        journaled note."""
        try:
            blob = Path(payload).read_bytes()
            manifest = {
                "key": key,
                "name": name,
                "crc32c": self._crc32c(blob, name),
                "bytes": len(blob),
                "fingerprint": self.fingerprint(compiler),
                "created": time.time(),
            }
            for path, data in zip(self._paths(key),
                                  (blob, json.dumps(manifest).encode())):
                # pid+thread-unique tmp: concurrent warmers of one key
                # never truncate each other's in-flight file
                tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
        except OSError as e:
            if self.journal is not None:
                self.journal.write(
                    "note", note="excache_store_failed", key=key, name=name,
                    error=f"{type(e).__name__}: {e}"[:200])
            return False
        self._c_stores.inc()
        self._event("excache_store", key, name=name, bytes=len(blob))
        return True

    def build_dir(self) -> str:
        """A private directory under the root for one build's outputs
        (the caller removes it)."""
        return tempfile.mkdtemp(prefix=".build-", dir=self.root)
