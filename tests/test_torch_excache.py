"""The port's executable cache (core/excache.py) over its compiled
libraries, on the CPU: the counterparts of the reference's cache cases
that run here (tests/test_excache.py:86-246, :617), and the real seam.

The cache-core cases store a tiny library that g++ builds once a module
(a probe, `dv_probe()`); `get_or_build` stores it. Held: the key covers
the sources, the flags and every fingerprint field; a miss is journaled;
an entry whose manifest disagrees with the environment in one field is
refused with `version_skew` (torch, compiler, platform_version) or
`topology_skew` (platform, device_kind, device_count, mesh_shape), left
in place and rebuilt; a corrupt payload or manifest is quarantined; crc
valid garbage as the .so gives `deserialize_failed`, a quarantine and a
rebuild; four threads warming one dir converge on one entry with the
lock sanitizer armed; the reasons are tools/check_journal.py's; every
journal passes `check_journal --strict`. The seam: the record library,
built by g++ through core/build.py, goes through the cache in two fresh
subprocesses (OMP_NUM_THREADS=1): the first compiles 1 library and
stores it, the second compiles 0 and hits, and both read the same
records through it.
"""
import ctypes
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import google_crc32c
import numpy as np
import pytest

from deep_vision_tpu_torch.core import build
from deep_vision_tpu_torch.core.excache import (
    _TOPOLOGY_FIELDS,
    _VERSION_FIELDS,
    EXCACHE_ENV,
    EXCACHE_INVALID_REASONS,
    ExecutableCache,
    compiler_version,
    crc32c_py,
    env_fingerprint,
)
from deep_vision_tpu_torch.core.knobs import KNOBS
from deep_vision_tpu_torch.data import native, native_build
from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.check_journal import check_journal  # noqa: E402

FLAGS = ("-O2", "-shared", "-fPIC")
SKEW = {"torch": "version_skew", "compiler": "version_skew",
        "platform_version": "version_skew", "platform": "topology_skew",
        "device_kind": "topology_skew", "device_count": "topology_skew",
        "mesh_shape": "topology_skew"}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """(g++, the probe's source, a built copy of it)."""
    d = tmp_path_factory.mktemp("probe")
    src = d / "probe.c"
    src.write_text('extern "C" int dv_probe(void) { return 7; }\n')
    cxx = native_build.find_cxx()
    so = d / "probe.so"
    subprocess.run([cxx, *FLAGS, "-o", str(so), str(src)], check=True)
    return cxx, src, so


def get_or_build(cache, key, probe, name="probe"):
    """(library, "cache" | "built"): the entry's library, else the probe
    stored and loaded from the entry, as core/build.py does a library
    after compiling it."""
    lib = cache.load(key, probe[0], name=name)
    if lib is not None:
        return lib, "cache"
    assert cache.store(key, probe[2], probe[0], name=name)
    return ctypes.CDLL(cache.payload_path(key)), "built"


def events(path, name=None):
    return [e for e in read_journal(path)
            if name is None or e["event"] == name]


def journal_at(tmp_path, name="j.jsonl"):
    return RunJournal(str(tmp_path / name), kind="serve")


def stored(tmp_path, probe, journal=None):
    """A cache at tmp_path/c holding the probe's entry -> (cache, key)."""
    cache = ExecutableCache(str(tmp_path / "c"), journal=journal,
                            registry=Registry())
    key = cache.key_for([probe[1]], FLAGS, probe[0])
    lib, source = get_or_build(cache, key, probe)
    assert source == "built" and lib.dv_probe() == 7
    return cache, key


# -- keys and fingerprint --------------------------------------------------------

def test_fingerprint_fields_on_the_cpu(probe):
    fp = env_fingerprint(probe[0])
    assert set(fp) == set(_VERSION_FIELDS + _TOPOLOGY_FIELDS)
    assert fp["compiler"] == compiler_version(probe[0])
    assert "g++" in fp["compiler"] or "gcc" in fp["compiler"]
    assert (fp["platform"], fp["platform_version"]) == ("cpu", "host")
    assert fp["device_count"] == 1 and fp["mesh_shape"] is None
    assert KNOBS[EXCACHE_ENV].kind == "str"


@pytest.mark.parametrize("change", ["source", "header", "flags",
                                    *SKEW])
def test_key_covers_sources_flags_and_every_field(tmp_path, probe, change):
    cache = ExecutableCache(str(tmp_path / "c"), registry=Registry())
    header = tmp_path / "probe.h"
    header.write_text("#define DV 7\n")
    files, flags = [probe[1], header], FLAGS
    before = cache.key_for(files, flags, probe[0])
    assert cache.key_for(files, flags, probe[0]) == before
    if change == "source":
        src = tmp_path / "probe.c"
        src.write_text(probe[1].read_text() + "/* edited */\n")
        files = [src, header]
    elif change == "header":
        header.write_text("#define DV 8\n")
    elif change == "flags":
        flags = FLAGS + ("-g",)
    else:
        fp = dict(cache.fingerprint(probe[0]))
        fp[change] = [9, 9] if change == "mesh_shape" else "other"
        cache._fps[probe[0]] = fp
    assert cache.key_for(files, flags, probe[0]) != before


def test_crc32c_py_is_native_crc32c():
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 4096, 100_003):
        blob = rng.bytes(n)
        assert crc32c_py(blob) == native.crc32c(blob) == \
            google_crc32c.value(blob)


# -- load, store, refusals ------------------------------------------------------

def test_round_trip_and_miss_journaled(tmp_path, probe):
    journal = journal_at(tmp_path)
    cache, key = stored(tmp_path, probe, journal)
    assert cache.load("deadbeef" * 4, probe[0], name="nope") is None
    fresh = ExecutableCache(cache.root, journal=journal, registry=Registry())
    lib, source = get_or_build(fresh, key, probe)
    assert source == "cache" and lib.dv_probe() == 7
    journal.close()
    rows = [(e["event"], e["key"]) for e in events(journal.path)
            if e["event"].startswith("excache_")]
    assert rows == [("excache_miss", key), ("excache_store", key),
                    ("excache_miss", "deadbeef" * 4), ("excache_hit", key)]
    with open(os.path.join(cache.root, key + ".json")) as f:
        man = json.load(f)
    assert man["crc32c"] == google_crc32c.value(
        Path(cache.payload_path(key)).read_bytes())
    assert man["fingerprint"] == cache.fingerprint(probe[0])
    assert check_journal(journal.path, strict=True) == []


@pytest.mark.parametrize("field", list(SKEW))
def test_skewed_entry_refused(tmp_path, probe, field):
    journal = journal_at(tmp_path)
    cache, key = stored(tmp_path, probe, journal)
    man = os.path.join(cache.root, key + ".json")
    doc = json.load(open(man))
    doc["fingerprint"][field] = ([9, 9] if field == "mesh_shape"
                                 else 999 if field == "device_count"
                                 else "skewed-by-test")
    with open(man, "w") as fh:
        fh.write(json.dumps(doc))
    fresh = ExecutableCache(cache.root, journal=journal, registry=Registry())
    assert fresh.load(key, probe[0], name="probe") is None
    lib, source = get_or_build(fresh, key, probe)
    assert source == "built" and lib.dv_probe() == 7
    journal.close()
    inv = events(journal.path, "excache_invalid")
    assert [e["reason"] for e in inv] == [SKEW[field]] * 2
    assert list(inv[0]["recorded"]) == [field]
    # skewed entries stay in place, and the rebuild's store replaced it
    assert not os.path.exists(os.path.join(cache.root, "quarantine"))
    assert fresh.load(key, probe[0], name="probe") is not None
    assert check_journal(journal.path, strict=True) == []


def test_corrupt_payload_quarantined(tmp_path, probe):
    journal = journal_at(tmp_path)
    cache, key = stored(tmp_path, probe, journal)
    with open(cache.payload_path(key), "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xde\xad\xbe\xef")
    lib, source = get_or_build(cache, key, probe)
    assert source == "built" and lib.dv_probe() == 7
    qdir = os.path.join(cache.root, "quarantine")
    assert sorted(os.listdir(qdir)) == [f"{key}.json.corrupt",
                                        f"{key}.so.corrupt"]
    journal.close()
    inv = events(journal.path, "excache_invalid")
    assert [(e["reason"], e["detail"]) for e in inv] == [
        ("corrupt", "payload crc32c mismatch")]
    assert cache.load(key, probe[0], name="probe") is not None
    assert check_journal(journal.path, strict=True) == []


@pytest.mark.parametrize("manifest", ["{not json", "[1, 2]", "{}"])
def test_corrupt_manifest_quarantined(tmp_path, probe, manifest):
    journal = journal_at(tmp_path)
    cache, key = stored(tmp_path, probe, journal)
    with open(os.path.join(cache.root, key + ".json"), "w") as fh:
        fh.write(manifest)
    assert cache.load(key, probe[0], name="probe") is None
    assert os.path.isdir(os.path.join(cache.root, "quarantine"))
    journal.close()
    assert [e["reason"] for e in events(journal.path, "excache_invalid")] \
        == ["corrupt"]


def test_unloadable_payload_quarantined_and_rebuilt(tmp_path, probe):
    """crc-VALID bytes the loader refuses: rewrite payload and crc. The
    entry is stored without loading it here: a process that has loaded a
    path gets the loaded library back from dlopen, whatever the file now
    holds (in use, a library loads once a process)."""
    journal = journal_at(tmp_path)
    cache = ExecutableCache(str(tmp_path / "c"), journal=journal,
                            registry=Registry())
    key = cache.key_for([probe[1]], FLAGS, probe[0])
    assert cache.store(key, probe[2], probe[0], name="probe")
    blob = b"not a shared library" * 10
    with open(cache.payload_path(key), "wb") as fh:
        fh.write(blob)
    man = os.path.join(cache.root, key + ".json")
    doc = json.load(open(man))
    doc["crc32c"] = int(google_crc32c.value(blob))
    with open(man, "w") as fh:
        fh.write(json.dumps(doc))
    lib, source = get_or_build(cache, key, probe)
    assert source == "built" and lib.dv_probe() == 7
    qdir = os.path.join(cache.root, "quarantine")
    assert f"{key}.so.deserialize_failed" in os.listdir(qdir)
    journal.close()
    (inv,) = events(journal.path, "excache_invalid")
    assert inv["reason"] == "deserialize_failed"
    assert check_journal(journal.path, strict=True) == []


def test_concurrent_warmers_one_dir(tmp_path, probe):
    """Four threads racing get_or_build on one dir, each its own cache
    object: every warmer gets a working library, the dir converges to one
    entry, nothing torn is left, and the sanitizer sees no violation."""
    locksmith.arm(registry=Registry())
    try:
        root = str(tmp_path / "c")
        results, errors = [], []
        barrier = threading.Barrier(4)

        def warm(i):
            try:
                cache = ExecutableCache(root, registry=Registry())
                key = cache.key_for([probe[1]], FLAGS, probe[0])
                barrier.wait(timeout=30)
                lib, source = get_or_build(cache, key, probe, f"w{i}")
                results.append((source, lib.dv_probe()))
            except Exception as e:  # pragma: no cover - failure detail
                errors.append(e)

        threads = [threading.Thread(target=warm, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and len(results) == 4
        assert {r[1] for r in results} == {7}
        names = sorted(os.listdir(root))
        assert [n.rsplit(".", 1)[1] for n in names] == ["json", "so"]
        assert not locksmith.report()["violations"]
    finally:
        locksmith.disarm()


def test_reasons_in_sync_with_check_journal():
    from tools.check_journal import EXCACHE_INVALID_REASONS as SCHEMA

    assert set(EXCACHE_INVALID_REASONS) == SCHEMA


# -- the build seam ---------------------------------------------------------------

@pytest.fixture
def detached():
    yield
    build.detach_cache()


def test_one_cache_a_process(tmp_path, detached):
    a = ExecutableCache(str(tmp_path / "a"), registry=Registry())
    assert build.attach_cache(a) is a
    again = ExecutableCache(str(tmp_path / "a"), registry=Registry())
    assert build.attach_cache(again) is a
    with pytest.raises(RuntimeError, match="second root"):
        build.attach_cache(ExecutableCache(str(tmp_path / "b"),
                                           registry=Registry()))
    from deep_vision_tpu_torch.serve import Engine

    with pytest.raises(RuntimeError, match="second root"):
        Engine(device="cpu", excache=ExecutableCache(str(tmp_path / "b"),
                                                     registry=Registry()))
    assert Engine(device="cpu", excache=again).excache is a


def test_a_loaded_library_is_not_described_again(monkeypatch):
    """The wrappers load their library at every call (ops/cuda/nms.py
    `_lib`, data/native.py `load_library`): once a library is loaded,
    a load must not describe it again (hashing its sources: ~0.7 ms a
    call)."""
    from deep_vision_tpu_torch.ops.cuda import build as cuda_build

    native.load_library()

    def described(*args):
        raise AssertionError("a loaded library was described again")

    monkeypatch.setattr(native_build, "library", described)
    monkeypatch.setattr(cuda_build, "library", described)
    monkeypatch.setattr(build, "hashed_path", described)
    assert native.crc32c(b"abc") == google_crc32c.value(b"abc")
    fake = object()
    monkeypatch.setitem(build._loaded, "nms", fake)
    assert cuda_build.load("nms") is fake


SEAM = """
import hashlib, json, sys
from deep_vision_tpu_torch.core import build
from deep_vision_tpu_torch.core.excache import ExecutableCache
from deep_vision_tpu_torch.data import native
from deep_vision_tpu_torch.obs.journal import RunJournal
root, journal_path, shard = sys.argv[1:]
journal = RunJournal(journal_path, kind="serve")
build.attach_cache(ExecutableCache(root, journal=journal))
records = list(native.read_records_native(shard))
journal.close()
print(json.dumps({"builds": build.build_count(),
                  "loads": build.cache_load_count(), "n": len(records),
                  "sha": hashlib.sha256(b"".join(records)).hexdigest()}))
"""


def test_record_library_through_the_cache_in_fresh_processes(tmp_path):
    from deep_vision_tpu_torch.data.records import RecordWriter

    shard = str(tmp_path / "shard.tfrecord")
    rng = np.random.RandomState(0)
    with RecordWriter(shard) as w:
        for i in range(5):
            w.write(rng.bytes(100 + i))
    root = str(tmp_path / "c")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    out = []
    for i in range(2):
        path = str(tmp_path / f"j{i}.jsonl")
        res = subprocess.run(
            [sys.executable, "-c", SEAM, root, path, shard], cwd=ROOT,
            capture_output=True, text=True, timeout=120, env=env)
        assert res.returncode == 0, res.stderr[-2000:]
        out.append((json.loads(res.stdout.splitlines()[-1]),
                    [(e["event"], e["name"]) for e in events(path)
                     if e["event"].startswith("excache_")]))
        assert check_journal(path, strict=True) == []
    (first, first_rows), (second, second_rows) = out
    lib = native_build.LIBRARY
    assert (first["builds"], first["loads"]) == (1, 0)
    assert first_rows == [("excache_miss", lib), ("excache_store", lib)]
    assert (second["builds"], second["loads"]) == (0, 1)
    assert second_rows == [("excache_hit", lib)]
    assert first["n"] == second["n"] == 5 and first["sha"] == second["sha"]
    names = [json.load(open(os.path.join(root, f)))["name"]
             for f in os.listdir(root) if f.endswith(".json")]
    assert names == [lib]
