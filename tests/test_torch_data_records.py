"""Port parity: the record layer (data/example_codec.py, data/records.py,
data/native.py and its build, resilience/retry.py) against the JAX
package's own, on the CPU.

The codec and the writer must be byte-identical to the reference's, so
shards written by either side are the same files; the readers must read
the reference's shards and fail on the same faults with the same error
types; the masked crc32c, which the port takes from the native library
built from native/*.cc, must equal `google_crc32c`'s as the reference
masks it; the tolerant reader must dead-letter the same (path, offset)
pairs and give up at the same record.
"""
import json
import os
import shutil

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deep_vision_tpu.data import example_codec as ref_codec
from deep_vision_tpu.data import records as ref_records
from deep_vision_tpu.resilience.retry import RetryPolicy as RefRetryPolicy
from deep_vision_tpu_torch.data import example_codec, native, native_build
from deep_vision_tpu_torch.data import records
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.core import build
from deep_vision_tpu_torch.resilience import RetryPolicy

INT64 = st.integers(-2 ** 63, 2 ** 63 - 1)
FEATURE = st.one_of(
    st.lists(st.binary(max_size=40), max_size=4),
    st.lists(st.floats(width=32, allow_nan=False), min_size=1, max_size=6),
    st.lists(INT64, min_size=1, max_size=6),
)


# -- codec -------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(min_size=1, max_size=12), FEATURE,
                       max_size=5))
def test_encode_example_is_byte_identical_and_cross_decodes(features):
    got = example_codec.encode_example(features)
    assert got == ref_codec.encode_example(features)
    assert example_codec.decode_example(got) == \
        ref_codec.decode_example(got)
    decoded = example_codec.decode_example(ref_codec.encode_example(features))
    assert decoded == {k: list(v) for k, v in features.items()}


def test_codec_keeps_the_references_mixed_and_numpy_rules():
    feats = {"mixed": [0, 0.5], "np": [np.int64(3), np.int32(-4)],
             "f": [np.float32(1.5)], "s": ["text"], "empty": []}
    got = example_codec.encode_example(feats)
    assert got == ref_codec.encode_example(feats)
    assert example_codec.decode_example(got) == {
        "mixed": [0.0, 0.5], "np": [3, -4], "f": [1.5], "s": [b"text"],
        "empty": []}
    with pytest.raises(TypeError):
        example_codec.encode_example({"bad": [object()]})


# -- records -----------------------------------------------------------------

def payloads(seed, n=20):
    rng = np.random.RandomState(seed)
    sizes = [0, 1, 7, 1000, 70_000] + list(rng.randint(0, 5000, n - 5))
    return [rng.bytes(int(s)) for s in sizes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_shards_are_byte_identical_to_the_references(seed, tmp_path):
    data = payloads(seed)
    assert records.write_records(str(tmp_path / "port"), data) == len(data)
    ref_records.write_records(str(tmp_path / "ref"), data)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()


READERS = {
    "python": records.read_records,
    "native": native.read_records_native,
    "best": records.best_reader(),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_port_readers_read_reference_shards(reader, tmp_path):
    data = payloads(3)
    path = str(tmp_path / "shard")
    ref_records.write_records(path, data)
    assert list(READERS[reader](path)) == data


def test_record_iterator_and_the_native_pool_read_reference_shards(tmp_path):
    shards = []
    for i in range(3):
        shards.append(str(tmp_path / f"s{i}"))
        ref_records.write_records(shards[-1], payloads(10 + i, 8))
    want = list(ref_records.record_iterator(str(tmp_path / "s*"),
                                            shuffle_shards=True, seed=4))
    assert list(records.record_iterator(str(tmp_path / "s*"),
                                        shuffle_shards=True, seed=4)) == want
    assert records.expand_shards(str(tmp_path / "s*")) == shards
    assert sorted(native.pool_records_native(shards, num_threads=2)) == \
        sorted(want)
    with pytest.raises(FileNotFoundError):
        records.expand_shards(str(tmp_path / "none*"))


@pytest.mark.parametrize("data", [b"", b"x", b"hello world" * 100,
                                  bytes(range(256)) * 40])
def test_masked_crc_equals_google_crc32c_masked(data):
    import google_crc32c

    crc = google_crc32c.value(data)
    want = ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF
    assert native.masked_crc32c(data) == want == ref_records._masked_crc(data)
    assert native.masked_crc32c(bytearray(data)) == want


def damage(path, how):
    """Damage the fourth record (1,000 bytes) of a payloads(5) shard."""
    raw = bytearray(open(path, "rb").read())
    at = sum(16 + len(p) for p in payloads(5)[:3])  # its offset
    if how == "data":
        raw[at + 12 + 3] ^= 0xFF  # a byte of its data
    elif how == "header":
        raw[at + 2] ^= 0xFF  # its length
    elif how == "truncated":
        raw = raw[:at + 12 + 500]  # cut inside its data
    elif how == "short_header":
        raw = raw[:at + 5]
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("how", ["data", "header", "truncated",
                                 "short_header"])
@pytest.mark.parametrize("reader", ["python", "native"])
def test_faults_raise_the_references_error_types(reader, how, tmp_path):
    path = str(tmp_path / "shard")
    records.write_records(path, payloads(5))
    damage(path, how)
    with pytest.raises(Exception) as want:
        list(ref_records.read_records(path))
    with pytest.raises(Exception) as got:
        list(READERS[reader](path))
    assert type(got.value) is type(want.value)
    assert isinstance(got.value, (IOError, EOFError))
    if reader == "python":
        assert str(got.value) == str(want.value)


def tolerant_run(mod, paths, budget):
    got = []
    try:
        for p in paths:
            for offset, data in mod.read_records_tolerant(p, budget):
                got.append((p, offset, data))
    except mod.BadRecordBudgetExceeded as e:
        return got, type(e).__name__
    return got, None


@pytest.mark.parametrize("max_count", [1, 2, 10])
def test_tolerant_reader_dead_letters_the_same_records(max_count, tmp_path):
    paths = []
    for i, how in enumerate(["data", "truncated", "header", None]):
        paths.append(str(tmp_path / f"s{i}"))
        records.write_records(paths[-1], payloads(5))
        if how:
            damage(paths[-1], how)
    rows = {}
    for name, mod in (("port", records), ("ref", ref_records)):
        dead = str(tmp_path / f"{name}.jsonl")
        budget = mod.BadRecordBudget(max_count=max_count,
                                     dead_letter_path=dead)
        got, exceeded = tolerant_run(mod, paths, budget)
        with open(dead) as f:
            letters = [json.loads(line) for line in f]
        rows[name] = (got, exceeded, budget.spend(),
                      [(r["path"], r["offset"], r["reason"])
                       for r in letters])
    assert rows["port"] == rows["ref"]
    assert rows["port"][1] == (None if max_count >= 3
                               else "BadRecordBudgetExceeded")


def test_budget_fraction_parse_and_pickle_match_the_reference():
    import pickle

    for spec in ("0.25", "3"):
        got, want = (records.BadRecordBudget.parse(spec, min_seen=4),
                     ref_records.BadRecordBudget.parse(spec, min_seen=4))
        assert (got.max_count, got.max_fraction, got.describe()) == (
            want.max_count, want.max_fraction, want.describe())
    budget = pickle.loads(pickle.dumps(records.BadRecordBudget(max_count=2)))
    budget.record_ok(3)
    assert budget.spend() == {"bad": 0, "ok": 3}
    with pytest.raises(ValueError):
        records.BadRecordBudget()


# -- the native library's build ----------------------------------------------

def test_native_library_is_built_with_gxx_into_the_build_dir(
        monkeypatch, tmp_path):
    assert native_build.library_path().parent == build.BUILD_DIR
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    lib = native_build.library_path()
    assert lib.parent == tmp_path / "build"
    assert lib.name.startswith("dvtpu_records-") and lib.suffix == ".so"
    assert native_build.build() > 0.0 and lib.exists()
    assert native_build.build() == 0.0  # built once, then reused
    assert "-msse4.2" not in native_build.CXX_FLAGS or \
        os.uname().machine == "x86_64"
    assert {"-O3", "-std=c++17", "-fPIC", "-pthread"} <= set(
        native_build.CXX_FLAGS)


def test_the_native_library_name_covers_its_sources_and_flags(
        monkeypatch, tmp_path):
    before = native_build.library_path()
    monkeypatch.setattr(native_build, "CXX_FLAGS",
                        native_build.CXX_FLAGS + ("-g",))
    assert native_build.library_path() != before
    monkeypatch.undo()
    for f in native_build.SOURCES + native_build.HEADERS:
        shutil.copy(native_build.NATIVE_DIR / f, tmp_path / f)
    monkeypatch.setattr(native_build, "NATIVE_DIR", tmp_path)
    assert native_build.library_path() == before
    with open(tmp_path / "crc32c.h", "a") as f:
        f.write("// edited\n")
    assert native_build.library_path() != before


def test_no_compiler_raises_naming_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build()
    assert not (tmp_path / "build").exists()


# -- retry -------------------------------------------------------------------

def test_retry_policy_schedule_and_outcomes_match_the_reference():
    kw = dict(name="t", max_attempts=4, base_delay_s=0.1, jitter=0.5,
              seed=7)
    got, want = RetryPolicy(**kw), RefRetryPolicy(**kw)
    assert [got.delay(a) for a in range(1, 6)] == \
        [want.delay(a) for a in range(1, 6)]
    for policy_cls in (RetryPolicy, RefRetryPolicy):
        slept, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        policy = policy_cls(name="t", max_attempts=4, seed=1,
                            sleep=slept.append)
        assert policy.call(flaky) == "ok" and len(calls) == 3
        assert len(slept) == 2
        with pytest.raises(ValueError):
            policy.call(lambda: (_ for _ in ()).throw(ValueError("bug")))
    reg = Registry()
    policy = RetryPolicy(name="open", max_attempts=2, sleep=lambda s: None,
                         registry=reg)
    with pytest.raises(OSError):
        policy.call(open, "/nonexistent/shard")
    assert reg.counter("retry_attempts_total",
                       labels={"policy": "open"}).value == 1
    assert reg.counter("retry_giveups_total",
                       labels={"policy": "open"}).value == 1
