"""TFRecord-compatible record container IO (no TensorFlow dependency).

A port of deep_vision_tpu/data/records.py: the same shard files, byte
for byte, and the same reader semantics. The shard files every
reference converter writes (`Datasets/VOC2007/tfrecords.py:110-121`,
`Datasets/MSCOCO/tfrecords.py`, `build_imagenet_tfrecord.py`) use the
TFRecord framing:

    uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)

The masked crc32c comes from the native library (`native/crc32c.cc`,
compiled at first use by data/native_build.py), where the reference
uses `google_crc32c`; the C++ reader (`native/record_reader.cc`) is the
training path (`best_reader`).

Degradation contract (the Varuna/Check-N-Run posture: at production scale
SOME shard always has a rotten byte): `read_records` keeps its strict
raise-on-corruption semantics (native-reader parity), while
`read_records_tolerant` + `BadRecordBudget` skip bad records under a
bounded budget — each skip is appended to a dead-letter JSONL with
file + byte offset + reason, and the run aborts with a clear
`BadRecordBudgetExceeded` once the budget is spent. Because a record's
data CRC sits behind an intact length header, data corruption is
resyncable (skip exactly that record); a corrupt *header* loses the
framing, so the shard remainder is dead-lettered as one event rather
than risking garbage frames.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import random
import struct
import sys
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from deep_vision_tpu_torch.data.native import (
    masked_crc32c as _masked_crc,
    read_records_native,
)
from deep_vision_tpu_torch.obs.registry import get_registry
from deep_vision_tpu_torch.resilience import RetryPolicy


class RecordWriter:
    """Append-only TFRecord-framing writer."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, records: Iterable[bytes]) -> int:
    n = 0
    with RecordWriter(path) as w:
        for r in records:
            w.write(r)
            n += 1
    return n


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one file (strict: corruption raises)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise EOFError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if verify and _masked_crc(header) != hcrc:
                raise IOError(f"corrupt record header in {path}")
            data = f.read(length)
            if len(data) < length:
                raise EOFError(f"truncated record in {path}")
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify and _masked_crc(data) != dcrc:
                raise IOError(f"corrupt record in {path}")
            yield data


# -- bounded-degradation reading ---------------------------------------------

class BadRecordBudgetExceeded(RuntimeError):
    """The run's tolerance for bad records is spent; aborting is now the
    correct behavior (silent unbounded skipping would train on a silently
    shrinking dataset)."""


class BadRecordBudget:
    """Counts skipped records against a bound and dead-letters each one.

    max_count:     absolute cap on skipped records (None = uncapped).
    max_fraction:  cap on bad/seen, enforced once `min_seen` records have
                   been observed (a fraction over 3 records is noise).
    dead_letter_path: JSONL, one line per skipped record with file, byte
                   offset, reason, and timestamp. Appended with O_APPEND
                   per line so worker processes can share one file.

    Thread-safe; picklable (DataLoader worker processes receive a copy, so
    with `num_procs > 0` the bound applies per worker — the global worst
    case is num_procs * budget, documented in the README).
    """

    def __init__(self, max_count: Optional[int] = None,
                 max_fraction: Optional[float] = None,
                 min_seen: int = 100,
                 dead_letter_path: Optional[str] = None):
        if max_count is None and max_fraction is None:
            raise ValueError("budget needs max_count and/or max_fraction")
        self.max_count = max_count
        self.max_fraction = max_fraction
        self.min_seen = min_seen
        self.dead_letter_path = dead_letter_path
        self.bad = 0
        self.ok = 0
        # snapshot-resume replay latch (data/snapshot.py): while True,
        # record_bad still COUNTS (the deterministic replay must re-spend
        # the epoch's budget to land on the saved position) but skips the
        # dead-letter row and stderr line — the original run already
        # emitted them for this prefix
        self.replaying = False
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, **kw) -> "BadRecordBudget":
        """CLI form: a value < 1 is a fraction, >= 1 an absolute count."""
        v = float(spec)
        if v <= 0:
            raise ValueError(f"bad-record budget must be positive, got {spec}")
        if v < 1.0:
            return cls(max_fraction=v, **kw)
        return cls(max_count=int(v), **kw)

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_lock"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    def describe(self) -> str:
        parts = []
        if self.max_count is not None:
            parts.append(f"max_count={self.max_count}")
        if self.max_fraction is not None:
            parts.append(f"max_fraction={self.max_fraction}")
        return " ".join(parts)

    def record_ok(self, n: int = 1) -> None:
        with self._lock:
            self.ok += n

    def spend(self) -> dict:
        """The current (bad, ok) counters, for the pipeline snapshot."""
        with self._lock:
            return {"bad": self.bad, "ok": self.ok}

    def set_spend(self, spend: dict) -> None:
        """Restore counters from a snapshot (data/snapshot.py resume)."""
        with self._lock:
            self.bad = int(spend.get("bad", 0))
            self.ok = int(spend.get("ok", 0))

    def _exceeded(self) -> bool:
        if self.max_count is not None and self.bad > self.max_count:
            return True
        seen = self.bad + self.ok
        return (self.max_fraction is not None and seen >= self.min_seen
                and self.bad / seen > self.max_fraction)

    def record_bad(self, path: str, offset: int, reason: str) -> None:
        """Account one skipped record; raises once the budget is spent."""
        with self._lock:
            self.bad += 1
            bad = self.bad
        if self.replaying:
            # snapshot replay: count silently (see __init__), still abort
            # once spent — a budget the original run exhausted must not
            # survive the resume
            if self._exceeded():
                raise BadRecordBudgetExceeded(
                    f"bad-record budget exceeded during snapshot replay "
                    f"({self.describe()}): {self.bad} bad of "
                    f"{self.bad + self.ok} seen")
            return
        row = {"ts": round(time.time(), 3), "path": path,
               "offset": int(offset), "reason": reason}
        if self.dead_letter_path:
            d = os.path.dirname(self.dead_letter_path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.dead_letter_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        get_registry().counter(
            "data_bad_records_total", "records skipped as bad").inc()
        # first few loudly, then every 100th: a rotting dataset must be
        # visible in the log without drowning it
        if bad <= 5 or bad % 100 == 0:
            print(f"data: SKIPPED bad record #{bad} at {path}:{offset} "
                  f"({reason})"
                  + (f" -> {self.dead_letter_path}"
                     if self.dead_letter_path else ""),
                  file=sys.stderr)
        if self._exceeded():
            raise BadRecordBudgetExceeded(
                f"bad-record budget exceeded ({self.describe()}): "
                f"{self.bad} bad of {self.bad + self.ok} seen; last: "
                f"{path}:{offset} ({reason})"
                + (f"; full list in {self.dead_letter_path}"
                   if self.dead_letter_path else ""))


# shard opens retry transient I/O (flaky network filesystems); corruption
# inside the file is the budget's job, not the retry's
_OPEN_RETRY = RetryPolicy(name="data.open", max_attempts=3,
                          base_delay_s=0.2, max_delay_s=2.0)


def read_records_tolerant(
    path: str, budget: BadRecordBudget, verify: bool = True
) -> Iterator[Tuple[int, bytes]]:
    """Yield (byte_offset, payload), skipping bad records under `budget`.

    Data-CRC corruption is resyncable (the length header framed the record)
    and skips exactly one record; a corrupt/truncated header loses the
    framing, so the shard remainder is dead-lettered as ONE budget event.
    `BadRecordBudgetExceeded` propagates to the caller — that is the abort.
    """
    with _OPEN_RETRY.call(open, path, "rb") as f:
        while True:
            offset = f.tell()
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                budget.record_bad(path, offset, "truncated record header")
                return
            (length,) = struct.unpack("<Q", header)
            hcrc_b = f.read(4)
            if len(hcrc_b) < 4 or (
                    verify and _masked_crc(header) != struct.unpack(
                        "<I", hcrc_b)[0]):
                budget.record_bad(
                    path, offset,
                    "corrupt record header (framing lost; skipping the "
                    "shard remainder)")
                return
            data = f.read(length)
            dcrc_b = f.read(4)
            if len(data) < length or len(dcrc_b) < 4:
                budget.record_bad(path, offset, "truncated record")
                return
            if verify and _masked_crc(data) != struct.unpack("<I", dcrc_b)[0]:
                budget.record_bad(path, offset, "corrupt record data")
                continue
            yield offset, data
            budget.record_ok()


def best_reader():
    """The fastest single-file record reader: the native C++ one (GIL-free
    IO + crc), which the port always builds. It has `read_records`'s
    iteration order and exceptions."""
    return read_records_native


def expand_shards(pattern: Union[str, Sequence[str]]) -> List[str]:
    """Glob pattern(s) -> sorted shard list (list_files analog, deterministic)."""
    patterns = [pattern] if isinstance(pattern, str) else list(pattern)
    files: List[str] = []
    for p in patterns:
        matched = sorted(_glob.glob(p)) if any(c in p for c in "*?[") else [p]
        files.extend(matched)
    if not files:
        raise FileNotFoundError(f"no record shards match {pattern!r}")
    return files


def record_iterator(
    pattern: Union[str, Sequence[str]],
    *,
    shuffle_shards: bool = False,
    seed: Optional[int] = None,
    shard_index: int = 0,
    num_shards: int = 1,
) -> Iterator[bytes]:
    """Iterate records across shards.

    `shard_index/num_shards` split the *file list* across hosts — the
    host-sharded input feed for multi-host training (each host reads only its
    shard subset, the pjit analog of `experimental_distribute_dataset` at
    YOLO/tensorflow/train.py:291-294).
    """
    files = expand_shards(pattern)
    files = files[shard_index::num_shards]
    if shuffle_shards:
        random.Random(seed).shuffle(files)
    reader = best_reader()
    for path in files:
        yield from reader(path)
