"""Input-pipeline checkpointing: the data iterator as a checkpoint citizen.

A copy of deep_vision_tpu/data/snapshot.py. A `DataLoaderState`
captures everything host-side the pipeline needs to reproduce its
position — epoch, batches consumed, epoch seed, the shard cursor (which
shard / which record the reader had reached), the buffer-shuffle RNG
state, and the `BadRecordBudget` spend — as a JSON-clean dict
(`DataLoader.state_dict`), so a kill/resume replays a byte-identical
batch stream instead of restarting from shard zero. The port's
checkpoints, which will carry it beside the model state, come with the
rest of the Trainer.

Resume semantics (the part worth being precise about):

* Every random decision in an epoch derives from `(seed, epoch)` —
  the epoch RNG, the per-sample transform keys `(epoch_seed, k)`, and
  the shard-order reshuffle all do. Restoring therefore does NOT need
  to deserialize live RNG objects: `load_state_dict` re-arms the
  epoch counter and replays the interrupted epoch's stream
  deterministically, SKIPPING the first `batches * batch_size`
  samples at the transform boundary (the sample index `k` keeps
  advancing across the skip, so per-sample augmentation keys stay
  aligned) — the post-resume batch sequence is byte-identical to an
  uninterrupted run's.
* The `BadRecordBudget` spend is restored to its epoch-start values
  and the replay re-spends the intra-epoch portion deterministically,
  so the budget a resumed run exhausts is the budget the uninterrupted
  run would have (dead-letter rows for the replayed prefix are
  suppressed via the budget's `replaying` latch — counters move,
  duplicate rows don't).
* The shard cursor / record offset / RNG state in the saved state are
  the producer's **read frontier** at snapshot time (what had been
  pulled from storage, which runs ahead of what the consumer had been
  handed by the shuffle buffer and in-flight transform window). They
  are the observability view — "where in the shard stream was this
  run"; exactness of the resume itself comes from the deterministic replay, not from seeking
  to the frontier.
* A `fingerprint` of the source (shard list, or map-style length)
  travels in the state: restoring against a dataset that changed on
  disk raises `SnapshotMismatch` instead of silently training on a
  shifted stream.

Unsupported configurations fail loudly: `num_procs > 0` interleaves
worker output nondeterministically (`SnapshotUnsupported`).

Imports neither torch nor any image library: spawned data workers
import it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

import numpy as np

STATE_VERSION = 1


class SnapshotError(RuntimeError):
    """Base for input-pipeline snapshot failures."""


class SnapshotUnsupported(SnapshotError):
    """The loader's configuration cannot snapshot (num_procs > 0: worker
    interleave order is nondeterministic, so no host-side state can
    reproduce the stream)."""


class SnapshotMismatch(SnapshotError):
    """The saved state does not match the current pipeline (dataset
    changed on disk, different batch size/seed): resuming would silently
    re-visit or skip data, so refusing is the only honest answer."""


@dataclasses.dataclass
class DataLoaderState:
    """One resumable position of a DataLoader's batch stream.

    epoch/batches are the exact resume point (consumer side); cursor,
    rng, and budget are the producer's read frontier at that point
    (see module docstring). Everything is JSON-serializable so the
    state rides the checkpoint's crc32c host sidecar unchanged.
    """

    epoch: int
    batches: int
    epoch_seed: int
    fingerprint: str
    cursor: Optional[Dict[str, Any]] = None  # shard/shard_index/record/read
    rng: Optional[Dict[str, Any]] = None     # np.Generator bit_generator state
    budget: Optional[Dict[str, int]] = None  # {"bad": n, "ok": n} at frontier
    budget_epoch_start: Optional[Dict[str, int]] = None
    version: int = STATE_VERSION

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DataLoaderState":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def validate_state(d: dict) -> DataLoaderState:
    """Parse + sanity-check a state dict from a sidecar; raises
    SnapshotMismatch on anything unusable (version from the future,
    negative counters) rather than resuming on garbage."""
    try:
        st = DataLoaderState.from_dict(d)
    except TypeError as e:
        raise SnapshotMismatch(f"unusable data_state: {e}") from None
    if st.version > STATE_VERSION:
        raise SnapshotMismatch(
            f"data_state version {st.version} is from a newer writer "
            f"(this reader knows {STATE_VERSION})")
    if st.epoch < 0 or st.batches < 0:
        raise SnapshotMismatch(
            f"data_state has negative position (epoch={st.epoch}, "
            f"batches={st.batches})")
    return st


def fingerprint(dataset, batch_size: int, seed: int,
                shuffle: bool = False, shuffle_buffer: int = 0,
                drop_remainder: bool = False,
                host_shard: Optional[tuple] = None) -> str:
    """Identity of the stream a state belongs to: the shard list for
    record-backed datasets, the length for map-style ones, plus EVERY
    loader knob that changes the sample order or batch boundaries —
    shuffle/shuffle_buffer permute the post-shuffle order `skip` counts
    in, drop_remainder moves the epoch boundary, and `host_shard`
    (shard_index, num_shards) pins WHICH host's slice of a multi-host
    world this stream is: a snapshot taken at world N must refuse
    restore at world M (the elastic-resize contract — the re-derived
    slice is a different stream, and replaying the old position on it
    would silently re-visit/skip data). Saved into every state; a
    mismatch at restore is a changed-stream signal."""
    h = hashlib.sha1()
    h.update(f"bs={batch_size};seed={seed};sh={int(shuffle)};"
             f"buf={shuffle_buffer};dr={int(drop_remainder)};".encode())
    if host_shard is not None:
        idx, n = host_shard
        h.update(f"hs={int(idx)}/{int(n)};".encode())
    files = getattr(dataset, "files", None)
    if files is not None:
        import os

        for f in files:
            h.update(str(f).encode())
            # shard SIZE too: a rebuilt shard under the same name is a
            # different stream (full content hashing would cost a read
            # of the dataset; size catches the common rebuild cheaply)
            try:
                h.update(f";{os.path.getsize(f)}\n".encode())
            except OSError:
                h.update(b";?\n")
    else:
        try:
            h.update(f"len={len(dataset)}".encode())
        except TypeError:
            h.update(b"iterable")
    h.update(type(dataset).__name__.encode())
    return h.hexdigest()


def rng_state(rng: np.random.Generator) -> dict:
    """JSON-clean snapshot of a numpy Generator's bit-generator state
    (observability + cross-run comparison; restore replays instead of
    deserializing — see module docstring)."""
    return json.loads(json.dumps(rng.bit_generator.state, default=int))


class LiveCursor:
    """The producer-updated shard read frontier.

    A RecordDataset with a cursor attached updates it as it reads:
    shard index within the epoch's (possibly reshuffled) order, shard
    path, record index within the shard, and total records read this
    epoch. Single-writer; readers snapshot via one atomic tuple load,
    so no lock sits on the per-record hot path.
    """

    __slots__ = ("_v",)

    def __init__(self):
        self._v = (0, None, 0, 0)  # (shard_index, shard_path, record, read)

    def begin_epoch(self) -> None:
        self._v = (0, None, 0, 0)

    def begin_shard(self, index: int, path: str) -> None:
        _, _, _, read = self._v
        self._v = (index, path, 0, read)

    def advance(self) -> None:
        si, path, rec, read = self._v
        self._v = (si, path, rec + 1, read + 1)

    def read_count(self) -> int:
        return self._v[3]

    def snapshot(self) -> dict:
        si, path, rec, read = self._v
        return {"shard_index": si, "shard": path, "record": rec,
                "read": read}
