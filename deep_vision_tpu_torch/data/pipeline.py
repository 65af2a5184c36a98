"""Host input pipeline: transform workers -> shuffle -> fixed-shape batches.

A port of deep_vision_tpu/data/pipeline.py, the same batches for the same
seed. It replaces both input stacks of the original code: torch DataLoader
with worker processes (ResNet/pytorch/train.py:218-257) and
tf.data map(AUTOTUNE)/shuffle/batch/prefetch chains
(YOLO/tensorflow/train.py:260-273). Decode+augment run on a thread pool
(cv2/PIL and numpy release the GIL for the heavy work) or, with
`num_procs > 0`, on worker *processes* that each own a disjoint slice of
the dataset — the GIL-free analog of torch's `num_workers` processes. A
sample-level shuffle buffer reproduces `shuffle(512)`/`shuffle(10000)`
semantics, and batches are collated into fixed-shape numpy dicts, which
the Trainer's device prefetch (data/device_prefetch.py) places on the
card.

Observability (obs/): each batch's collate runs under a `data/collate`
span, its decode and augment work (which spans loop iterations) is one
`data/augment_batch` event, and each batch the consumer takes off the
prefetch queue is one `data/fetch` event (not the end-of-epoch
sentinel); a dead worker's restart leaves a `data_worker_restart` flight
note; the snapshot ring's lock is the locksmith role
"data.pipeline.snapshot".
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np

# imports no torch: spawned data workers import this module
from deep_vision_tpu_torch.data import snapshot as _snapshot
from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.registry import get_registry
from deep_vision_tpu_torch.obs.trace import now_us, span, trace_event


class Compose:
    """Chain of transforms, each `(sample, rng) -> sample`."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


def collate(samples: List[dict]) -> dict:
    """Stack a list of sample dicts into one batch dict of arrays."""
    keys = samples[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}


def _buffer_shuffle(samples: Iterable[dict], buffer: int,
                    rng: np.random.Generator) -> Iterator[dict]:
    """Reservoir-style shuffle (tf.data shuffle(buffer) semantics)."""
    buf: List[dict] = []
    for s in samples:
        if len(buf) < buffer:
            buf.append(s)
            continue
        j = int(rng.integers(0, len(buf)))
        out, buf[j] = buf[j], s
        yield out
    rng.shuffle(buf)  # type: ignore[arg-type]
    yield from buf


#: samples a worker process may run ahead of the parent's reads
PROC_LOOKAHEAD = 64


def _proc_worker(dataset, transform, epoch_seed, wid, conn, stop_evt,
                 skip: int = 0):
    """Worker-process body: stream, transform, and ship samples.

    Runs in a spawned child; `dataset` is this worker's disjoint slice.
    Samples cross the process boundary pickled over this worker's own
    pipe (`conn`, whose write end only this process holds), sent by a
    thread of this process that runs up to PROC_LOOKAHEAD samples ahead
    of the parent's reads — keep images uint8 until the last transform
    to halve that traffic. A worker that dies mid-send tears only its own
    pipe, whose end the parent then reads; over a queue shared by the
    workers the dead writer would leave the queue's lock held or half a
    message in the survivors' way, and the parent would wait forever.
    Samples ship tagged `(wid, sample)` so the parent can count
    per-worker deliveries; a replacement worker for a dead one is
    started with `skip` = that count and fast-forwards past the
    already-delivered prefix of its slice (the slice iterates
    deterministically — the parent never advances the original dataset
    object it re-pickles).
    """
    ahead: "queue.Queue" = queue.Queue(maxsize=PROC_LOOKAHEAD)

    def send_all() -> None:
        while True:
            item = ahead.get()
            if item is None:
                return
            try:
                conn.send(item)
            except OSError:  # the parent is gone
                return

    sender = threading.Thread(target=send_all, daemon=True)
    sender.start()

    def put(item) -> bool:
        # keep observing the stop: a parent that stopped reading leaves
        # the lookahead full, and a plain put would block past the stop
        while not stop_evt.is_set():
            try:
                ahead.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    try:
        rng = np.random.default_rng((epoch_seed, wid))
        for k, sample in enumerate(dataset):
            if stop_evt.is_set():
                break
            if k < skip:
                continue  # already delivered by the worker this one replaces
            if transform is not None:
                sample = transform(sample, rng)
            if not put((wid, sample)):
                break
    except BaseException as e:  # noqa: BLE001 - surfaced in the parent
        put(("__error__", repr(e)))
    finally:
        put(("__done__", wid))
        ahead.put(None)  # the sender's end, past the stop too
        sender.join()
        conn.close()


class DataLoader:
    """dataset (+ transforms) -> iterator of batch dicts.

    dataset: __len__/__getitem__ map-style OR any iterable of sample dicts.
    Map-style datasets get a full index shuffle per epoch (torch DataLoader
    shuffle=True semantics); iterable datasets get a reservoir-style shuffle
    buffer (tf.data shuffle(buffer) semantics, YOLO/tensorflow/train.py:267).

    `num_procs > 0` decodes in worker PROCESSES instead of threads: the
    dataset must expose `.split(i, n)` returning the i-th of n disjoint
    slices (RecordDataset does, by shard), and dataset+transform must be
    picklable. Sample order then interleaves arbitrarily across workers —
    use `shuffle` (which is the training configuration anyway).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        transform: Optional[Callable] = None,
        shuffle: bool = False,
        shuffle_buffer: int = 512,
        num_workers: int = 8,
        drop_remainder: bool = False,
        seed: int = 0,
        collate_fn: Callable = collate,
        prefetch: int = 2,
        num_procs: int = 0,
        name: str = "default",
        worker_restarts: int = 1,
        worker_poll_s: float = 10.0,
        host_shard: Optional[tuple] = None,
    ):
        self.dataset = dataset
        self.name = name  # labels this loader's obs metrics (train vs val)
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.shuffle_buffer = shuffle_buffer
        self.num_workers = max(1, num_workers)
        self.drop_remainder = drop_remainder
        self.seed = seed
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.num_procs = num_procs
        # times a dead worker PROCESS (OOM-killed, segfaulted) is replaced
        # and its undelivered samples resubmitted before the loader gives up;
        # worker_poll_s is the dead-worker check cadence while the queue is
        # quiet (tests shrink it — a liveness probe, not a correctness knob)
        self.worker_restarts = worker_restarts
        self.worker_poll_s = worker_poll_s
        # which host's slice of a multi-host world this loader feeds
        # ((shard_index, num_shards), the multihost.host_shard() value at
        # construction). Pure snapshot identity: it pins the stream's
        # fingerprint so a DataLoaderState taken at world N refuses
        # restore at world M after an elastic resize — the re-derived
        # slice is a different stream. None (single-host) changes nothing.
        self.host_shard = (tuple(int(v) for v in host_shard)
                           if host_shard is not None else None)
        if num_procs > 0 and not hasattr(dataset, "split"):
            raise TypeError(
                f"num_procs={num_procs} needs a dataset with .split(i, n); "
                f"{type(dataset).__name__} has none"
            )
        self._epoch = 0
        self._map_style = hasattr(dataset, "__getitem__") and hasattr(
            dataset, "__len__"
        )
        # -- snapshot plumbing (data/snapshot.py) --------------------------
        # The producer writes a resumable DataLoaderState into `_ring`
        # after every collated batch (keyed (epoch, batches)); the consumer
        # side of __iter__ marks which key it has actually been handed, so
        # state_dict() returns the exact consumed position even while the
        # prefetch thread runs ahead. `_resume` arms a deterministic
        # skip-replay for the next epoch iteration (see load_state_dict).
        self._ring: dict = {}
        self._ring_keys: List[tuple] = []
        self._ring_lock = locksmith.lock("data.pipeline.snapshot")
        self._consumed_key: Optional[tuple] = None
        self._resume: Optional[_snapshot.DataLoaderState] = None
        self._fp: Optional[str] = None
        # per-batch state recording is OFF until armed (enable_snapshots /
        # load_state_dict): eval loaders
        # and non-snapshot runs must not pay the ring/rng/cursor
        # bookkeeping on the producer hot path — the LiveCursor is
        # attached to the dataset only when arming, too
        self._snapshot_on = False
        self._cursor = None

    def __len__(self) -> int:
        if not self._map_style:
            raise TypeError("length unknown for iterable datasets")
        n = len(self.dataset)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    # -- internals ---------------------------------------------------------

    def _samples(self, epoch_rng: np.random.Generator) -> Iterator[dict]:
        if self._map_style:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                epoch_rng.shuffle(idx)
            for i in idx:
                yield self.dataset[int(i)]
        else:
            it = iter(self.dataset)
            if not self.shuffle:
                yield from it
                return
            yield from _buffer_shuffle(it, self.shuffle_buffer, epoch_rng)

    def _transformed(self, epoch_seed: int,
                     epoch_rng: np.random.Generator,
                     skip: int = 0,
                     quiet_read: int = 0) -> Iterator[dict]:
        """Shuffled + transformed sample stream for one epoch.

        `skip` is the snapshot-resume fast-forward (data/snapshot.py): the
        first `skip` post-shuffle samples are consumed WITHOUT transform —
        they were already trained on before the kill — while the sample
        index `k` keeps advancing so per-sample transform keys
        `(epoch_seed, k)` stay aligned with the uninterrupted run's.

        The bad-record budget's `replaying` latch is held until BOTH the
        consumed prefix is skipped and the source has re-read past
        `quiet_read` (the original run's read frontier from the snapshot
        cursor): the original run dead-lettered every bad record up to
        its frontier — which ran ahead of the consumed prefix by the
        shuffle buffer and in-flight transforms — so re-emitting rows
        for anything before it would double-report.
        """
        budget = getattr(self.dataset, "bad_record_budget", None)
        latched = bool(skip) and budget is not None
        if latched:
            budget.replaying = True

        def maybe_unlatch(k: int) -> None:
            nonlocal latched
            if not latched or k < skip:
                return
            if (quiet_read and self._cursor is not None
                    and self._cursor.read_count() < quiet_read):
                return
            budget.replaying = False
            latched = False

        try:
            samples = self._samples(epoch_rng)
            if self.transform is None:
                for k, sample in enumerate(samples):
                    if k < skip:
                        continue
                    maybe_unlatch(k)
                    yield sample
                return
            # ordered parallel map: worker i gets its own derived rng stream
            with ThreadPoolExecutor(self.num_workers) as pool:
                window: "queue.Queue" = queue.Queue()
                in_flight = 0
                max_in_flight = self.num_workers * 2

                def submit(sample, k):
                    rng = np.random.default_rng((epoch_seed, k))
                    return pool.submit(self.transform, sample, rng)

                k = 0
                for sample in samples:
                    if k < skip:
                        k += 1
                        continue
                    maybe_unlatch(k)
                    window.put(submit(sample, k))
                    k += 1
                    in_flight += 1
                    if in_flight >= max_in_flight:
                        yield window.get().result()
                        in_flight -= 1
                while in_flight:
                    yield window.get().result()
                    in_flight -= 1
        finally:
            if budget is not None:
                budget.replaying = False

    def _proc_samples(self, epoch_seed: int, epoch: int) -> Iterator[dict]:
        """Transformed samples from `num_procs` spawned workers, merged.

        Spawn, not fork: the parent has usually initialized CUDA (threads +
        a live context) by the time the first epoch starts, and forking a
        multithreaded process is a deadlock lottery. Spawned children import
        fresh, and nothing they import touches the card.
        """
        ctx = mp.get_context("spawn")
        stop = ctx.Event()
        procs = []
        readers = {}  # a live worker's pipe (read end) -> its worker id
        shards = []

        def spawn(wid: int, skip: int = 0):
            """Start (or restart) worker `wid` on its pre-built slice."""
            recv_end, send_end = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_proc_worker,
                args=(shards[wid], self.transform, epoch_seed, wid,
                      send_end, stop, skip),
                daemon=True,
            )
            p.start()
            send_end.close()  # the worker's exit must end the pipe
            readers[recv_end] = wid
            return p

        def read(conn):
            """One message from a worker's pipe; None once the pipe ended
            (the worker exited, or died: a message its death tore ends it
            too), and the pipe is dropped."""
            try:
                return conn.recv()
            except (EOFError, OSError):
                del readers[conn]
                conn.close()
                return None

        # Spawn, not fork (see docstring). Build every slice up front: a
        # replacement worker re-pickles the SAME slice object, which the
        # parent never iterates, so its replay order is deterministic.
        try:
            for i in range(self.num_procs):
                shard = self.dataset.split(i, self.num_procs)
                # the parent never iterates self.dataset in proc mode, so its
                # epoch counter would freeze the per-epoch shard reshuffle —
                # propagate the loader's epoch into each slice explicitly
                if hasattr(shard, "set_epoch"):
                    shard.set_epoch(epoch)
                shards.append(shard)
                procs.append(spawn(i))
        except BaseException:
            # a failed start (EAGAIN at high num_procs) must not leak the
            # already-live workers for the process's lifetime
            stop.set()
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
            raise
        done: set = set()
        delivered = [0] * self.num_procs  # samples consumed per worker id
        restarts = [0] * self.num_procs

        def classify(item):
            """-> ('done', wid) | ('sample', wid, sample); raises on error."""
            if isinstance(item, tuple) and len(item) == 2:
                tag = item[0]
                if tag == "__done__":
                    return ("done", item[1])
                if tag == "__error__":
                    raise RuntimeError(f"data worker failed: {item[1]}")
                return ("sample", tag, item[1])
            return ("sample", None, item)

        try:
            while len(done) < self.num_procs:
                ready = mp.connection.wait(list(readers),
                                           timeout=self.worker_poll_s)
                if not ready:
                    # watchdog: a SIGKILL'd/segfaulted worker writes no done
                    # marker; without this the loader would hang forever.
                    failed = [
                        i for i, p in enumerate(procs)
                        if i not in done and not p.is_alive()
                    ]
                    if not failed:
                        continue
                    # Read what the dead worker(s) already shipped BEFORE
                    # deciding the resubmission point: anything left in a
                    # pipe would otherwise be replayed twice. A dead
                    # worker's pipe holds a finite rest and then ends.
                    for conn in [c for c, w in readers.items()
                                 if w in failed]:
                        while conn in readers:
                            extra = read(conn)
                            if extra is None:
                                break
                            kind = classify(extra)
                            if kind[0] == "done":
                                done.add(kind[1])
                                continue
                            _, wid, sample = kind
                            if wid is not None:
                                delivered[wid] += 1
                            yield sample
                    for wid in failed:
                        if wid in done:
                            continue  # its done marker was in the drain
                        if restarts[wid] >= self.worker_restarts:
                            raise RuntimeError(
                                f"data worker {wid} died without a done "
                                f"marker {restarts[wid] + 1}x (OOM-killed or "
                                "crashed in native code); restart budget "
                                f"({self.worker_restarts}) spent"
                            )
                        restarts[wid] += 1
                        print(
                            f"data: worker {wid} died (OOM-killed or crashed "
                            f"in native code); restarting it and resubmitting "
                            f"its in-flight samples (delivered "
                            f"{delivered[wid]}, restart {restarts[wid]}/"
                            f"{self.worker_restarts})", flush=True,
                        )
                        get_registry().counter(
                            "data_worker_restarts_total",
                            "dead data workers replaced",
                            labels={"loader": self.name}).inc()
                        # a worker that keeps dying is postmortem context
                        # for the crash or hang that often follows
                        try:
                            from deep_vision_tpu_torch.obs import flight

                            flight.note(
                                "data_worker_restart", loader=self.name,
                                worker=wid, delivered=delivered[wid],
                                restart=restarts[wid],
                                budget=self.worker_restarts)
                        except Exception:
                            pass
                        procs[wid] = spawn(wid, skip=delivered[wid])
                    continue
                for conn in ready:
                    item = read(conn)
                    if item is None:
                        continue  # its worker ended; the watchdog judges it
                    kind = classify(item)
                    if kind[0] == "done":
                        done.add(kind[1])
                        continue
                    _, wid, sample = kind
                    if wid is not None:
                        delivered[wid] += 1
                    yield sample
        finally:
            stop.set()
            # read and drop until each worker's pipe ends, so a worker
            # blocked in send sees the stop and exits
            deadline = time.monotonic() + 5
            while readers and time.monotonic() < deadline:
                for conn in mp.connection.wait(list(readers), timeout=0.1):
                    read(conn)
            for conn in list(readers):
                conn.close()
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()

    def _batches(self) -> Iterator[dict]:
        epoch = self._epoch
        epoch_seed = self.seed + epoch
        self._epoch += 1
        # pin the dataset's own epoch counter to the LOADER's in every
        # mode (was proc-mode-only): a resumed process otherwise restarts
        # the dataset at epoch 0 and silently replays shard order from
        # scratch while the trainer continues at epoch N — every per-epoch
        # random decision must derive from (seed, epoch), not from how
        # many times this process happened to iterate
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        resume = self._resume
        self._resume = None
        if resume is not None and resume.epoch != epoch:
            resume = None  # armed for a different epoch: nothing to skip
        skip = resume.batches * self.batch_size if resume is not None else 0
        budget = getattr(self.dataset, "bad_record_budget", None)
        if budget is not None:
            if resume is not None and resume.budget_epoch_start is not None:
                # the deterministic replay below re-spends the intra-epoch
                # portion; start the epoch where the original did
                budget.set_spend(resume.budget_epoch_start)
            budget_start = budget.spend()
        else:
            budget_start = None
        epoch_rng = np.random.default_rng(epoch_seed)
        if self.num_procs > 0:
            samples: Iterable[dict] = self._proc_samples(epoch_seed, epoch)
            if self.shuffle:
                samples = _buffer_shuffle(
                    samples, self.shuffle_buffer, epoch_rng,
                )
        else:
            samples = self._transformed(
                epoch_seed, epoch_rng, skip=skip,
                quiet_read=int((resume.cursor or {}).get("read", 0) or 0)
                if resume is not None else 0)
        buf: List[dict] = []
        bi = skip // self.batch_size  # batches already consumed pre-resume
        # one batch's decode and augment work spans loop iterations, so it
        # is an explicit event from the request of its first sample
        t0 = now_us()
        for s in samples:
            buf.append(s)
            if len(buf) == self.batch_size:
                with span("data/collate", loader=self.name):
                    batch = self.collate_fn(buf)
                trace_event("data/augment_batch", t0, loader=self.name,
                            batch_size=len(buf))
                bi += 1
                self._record_snapshot(epoch, bi, epoch_seed, epoch_rng,
                                      budget, budget_start)
                yield batch
                buf = []
                t0 = now_us()
        if buf and not self.drop_remainder:
            batch = self.collate_fn(buf)
            trace_event("data/augment_batch", t0, loader=self.name,
                        batch_size=len(buf))
            bi += 1
            # the tail batch's entry is the epoch-end state, written
            # BEFORE the yield (handed = consumed, same as _mark_consumed):
            # a preempt save while the trainer processes the tail must
            # find its key in the ring, not fabricate a position
            self._record_snapshot(epoch, bi, epoch_seed, epoch_rng,
                                  budget, budget_start, epoch_end=True)
            yield batch
        # end-of-epoch state: resuming after the final batch means
        # starting the NEXT epoch clean (overwrites the tail batch's
        # entry under the same key with identical content)
        self._record_snapshot(epoch, bi, epoch_seed, epoch_rng,
                              budget, budget_start, epoch_end=True)

    # -- snapshot/restore (data/snapshot.py) --------------------------------

    def _fingerprint(self) -> str:
        if self._fp is None:
            self._fp = _snapshot.fingerprint(
                self.dataset, self.batch_size, self.seed,
                shuffle=self.shuffle, shuffle_buffer=self.shuffle_buffer,
                drop_remainder=self.drop_remainder,
                host_shard=self.host_shard)
        return self._fp

    def _record_snapshot(self, epoch: int, bi: int, epoch_seed: int,
                         epoch_rng, budget, budget_start,
                         epoch_end: bool = False) -> None:
        """Producer side: the resumable state AFTER batch `bi` of `epoch`
        (or after the whole epoch), written into the bounded ring the
        consumer-side state_dict() reads."""
        if not self._snapshot_on or self.num_procs > 0:
            return  # not armed (or unsupported): stay off the hot path
        spend = budget.spend() if budget is not None else None
        if epoch_end:
            st = _snapshot.DataLoaderState(
                epoch=epoch + 1, batches=0,
                epoch_seed=self.seed + epoch + 1,
                fingerprint=self._fingerprint(),
                cursor=self._cursor.snapshot() if self._cursor else None,
                budget=spend, budget_epoch_start=spend,
            )
        else:
            st = _snapshot.DataLoaderState(
                epoch=epoch, batches=bi, epoch_seed=epoch_seed,
                fingerprint=self._fingerprint(),
                cursor=self._cursor.snapshot() if self._cursor else None,
                rng=_snapshot.rng_state(epoch_rng),
                budget=spend, budget_epoch_start=budget_start,
            )
        key = (epoch, bi)
        # the bound must exceed how far the producer can run ahead of the
        # consumer (the prefetch depth), or a deep-prefetch loader could
        # evict the very key the consumer's next state_dict() needs
        bound = max(64, self.prefetch + 8)
        with self._ring_lock:
            if key not in self._ring:
                self._ring_keys.append(key)
            self._ring[key] = st.to_dict()
            while len(self._ring_keys) > bound:
                old = self._ring_keys.pop(0)
                self._ring.pop(old, None)

    def _mark_consumed(self, epoch: int, batches: int) -> None:
        self._consumed_key = (epoch, batches)

    def pin_host_shard(self, shard) -> None:
        """Stamp the host-shard identity (shard_index, num_shards) into
        this loader's snapshot fingerprint after construction — for
        elastic multi-host runs whose loader was built without one — so
        a DataLoaderState taken at world N
        actually REFUSES restore at world M instead of silently
        matching. Must happen before the fingerprint is first computed
        (i.e. before any state is recorded): re-stamping a live stream
        would be the very identity shift the fingerprint exists to
        catch."""
        shard = tuple(int(v) for v in shard)
        if self._fp is not None and self.host_shard != shard:
            raise _snapshot.SnapshotError(
                "pin_host_shard after the fingerprint was computed: the "
                "stream's identity is already fixed")
        self.host_shard = shard

    def snapshot_supported(self) -> bool:
        """num_procs workers interleave nondeterministically — no
        host-side state can reproduce that stream, so snapshots refuse."""
        return self.num_procs == 0

    def enable_snapshots(self) -> None:
        """Arm per-batch state recording. Must happen before the
        epoch whose mid-epoch positions you want to capture — epoch-
        boundary states are exact either way."""
        if not self.snapshot_supported():
            raise _snapshot.SnapshotUnsupported(
                f"DataLoader(num_procs={self.num_procs}) cannot snapshot: "
                "worker-process interleave order is nondeterministic")
        self._snapshot_on = True
        if self._cursor is None and hasattr(self.dataset, "cursor"):
            self._cursor = _snapshot.LiveCursor()
            self.dataset.cursor = self._cursor

    def state_dict(self) -> dict:
        """The resumable position of this loader's batch stream (a
        data/snapshot.py DataLoaderState as a JSON-clean dict), exact to
        the batch the consumer was last handed — checkpoint it next to
        the model."""
        if not self.snapshot_supported():
            raise _snapshot.SnapshotUnsupported(
                f"DataLoader(num_procs={self.num_procs}) cannot snapshot: "
                "worker-process interleave order is nondeterministic")
        key = self._consumed_key
        with self._ring_lock:
            st = dict(self._ring[key]) if key in self._ring else None
        if st is not None:
            return st
        if self._resume is not None:
            return self._resume.to_dict()  # armed but not yet iterated
        if key is not None:
            # the loader HAS been iterated but the consumed position is
            # not in the ring: either snapshots were armed after
            # iteration started, or the ring bound failed — fabricating
            # a position here would be the silent stream shift this
            # module exists to refuse
            raise _snapshot.SnapshotError(
                f"no recorded state for consumed position {key}: call "
                "enable_snapshots() before iterating")
        return _snapshot.DataLoaderState(
            epoch=self._epoch, batches=0,
            epoch_seed=self.seed + self._epoch,
            fingerprint=self._fingerprint(),
        ).to_dict()

    def load_state_dict(self, state: dict) -> dict:
        """Arm a resume at `state`'s position; the next epoch iteration
        deterministically replays and skips what was already consumed.
        Returns a small info dict (epoch/batches/shard/record) for the
        caller's log. Raises SnapshotMismatch
        when the dataset or loader shape changed under the snapshot."""
        if not self.snapshot_supported():
            raise _snapshot.SnapshotUnsupported(
                f"DataLoader(num_procs={self.num_procs}) cannot snapshot: "
                "worker-process interleave order is nondeterministic")
        st = _snapshot.validate_state(state)
        if st.fingerprint and st.fingerprint != self._fingerprint():
            raise _snapshot.SnapshotMismatch(
                "data_state fingerprint mismatch: the dataset shard list, "
                "loader shape (batch size, seed, shuffle/buffer, "
                "drop_remainder), or host-shard slice (an elastic N->M "
                "world resize) changed since the snapshot — resuming "
                "would silently shift the stream")
        self._epoch = st.epoch
        self._resume = st
        self._consumed_key = None
        self.enable_snapshots()  # a restored loader keeps snapshotting
        budget = getattr(self.dataset, "bad_record_budget", None)
        if budget is not None and st.budget is not None:
            # boundary snapshot: counters restore directly; mid-epoch:
            # epoch-start values now, the replay re-spends the rest
            budget.set_spend(
                st.budget if st.batches == 0
                else (st.budget_epoch_start or st.budget))
        cur = st.cursor or {}
        return {"epoch": st.epoch, "batches": st.batches,
                "shard": cur.get("shard"), "record": cur.get("record")}

    def __iter__(self) -> Iterator[dict]:
        """Yield batches, producing up to `prefetch` ahead on a thread.

        This is the HOST half of the prefetch story (decode/augment
        latency); the DEVICE half — overlapping the H2D transfer itself
        with compute — is data/device_prefetch.py, which the Trainer
        stacks on top of this iterator (`Trainer(device_prefetch=N)`)."""
        iter_epoch = self._epoch  # the epoch _batches() is about to run
        base = (self._resume.batches
                if self._resume is not None
                and self._resume.epoch == iter_epoch else 0)
        if self.prefetch <= 0:
            i = base
            for b in self._batches():
                i += 1
                self._mark_consumed(iter_epoch, i)
                yield b
            return
        # Depth is sampled at every consumer get; a get on an empty queue
        # means the accelerator out-ran the host pipeline (starvation)
        reg = get_registry()
        labels = {"loader": self.name}  # train vs val stay distinguishable
        g_depth = reg.gauge("data_prefetch_depth",
                            "prefetch batches ready when the consumer asked",
                            labels=labels)
        c_starved = reg.counter("data_prefetch_starved_total",
                                "consumer gets that found the queue empty",
                                labels=labels)
        c_batches = reg.counter("data_batches_total", "batches yielded",
                                labels=labels)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: List[BaseException] = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        first = True
        i = base
        while True:
            depth = q.qsize()
            t0 = now_us()
            item = q.get()
            if item is sentinel:
                # the end-of-epoch wait is neither starvation nor fetch
                # time
                break
            trace_event("data/fetch", t0, loader=self.name,
                        prefetch_depth=depth)
            g_depth.set(depth)
            # skip the first get (the producer just started — inevitably
            # empty): counting it would stamp phantom starvation on every
            # epoch of a healthy pipeline
            if depth == 0 and not first:
                c_starved.inc()
            first = False
            c_batches.inc()
            i += 1
            # marked BEFORE the yield: a batch handed to the consumer is
            # consumed — a checkpoint taken mid-step must not replay it
            self._mark_consumed(iter_epoch, i)
            yield item
        t.join()
        if err:
            raise err[0]
