"""Double-buffered DEVICE prefetch: H2D transfer overlapped with compute.

A port of deep_vision_tpu/data/device_prefetch.py. The host-thread
prefetch in data/pipeline.py hides decode/augment latency; this module
moves the host-to-device copy off the step: a producer thread places the
NEXT batch(es) on the card while the current step runs. There
`jax.device_put` is asynchronous and safe across threads. Here the
placing function (the Trainer's `_place_one`) pins the batch and copies
it on a CUDA stream of the producer thread, and hands the consumer an
event (`PlacedBatch.ready`) that its stream must wait on before it reads
the batch.

Observability rides the port's registry, next to the host-prefetch
gauges (data_prefetch_* in pipeline.py):

    device_prefetch_depth          placed batches ready at the consumer get
    device_prefetch_starved_total  gets that found the buffer empty
    device_prefetch_batches_total  placed batches handed to the step loop
    device_prefetch_place_ms       host ms of each placing call, on the
                                   producer thread

The reference's `group`/`place_group` (stacked multistep supersteps)
waits for the port's multistep Trainer.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator

from deep_vision_tpu_torch.obs.registry import get_registry


class PlacedBatch:
    """A device-resident batch + the host-side metadata the loop needs
    without a device fetch: `data` (the placed dict), `n` (valid
    examples, padding excluded), and `ready`: the event recorded on the
    copy's stream after the copy, which the consumer's stream waits on
    before reading `data` (None where the copy is done when placing
    returns, as on the CPU)."""

    __slots__ = ("data", "n", "ready")

    def __init__(self, data, n: int, ready=None):
        self.data = data
        self.n = int(n)
        self.ready = ready


class DevicePrefetcher:
    """Wrap a host-batch iterable; yield `PlacedBatch`es placed ahead of
    consumption by `place_one(batch) -> PlacedBatch`, up to `depth`
    ahead. Placement runs on the producer thread, so the transfer
    overlaps both the host pipeline and device compute.
    """

    def __init__(self, place_one: Callable, depth: int = 2,
                 name: str = "train", registry=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.place_one = place_one
        self.depth = int(depth)
        self.name = name
        if registry is None:
            registry = get_registry()
        labels = {"loader": name}
        self._g_depth = registry.gauge(
            "device_prefetch_depth",
            "device-placed batches ready when the consumer asked",
            labels=labels)
        self._c_starved = registry.counter(
            "device_prefetch_starved_total",
            "consumer gets that found no placed batch ready",
            labels=labels)
        self._c_batches = registry.counter(
            "device_prefetch_batches_total",
            "device-placed batches yielded", labels=labels)
        self._h_place = registry.histogram(
            "device_prefetch_place_ms",
            "host ms of each placing call on the producer thread",
            labels=labels)

    def _timed(self, batch) -> PlacedBatch:
        t0 = time.perf_counter()
        placed = self.place_one(batch)
        self._h_place.observe((time.perf_counter() - t0) * 1e3)
        return placed

    def __call__(self, source: Iterable) -> Iterator[PlacedBatch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            # bounded put that keeps observing stop: an abandoned consumer
            # leaves the queue full, and a plain put would pin this
            # thread forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in source:
                    if not put(self._timed(batch)):
                        return
            except BaseException as e:  # surfaced at the consumer's get
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name=f"device-prefetch-{self.name}")
        t.start()
        first = True
        try:
            while True:
                depth = q.qsize()
                item = q.get()
                if item is sentinel:
                    break
                self._g_depth.set(depth)
                # the first get races the producer's warm-up fill and would
                # stamp phantom starvation on every healthy epoch
                if depth == 0 and not first:
                    self._c_starved.inc()
                first = False
                self._c_batches.inc()
                yield item
        finally:
            stop.set()
            try:  # unblock a producer stuck in put()
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)
        if err:
            raise err[0]
