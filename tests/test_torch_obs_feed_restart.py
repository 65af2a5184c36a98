"""The feed's flight note on a worker restart (data/pipeline.py).

A worker process that dies without its done marker (SIGKILLed, as the
OOM killer does) is replaced and resumes past what it delivered; the
installed flight recorder gets a `data_worker_restart` note with the
loader, the worker, its delivered count, the restart and the budget,
and the stream still yields every sample once. The module imports no
JAX: the spawned worker imports it to unpickle its slice.
"""
import json
import os
import signal

import numpy as np

from deep_vision_tpu_torch.data.pipeline import DataLoader
from deep_vision_tpu_torch.obs import flight

N = 6
DIE_AT = 2


class DyingSlice:
    """Samples 0..N-1; the first worker to reach DIE_AT kills itself (a
    marker file remembers it, so its replacement lives)."""

    def __init__(self, marker):
        self.marker = marker

    def __iter__(self):
        for i in range(N):
            if i == DIE_AT and not os.path.exists(self.marker):
                open(self.marker, "w").close()
                os.kill(os.getpid(), signal.SIGKILL)
            yield {"x": np.full((2,), i, np.float32)}


class DyingDataset:
    def __init__(self, marker):
        self.marker = marker

    def __iter__(self):
        return iter(DyingSlice(self.marker))

    def split(self, i, n):
        return DyingSlice(self.marker)


def test_a_dead_worker_leaves_a_flight_note(tmp_path):
    fr = flight.FlightRecorder(str(tmp_path / "flight"), run_id="feed")
    flight.set_flight(fr)
    try:
        loader = DataLoader(DyingDataset(str(tmp_path / "died")),
                            batch_size=2, num_procs=1, worker_poll_s=0.2,
                            worker_restarts=1, name="feed")
        seen = sorted(int(v) for b in loader for v in b["x"][:, 0])
        bundle = fr.dump("manual")
    finally:
        fr.close()
    assert seen == list(range(N))
    assert os.path.exists(tmp_path / "died")
    notes = [json.loads(x) for x in open(os.path.join(bundle,
                                                      "notes.jsonl"))]
    assert len(notes) == 1
    note = notes[0]
    assert note.pop("ts") > 0
    # what reached the parent before the kill: the queue's feeder thread
    # may not have flushed the last samples put
    assert 0 <= note.pop("delivered") <= DIE_AT
    assert note == {"category": "data_worker_restart", "loader": "feed",
                    "worker": 0, "restart": 1, "budget": 1}
