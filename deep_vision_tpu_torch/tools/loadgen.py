"""The socket load client and the process fleet's builders (the port of
the repository's tools/loadgen.py: `HttpLoadClient`, `fleet_builder`
and the toy models).

`HttpLoadClient` is a client of a `serve/transport.py` front door:
`submit(model, image) -> Future`, a POST of /v1/<model> on a worker
thread, retried under a `resilience.RetryPolicy` (connection loss, 429
and 503 are retryable; a 429/503's Retry-After is a floor under the
policy's own backoff). Terminal verdicts come back typed: ShedError
when the budget runs out on sheds, DeadlineExceeded on a 504 (never
retried: the client's own budget expired), ReplicaLost on a lost
connection or a reasonless 503, ServeError otherwise. `counts` keeps
offered / ok / shed / deadline / error, the retries and how often a
Retry-After set the pace. The trace context installed on the thread
that calls `submit` rides the request as its `traceparent` (the
reference's client reads it on its worker thread, where none is
installed, so its requests start fresh traces).

A `ProcReplicaPool` spawns its replicas, and spawn pickles a builder by
reference, so the builders live here, at module level:

- `fleet_builder`: the two toy models of the reference's fleet smoke,
  `toy` and `aux`, from the same seeded numpy draws, so the port's fleet
  and the reference's compute the same rows;
- `yolo_fleet_builder`: YOLOv3 at 416x416 and 80 classes on buckets
  1-8, seeded and calibrated as chip_smoke.py's serving phase does, its
  detections through `inference.yolo_predict_fn`, so through the NMS
  kernel on the card.

The reference's `LoadGen`, its --varz cross-check and its in-process
fleet smoke are not ported.
"""
from __future__ import annotations

import http.client
import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from deep_vision_tpu_torch.obs import propagate
from deep_vision_tpu_torch.resilience import RetryPolicy
from deep_vision_tpu_torch.serve import (
    DEADLINE_HEADER,
    DeadlineExceeded,
    Engine,
    ReplicaLost,
    ServeError,
    ShedError,
)

#: the toy models' image shape and buckets (the reference's)
IMG = (4, 4, 1)
BUCKETS = (1, 2, 4)

#: chip_smoke.py's serving phase: YOLOv3's input side, classes, buckets,
#: detection parameters, and the seeded images its running statistics
#: are calibrated on (RandomState(CALIBRATION_SEED), CALIBRATION_IMAGES)
YOLO_IMAGE = 416
YOLO_CLASSES = 80
YOLO_BUCKETS = (1, 2, 4, 8)
YOLO_DETECTION = {"max_detections": 100, "iou_threshold": 0.5,
                  "score_threshold": 0.5}
CALIBRATION_SEED = 0
CALIBRATION_IMAGES = 8


class HttpLoadClient:
    """A front door's client over a real socket (module docstring)."""

    def __init__(self, host: str, port: int,
                 deadline_ms: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None, journal=None,
                 registry=None, max_inflight: int = 32,
                 timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.deadline_ms = deadline_ms
        self.timeout_s = float(timeout_s)
        # worth another try over the wire: sheds (the server said
        # "later", and when) and lost connections; NOT DeadlineExceeded
        # (the client's own budget expired) and NOT application errors
        self.retry = retry or RetryPolicy(
            name="loadgen.http", max_attempts=4, base_delay_s=0.02,
            multiplier=2.0, max_delay_s=0.5, jitter=0.25,
            retry_on=(ShedError, ReplicaLost, ConnectionError,
                      TimeoutError),
            journal=journal, registry=registry)
        self._pool = ThreadPoolExecutor(max_workers=int(max_inflight),
                                        thread_name_prefix="loadgen-http")
        self._lock = threading.Lock()
        self.counts = {"offered": 0, "ok": 0, "shed": 0, "deadline": 0,
                       "error": 0, "retries": 0, "retry_after_honored": 0}

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def submit(self, model: str, image) -> Future:
        fut: Future = Future()
        with self._lock:
            self.counts["offered"] += 1
        self._pool.submit(self._run_one, model, image, propagate.current(),
                          fut)
        return fut

    def _bump(self, key: str) -> None:
        with self._lock:
            self.counts[key] += 1

    def _run_one(self, model: str, image, ctx, fut: Future) -> None:
        if not fut.set_running_or_notify_cancel():
            return
        attempt = 0
        while True:
            try:
                fut.set_result(self._post(model, image, ctx))
                self._bump("ok")
                return
            except Exception as e:
                attempt += 1
                retry_after_s = getattr(e, "retry_after_s", None)
                if not self.retry.should_retry(attempt, e):
                    self.retry.note(attempt, e, "gave_up")
                    self._bump(_outcome_key(e))
                    fut.set_exception(e)
                    return
                # the server's Retry-After is a FLOOR under the policy's
                # own backoff: the server knows its queue
                delay = self.retry.delay(attempt)
                if retry_after_s is not None and retry_after_s > delay:
                    delay = retry_after_s
                    self._bump("retry_after_honored")
                self.retry.note(attempt, e, "retrying", delay_s=delay)
                self._bump("retries")
                if delay > 0:
                    time.sleep(delay)

    def _post(self, model: str, image, ctx):
        body = json.dumps(
            {"image": image.tolist() if hasattr(image, "tolist")
             else image}).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if self.deadline_ms is not None:
            headers[DEADLINE_HEADER] = f"{self.deadline_ms:.3f}"
        if ctx is not None:
            headers["traceparent"] = ctx.to_traceparent()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            try:
                conn.request("POST", f"/v1/{model}", body=body,
                             headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            except (OSError, http.client.HTTPException) as e:
                raise ReplicaLost(
                    f"connection to {self.host}:{self.port} lost "
                    f"({type(e).__name__}: {e})")
            try:
                payload = json.loads(raw.decode("utf-8"))
            except ValueError:
                raise ReplicaLost(
                    f"torn response from {self.host}:{self.port} "
                    f"({len(raw)} bytes, not JSON)")
            if resp.status == 200:
                return payload.get("outputs", payload)
            retry_after = resp.getheader("Retry-After")
            if resp.status in (429, 503):
                reason = payload.get("reason")
                # a reason names a POLICY shed; a reasonless 503 is a
                # fleet failure behind the front door (ReplicaLost)
                e = (ShedError(model, reason) if reason
                     else ReplicaLost(payload.get("detail")
                                      or "fleet error behind the edge"))
                if retry_after is not None:
                    try:
                        e.retry_after_s = float(retry_after)
                    except ValueError:
                        pass
                raise e
            if resp.status == 504:
                raise DeadlineExceeded(
                    f"deadline shed at {payload.get('stage', '?')}")
            raise ServeError(
                f"{self.host}:{self.port} answered {resp.status}: "
                f"{payload.get('detail', payload)}")
        finally:
            conn.close()


def _outcome_key(e: Exception) -> str:
    if isinstance(e, ShedError):
        return "shed"
    if isinstance(e, DeadlineExceeded):
        return "deadline"
    return "error"


# -- the toy fleet ---------------------------------------------------------

def toy_fn(variables, images):
    flat = images.reshape(images.shape[0], -1)
    return {"scores": flat @ variables["w"],
            "mean": images.mean(dim=(1, 2, 3))}


def aux_fn(variables, images):
    flat = images.reshape(images.shape[0], -1)
    return {"logits": flat @ variables["w"] + variables["b"]}


def toy_variables(scale: float = 1.0, seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rng.randn(16, 3).astype(np.float32)
                                  * scale)}


def aux_variables(seed: int = 1):
    rng = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rng.randn(16, 5).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(5).astype(np.float32))}


def fleet_builder(journal=None, registry=None, device=None,
                  native: bool = False) -> Engine:
    """The two-toy-model engine every fleet process, and the parent's
    template, builds. `native=True` also loads the host record library
    (data/native.py), as a replica that reads records would: on the CPU,
    where the toy launches no kernel, it is the library a process loads
    through its executable cache."""
    if native:
        from deep_vision_tpu_torch.data import native as native_lib

        native_lib.load_library()
    eng = Engine(device=device, registry=registry)
    eng.register("toy", toy_fn, toy_variables(), input_shape=IMG,
                 buckets=BUCKETS)
    eng.register("aux", aux_fn, aux_variables(), input_shape=IMG,
                 buckets=BUCKETS)
    return eng


# -- YOLOv3 ------------------------------------------------------------------

def yolo_fleet_builder(journal=None, registry=None, device=None,
                       excache=None) -> Engine:
    """YOLOv3 as chip_smoke.py's serving phase builds it (seed 0, running
    statistics calibrated on its seeded images, its detection
    parameters) in an Engine as model "yolov3". It is a float32 model,
    as the reference's: TF32 is turned off in this process, as the
    serving phase turns it off in its own. With a journal, the
    process's NMS launches are written to it when it closes (a `note`,
    `nms_launches`), so a fleet's children report their own counts.
    `excache`: an executable cache (core/excache.py) the Engine
    attaches, so the NMS library loads through it."""
    from deep_vision_tpu_torch.inference import yolo_predict_fn
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.nn.layers import calibrate_batch_stats
    from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = Engine(device=device, registry=registry, excache=excache)
    model = get_model("yolov3", num_classes=YOLO_CLASSES, seed=0,
                      device=eng.device)
    rng = np.random.RandomState(CALIBRATION_SEED)
    calibrate_batch_stats(model, torch.from_numpy(rng.rand(
        CALIBRATION_IMAGES, YOLO_IMAGE, YOLO_IMAGE, 3).astype(
            np.float32)).to(eng.device))
    eng.register("yolov3", yolo_predict_fn(model, **YOLO_DETECTION),
                 model.state_dict(),
                 input_shape=(YOLO_IMAGE, YOLO_IMAGE, 3),
                 buckets=YOLO_BUCKETS)
    if journal is not None:
        journal.add_closer(lambda: journal.write(
            "note", note="nms_launches", launches=greedy_nms.launches))
    return eng
