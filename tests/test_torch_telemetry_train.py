"""The live telemetry plane on the port's Trainer (train/trainer.py
`telemetry=`), on the CPU, after the reference's tests/test_telemetry.py
TestConcurrentScrapes and TestHealthFlip.

A tiny s2d ResNet's fit runs with three threads scraping every route
and the lock sanitizer armed by DVT_LOCKSMITH=1: no scrape answers
other than 200 or 503, the sanitizer sees no lock-order violation, and
`torch.Tensor.item`, `.tolist`, `.cpu`, `__float__` and
`torch.cuda.synchronize`, patched to record calls from any thread but
the trainer's, record none: a scrape reads no tensor. /statusz's
`train.step` is the journal's last step row and `perf` carries the
StepClock's p50/p95. /healthz turns to 503 when the HealthMonitor
aborts (with the reference's detail keys) and back to 200 under a fresh
Trainer and monitor registered by the same names.
"""
import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deep_vision_tpu.obs.health import HealthMonitor as RefHealthMonitor
from deep_vision_tpu.obs.health import TrainingHealthError as RefHealthError
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import resnet
from deep_vision_tpu_torch.obs import TelemetryServer, locksmith, perfwatch
from deep_vision_tpu_torch.obs.health import (
    HealthMonitor,
    TrainingHealthError,
)
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.train import Trainer, build_optimizer

ROUTES = ("/metrics", "/varz", "/healthz", "/statusz", "/alertz")


@pytest.fixture(autouse=True)
def _clean():
    yield
    locksmith.disarm()
    perfwatch._reset_for_tests()


def get(address, path, timeout=10.0):
    try:
        with urllib.request.urlopen(f"http://{address}{path}",
                                    timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def tiny_trainer(journal, registry, **kw):
    model = resnet.ResNet(stage_sizes=(1, 1), width=8, num_classes=10,
                          stem="s2d")
    resnet.reset_parameters(model, torch.Generator().manual_seed(0))
    return Trainer(model, build_optimizer("sgd", 0.05, momentum=0.9),
                   classification_loss_fn, torch.zeros(1, 8, 8, 12),
                   device="cpu", journal=journal, registry=registry, **kw)


def batches(n, rows=4, nan=False):
    rng = np.random.RandomState(0)
    out = [{"image": rng.rand(rows, 8, 8, 12).astype(np.float32),
            "label": rng.randint(0, 10, rows).astype(np.int32)}
           for _ in range(n)]
    if nan:
        out[-1]["image"][:] = np.nan
    return out


class DeviceReads:
    """Patches the tensor reads a scrape must never make, recording each
    call made from a thread other than `owner`."""

    NAMES = ("item", "tolist", "cpu", "__float__")

    def __init__(self, monkeypatch, owner):
        self.calls = []
        self.owner = owner
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name,
                                self._wrap(getattr(torch.Tensor, name),
                                           name))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            self._wrap(torch.cuda.synchronize,
                                       "cuda.synchronize"))

    def _wrap(self, fn, name):
        def recorded(*a, **kw):
            if threading.get_ident() != self.owner:
                self.calls.append((name, threading.current_thread().name))
            return fn(*a, **kw)

        return recorded


def test_scrapes_during_fit_read_no_tensor_and_take_locks_in_order(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DVT_LOCKSMITH", "1")
    reg = Registry()
    j = RunJournal(str(tmp_path / "run.jsonl"), kind="train")
    san = locksmith.arm_from_env(journal=j)
    assert san is not None
    tele = TelemetryServer(port=0, role="train", registry=reg, journal=j,
                           discovery_dir=str(tmp_path))
    health = HealthMonitor(policy="warn", journal=j, registry=reg)
    trainer = tiny_trainer(j, reg, health=health, telemetry=tele)
    tele.start()
    reads = DeviceReads(monkeypatch, threading.get_ident())
    stop = threading.Event()
    failures, rounds = [], [0, 0, 0]

    def scrape(k):
        while not stop.is_set() or rounds[k] < 4:
            for path in ROUTES:
                code, _ = get(tele.address, path)
                if code not in (200, 503):
                    failures.append((path, code))
            rounds[k] += 1
            time.sleep(0.002)

    scrapers = [threading.Thread(target=scrape, args=(k,), daemon=True)
                for k in range(3)]
    for t in scrapers:
        t.start()
    data = batches(4)
    try:
        trainer.fit(lambda: data, epochs=2, handle_preemption=False)
    finally:
        stop.set()
        for t in scrapers:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in scrapers)
    assert not failures, failures[:3]
    assert min(rounds) >= 4
    assert reads.calls == []
    code, body = get(tele.address, "/statusz")
    status = json.loads(body)["status"]
    code_m, metrics = get(tele.address, "/metrics")
    trainer.close()
    tele.close()
    health.stop()
    report = locksmith.report()
    locksmith.disarm()
    j.close()
    assert code == code_m == 200
    assert report["violations"] == []
    assert {"obs.telemetry", "obs.registry", "obs.journal"} <= \
        set(report["locks"])
    steps = [r for r in read_journal(j.path) if r["event"] == "step"]
    assert len(steps) == 8
    assert status["train"]["step"] == steps[-1]["step"] == 8
    assert status["train"]["epoch"] == steps[-1]["epoch"] == 1
    assert status["train"]["steps_seen"] == 8
    assert status["train"]["examples_per_sec"] > 0
    p50, p95 = (status["perf"]["step_time_ms_p50"],
                status["perf"]["step_time_ms_p95"])
    assert 0 < p50 <= p95 and math.isfinite(p95)
    assert status["perf"]["recompiles"] == 0
    assert "train_step_ms_count 8" in metrics
    assert not any(r["event"] == "lock_order_violation"
                   for r in read_journal(j.path))


def test_statusz_before_a_step_and_the_mirror_after_each(tmp_path):
    reg = Registry()
    tele = TelemetryServer(registry=reg)
    trainer = tiny_trainer(None, reg, telemetry=tele)
    st = tele.statusz()["status"]
    assert st["train"] == {"step": None, "epoch": None,
                           "examples_per_sec": None, "steps_seen": 0,
                           "multistep": 1}
    assert "step_time_ms_p50" not in st["perf"]
    seen = []
    trainer.logger.start_epoch()
    for b in batches(3):
        trainer._single_step_and_log(b, epoch=5)
        seen.append(tele.statusz()["status"]["train"]["step"])
    assert seen == [1, 2, 3]
    assert tele.statusz()["status"]["train"]["epoch"] == 5
    assert set(tele.healthz()[1]["checks"]) == set()  # no monitor given


def test_healthz_flips_on_abort_and_back_on_a_fresh_monitor(tmp_path):
    reg = Registry()
    tele = TelemetryServer(port=0, role="train", registry=reg).start()
    try:
        mon = HealthMonitor(policy="abort", registry=reg)
        trainer = tiny_trainer(None, reg, health=mon, telemetry=tele)
        code, body = get(tele.address, "/healthz")
        assert code == 200 and json.loads(body)["checks"]["train"]["ok"]
        data = batches(2, nan=True)
        with pytest.raises(TrainingHealthError):
            trainer.fit(lambda: data, epochs=1, handle_preemption=False)
        code, body = get(tele.address, "/healthz")
        check = json.loads(body)["checks"]["train"]
        assert code == 503 and check["aborted"] is True
        assert "at step 2" in check["abort_reason"]
        # the reference's monitor, aborted alike, has the same detail
        ref = RefHealthMonitor(policy="abort")
        with pytest.raises(RefHealthError):
            ref.check_step(2, loss=float("nan"))
        ok, detail = ref.healthz()
        assert not ok and sorted(detail) == sorted(
            k for k in check if k != "ok")
        mon.stop()
        ref.stop()
        # a fresh run's monitor takes the slot by name: healthy again
        fresh = HealthMonitor(policy="abort", registry=Registry())
        tiny_trainer(None, Registry(), health=fresh, telemetry=tele)
        code, body = get(tele.address, "/healthz")
        assert code == 200 and not json.loads(body)["checks"]["train"][
            "aborted"]
        fresh.stop()
    finally:
        tele.close()


@pytest.mark.parametrize("site", ["divergence", "summary"])
def test_every_abort_raise_latches_first(site):
    """The latch is up at each of the monitor's abort raises, as the
    reference's (non-finite step above; divergence; the epoch
    summary)."""
    for mon_cls, err in ((HealthMonitor, TrainingHealthError),
                         (RefHealthMonitor, RefHealthError)):
        mon = mon_cls(policy="abort", min_history=3, patience=2)
        with pytest.raises(err):
            if site == "summary":
                mon.check_summary(0, {"loss": float("inf")})
            else:
                for i, loss in enumerate([1.0, 1.01, 0.99, 1.0, 50.0,
                                          60.0]):
                    mon.check_step(i, loss=loss)
        ok, detail = mon.healthz()
        assert not ok and detail["aborted"] and detail["abort_reason"]


def test_the_watchdog_latch_turns_healthz_and_a_beat_clears_it():
    for mon_cls in (HealthMonitor, RefHealthMonitor):
        mon = mon_cls(policy="warn", watchdog_timeout=0.05)
        mon.start_watchdog()
        try:
            deadline = time.monotonic() + 10
            while mon.healthz()[0] and time.monotonic() < deadline:
                time.sleep(0.01)
            ok, detail = mon.healthz()
            assert not ok and detail["watchdog_fired"] and \
                not detail["aborted"]
            mon.beat()
            assert mon.healthz()[0]
        finally:
            mon.stop()
