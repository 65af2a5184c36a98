"""Serving contracts of deep_vision_tpu_torch/serve, mirroring
tests/test_serve.py: buckets and padding, the closed bucket menu, the
batching queue, request-scoped failures, deadline shedding, the drain
ledger, and hot weight swaps without a re-warm.

Runs a torch toy model on the CPU, so the whole stack (queue -> bucket
-> engine -> router -> slo) is exercised in seconds; the real YOLO path
is tests/test_torch_slice.py here and chip_smoke.py on the card.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.serve import (
    BatchingQueue,
    DeadlineExceeded,
    Engine,
    Request,
    ServeError,
    Server,
    ServerClosed,
    SLOTracker,
    bucket_for,
    normalize_buckets,
    pad_batch,
    split_rows,
)

IMG = (4, 4, 1)


def toy_fn(variables, images):
    flat = images.reshape(images.shape[0], -1)
    return {"scores": flat @ variables["w"],
            "mean": images.mean(dim=(1, 2, 3))}


def toy_variables(seed=0):
    w = np.random.RandomState(seed).randn(16, 3).astype(np.float32)
    return {"w": torch.from_numpy(w)}


def make_engine(buckets=(1, 2, 4), seed=0, fn=toy_fn):
    eng = Engine(device="cpu", registry=Registry())
    eng.register("toy", fn, toy_variables(seed), input_shape=IMG,
                 buckets=buckets)
    return eng


def images(n, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.rand(*IMG).astype(np.float32) for _ in range(n)]


def reference(ims, seed=0):
    return {k: v.numpy() for k, v in
            toy_fn(toy_variables(seed), torch.from_numpy(np.stack(ims))).items()}


class TestBuckets:
    def test_bucket_for_rounds_up(self):
        menu = (1, 2, 4, 8)
        assert [bucket_for(n, menu) for n in (1, 2, 3, 5, 8, 9)] == \
            [1, 2, 4, 8, 8, None]

    def test_normalize_rejects_garbage(self):
        assert normalize_buckets([4, 1, 4, 2]) == (1, 2, 4)
        for bad in ([], [0, 2]):
            with pytest.raises(ValueError):
                normalize_buckets(bad)

    def test_pad_batch_and_split_rows(self):
        ims = images(3)
        arr = pad_batch(ims, 4)
        assert arr.shape == (4,) + IMG
        np.testing.assert_array_equal(arr[3], np.zeros(IMG, np.float32))
        rows = split_rows({"a": np.arange(8).reshape(4, 2)}, 3)
        assert len(rows) == 3 and rows[1]["a"].tolist() == [2, 3]
        with pytest.raises(ValueError):
            pad_batch(images(5), 4)


class TestEngine:
    def test_warmup_runs_every_bucket(self):
        eng = make_engine(buckets=(1, 2, 4))
        stats = eng.warmup()
        assert stats["pairs"] == 3
        assert eng.warmed_buckets("toy") == (1, 2, 4)

    def test_unwarmed_bucket_raises(self):
        eng = make_engine(buckets=(1, 2))
        eng.warmup()
        with pytest.raises(ServeError, match="no warmed bucket"):
            eng.run("toy", np.zeros((3,) + IMG, np.float32))

    def test_register_after_warmup_raises(self):
        eng = make_engine()
        with pytest.raises(ServeError, match="unknown model"):
            eng.entry("nope")
        eng.warmup()
        with pytest.raises(ServeError, match="after warmup"):
            eng.register("late", toy_fn, toy_variables(), IMG)

    def test_padded_rows_equal_unpadded(self):
        eng = make_engine(buckets=(4,))
        eng.warmup()
        ims = images(3)
        out = eng.run("toy", pad_batch(ims, 4))
        ref = reference(ims)
        for k in ref:
            np.testing.assert_allclose(out[k][:3].numpy(), ref[k], rtol=1e-6)

    def test_hot_swap_without_rewarm(self):
        calls = []

        def counting_fn(variables, x):
            calls.append(x.shape[0])
            return toy_fn(variables, x)

        eng = make_engine(buckets=(1, 2), fn=counting_fn)
        eng.warmup()
        warm_calls = len(calls)
        x = pad_batch(images(2), 2)
        eng.set_variables("toy", toy_variables(seed=5))
        got = eng.run("toy", x)["scores"].numpy()
        np.testing.assert_allclose(got, reference(images(2), seed=5)["scores"],
                                   rtol=1e-6)
        assert len(calls) == warm_calls + 1  # one run, no re-warm
        shadow = eng.clone_with_variables({"toy": toy_variables(seed=6)})
        np.testing.assert_allclose(
            shadow.run("toy", x)["scores"].numpy(),
            reference(images(2), seed=6)["scores"], rtol=1e-6)
        # the serving engine kept its own swap
        np.testing.assert_allclose(eng.run("toy", x)["scores"].numpy(), got)
        with pytest.raises(ServeError, match="shape/dtype"):
            eng.set_variables("toy", {"w": torch.zeros(16, 4)})
        with pytest.raises(ServeError, match="variable set"):
            eng.set_variables("toy", {"v": torch.zeros(16, 3)})

    def test_start_before_warmup_refused(self):
        with pytest.raises(ServeError, match="warmup"):
            Server(make_engine()).start()

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            assert Engine().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                Engine()


class TestBatchingQueue:
    def test_coalesces_to_max_batch(self):
        q = BatchingQueue(max_batch=4, max_wait_ms=5000)
        for _ in range(6):
            q.submit(Request("m", None))
        t0 = time.perf_counter()
        assert len(q.next_batch()) == 4
        assert time.perf_counter() - t0 < 1.0
        assert q.depth == 2

    def test_max_wait_flushes_partial_batch(self):
        q = BatchingQueue(max_batch=8, max_wait_ms=40)
        q.submit(Request("m", None))
        t0 = time.perf_counter()
        assert len(q.next_batch()) == 1
        assert 0.02 <= time.perf_counter() - t0 < 5.0

    def test_close_flushes_then_none(self):
        q = BatchingQueue(max_batch=4, max_wait_ms=60_000)
        for _ in range(2):
            q.submit(Request("m", None))
        q.close()
        assert len(q.next_batch()) == 2
        assert q.next_batch() is None
        with pytest.raises(Exception):
            q.submit(Request("m", None))


class TestServer:
    def _server(self, **kw):
        eng = make_engine(buckets=(1, 2, 4))
        eng.warmup()
        kw.setdefault("max_wait_ms", 3.0)
        return Server(eng, registry=Registry(), **kw).start()

    def test_round_trip_matches_reference(self):
        srv = self._server()
        try:
            ims = images(5)
            rows = [f.result(timeout=30)
                    for f in [srv.submit("toy", im) for im in ims]]
            ref = reference(ims)
            for i, row in enumerate(rows):
                np.testing.assert_allclose(row["scores"], ref["scores"][i],
                                           rtol=1e-6)
        finally:
            summary = srv.close()
        assert summary["outcome"] == "flushed" and summary["completed"] == 5

    def test_bad_shape_fails_one_request(self):
        srv = self._server()
        try:
            bad = srv.submit("toy", np.zeros((2, 2, 1), np.float32))
            ok = srv.submit("toy", images(1)[0])
            with pytest.raises(ServeError, match="request shape"):
                bad.result(timeout=30)
            assert ok.result(timeout=30)["scores"].shape == (3,)
            with pytest.raises(ServeError, match="unknown model"):
                srv.submit("nope", images(1)[0]).result(timeout=30)
        finally:
            summary = srv.close()
        assert summary["errors"] == 2 and summary["completed"] == 1

    def test_deadline_shed_at_dispatch(self):
        srv = self._server(max_wait_ms=150.0)
        try:
            late = srv.submit("toy", images(1)[0], deadline_ms=1.0)
            on_time = srv.submit("toy", images(1)[0], deadline_ms=60_000)
            with pytest.raises(DeadlineExceeded):
                late.result(timeout=30)
            assert on_time.result(timeout=30) is not None
        finally:
            summary = srv.close()
        assert summary["errors"] == 1 and summary["completed"] == 1

    def test_drain_invariant_under_concurrent_clients(self):
        srv = self._server(max_wait_ms=1.0)
        futs, lock = [], threading.Lock()

        def client(seed):
            for im in images(10, seed=seed):
                try:
                    f = srv.submit("toy", im)
                except ServerClosed:
                    return
                with lock:
                    futs.append(f)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.02)
        if futs:
            futs[0].cancel()
        summary = srv.close()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert summary["outcome"] == "flushed" and summary["pending"] == 0
        assert summary["accepted"] == summary["completed"] \
            + summary["errors"] + summary["cancelled"]
        assert summary["accepted"] == len(futs)
        assert all(f.done() for f in futs)
        with pytest.raises(ServerClosed):
            srv.submit("toy", images(1)[0])
        assert srv.close()["outcome"] == "flushed"  # idempotent

    def test_cancelled_future_balances_the_books(self):
        srv = self._server(max_wait_ms=200.0)
        try:
            futs = [srv.submit("toy", im) for im in images(3)]
            assert futs[1].cancel()
            assert futs[0].result(timeout=30) is not None
            assert futs[2].result(timeout=30) is not None
        finally:
            summary = srv.close()
        assert summary["cancelled"] == 1 and summary["completed"] == 2

    def test_sigterm_sets_stop_and_drain_flushes(self):
        srv = self._server(max_wait_ms=60_000)
        prev = signal.getsignal(signal.SIGTERM)
        try:
            srv.install_sigterm()
            futs = [srv.submit("toy", im) for im in images(2)]
            os.kill(os.getpid(), signal.SIGTERM)
            assert srv.wait_for_stop(timeout=10)
            with pytest.raises(ServerClosed):
                srv.submit("toy", images(1)[0])
            summary = srv.drain("sigterm")
            assert summary["outcome"] == "flushed"
            assert summary["reason"] == "sigterm"
            assert all(f.result(timeout=30) is not None for f in futs)
        finally:
            srv.uninstall_sigterm()
            signal.signal(signal.SIGTERM, prev)

    def test_slo_report_per_model(self):
        srv = self._server()
        try:
            for burst in (1, 3, 2):
                for f in [srv.submit("toy", im) for im in images(burst)]:
                    f.result(timeout=30)
        finally:
            srv.close()
        rep = srv.slo.report()["toy"]
        assert rep["requests"] == 6 and rep["batches"] >= 3
        assert 0 < rep["p50_ms"] <= rep["p99_ms"]


def test_slo_tracker_report_and_render():
    slo = SLOTracker(registry=Registry(), slo_ms=50.0)
    for ms in (5, 8, 12, 200):
        slo.request_done("toy", ms, "ok")
    slo.request_done("toy", 1.0, "error")
    slo.batch_done("toy", bucket=4, size=3, queue_wait_ms=2.0, exec_ms=6.0)
    rep = slo.report()["toy"]
    assert rep["requests"] == 4 and rep["errors"] == 1
    assert rep["occupancy_pct"] == pytest.approx(75.0)
    assert rep["padding_waste_pct"] == pytest.approx(25.0)
    assert rep["slo_violations"] == 1
    assert "occupancy 75.0%" in slo.render()


@pytest.mark.parametrize("name,want,phase", [
    ("(anonymous namespace)::nms_compact(float const*, int, int, float, "
     "int*, float*, (anonymous namespace)::State*, float*, int*)", "nms",
     "nms_compact"),
    ("(anonymous namespace)::nms_select((anonymous namespace)::Args)", "nms",
     "nms_select"),
    ("nms_kernel(float4 const*, float const*)", "nms", "nms_kernel"),
    ("nms_mask_sm90", "nms", "nms_mask_sm90"),  # before the "sm90" marker
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw",
     "conv", None),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4", "conv", None),
    ("void at::native::vectorized_elementwise_kernel<4>", "other", None),
])
def test_profile_serve_groups_the_nms_kernels_first(name, want, phase):
    from deep_vision_tpu_torch.tools.profile_serve import group, nms_phase

    assert group(name) == want
    assert nms_phase(name) == phase
