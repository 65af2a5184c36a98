"""The port's canary weight swap (serve/swap.py) against the JAX
package's SwapController on tests/test_serve_pool.py's toy predictor.

Each scenario runs through both packages (a two-replica pool, a
checkpoint of the new weights, live traffic while the swap runs) and the
journals' `serve_swap` (phase, outcome, reason) sequences must be equal:
a promote, a poisoned canary that rolls back on its errors, an
`io_error` at the load that rolls back at warm, and a missing checkpoint
that fails at warm. On the port's side a promote changes neither
`warmup_count()` nor the kernel-build count, every base replica serves
the new weights after it, and a rollback leaves the old ones serving.
The enums equal the reference's and tools/check_journal.py's.
"""
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.core.checkpoint import (
    CheckpointManager as RefCheckpointManager,
)
from deep_vision_tpu.obs import RunJournal as RefJournal
from deep_vision_tpu.obs import read_journal as ref_read_journal
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu.resilience import faults as ref_faults
from deep_vision_tpu.serve import SWAP_OUTCOMES as REF_OUTCOMES
from deep_vision_tpu.serve import SWAP_PHASES as REF_PHASES
from deep_vision_tpu.serve import Engine as RefEngine
from deep_vision_tpu.serve import ReplicaPool as RefPool
from deep_vision_tpu.serve import SwapController as RefSwap
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.ops.cuda import build
from deep_vision_tpu_torch.resilience import faults
from deep_vision_tpu_torch.serve import (
    SWAP_OUTCOMES,
    SWAP_PHASES,
    Engine,
    ReplicaPool,
    SwapController,
    swap_tree,
)
from deep_vision_tpu_torch.serve.engine import warmup_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.check_journal import check_journal  # noqa: E402

IMG = (4, 4, 1)


def toy_fn(variables, images):
    flat = images.reshape(images.shape[0], -1)
    return {"scores": flat @ variables["w"],
            "mean": images.mean(dim=(1, 2, 3))}


def ref_toy_fn(variables, images):
    flat = images.reshape((images.shape[0], -1))
    return {"scores": flat @ variables["w"],
            "mean": images.mean(axis=(1, 2, 3))}


def weights(scale=1.0, seed=0):
    return np.random.RandomState(seed).randn(16, 3).astype(np.float32) * scale


POISON = np.full((16, 3), 1e38, np.float32)  # finite, overflows on data


class Side:
    """One package's pool, swap controller, checkpoint and journal."""

    def __init__(self, port: bool, tmp, new_w):
        self.port = port
        tag = "port" if port else "ref"
        if port:
            self.journal = RunJournal(str(tmp / f"{tag}.jsonl"), kind="serve")
            registry = Registry()

            def build_engine(rid):
                eng = Engine(device="cpu", registry=registry)
                eng.register("toy", toy_fn, {"w": torch.from_numpy(weights())},
                             input_shape=IMG, buckets=(1, 2, 4))
                return eng

            self.pool = ReplicaPool(build_engine, replicas=2,
                                    journal=self.journal, registry=registry,
                                    max_wait_ms=3.0).start()
            self.ckpt = CheckpointManager(str(tmp / f"{tag}_ckpt"),
                                          journal=self.journal)
            if new_w is not None:
                self.ckpt.save_tree(1, swap_tree(
                    {"toy": {"w": torch.from_numpy(new_w)}}))
        else:
            self.journal = RefJournal(str(tmp / f"{tag}.jsonl"), kind="serve")
            registry = RefRegistry()

            def build_engine(rid):
                eng = RefEngine(registry=registry)
                eng.register("toy", ref_toy_fn, {"w": jnp.asarray(weights())},
                             input_shape=IMG, buckets=(1, 2, 4))
                return eng

            self.pool = RefPool(build_engine, replicas=2,
                                journal=self.journal, registry=registry,
                                max_wait_ms=3.0).start()
            self.ckpt = RefCheckpointManager(str(tmp / f"{tag}_ckpt"),
                                             journal=self.journal)
            if new_w is not None:
                self.ckpt.save_tree(1, {"toy": {"w": jnp.asarray(new_w)}})
        self.ckpt.wait()
        self.swapper = (SwapController if port else RefSwap)(
            self.pool, journal=self.journal, canary_pct=50,
            min_canary_requests=4, canary_timeout_s=30.0)

    def faults(self):
        return faults if self.port else ref_faults

    def swap_under_traffic(self, step=1, seed=11):
        """Run the swap on a thread and feed requests until it ends."""
        box = {}
        t = threading.Thread(target=lambda: box.update(
            verdict=self.swapper.swap(self.ckpt, step=step,
                                      models=("toy",))), daemon=True)
        t.start()
        rng = np.random.RandomState(seed)
        deadline = time.time() + 30
        while t.is_alive() and time.time() < deadline:
            try:
                self.pool.submit("toy", rng.rand(*IMG).astype(np.float32))
            except Exception:
                pass
            time.sleep(0.004)
        t.join(timeout=60)
        return box["verdict"]

    def answer(self, im):
        return np.asarray(
            self.pool.submit("toy", im).result(timeout=30)["scores"])

    def close(self):
        self.pool.close()
        self.ckpt.close()
        self.journal.close()
        read = read_journal if self.port else ref_read_journal
        rows = [e for e in read(self.journal.path)
                if e.get("event") == "serve_swap"]
        return [(e["phase"], e["outcome"], e.get("reason")) for e in rows]


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faults, ref_faults):
        mod.install(None)
        os.environ.pop(mod.ENV_SPEC, None)
        os.environ.pop(mod.ENV_SEED, None)


def both(tmp_path, new_w):
    return Side(True, tmp_path, new_w), Side(False, tmp_path, new_w)


def test_promote_swaps_every_replica_with_no_warmup(tmp_path):
    new_w = weights(scale=2.0, seed=7)
    port, ref = both(tmp_path, new_w)
    im = np.random.RandomState(42).rand(*IMG).astype(np.float32)
    try:
        w0, b0 = warmup_count(), build.build_count()
        got = port.swap_under_traffic()
        assert got["outcome"] == "promoted", got
        assert (warmup_count(), build.build_count()) == (w0, b0), \
            "restore, shadow probe, canary and promote run no warm-up"
        want = ref.swap_under_traffic()
        assert want["outcome"] == "promoted", want
        expect = im.reshape(-1) @ new_w
        for _ in range(4):  # least-in-flight reaches both replicas
            np.testing.assert_allclose(port.answer(im), expect, rtol=1e-5)
            np.testing.assert_allclose(ref.answer(im), expect, rtol=1e-5)
    finally:
        seq, ref_seq = port.close(), ref.close()
    assert seq == ref_seq == [("warm", "started", None), ("warm", "ok", None),
                              ("canary", "started", None),
                              ("canary", "ok", None), ("promote", "ok", None)]
    assert check_journal(port.journal.path, strict=True) == []


def test_poisoned_canary_rolls_back(tmp_path):
    port, ref = both(tmp_path, POISON)
    im = np.random.RandomState(43).rand(*IMG).astype(np.float32)
    try:
        for side in (port, ref):
            verdict = side.swap_under_traffic()
            assert verdict["outcome"] == "rolled_back", verdict
            assert verdict["reason"] == "errors"
            # the base replicas never stopped serving the old weights
            np.testing.assert_allclose(side.answer(im),
                                       im.reshape(-1) @ weights(), rtol=1e-5)
        assert port.pool.canary_status() is None
    finally:
        seq, ref_seq = port.close(), ref.close()
    assert seq == ref_seq == [
        ("warm", "started", None), ("warm", "ok", None),
        ("canary", "started", None), ("canary", "failed", "errors"),
        ("rollback", "ok", "errors")]
    assert check_journal(port.journal.path, strict=True) == []


def test_failed_restore_rolls_back_at_warm(tmp_path):
    port, ref = both(tmp_path, weights(scale=2.0, seed=7))
    try:
        for side in (port, ref):
            side.faults().install_spec("serve.replica:io_error@1", seed=0,
                                       journal=side.journal,
                                       export_env=False)
            verdict = side.swapper.swap(side.ckpt, step=1, models=("toy",))
            side.faults().install(None)
            assert verdict["outcome"] == "rolled_back"
            assert verdict["reason"] == "warm_failed"
            assert verdict["timeline"][1]["error"].startswith(
                "FaultInjected")
            assert side.pool.canary_status() is None
            assert side.answer(np.zeros(IMG, np.float32)) is not None
    finally:
        seq, ref_seq = port.close(), ref.close()
    assert seq == ref_seq == [("warm", "started", None),
                              ("warm", "failed", None),
                              ("rollback", "ok", "warm_failed")]
    assert check_journal(port.journal.path, strict=True) == []


def test_no_checkpoint_is_a_warm_failure(tmp_path):
    port, ref = both(tmp_path, None)
    try:
        for side in (port, ref):
            verdict = side.swapper.swap(side.ckpt, models=("toy",))
            assert verdict["outcome"] == "rolled_back"
            assert verdict["reason"] == "warm_failed"
        # a directory path works as the source too
        verdict = port.swapper.swap(str(tmp_path / "empty"), models=("toy",))
        assert verdict["reason"] == "warm_failed"
        assert "no valid checkpoint" in verdict["timeline"][1]["error"]
    finally:
        seq, ref_seq = port.close(), ref.close()
    assert seq[:3] == ref_seq == [("warm", "started", None),
                                  ("warm", "failed", None),
                                  ("rollback", "ok", "warm_failed")]


def test_one_swap_at_a_time(tmp_path):
    port = Side(True, tmp_path, weights(seed=3))
    try:
        assert port.swapper._swap_lock.acquire(blocking=False)
        try:
            with pytest.raises(Exception, match="already in flight"):
                port.swapper.swap(port.ckpt, step=1)
        finally:
            port.swapper._swap_lock.release()
    finally:
        port.close()


def test_enums_match_the_reference_and_the_schema():
    from tools.check_journal import SERVE_SWAP_OUTCOMES, SERVE_SWAP_PHASES

    assert SWAP_PHASES == REF_PHASES
    assert SWAP_OUTCOMES == REF_OUTCOMES
    assert set(SWAP_PHASES) == SERVE_SWAP_PHASES
    assert set(SWAP_OUTCOMES) == SERVE_SWAP_OUTCOMES
