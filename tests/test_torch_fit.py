"""Port parity: the Trainer's epoch loop (fit, evaluate, plateau LR,
checkpoints, resume, EMA, preemption, the non-finite skip) against the
JAX Trainer, on the CPU, on a tiny s2d ResNet (two stages, widths 8 and
16, 10 classes, 16x16x12 inputs, batch 16).

Tolerances, each with its reason:
- two epochs of fit against the JAX Trainer (SGD lr 0.02, momentum 0.9,
  plateau on the val loss, EMA 0.9, a checkpoint each epoch): the
  per-epoch train and val summaries at rtol 1e-4, atol 1e-4 x the
  largest magnitude (tests/test_torch_train.py's Trainer-step tolerance:
  convolutions and BatchNorm statistics summed in other orders; the
  losses of the six steps differ by under 1e-6 here); top1 and top5
  within one sample of the epoch (1 / rows): they are counts, and a
  logit pair within rounding of a tie ranks either way; the learning
  rate by epoch and the plateau's state exactly (the same host
  arithmetic on a val loss the two sides agree on); the val summaries
  are EMA evaluations on both sides; the EMA update itself, fed the same
  parameter sequence on both sides, at rtol 1e-6, atol 1e-7 (the same
  float32 multiply-adds);
- the non-finite skip, resume, preemption: bitwise, port against port
  (the same arithmetic in the same order).
"""
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.core import train_state as ref_train_state
from deep_vision_tpu.core.checkpoint import CheckpointManager as RefManager
from deep_vision_tpu.losses.classification import (
    classification_loss_fn as jax_loss_fn,
)
from deep_vision_tpu.models import resnet as jax_resnet
from deep_vision_tpu.parallel.mesh import create_mesh
from deep_vision_tpu.train.ema import EmaParams as RefEma
from deep_vision_tpu.train.optimizers import ReduceLROnPlateau as RefPlateau
from deep_vision_tpu.train.optimizers import build_optimizer as jax_build
from deep_vision_tpu.train import trainer as jax_trainer_module
from deep_vision_tpu.train.trainer import Trainer as JaxTrainer
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.data import DataLoader, RecordDataset
from deep_vision_tpu_torch.data import transforms as T
from deep_vision_tpu_torch.data.pipeline import Compose
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import resnet
from deep_vision_tpu_torch.obs.health import HealthMonitor
from deep_vision_tpu_torch.tools.synth_records import (
    raw_schema,
    write_synth_records,
)
from deep_vision_tpu_torch.train import Trainer, build_optimizer
from deep_vision_tpu_torch.train.ema import EmaParams
from deep_vision_tpu_torch.train.optimizers import (
    ReduceLROnPlateau,
    make_schedule,
)

LR = 0.02
EPOCHS = 2
HW = 16
#: two stages: the last BatchNorms see 2x2 positions a sample, not 1x1;
#: four stages at this size are chaotic (a 1e-7 perturbation of the JAX
#: side's own parameters moves its sixth step's loss by 1-15%), so no two
#: implementations can agree on six steps there
STAGES = (1, 1)
BATCH = 16
RTOL = 1e-4


def close(got, want, name="", rtol=RTOL):
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=name)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def tiny_pair(seed, batch=BATCH, n_batches=3, hw=HW):
    """JAX and port tiny ResNets holding the same random variables, and
    seeded train batches and one eval batch."""
    jm = jax_resnet.ResNet(stage_sizes=STAGES, width=8, num_classes=10,
                           stem="s2d")
    tm = resnet.ResNet(stage_sizes=STAGES, width=8, num_classes=10,
                       stem="s2d")
    rng = np.random.RandomState(seed)
    # every leaf is drawn anew, so only the shapes of the init are needed
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 12)))
    v = randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape),
                                         shapes), rng)
    tm.load_state_dict(variables_from_jax(v))
    batches = [{"image": rng.rand(batch, hw, hw, 12).astype(np.float32),
                "label": rng.randint(0, 10, (batch,)).astype(np.int32)}
               for _ in range(n_batches + 1)]
    return jm, tm, v, batches[:-1], batches[-1]


def port_tiny(seed=0):
    return tiny_pair(seed)[1]


def plateau_kw():
    # never "better" after the first epoch: the second halves the LR
    return dict(factor=0.5, patience=0, mode="min", threshold=100.0)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Two epochs of fit on each side, one epoch a call, with the LR
    read after each. The JAX side runs with DVT_PALLAS_FUSED=1, so its
    BatchNorms take the folded bn_act arithmetic as the port's do."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DVT_PALLAS_FUSED", "1")
        mp.setattr(jax_trainer_module, "create_train_state",
                   compiled_train_state)
        return run_both(tmp_path_factory.mktemp("fit"))


def compiled_train_state(model, tx, sample_input, rng=None):
    """The reference's create_train_state as one compiled function: the
    JAX Trainer's initial state in a few seconds less than op by op. The
    test replaces its parameters, statistics and optimizer state."""
    return jax.jit(functools.partial(ref_train_state.create_train_state,
                                     model, tx))(sample_input, rng)


def run_both(tmp):
    jm, tm, v, train, val = tiny_pair(7)
    jt = JaxTrainer(jm, jax_build("sgd", LR, momentum=0.9, weight_decay=1e-4),
                    jax_loss_fn, jnp.zeros((BATCH, HW, HW, 12)),
                    mesh=create_mesh(devices=jax.devices()[:1]),
                    checkpoint_manager=RefManager(str(tmp / "jax")),
                    plateau=RefPlateau(**plateau_kw()),
                    plateau_metric="loss", ema_decay=0.9)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jt.state.tx.init(params))
    jt.ema = RefEma(jt.state.params, decay=0.9)
    tt = Trainer(tm, build_optimizer("sgd", LR, momentum=0.9,
                                     weight_decay=1e-4),
                 classification_loss_fn, torch.zeros(8, 16, 16, 12),
                 device="cpu",
                 checkpoint_manager=CheckpointManager(str(tmp / "port")),
                 plateau=ReduceLROnPlateau(**plateau_kw()),
                 plateau_metric="loss", ema_decay=0.9)
    lrs = {"jax": [], "port": []}
    for epoch in range(EPOCHS):
        for name, tr in (("jax", jt), ("port", tt)):
            tr.fit(lambda: iter(train), lambda: iter([val]),
                   epochs=epoch + 1, start_epoch=epoch,
                   handle_preemption=False)
            lrs[name].append(tr.current_lr)
    jt.close()
    tt.close()
    return jt, tt, lrs, tmp


@pytest.mark.parametrize("logger", ["logger", "eval_logger"])
def test_fit_summaries_match_the_jax_trainer(both, logger):
    jt, tt, _, _ = both
    want = getattr(jt, logger).history
    got = getattr(tt, logger).history
    keys = ["loss", "top1", "top5"] + (["grad_norm"] if logger == "logger"
                                       else [])
    rows = BATCH * (3 if logger == "logger" else 1)
    for k in keys:
        assert [e for e, _ in got[k]] == list(range(EPOCHS))
        g, w = [x for _, x in got[k]], [x for _, x in want[k]]
        if k.startswith("top"):  # counts: one sample may rank either way
            np.testing.assert_allclose(g, w, rtol=0, atol=1 / rows + 1e-7,
                                       err_msg=k)
        else:
            close(g, w, k)
    assert set(got) == set(want)  # examples_per_sec, epoch_time_s too


def test_plateau_lr_by_epoch_and_its_checkpoint_match(both):
    jt, tt, lrs, tmp = both
    assert lrs["port"] == pytest.approx(lrs["jax"], rel=1e-7, abs=0)
    assert lrs["port"] == pytest.approx([LR, LR / 2], rel=1e-7)
    assert tt.plateau.scale == jt.plateau.scale == 0.5
    assert tt.plateau.num_bad == jt.plateau.num_bad
    close(tt.plateau.best, jt.plateau.best, "best")
    host, err = tt.ckpt._read_sidecar(tt.state.step)
    assert err is None and host["epoch"] == EPOCHS - 1
    assert host["plateau"] == tt.plateau.state_dict()
    ref = RefManager(str(tmp / "jax"))._read_sidecar(int(jt.state.step))[0]
    assert host["plateau"]["scale"] == ref["plateau"]["scale"]
    assert sorted(host) == sorted(k for k in ref if k != "__sharding__")


def test_ema_eval_state_and_shadow_match_ema_params(both):
    """The val summaries (compared above) are EMA evaluations on both
    sides; here the shadow's arithmetic: the port's EmaParams and the
    reference's fed the same parameter sequence, and the fit's shadow
    kept out of the training model."""
    jt, tt, _, _ = both
    assert tt.ema.state_dict() == jt.ema.state_dict()
    assert not any(torch.equal(p, tt.ema.params[n])
                   for n, p in tt.model.named_parameters() if p.numel() > 1)
    _, tm, v, _, _ = tiny_pair(5)
    ref = RefEma(jax.tree_util.tree_map(jnp.asarray, v["params"]), decay=0.9)
    port = EmaParams(tm, decay=0.9)
    rng = np.random.RandomState(6)
    named = dict(tm.named_parameters())
    for _ in range(5):
        params = jax.tree_util.tree_map(
            lambda x: (x + rng.randn(*np.shape(x)) * 0.1).astype(np.float32),
            v["params"])
        with torch.no_grad():
            for k, t in variables_from_jax({"params": params}).items():
                named[k].copy_(t)
        ref.update(jax.tree_util.tree_map(jnp.asarray, params))
        port.update(tm)
    want = variables_from_jax({"params": jax.device_get(ref.params)})
    for k, w in want.items():
        np.testing.assert_allclose(port.params[k].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_resume_restores_lr_plateau_ema_and_loggers(both):
    _, tt, _, tmp = both
    tm = port_tiny()
    tr = Trainer(tm, build_optimizer("sgd", LR, momentum=0.9,
                                     weight_decay=1e-4),
                 classification_loss_fn, torch.zeros(8, 16, 16, 12),
                 device="cpu",
                 checkpoint_manager=CheckpointManager(str(tmp / "port")),
                 plateau=ReduceLROnPlateau(**plateau_kw()),
                 plateau_metric="loss", ema_decay=0.9)
    assert tr.resume() == EPOCHS and tr.state.step == tt.state.step
    assert tr.current_lr == tt.current_lr == LR / 2 and tr._base_lr == LR
    assert tr.plateau.state_dict() == tt.plateau.state_dict()
    assert tr.logger.history == {k: [tuple(x) for x in v]
                                 for k, v in tt.logger.history.items()}
    for k, v in tt.ema.params.items():
        assert torch.equal(tr.ema.params[k], v), k
    for k, v in tt.model.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k


# -- the non-finite skip -------------------------------------------------------

def _state(tr):
    opt = tr.state.optimizer
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            {id(p): {k: v.clone() for k, v in opt.state[p].items()}
             for g in opt.param_groups for p in g["params"]},
            tr.state.step)


def test_skip_step_keeps_the_whole_pre_step_state_bitwise():
    _, tm, _, train, _ = tiny_pair(3)
    _, ref_model, _, _, _ = tiny_pair(3)
    tr = Trainer(tm, build_optimizer("sgd", 0.1, momentum=0.9),
                 classification_loss_fn, torch.zeros(1, 16, 16, 12),
                 device="cpu", health=HealthMonitor("skip_step"))
    ref = Trainer(ref_model, build_optimizer("sgd", 0.1, momentum=0.9),
                  classification_loss_fn, torch.zeros(1, 16, 16, 12),
                  device="cpu")
    for t in (tr, ref):
        assert float(t.train_step(train[0]).get("skipped", 0.0)) == 0.0
    before = _state(tr)
    poisoned = dict(train[1], image=train[1]["image"].copy())
    poisoned["image"][0, 0, 0, 0] = np.nan
    m = tr.train_step(poisoned)
    assert float(m["skipped"]) == 1.0 and not np.isfinite(float(m["loss"]))
    after = _state(tr)
    assert after[2] == before[2] == 1
    assert all(torch.equal(after[0][k], v) for k, v in before[0].items())
    assert all(torch.equal(after[1][i][k], v) for i, st in before[1].items()
               for k, v in st.items())
    # the run goes on as if the poisoned batch had never come
    for t in (tr, ref):
        t.train_step(train[2])
    for k, v in ref_model.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k


def test_skipped_steps_stay_out_of_the_epoch_means(tmp_path):
    from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal

    _, tm, _, train, _ = tiny_pair(4)
    poisoned = dict(train[1], image=np.full_like(train[1]["image"], np.nan))
    journal = RunJournal(str(tmp_path / "j.jsonl"))
    tr = Trainer(tm, build_optimizer("sgd", 0.05, momentum=0.9),
                 classification_loss_fn, torch.zeros(1, 16, 16, 12),
                 device="cpu", journal=journal,
                 health=HealthMonitor("skip_step", journal=journal))
    history = tr.fit(lambda: iter([train[0], poisoned, train[2]]), epochs=1)
    journal.close()
    assert tr.state.step == 2 and np.isfinite(history[0]["train"]["loss"])
    rows = read_journal(str(tmp_path / "j.jsonl"))
    health = [r for r in rows if r["event"] == "health"]
    assert [(r["kind"], r["action"], r["step"]) for r in health] == [
        ("non_finite", "skip", 1)]
    assert [r["skipped"] for r in rows if r["event"] == "step"] == [
        False, True, False]


def test_a_diverged_epoch_raises_without_a_relaxing_policy():
    _, tm, _, train, _ = tiny_pair(5)
    bad = dict(train[0], image=np.full_like(train[0]["image"], np.nan))
    tr = Trainer(tm, build_optimizer("sgd", 1e-3), classification_loss_fn,
                 torch.zeros(1, 16, 16, 12), device="cpu")
    with pytest.raises(FloatingPointError, match="diverged"):
        tr.fit(lambda: iter([bad, train[1]]), epochs=3)
    warn = Trainer(port_tiny(5), build_optimizer("sgd", 1e-3),
                   classification_loss_fn, torch.zeros(1, 16, 16, 12),
                   device="cpu", health=HealthMonitor("warn"))
    assert len(warn.fit(lambda: iter([bad]), epochs=2)) == 2


# -- resume with the data position -------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    write_synth_records(str(d), count=48, size=36, shards=4, encoding="raw",
                        seed=3)
    return str(d / "*")


def loader(pattern):
    chain = Compose([T.RandomHorizontalFlip(), T.RandomCrop(32),
                     T.ToFloatNormalize(), T.SpaceToDepth()])
    ds = RecordDataset(pattern, raw_schema, shuffle_shards=True)
    return DataLoader(ds, 8, transform=chain, shuffle=True, num_workers=2,
                      drop_remainder=True)


def records_trainer(pattern, ckpt, seed=11):
    """A Trainer over the records (1000 classes) and its DataLoader; the
    weights are drawn from `seed`, so a resume must overwrite them."""
    tm = resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=1000,
                       stem="s2d")
    resnet.reset_parameters(tm, torch.Generator().manual_seed(seed))
    data = loader(pattern)
    tr = Trainer(tm, build_optimizer("sgd", 0.05, momentum=0.9),
                 classification_loss_fn, torch.zeros(1, 16, 16, 12),
                 device="cpu", checkpoint_manager=CheckpointManager(ckpt),
                 plateau=ReduceLROnPlateau(factor=0.5, patience=0),
                 data_loader=data)
    return tr, data


def test_resume_continues_bitwise_with_the_data_position(shards, tmp_path):
    straight, data = records_trainer(shards, str(tmp_path / "a"))
    straight.fit(lambda: data, epochs=3, handle_preemption=False)
    first, data = records_trainer(shards, str(tmp_path / "b"))
    first.fit(lambda: data, epochs=1, handle_preemption=False)
    first.close()
    again, data = records_trainer(shards, str(tmp_path / "b"), seed=12)
    assert again.resume() == 1 and again.state.step == 6
    again.fit(lambda: data, epochs=3, start_epoch=1, handle_preemption=False)
    assert again.state.step == straight.state.step == 18
    for k, v in straight.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    sa, sb = (t.state.optimizer.state_dict() for t in (straight, again))
    assert sa["param_groups"] == sb["param_groups"]
    for k, st in sa["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           sb["state"][k]["momentum_buffer"]), k


def test_a_mid_epoch_preemption_resumes_the_data_stream(shards, tmp_path):
    """SIGTERM after the second step of epoch 1: the step in flight
    finishes, the save records the loader's position, and the resumed
    run ends bitwise where an uninterrupted one does."""
    straight, data = records_trainer(shards, str(tmp_path / "a"))
    straight.fit(lambda: data, epochs=2, handle_preemption=False)
    cut, data = records_trainer(shards, str(tmp_path / "b"))

    def preempting():
        for i, b in enumerate(data):
            if data._epoch == 2 and i == 1:  # epoch 1, after its 2nd batch
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    cut.fit(preempting, epochs=2)
    assert cut.preempted and cut.state.step == 6 + 2
    again, data = records_trainer(shards, str(tmp_path / "b"), seed=12)
    assert again.resume() == 1 and again.state.step == 8
    again.fit(lambda: data, epochs=2, start_epoch=1)
    assert again.state.step == straight.state.step == 12
    for k, v in straight.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


# -- preemption (tests/test_trainer.py:166, :208) -----------------------------

def make_preemptible(ckpt):
    return Trainer(port_tiny(1), build_optimizer("adam", 1e-3),
                   classification_loss_fn, torch.zeros(1, 16, 16, 12),
                   device="cpu", checkpoint_manager=CheckpointManager(ckpt))


def eight_batches(seed=2):
    rng = np.random.RandomState(seed)
    return [{"image": rng.rand(4, 16, 16, 12).astype(np.float32),
             "label": rng.randint(0, 10, (4,)).astype(np.int32)}
            for _ in range(8)]


def test_preemption_checkpoints_and_resumes(tmp_path):
    batches = eight_batches()

    def preempting_batches():
        for i, b in enumerate(batches):
            if i == 2:  # "maintenance event" after 2 steps of epoch 0
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    trainer = make_preemptible(str(tmp_path))
    trainer.fit(preempting_batches, epochs=5)  # returns instead of dying
    assert trainer.state.step == 3  # the in-flight step completed
    trainer2 = make_preemptible(str(tmp_path))
    assert trainer2.resume() == 0  # the incomplete epoch is re-run
    assert trainer2.state.step == 3
    trainer2.fit(lambda: iter(batches), epochs=2, start_epoch=0)
    assert trainer2.state.step == 3 + 2 * 8
    # the handler was restored: SIGTERM is the default again
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_preemption_during_eval_saves_the_completed_epoch(tmp_path):
    batches = eight_batches()

    def preempting_eval():
        os.kill(os.getpid(), signal.SIGTERM)
        yield from batches[:2]

    trainer = make_preemptible(str(tmp_path))
    trainer.fit(lambda: iter(batches), preempting_eval, epochs=5)
    assert trainer.state.step == 8
    trainer2 = make_preemptible(str(tmp_path))
    assert trainer2.resume() == 1 and trainer2.state.step == 8


# -- construction ---------------------------------------------------------------

def test_schedule_plus_plateau_rejected():
    tx = build_optimizer("sgd", make_schedule("step", 0.1, step_size=10),
                         momentum=0.9)
    with pytest.raises(ValueError, match="schedule"):
        Trainer(port_tiny(), tx, classification_loss_fn,
                torch.zeros(1, 16, 16, 12), device="cpu",
                plateau=ReduceLROnPlateau())


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"multistep": 2},
                                {"checkify_errors": True},
                                {"profile_dir": "p"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Trainer(port_tiny(), build_optimizer("sgd", 0.1),
                classification_loss_fn, torch.zeros(1, 16, 16, 12),
                device="cpu", **kw)


def test_executable_cache_trains_bitwise_as_without(shards, tmp_path):
    """Trainer(executable_cache=) attaches the cache to the process
    (one root a process) and trains the records run bitwise as the
    Trainer without it."""
    from deep_vision_tpu_torch.core import build
    from deep_vision_tpu_torch.core.excache import ExecutableCache

    plain, data = records_trainer(shards, str(tmp_path / "a"))
    plain.fit(lambda: data, epochs=1, handle_preemption=False)
    cache = ExecutableCache(str(tmp_path / "excache"))
    try:
        tm = resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8,
                           num_classes=1000, stem="s2d")
        resnet.reset_parameters(tm, torch.Generator().manual_seed(11))
        data = loader(shards)
        cached = Trainer(tm, build_optimizer("sgd", 0.05, momentum=0.9),
                         classification_loss_fn, torch.zeros(1, 16, 16, 12),
                         device="cpu", data_loader=data,
                         checkpoint_manager=CheckpointManager(
                             str(tmp_path / "b")),
                         plateau=ReduceLROnPlateau(factor=0.5, patience=0),
                         executable_cache=cache)
        assert cached.excache is cache and build._cache is cache
        cached.fit(lambda: data, epochs=1, handle_preemption=False)
        with pytest.raises(RuntimeError, match="second root"):
            Trainer(port_tiny(), build_optimizer("sgd", 0.1),
                    classification_loss_fn, torch.zeros(1, 16, 16, 12),
                    device="cpu", executable_cache=ExecutableCache(
                        str(tmp_path / "other")))
    finally:
        build.detach_cache()
    assert cached.state.step == plain.state.step == 6
    for k, v in plain.model.state_dict().items():
        assert torch.equal(cached.model.state_dict()[k], v), k


def test_current_lr_tracks_the_schedule():
    sched = make_schedule("step", 0.1, step_size=2, gamma=0.5)
    tr = Trainer(port_tiny(), build_optimizer("sgd", sched, momentum=0.9),
                 classification_loss_fn, torch.zeros(1, 16, 16, 12),
                 device="cpu")
    assert tr.current_lr == pytest.approx(0.1)
    for b in eight_batches()[:4]:
        tr.train_step(b)
    # steps 0-1 ran at 0.1, steps 2-3 at 0.05: the last update's
    assert tr.current_lr == pytest.approx(0.05)


# -- the health monitor (obs/health.py) against the reference's -----------------

class _Rows:
    def __init__(self):
        self.rows = []

    def write(self, event, **fields):
        self.rows.append({"event": event, **fields})


def _health_run(mod, policy, sequence):
    """Actions and journal rows of a monitor fed `sequence` of (loss,
    grad_norm, skipped); an abort ends the run."""
    rows = _Rows()
    mon = mod.HealthMonitor(policy, journal=rows, min_history=5, window=10,
                            patience=2)
    actions = []
    for step, (loss, gnorm, skipped) in enumerate(sequence, 1):
        try:
            actions.append(mon.check_step(step, loss=loss, grad_norm=gnorm,
                                          skipped=skipped))
        except mod.TrainingHealthError as e:
            actions.append(f"raised: {e}")
            break
    return actions, [(r["kind"], r.get("action"), r.get("step"))
                     for r in rows.rows]


HEALTH_SEQUENCE = ([(1.0 + 0.01 * (i % 3), 1.0, False) for i in range(8)]
                   + [(50.0, 1.0, False), (1.01, float("nan"), False),
                      (60.0, 2.0, False), (70.0, 2.0, False),
                      (float("inf"), 3.0, True), (1.0, 1.0, False)])


@pytest.mark.parametrize("policy", ["warn", "skip_step", "abort"])
def test_health_policies_act_as_the_references(policy):
    from deep_vision_tpu.obs import health as ref_health
    from deep_vision_tpu_torch.obs import health

    assert _health_run(health, policy, HEALTH_SEQUENCE) == _health_run(
        ref_health, policy, HEALTH_SEQUENCE)
    got = _health_run(health, policy, HEALTH_SEQUENCE)[0]
    assert "spike" in got or got[-1].startswith("raised")


def test_watchdog_dumps_every_threads_stack_once_a_stall():
    import time

    rows = _Rows()
    mon = HealthMonitor("warn", journal=rows, watchdog_timeout=0.2)
    mon.start_watchdog()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not any(
                r["kind"] == "hang" for r in rows.rows):
            time.sleep(0.05)
        time.sleep(0.3)  # a second deadline without a beat: no second dump
    finally:
        mon.stop()
    hangs = [r for r in rows.rows if r["kind"] == "hang"]
    assert [r["kind"] for r in rows.rows][0] == "watchdog_started"
    assert len(hangs) == 1 and any("MainThread" in k
                                   for k in hangs[0]["stacks"])
    assert mon._wd_thread is None
