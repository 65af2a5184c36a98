"""Port parity: data/pipeline.py, data/datasets.py's RecordDataset,
data/snapshot.py and data/device_prefetch.py against the JAX package's
own, and the Trainer's device prefetch, on the CPU.

The same records (written by the port's writer from a numpy seed) and
the same seeds go through both loaders: thread-worker streams must be
equal batch for batch, bit for bit; worker-process streams interleave
nondeterministically, so an epoch's samples must be equal as a multiset;
a stream resumed from a mid-epoch `state_dict` must replay the
reference's remaining batches. The Trainer fed through
`device_prefetch=2` must give the history it gives without it, bit for
bit, and, from port-written records, the JAX Trainer's losses fed by the
reference DataLoader, within tests/test_torch_train.py's tolerance for
Trainer steps (rtol 1e-4, atol 1e-4 x the largest magnitude:
convolutions and BatchNorm statistics summed in other orders). As there,
over three steps: at lr 0.1 the two sides' rounding differences grow
about fivefold a step (2.6e-5 of the loss at the third step here, 4e-4
at the fourth).
"""
import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.data import datasets as ref_datasets
from deep_vision_tpu.data import device_prefetch as ref_prefetch
from deep_vision_tpu.data import pipeline as ref_pipeline
from deep_vision_tpu.data import transforms as ref_T
from deep_vision_tpu.losses.classification import (
    classification_loss_fn as jax_loss_fn,
)
from deep_vision_tpu.models import resnet as jax_resnet
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu.parallel.mesh import create_mesh
from deep_vision_tpu.train.optimizers import build_optimizer as jax_build
from deep_vision_tpu.train.trainer import Trainer as JaxTrainer
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.data import datasets, device_prefetch, pipeline
from deep_vision_tpu_torch.data import transforms as T
from deep_vision_tpu_torch.data.snapshot import SnapshotMismatch
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import resnet
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.tools.synth_records import (
    raw_schema,
    write_synth_records,
)
from deep_vision_tpu_torch.train import Trainer, build_optimizer


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setenv("DVT_PALLAS_FUSED", "1")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """48 raw 20x20 images in 4 shards, written by the port."""
    d = tmp_path_factory.mktemp("records")
    write_synth_records(str(d), count=48, size=20, shards=4, seed=3)
    return str(d / "train-*")


def chain(mod):
    """The ImageNet train chain at 16x16, SpaceToDepth included."""
    return mod.Compose([mod.T.RandomHorizontalFlip(), mod.T.RandomCrop(16),
                        mod.T.ColorJitter(0.4, 0.4, 0.4),
                        mod.T.ToFloatNormalize(expand_gray_to_rgb=True),
                        mod.T.SpaceToDepth()])


class Side:
    """One side's classes: the port's (`PORT`) or the reference's (`REF`)."""

    def __init__(self, pl, ds, transforms):
        self.DataLoader, self.Compose = pl.DataLoader, pl.Compose
        self.RecordDataset, self.T = ds.RecordDataset, transforms


PORT = Side(pipeline, datasets, T)
REF = Side(ref_pipeline, ref_datasets, ref_T)


def record_loader(side, pattern, **kw):
    ds = side.RecordDataset(pattern, raw_schema, shuffle_shards=True,
                            seed=kw.pop("seed", 0))
    return side.DataLoader(ds, kw.pop("batch_size", 8),
                           transform=kw.pop("transform", chain(side)), **kw)


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes(), k


class MapData:
    def __init__(self, n=37):
        rng = np.random.default_rng(1)
        self.items = [{"image": rng.integers(0, 256, (20, 20, 3), np.uint8),
                       "label": np.int32(i)} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


# -- DataLoader --------------------------------------------------------------

@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_map_style_loader_with_shuffle_matches_the_reference(
        num_workers, drop_remainder):
    out = []
    for side in (PORT, REF):
        loader = side.DataLoader(MapData(), 8, transform=chain(side),
                                 shuffle=True, num_workers=num_workers,
                                 drop_remainder=drop_remainder, seed=5)
        assert len(loader) == (4 if drop_remainder else 5)
        out.append([b for _ in range(2) for b in loader])  # two epochs
    assert_batches_equal(*out)


@pytest.mark.parametrize("shuffle_buffer", [1, 16, 1000])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_record_loader_matches_the_reference(shards, shuffle_buffer,
                                             drop_remainder):
    out = []
    for side in (PORT, REF):
        loader = record_loader(side, shards, shuffle=True,
                               shuffle_buffer=shuffle_buffer,
                               drop_remainder=drop_remainder, batch_size=10,
                               num_workers=3, seed=2)
        out.append([b for _ in range(2) for b in loader])
    assert_batches_equal(*out)
    assert out[0][0]["image"].shape == (10, 8, 8, 12)
    assert len(out[0]) == (8 if drop_remainder else 10)


def test_unshuffled_loader_without_transform_and_host_prefetch_off(shards):
    out = []
    for side in (PORT, REF):
        loader = record_loader(side, shards, transform=None, prefetch=0,
                               batch_size=7)
        out.append(list(loader))
    assert_batches_equal(*out)


def sample_key(image, label):
    return (image.tobytes(), int(label))


def test_worker_processes_give_the_references_samples_as_a_multiset(shards):
    keys = []
    for side in (PORT, REF):
        loader = record_loader(side, shards, shuffle=True, num_procs=2,
                               batch_size=8, worker_poll_s=1.0)
        keys.append(sorted(sample_key(i, l) for b in loader
                           for i, l in zip(b["image"], b["label"])))
    assert len(keys[0]) == 48 and keys[0] == keys[1]


def test_worker_processes_need_a_splittable_dataset():
    with pytest.raises(TypeError, match="split"):
        pipeline.DataLoader(MapData(), 4, num_procs=2)


def test_a_resumed_stream_replays_the_references_remaining_batches(shards):
    full = list(record_loader(REF, shards, shuffle=True, shuffle_buffer=16,
                              batch_size=8, seed=4))
    loader = record_loader(PORT, shards, shuffle=True, shuffle_buffer=16,
                           batch_size=8, seed=4)
    loader.enable_snapshots()
    ref = record_loader(REF, shards, shuffle=True, shuffle_buffer=16,
                        batch_size=8, seed=4)
    ref.enable_snapshots()
    it, ref_it = iter(loader), iter(ref)
    for _ in range(2):
        next(it), next(ref_it)
    state = loader.state_dict()
    assert state == ref.state_dict()
    assert state["epoch"] == 0 and state["batches"] == 2
    resumed = record_loader(PORT, shards, shuffle=True, shuffle_buffer=16,
                            batch_size=8, seed=4)
    info = resumed.load_state_dict(state)
    assert info["epoch"] == 0 and info["batches"] == 2
    assert_batches_equal(list(resumed), full[2:])
    other = record_loader(PORT, shards, shuffle=True, batch_size=4, seed=4)
    with pytest.raises(SnapshotMismatch):
        other.load_state_dict(state)


def test_the_record_dataset_splits_and_budget_match_the_reference(
        shards, tmp_path):
    from deep_vision_tpu.data.records import BadRecordBudget as RefBudget
    from deep_vision_tpu_torch.data.records import BadRecordBudget

    for i in range(2):
        got = datasets.RecordDataset(shards, raw_schema, shuffle_shards=True,
                                     seed=3).split(i, 2)
        want = ref_datasets.RecordDataset(shards, raw_schema,
                                          shuffle_shards=True,
                                          seed=3).split(i, 2)
        got.set_epoch(1), want.set_epoch(1)
        assert got.files == want.files and got.seed == want.seed
        assert [sample_key(**s) for s in got] == \
            [sample_key(**s) for s in want]

    def bad_schema(feats):  # undecodable records burn the budget
        if feats["image/class/label"][0] % 5 == 0:
            raise ValueError("schema drift")
        return raw_schema(feats)

    seen = []
    for ds_mod, budget in ((datasets, BadRecordBudget(max_count=100)),
                           (ref_datasets, RefBudget(max_count=100))):
        ds = ds_mod.RecordDataset(shards, bad_schema,
                                  bad_record_budget=budget)
        seen.append(([sample_key(**s) for s in ds], budget.spend()))
    assert seen[0] == seen[1] and seen[0][1]["bad"] > 0


# -- DevicePrefetcher (CPU) --------------------------------------------------

def prefetchers(**kw):
    """[(port prefetcher, its registry), (the reference's, its registry)]
    over list batches, the reference's with its default group of 1."""
    out = []
    for mod, reg in ((device_prefetch, Registry()),
                     (ref_prefetch, RefRegistry())):
        out.append((mod.DevicePrefetcher(
            lambda b, m=mod: m.PlacedBatch(b, len(b)),
            registry=reg, **kw), reg))
    return out


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_prefetcher_keeps_order_as_the_reference(depth):
    source = [[i] * (i % 3 + 1) for i in range(10)]
    runs = [[(p.data, p.n) for p in pf(iter(source))]
            for pf, _ in prefetchers(depth=depth)]
    assert runs[0] == runs[1] == [(b, len(b)) for b in source]


def test_a_producer_error_surfaces_at_the_consumer():
    def source():
        yield [1]
        yield [2]
        raise IOError("shard gone")

    (pf, _), _ = prefetchers()
    got = []
    with pytest.raises(IOError, match="shard gone"):
        for p in pf(source()):
            got.append(p.data)
    assert got == [[1], [2]]


def test_an_abandoned_consumer_releases_the_producer():
    (pf, _), _ = prefetchers(depth=1)
    pf.name = "abandoned"
    it = pf(iter([[i] for i in range(100)]))
    assert next(it).data == [0]
    it.close()
    producers = [t for t in threading.enumerate()
                 if t.name == "device-prefetch-abandoned"]
    for t in producers:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in producers)


@pytest.mark.parametrize("slow", ["producer", "consumer"])
def test_the_starvation_counter_follows_the_references_rule(slow):
    counts = []
    for pf, reg in prefetchers(depth=2):
        place = pf.place_one

        def slow_place(b, place=place):
            if slow == "producer":
                time.sleep(0.02)
            return place(b)

        pf.place_one = slow_place
        for _ in pf(iter([[i] for i in range(6)])):
            if slow == "consumer":
                time.sleep(0.05)
        counts.append(reg.counter("device_prefetch_starved_total",
                                  labels={"loader": "train"}).value)
    assert counts[0] == counts[1] == (5 if slow == "producer" else 0)


def test_place_time_is_recorded_per_batch():
    reg = Registry()
    pf = device_prefetch.DevicePrefetcher(
        lambda b: device_prefetch.PlacedBatch(b, 1), registry=reg)
    assert len(list(pf(iter([[1], [2], [3]])))) == 3
    assert reg.histogram("device_prefetch_place_ms",
                         labels={"loader": "train"}).count == 3


# -- the Trainer's device prefetch -------------------------------------------

def port_resnet(seed=0):
    model = resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                          stem="s2d")
    resnet.reset_parameters(model, torch.Generator().manual_seed(seed))
    return model


def ten_class_batches(pattern, n_batches, batch=8, seed=0):
    """Loader batches with labels folded into 10 classes."""
    loader = record_loader(PORT, pattern, batch_size=batch, shuffle=True,
                           drop_remainder=True, seed=seed)
    out = []
    for b in loader:
        out.append(dict(b, label=(b["label"] % 10).astype(np.int32)))
    return out[:n_batches]


def test_fit_with_device_prefetch_gives_the_same_history_bitwise(shards):
    batches = ten_class_batches(shards, 4)
    masked = dict(batches[1], _mask=np.array([1, 1, 0, 1, 1, 1, 0, 1],
                                             np.float32))
    data = [batches[0], masked, batches[2], batches[3]]
    runs = []
    for depth in (0, 2):
        trainer = Trainer(port_resnet(), build_optimizer(
            "sgd", 0.05, momentum=0.9), classification_loss_fn,
            torch.zeros(1, 8, 8, 12), device="cpu", device_prefetch=depth)
        assert (trainer.prefetcher is None) == (depth == 0)
        history = trainer.fit(lambda: iter(data), lambda: iter(data[:1]),
                              epochs=2)
        runs.append((history, trainer.model.state_dict(), trainer.state.step))
    (h0, s0, n0), (h2, s2, n2) = runs
    assert h0 == h2 and n0 == n2 == 8
    assert all(torch.equal(s0[k], s2[k]) for k in s0)


def test_placed_batches_on_the_cpu_carry_a_mask_and_their_rows(shards):
    trainer = Trainer(port_resnet(), build_optimizer("sgd", 0.1),
                      classification_loss_fn, torch.zeros(1, 8, 8, 12),
                      device="cpu", device_prefetch=2)
    batch = ten_class_batches(shards, 1)[0]
    placed = trainer._place_one(batch)
    assert placed.n == 8 and placed.ready is None
    assert torch.equal(placed.data["_mask"], torch.ones(8))
    assert torch.equal(placed.data["image"], torch.from_numpy(batch["image"]))
    half = trainer._place_one(dict(batch, _mask=np.array([1, 0] * 4,
                                                         np.float32)))
    assert half.n == 4 and trainer._rows(half) == 4
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Trainer(port_resnet(), build_optimizer("sgd", 0.1),
                classification_loss_fn, torch.zeros(1, 8, 8, 12),
                device_prefetch=2)


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


def close(got, want, name, rtol=1e-4):
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=name)


def test_fed_trainer_matches_the_jax_trainer_fed_by_the_reference_loader(
        shards):
    jm = jax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                           stem="s2d")
    tm = resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                       stem="s2d")
    rng = np.random.RandomState(7)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((8, 8, 8, 12))))
    v = randomize(v, rng)
    tm.load_state_dict(variables_from_jax(v))
    kw = dict(momentum=0.9, weight_decay=1e-4)
    jt = JaxTrainer(jm, jax_build("sgd", 0.1, **kw), jax_loss_fn,
                    jnp.zeros((8, 8, 8, 12)),
                    mesh=create_mesh(devices=jax.devices()[:1]))
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jt.state.tx.init(params))

    def ten_classes(loader):
        for b in loader:
            yield dict(b, label=(b["label"] % 10).astype(np.int32))

    def loader(side):
        return record_loader(side, shards, batch_size=8, shuffle=True,
                             shuffle_buffer=16, drop_remainder=True, seed=6)

    def three(side):  # the first three batches of the epoch
        return itertools.islice(ten_classes(loader(side)), 3)

    want = [jax.device_get(jt.train_step(b)) for b in three(REF)]
    tt = Trainer(tm, build_optimizer("sgd", 0.1, **kw),
                 classification_loss_fn, torch.zeros(1, 8, 8, 12),
                 device="cpu", device_prefetch=2)
    losses = []

    def recording_loss(outputs, batch):
        loss, metrics = classification_loss_fn(outputs, batch)
        losses.append(float(loss.detach()))
        return loss, metrics

    tt.loss_fn = recording_loss
    history = tt.fit(lambda: three(PORT))
    assert tt.state.step == 3 and int(jt.state.step) == 3
    for i, m in enumerate(want):
        close(losses[i], float(m["loss"]), f"step {i} loss")
    for k in ("loss", "top1", "top5", "grad_norm"):
        close(history[0]["train"][k], np.mean([float(m[k]) for m in want]),
              k)
