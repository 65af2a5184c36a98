"""The Trainer's device prefetch on the card: stream-ordered placement.

Every test here is marked `cuda` and skips without a card: the copy
stream, its events and pinned memory exist only there. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_data.py

A missed event wait or a missed `record_stream` does not crash: the step
reads a batch that is still being copied, or one that a later copy has
overwritten. So each test holds one stream back with a spin kernel
(`torch.cuda._sleep`) at the moment the fault would show, and compares
checksums of what the compute stream read with the host batches. The
caching allocators are warmed first: a new pinned block (cudaHostAlloc)
or device segment (cudaMalloc) synchronises every stream with the
others, and would hide a missed wait.
"""
import numpy as np
import pytest
import torch

from deep_vision_tpu_torch.data import PlacedBatch
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.train import Trainer, build_optimizer

#: ~25 ms of spinning at the card's clocks: far longer than a copy
SPIN = 50_000_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: copy streams and pinned memory "
                    "have no CPU mode")
    return torch.device("cuda")


def trainer_on(device, depth=2):
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(48, 10))
    return Trainer(model, build_optimizer("sgd", 0.1),
                   classification_loss_fn, torch.zeros(1, 4, 4, 3),
                   device=device, device_prefetch=depth)


def host_batches(n, rows=64, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((rows, 4, 4, 3), np.float32),
             "label": rng.integers(0, 10, rows, dtype=np.int32)}
            for _ in range(n)]


def checksum(t):
    """Sum of the tensor's 32-bit words, on its stream, as int64."""
    return t.reshape(-1).view(torch.int32).to(torch.int64).sum()


def host_checksum(a):
    return int(a.reshape(-1).view(np.int32).astype(np.int64).sum())


@pytest.mark.cuda
def test_placed_batches_equal_host_batches_under_a_busy_compute_stream(
        cuda_device):
    trainer = trainer_on(cuda_device)
    batches = host_batches(12)

    def held_back():  # runs on the prefetcher's producer thread
        for b in batches:
            with torch.cuda.stream(trainer.copy_stream):
                torch.cuda._sleep(SPIN)  # the copy lands late
            yield b

    want = [(host_checksum(b["image"]), host_checksum(b["label"]))
            for b in batches]
    for _ in range(2):  # the first pass warms the caching allocators
        sums, order = [], []
        for placed in trainer.prefetcher(held_back()):
            assert isinstance(placed, PlacedBatch)
            data = trainer._on_device(placed)
            sums.append((checksum(data["image"]), checksum(data["label"])))
            torch.cuda._sleep(SPIN)  # the step still reads as copies run
            order.append(placed.n)
        torch.cuda.synchronize()
        assert [(int(a), int(b)) for a, b in sums] == want
        assert order == [64] * 12


@pytest.mark.cuda
def test_placed_tensors_come_from_pinned_memory(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    trainer = trainer_on(cuda_device)
    batches = host_batches(20)
    trainer._place_one(batches[0])
    torch.cuda.synchronize()
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        placed = [trainer._place_one(b) for b in batches[1:]]
        torch.cuda.synchronize()
    copies = [k.name for e in prof.events() for k in e.kernels
              if k.name.startswith("Memcpy HtoD")]
    assert len(copies) >= 2 * len(placed), copies
    assert all("Pinned" in name for name in copies), copies
    # the caching host allocator hands the same pinned blocks back
    assert torch.cuda.host_memory_stats()["num_host_alloc"] - before \
        < 2 * len(placed)
    for p, b in zip(placed, batches[1:]):
        assert p.data["image"].device.type == "cuda"
        assert torch.equal(p.data["image"].cpu(), torch.from_numpy(b["image"]))
        assert torch.equal(p.data["_mask"].cpu(), torch.ones(64))


@pytest.mark.cuda
def test_placed_tensors_are_not_reused_while_a_step_reads_them(cuda_device):
    trainer = trainer_on(cuda_device)
    first, second = host_batches(2, rows=4096, seed=1)
    placed = trainer._place_one(first)
    data = trainer._on_device(placed)  # waits and records the stream
    ptr = data["image"].data_ptr()
    torch.cuda._sleep(SPIN)  # the step is still busy when ...
    read = checksum(data["image"])
    del placed, data  # ... the loop lets go of the batch
    later = trainer._place_one(second)  # same shapes, on the copy stream
    torch.cuda.synchronize()
    assert int(read) == host_checksum(first["image"])
    assert later.data["image"].data_ptr() != ptr
    assert torch.equal(later.data["image"].cpu(),
                       torch.from_numpy(second["image"]))


@pytest.mark.cuda
def test_a_second_epoch_reuses_the_first_epochs_device_blocks(cuda_device):
    trainer = trainer_on(cuda_device)
    batches = host_batches(8, rows=8192)  # 1.5 MB images: the large pool
    segments = []

    def epoch():
        torch.cuda.synchronize()  # the last epoch's blocks are free
        segments.append(torch.cuda.memory_stats()["segment.all.allocated"])
        return iter(batches)

    trainer.fit(epoch, epochs=3)
    torch.cuda.synchronize()
    segments.append(torch.cuda.memory_stats()["segment.all.allocated"])
    # every epoch's producer thread copies on the Trainer's one stream, so
    # the caching allocator hands it the blocks the last epoch freed
    assert segments[1] == segments[2] == segments[3], segments
