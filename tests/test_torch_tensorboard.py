"""The port's TensorBoard writer (core/tensorboard.py) and MetricLogger's
scalars (core/metrics.py) against the JAX package's.

`_encode_event` gives the reference's bytes for the same arguments
(tolerance 0); a port `SummaryWriter` file reads through both packages'
record readers; the same `log_step` / `end_epoch` calls through both
packages' `MetricLogger(tb_writer=)` write the same (tag, step, value)
sequence, the epoch's wall-clock values (examples_per_sec and
epoch_time_s) compared by tag and step only.
"""
import math
import re

import pytest

from deep_vision_tpu.core import tensorboard as ref_tb
from deep_vision_tpu.core.metrics import MetricLogger as RefLogger
from deep_vision_tpu.data.records import read_records as ref_read_records
from deep_vision_tpu_torch.core import tensorboard as port_tb
from deep_vision_tpu_torch.core.metrics import MetricLogger
from deep_vision_tpu_torch.data.records import read_records

EVENTS = {
    "file_version": dict(wall_time=1.7e9, file_version="brain.Event:2"),
    "step_zero": dict(wall_time=1.7e9 + 0.125, step=0, tag="train/loss",
                      simple_value=2.25),
    "step_one": dict(wall_time=0.0, step=1, tag="a", simple_value=-1.0),
    "step_large": dict(wall_time=123.456, step=2 ** 40 + 3,
                       tag="val/epoch_top1", simple_value=0.875),
    "rounded_to_float32": dict(wall_time=5.5, step=300,
                               tag="train/batch_lr", simple_value=0.1),
    "unicode_tag": dict(wall_time=1.0, step=7, tag="verlust/ü",
                        simple_value=3.0),
    "long_tag": dict(wall_time=1.0, step=127, tag="t" * 200,
                     simple_value=1e-30),
    "nan": dict(wall_time=2.0, step=128, tag="train/batch_loss",
                simple_value=float("nan")),
    "inf": dict(wall_time=2.0, step=16384, tag="x", simple_value=-math.inf),
}


@pytest.mark.parametrize("case", sorted(EVENTS))
def test_encode_event_bytes_are_the_references(case):
    kw = EVENTS[case]
    assert port_tb._encode_event(**kw) == ref_tb._encode_event(**kw)


def test_a_port_event_file_reads_through_both_record_readers(tmp_path):
    w = port_tb.SummaryWriter(str(tmp_path / "tb"))
    for step, (tag, v) in enumerate([("loss", 2.5), ("top1", 0.25),
                                     ("loss", 1.5)]):
        w.scalar(tag, v, step)
    w.close()
    ours = list(read_records(w.path))
    theirs = list(ref_read_records(w.path))
    assert ours == theirs and len(ours) == 4
    assert ours[0][9:] == port_tb._encode_event(
        0.0, file_version="brain.Event:2")[9:]  # past the wall time
    assert [(s, t, v) for _, s, t, v in port_tb.read_scalars(w.path)] == [
        (0, "loss", 2.5), (1, "top1", 0.25), (2, "loss", 1.5)]
    ref_w = ref_tb.SummaryWriter(str(tmp_path / "ref"))
    ref_w.scalar("loss", 2.5, 0)
    ref_w.close()
    assert [(s, t, v) for _, s, t, v in port_tb.read_scalars(ref_w.path)] \
        == [(0, "loss", 2.5)]


class Scalars:
    """A tb_writer that keeps what it is given."""

    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, int(step), float(value)))


def drive(logger_cls):
    tb = Scalars()
    lg = logger_cls(tb_writer=tb, name="train", print_every=2)
    for epoch in range(2):
        lg.start_epoch()
        for i in range(3):
            step = epoch * 3 + i + 1
            kw = dict(batch_size=4, epoch=epoch, lr=0.1 / step)
            if i != 1:  # the middle step without a clock: no data wait
                kw.update(data_wait_ms=1.5 * step,
                          examples_per_sec=100.0 + step)
            lg.log_step(step, {"loss": 2.0 / step, "top1": 0.25 * i}, **kw)
        lg.end_epoch(epoch, extra={"grad_norm": epoch + 0.5})
    return tb.rows


WALL_CLOCK = ("train/epoch_examples_per_sec", "train/epoch_epoch_time_s",
              "train/examples_per_sec")


def step_lines(out):
    """The stdout step lines without their timestamps, the wall-clock
    rates masked."""
    return [re.sub(r"ex/s=[0-9.]+", "ex/s=*", line.split("] ", 1)[1])
            for line in out.splitlines() if " step " in line]


def test_metric_loggers_write_the_same_scalars(capsys):
    ref = drive(RefLogger)
    ref_out = capsys.readouterr().out
    port = drive(MetricLogger)
    port_out = capsys.readouterr().out
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    assert [r for r in port if r[0] not in WALL_CLOCK] == \
        [r for r in ref if r[0] not in WALL_CLOCK]
    # the rate is wall clock only where no clock gave one (the middle
    # step of each epoch)
    clocked = [r for r in port if r[0] == "train/examples_per_sec"
               and r[1] % 3 != 2]
    assert clocked == [r for r in ref if r[0] == "train/examples_per_sec"
                       and r[1] % 3 != 2] and len(clocked) == 4
    assert {"train/batch_loss", "train/data_wait_ms", "train/epoch_loss",
            "train/epoch_grad_norm"} <= {r[0] for r in port}
    assert step_lines(port_out) == step_lines(ref_out)
    assert any("data_wait_ms=" in line for line in step_lines(port_out))


def test_logger_scalars_land_in_the_event_file(tmp_path):
    w = port_tb.SummaryWriter(str(tmp_path))
    lg = MetricLogger(tb_writer=w, name="train", print_every=0)
    lg.start_epoch()
    lg.log_step(1, {"loss": 3.0}, batch_size=4, epoch=0, data_wait_ms=2.0,
                examples_per_sec=50.0)
    summary = lg.end_epoch(0)
    w.close()
    assert summary["loss"] == pytest.approx(3.0)
    got = {(t, s): v for _, s, t, v in port_tb.read_scalars(w.path)}
    assert got[("train/batch_loss", 1)] == 3.0
    assert got[("train/data_wait_ms", 1)] == 2.0
    assert got[("train/examples_per_sec", 1)] == 50.0
    assert got[("train/epoch_loss", 0)] == 3.0
