"""TensorBoard event files, written by hand (no TensorBoard or TF package).

The port of deep_vision_tpu/core/tensorboard.py: the same
`events.out.tfevents.*` bytes, framed by the port's record writer
(data/records.py `RecordWriter`, TFRecord framing with masked crc32c),
each record one Event proto encoded with the port's protobuf helpers
(data/example_codec.py `_tag`, `_write_varint`):

    Event   { 1: wall_time (double), 2: step (int64),
              3: file_version (string), 5: summary (Summary) }
    Summary { repeated 1: Value { 1: tag (string), 2: simple_value (float) } }

`read_scalars` reads such a file back (the version event left out), for
checks that have no TensorBoard either.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import List, Optional, Tuple

from deep_vision_tpu_torch.data.example_codec import (
    _read_varint,
    _tag,
    _write_varint,
)
from deep_vision_tpu_torch.data.records import RecordWriter, read_records


def _encode_event(wall_time: float, step: int = 0,
                  file_version: Optional[str] = None,
                  tag: Optional[str] = None,
                  simple_value: Optional[float] = None) -> bytes:
    """One Event's bytes; step 0 is left out, as proto3 leaves out a
    default value."""
    buf = bytearray()
    _write_varint(buf, _tag(1, 1))  # wall_time: double (wire type I64)
    buf += struct.pack("<d", wall_time)
    if step:
        _write_varint(buf, _tag(2, 0))
        _write_varint(buf, step)
    if file_version is not None:
        fv = file_version.encode()
        _write_varint(buf, _tag(3, 2))
        _write_varint(buf, len(fv))
        buf += fv
    if tag is not None:
        value = bytearray()
        tb = tag.encode()
        _write_varint(value, _tag(1, 2))
        _write_varint(value, len(tb))
        value += tb
        _write_varint(value, _tag(2, 5))  # simple_value: float (wire I32)
        value += struct.pack("<f", float(simple_value))
        summary = bytearray()
        _write_varint(summary, _tag(1, 2))
        _write_varint(summary, len(value))
        summary += value
        _write_varint(buf, _tag(5, 2))
        _write_varint(buf, len(summary))
        buf += summary
    return bytes(buf)


class SummaryWriter:
    """TensorBoard scalar writer: `scalar(tag, value, step)`, the
    `tb_writer` that core/metrics.py's MetricLogger takes. The file
    starts with the `brain.Event:2` version event."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"events.out.tfevents."
                                 f"{int(time.time())}.{socket.gethostname()}")
        self._w = RecordWriter(self.path)
        self._w.write(_encode_event(time.time(), file_version="brain.Event:2"))
        self._w.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._w.write(_encode_event(time.time(), step=int(step), tag=tag,
                                    simple_value=float(value)))

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()


def _fields(data: bytes):
    """(field, value) of one message: an int for a varint, bytes for a
    length-delimited or fixed-width field."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = data[pos:pos + n], pos + n
        else:
            raise ValueError(f"wire type {wire} in an event")
        yield field, value


def read_scalars(path: str) -> List[Tuple[float, int, str, float]]:
    """(wall_time, step, tag, value) of every scalar in an event file, in
    file order, through the record reader (crc-checked)."""
    out = []
    for record in read_records(path):
        wall, step, values = 0.0, 0, []
        for field, value in _fields(record):
            if field == 1:
                (wall,) = struct.unpack("<d", value)
            elif field == 2:
                step = value
            elif field == 5:
                for _, v in _fields(value):
                    got = dict(_fields(v))
                    values.append((got[1].decode(),
                                   struct.unpack("<f", got[2])[0]))
        out += [(wall, step, tag, val) for tag, val in values]
    return out
