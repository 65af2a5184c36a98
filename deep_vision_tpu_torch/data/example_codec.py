"""Minimal tf.train.Example protobuf wire codec (no TensorFlow dependency).

A copy of deep_vision_tpu/data/example_codec.py: the same bytes out, for
the same feature dicts in.

The reference's entire record tooling speaks tf.train.Example
(`Datasets/VOC2007/tfrecords.py:38-95`, `ResNet/tensorflow/train.py:150-160`);
implementing the wire format directly keeps those shard files readable and
writable from this framework without importing TF on the training hosts.

Wire schema (proto3 subset):

    Example    { 1: Features }
    Features   { 1: map<string, Feature> }   // repeated map-entry messages
    Feature    { oneof: 1: BytesList, 2: FloatList, 3: Int64List }
    BytesList  { repeated 1: bytes }
    FloatList  { repeated packed 1: float }   // also accepts unpacked
    Int64List  { repeated packed 1: varint }  // also accepts unpacked

Python-side representation is a flat dict:

    {"image/encoded": [b"..."], "image/width": [416], "bbox/xmin": [0.1, 0.4]}

bytes values -> BytesList, floats -> FloatList, ints -> Int64List.
"""
from __future__ import annotations

import numbers
import struct
from typing import Dict, List, Sequence, Union

FeatureValue = Union[Sequence[bytes], Sequence[float], Sequence[int]]

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


# -- varint ------------------------------------------------------------------

def _write_varint(buf: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


# -- encode ------------------------------------------------------------------

def _encode_feature(values: FeatureValue) -> bytes:
    buf = bytearray()
    if not values:
        # typeless empty feature: emit an empty Int64List
        inner = b""
        _write_varint(buf, _tag(3, _WIRE_LEN))
        _write_varint(buf, len(inner))
        return bytes(buf)
    v0 = values[0]
    if isinstance(v0, (bytes, bytearray, str)):
        inner = bytearray()
        for v in values:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_varint(inner, _tag(1, _WIRE_LEN))
            _write_varint(inner, len(v))
            inner += v
        _write_varint(buf, _tag(1, _WIRE_LEN))
    elif all(isinstance(v, numbers.Integral) for v in values):
        # every value must be integral (not just values[0]): a mixed list
        # like [0, 0.5] belongs in FloatList. numbers ABCs (not bare
        # int/float isinstance) so numpy scalars encode consistently.
        inner = bytearray()
        packed = bytearray()
        for v in values:
            _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)  # two's complement
        _write_varint(inner, _tag(1, _WIRE_LEN))
        _write_varint(inner, len(packed))
        inner += packed
        _write_varint(buf, _tag(3, _WIRE_LEN))
    elif isinstance(v0, numbers.Real):
        inner = bytearray()
        packed = struct.pack(f"<{len(values)}f", *(float(v) for v in values))
        _write_varint(inner, _tag(1, _WIRE_LEN))
        _write_varint(inner, len(packed))
        inner += packed
        _write_varint(buf, _tag(2, _WIRE_LEN))
    else:
        raise TypeError(f"unsupported feature value type {type(v0)}")
    _write_varint(buf, len(inner))
    buf += inner
    return bytes(buf)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize a feature dict to tf.train.Example bytes."""
    feats = bytearray()
    for key in features:  # insertion order, deterministic
        kb = key.encode("utf-8")
        fb = _encode_feature(list(features[key]))
        entry = bytearray()
        _write_varint(entry, _tag(1, _WIRE_LEN))
        _write_varint(entry, len(kb))
        entry += kb
        _write_varint(entry, _tag(2, _WIRE_LEN))
        _write_varint(entry, len(fb))
        entry += fb
        _write_varint(feats, _tag(1, _WIRE_LEN))
        _write_varint(feats, len(entry))
        feats += entry
    out = bytearray()
    _write_varint(out, _tag(1, _WIRE_LEN))
    _write_varint(out, len(feats))
    out += feats
    return bytes(out)


# -- decode ------------------------------------------------------------------

def _skip_field(data: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(data, pos)
    elif wire == _WIRE_I64:
        pos += 8
    elif wire == _WIRE_LEN:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire == _WIRE_I32:
        pos += 4
    else:
        raise ValueError(f"unknown wire type {wire}")
    return pos


def _decode_list(data: bytes, kind: int) -> List:
    """kind: 1 bytes, 2 float, 3 int64."""
    values: List = []
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1:
            pos = _skip_field(data, pos, wire)
            continue
        if kind == 1:
            n, pos = _read_varint(data, pos)
            values.append(data[pos:pos + n])
            pos += n
        elif kind == 2:
            if wire == _WIRE_LEN:  # packed
                n, pos = _read_varint(data, pos)
                values.extend(struct.unpack(f"<{n // 4}f", data[pos:pos + n]))
                pos += n
            else:  # unpacked fixed32
                values.append(struct.unpack("<f", data[pos:pos + 4])[0])
                pos += 4
        else:
            if wire == _WIRE_LEN:  # packed
                n, pos = _read_varint(data, pos)
                stop = pos + n
                while pos < stop:
                    v, pos = _read_varint(data, pos)
                    values.append(v - (1 << 64) if v >= 1 << 63 else v)
            else:
                v, pos = _read_varint(data, pos)
                values.append(v - (1 << 64) if v >= 1 << 63 else v)
    return values


def _decode_feature(data: bytes) -> List:
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field in (1, 2, 3) and wire == _WIRE_LEN:
            n, pos = _read_varint(data, pos)
            return _decode_list(data[pos:pos + n], field)
        pos = _skip_field(data, pos, wire)
    return []


def decode_example(data: bytes) -> Dict[str, List]:
    """Parse tf.train.Example bytes into {feature_name: list_of_values}."""
    features: Dict[str, List] = {}
    pos = 0
    # Example wrapper: find field 1 (Features)
    feats = b""
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:
            n, pos = _read_varint(data, pos)
            feats = data[pos:pos + n]
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    pos = 0
    while pos < len(feats):
        tag, pos = _read_varint(feats, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1 or wire != _WIRE_LEN:
            pos = _skip_field(feats, pos, wire)
            continue
        n, pos = _read_varint(feats, pos)
        entry = feats[pos:pos + n]
        pos += n
        # map entry: 1 key, 2 value
        epos = 0
        key, val = "", []
        while epos < len(entry):
            etag, epos = _read_varint(entry, epos)
            efield, ewire = etag >> 3, etag & 7
            if efield == 1 and ewire == _WIRE_LEN:
                kn, epos = _read_varint(entry, epos)
                key = entry[epos:epos + kn].decode("utf-8")
                epos += kn
            elif efield == 2 and ewire == _WIRE_LEN:
                vn, epos = _read_varint(entry, epos)
                val = _decode_feature(entry[epos:epos + vn])
                epos += vn
            else:
                epos = _skip_field(entry, epos, ewire)
        features[key] = val
    return features
