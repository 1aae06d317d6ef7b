"""Minimal pure-python TFRecord + tf.Example reader and writer: the port's
own copy of the JAX package's ``utils/tfrecord.py`` (held equal, definition
for definition, by ``tests/test_torch_port_imports.py``), for the MM-WHS
preparation (``prep/prepare_mmwhs.py``).

The reference decodes the PnP-AdaNet release with TF1 eager
(``src/utils/tf_to_numpy.py:9-37``: features ``data_vol``/``label_vol`` as
raw little-endian float32 bytes). TensorFlow is not needed: this implements
the two formats directly:

- TFRecord framing: [length: uint64le][masked crc32c of length: uint32le]
  [data][masked crc32c of data: uint32le] per record (CRCs are not verified
  — the reference's TF path doesn't surface them either; the writer puts
  zlib's CRC-32 in their place, which only this reader accepts);
- protobuf wire walk of Example -> Features -> map<string, Feature> ->
  BytesList/FloatList/Int64List.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _walk_fields(buf: bytes) -> Iterator[tuple]:
    """Yields (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes) -> FeatureValue:
    for field, _, val in _walk_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _walk_fields(val) if f == 1]
        if field == 2:  # FloatList (packed or repeated)
            floats: List[float] = []
            for f, wire, v in _walk_fields(val):
                if f == 1:
                    if wire == 2:
                        floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                    else:
                        floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:  # Int64List
            ints: List[int] = []
            for f, wire, v in _walk_fields(val):
                if f == 1:
                    if wire == 2:
                        pos = 0
                        while pos < len(v):
                            x, pos = _read_varint(v, pos)
                            ints.append(x)
                    else:
                        ints.append(v)
            return ints
    return []


def parse_example(buf: bytes) -> Dict[str, FeatureValue]:
    """Serialized tf.train.Example -> {feature_name: value_list}."""
    out: Dict[str, FeatureValue] = {}
    for field, _, features_buf in _walk_fields(buf):
        if field != 1:  # Example.features
            continue
        for f, _, entry in _walk_fields(features_buf):
            if f != 1:  # Features.feature map entry
                continue
            key = None
            feat: FeatureValue = []
            for ef, _, ev in _walk_fields(entry):
                if ef == 1:
                    key = ev.decode("utf-8")
                elif ef == 2:
                    feat = _parse_feature(ev)
            if key is not None:
                out[key] = feat
    return out


def read_tfrecord(path: str) -> Iterator[bytes]:
    """Yields raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"truncated record in {path}")
            f.read(4)  # data crc
            yield data


def read_examples(path: str) -> Iterator[Dict[str, FeatureValue]]:
    for rec in read_tfrecord(path):
        yield parse_example(rec)


def write_example(features: Dict[str, bytes]) -> bytes:
    """Serialize a {name: raw_bytes} dict as a tf.Example (BytesList) —
    used by tests and by dataset repackaging."""

    def varint(x: int) -> bytes:
        out = b""
        while True:
            b7 = x & 0x7F
            x >>= 7
            if x:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def ld(field: int, payload: bytes) -> bytes:
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    entries = b""
    for name, raw in features.items():
        bytes_list = ld(1, raw)
        feature = ld(1, bytes_list)
        entry = ld(1, name.encode()) + ld(2, feature)
        entries += ld(1, entry)
    return ld(1, entries)


def write_tfrecord(path: str, records) -> None:
    import zlib  # placeholder crc (masked crc32c not verified by our reader)

    with open(path, "wb") as f:
        for rec in records:
            f.write(struct.pack("<Q", len(rec)))
            f.write(struct.pack("<I", zlib.crc32(rec) & 0xFFFFFFFF))
            f.write(rec)
            f.write(struct.pack("<I", zlib.crc32(rec) & 0xFFFFFFFF))
