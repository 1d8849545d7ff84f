"""TensorBoard event files of scalars, standard library only (counterpart
of `crvqa_tpu/utils/tb_events.py`; the reference logs through
`torch.utils.tensorboard.SummaryWriter`, mask_trainer_Robust_VQA.py:51-65,
273-276, 785-799).

The Event / Summary protobufs and the TFRecord framing (length + masked
CRC32C) are encoded by hand, so a file needs neither tensorboard nor
tensorflow and is byte-identical to the JAX package's for the same scalars
and wall times. `read_scalars` reads that framing back, checking both CRCs.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE: list = []


def _crc_table() -> list:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reversed
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, tag: str, value: float
                  ) -> bytes:
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    val = _bytes(1, tag.encode()) + _float(2, float(value))
    summary = _bytes(1, val)  # Summary { repeated Value value = 1 }
    # Event { wall_time = 1 (double); step = 2 (int64); summary = 5 }
    return _double(1, wall_time) + _int64(2, int(step)) + _bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1; file_version = 3 (string) }
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBEventWriter:
    """`add_scalar(tag, value, step)` into an
    `events.out.tfevents.<time>.<host>.<pid>` file under `logdir`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self.path = os.path.join(logdir, fname)
        self._fh = open(self.path, "ab")
        self._fh.write(_tfrecord(_version_event(time.time())))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        if self._fh is None:
            return
        self._fh.write(_tfrecord(_scalar_event(
            wall_time if wall_time is not None else time.time(),
            step, tag, value)))

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------- reading


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes) -> list[tuple[int, object]]:
    """(field number, value) of a protobuf message: varints as ints,
    fixed64 / fixed32 as their 8 / 4 bytes, length-delimited as bytes."""
    out = []
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire} not read here")
        out.append((field, value))
    return out


def read_records(path: str) -> list[bytes]:
    """The TFRecord payloads of an event file, each header and payload
    held to its masked CRC32C."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        payload = data[i + 12:i + 12 + n]
        (pcrc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if hcrc != _masked_crc(header) or pcrc != _masked_crc(payload):
            raise ValueError(f"{path}: record at byte {i}: CRC mismatch")
        out.append(payload)
        i += 16 + n
    return out


def read_scalars(path: str) -> list[tuple[float, int, str, float]]:
    """(wall_time, step, tag, value) of every scalar in an event file, in
    file order; the version record is skipped."""
    out = []
    for payload in read_records(path):
        event = dict(_fields(payload))
        if 5 not in event:
            continue
        (wall,) = struct.unpack("<d", event[1])
        step = event.get(2, 0)
        step = step - (1 << 64) if step >= 1 << 63 else step
        for field, value in _fields(event[5]):
            if field != 1:
                continue
            val = dict(_fields(value))
            out.append((wall, step, val[1].decode(),
                        struct.unpack("<f", val[2])[0]))
    return out
