"""The MessagePack layout of the JAX package's parameter files, read and
written with the standard library and numpy (the port imports neither
`msgpack` nor flax).

The JAX package writes its checkpoints with `flax.serialization.to_bytes`
(`crvqa_tpu/core/checkpoint.py:45`), that is
`msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)` over
the tree's state dict. This module covers the subset that call emits:

- nil, bool, the int and float encodings, str (str8 included: the packer
  runs with `use_bin_type`), bin, array and map; ext as fixext 1/2/4/8/16
  and ext 8/16/32;
- ext code 1, an ndarray: a packed `(shape, dtype name, raw C-order
  bytes)`; code 2, a Python complex: a packed `(real, imag)`; code 3, a
  numpy scalar, packed as the 0-d array;
- a leaf of more than `MAX_CHUNK_SIZE` bytes, written as
  `{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": flat[:n], ...}}` and read back as one array.

The writer picks the shortest encoding everywhere, keeps each dict's
insertion order and packs Python floats as float64, as `packb` does, so a
tree read from a flax file packs back to the same bytes.

bfloat16: numpy has no such dtype here (it comes from `ml_dtypes`, which
the port does not import). A "bfloat16" leaf is read as its uint16 bits
and returned as a `torch.bfloat16` tensor; a `torch.bfloat16` tensor is
written as its uint16 bits under the name "bfloat16". A bfloat16 numpy
scalar (ext code 3) comes back as a 0-d tensor and is written back as a
0-d array. Every other leaf comes back as a numpy array (a view into the
file's buffer, no copy), a numpy scalar or a Python value; a tensor of
another dtype is written as its numpy array.
"""
from __future__ import annotations

import collections
import io
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax's MAX_CHUNK_SIZE: larger array leaves are written in chunks
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

ExtType = collections.namedtuple("ExtType", "code data")

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


# ------------------------------------------------------------------ reading

class _Reader:
    """Decodes from a buffer; `views`: bin values come back as memoryview
    slices of it (an array payload's bytes) rather than as bytes."""

    def __init__(self, buf, views: bool = False):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("msgpack: truncated data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            raw = self.take(self.unpack({0xC4: ">B", 0xC5: ">H",
                                         0xC6: ">I"}[b]))
            return raw if self.views else bytes(raw)
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[b])
        fmt = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
               0xD3: ">q"}.get(b)
        if fmt is not None:
            return self.unpack(fmt)
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H",
                                         0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return _unchunk(out) if CHUNKED in out else out

    def ext(self, n: int) -> Any:
        code = struct.unpack("b", self.take(1))[0]
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        return ExtType(code, bytes(data))


def _array_from_payload(data: memoryview):
    shape, name, raw = _Reader(data, views=True).value()
    if isinstance(name, memoryview):
        name = bytes(name).decode("ascii")
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data) -> Any:
    """Decode one object from a bytes-like buffer. Array leaves are views
    into `data` (writable when `data` is)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.mv):
        raise ValueError(f"msgpack: {len(reader.mv) - reader.pos} bytes "
                         "after the object")
    return out


def read_file(path: str) -> Any:
    """Decode a whole file, read once into one writable buffer."""
    with open(path, "rb") as f:
        buf = bytearray(f.seek(0, io.SEEK_END))
        f.seek(0)
        f.readinto(buf)
    return unpackb(buf)


# ------------------------------------------------------------------ writing

def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack("B", v)
    if -0x20 <= v < 0:
        return struct.pack("b", v)
    if 0 <= v <= 0xFF:
        return struct.pack("BB", 0xCC, v)
    if -0x80 <= v < 0:
        return struct.pack(">Bb", 0xD0, v)
    if 0 <= v <= 0xFFFF:
        return struct.pack(">BH", 0xCD, v)
    if -0x8000 <= v < 0:
        return struct.pack(">Bh", 0xD1, v)
    if 0 <= v <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, v)
    if -0x80000000 <= v < 0:
        return struct.pack(">Bi", 0xD2, v)
    if 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, v)
    if -0x8000000000000000 <= v < 0:
        return struct.pack(">Bq", 0xD3, v)
    raise OverflowError(f"msgpack: integer {v} out of range")


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str / array / map of `n` items: the fix form when
    `fix` is given and n <= fix_max, else the smallest of `codes`
    ((code, struct format, limit), ...)."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    for code, fmt, limit in codes:
        if n <= limit:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"msgpack: {n} is too long")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARRAY = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xA0, 31, _STR) + raw


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        head = struct.pack("B", _FIXEXT[n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack("b", code)


def _as_array(x) -> tuple[np.ndarray, str]:
    """(a C-contiguous numpy array of the leaf's bytes, its dtype name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = t.numpy()
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:  # ascontiguousarray would make 0-d 1-d
        arr = arr.copy(order="C")
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"msgpack: dtype {arr.dtype} cannot be written")
    return arr, arr.dtype.name


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's `_chunk`: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(x, torch.Tensor) else flat.size
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


class _Writer:
    """Streams the encoding to `out` (anything with `write`): small items
    are gathered in a buffer, array bytes are written as they are."""

    def __init__(self, out: BinaryIO):
        self.out = out
        self.buf = bytearray()

    def put(self, b) -> None:
        self.buf += b
        if len(self.buf) >= 1 << 16:
            self.flush()

    def flush(self) -> None:
        if self.buf:
            self.out.write(self.buf)
            self.buf = bytearray()

    def array(self, x, code: int) -> None:
        arr, name = _as_array(x)
        head = (_sized(3, 0x90, 15, _ARRAY)
                + _sized(arr.ndim, 0x90, 15, _ARRAY)
                + b"".join(_int(int(d)) for d in arr.shape) + _str(name)
                + _sized(arr.nbytes, None, 0, _BIN))
        self.put(_ext_header(code, len(head) + arr.nbytes) + head)
        if arr.nbytes < 1 << 16:
            self.put(arr.reshape(-1).view(np.uint8).tobytes())
        else:
            self.flush()
            self.out.write(memoryview(arr.reshape(-1).view(np.uint8)))

    def value(self, v) -> None:
        if v is None:
            self.put(b"\xc0")
        elif v is True or v is False:
            self.put(b"\xc3" if v else b"\xc2")
        elif type(v) is int:
            self.put(_int(v))
        elif type(v) is float:
            self.put(struct.pack(">Bd", 0xCB, v))
        elif type(v) is str:
            self.put(_str(v))
        elif type(v) in (bytes, bytearray, memoryview):
            raw = bytes(v)
            self.put(_sized(len(raw), None, 0, _BIN) + raw)
        elif type(v) is dict:
            self.put(_sized(len(v), 0x80, 15, _MAP))
            for key, item in v.items():
                self.value(key)
                self.value(_chunk(item) if _is_array(item)
                           and _nbytes(item) > MAX_CHUNK_SIZE else item)
        elif type(v) is list:
            self.put(_sized(len(v), 0x90, 15, _ARRAY))
            for item in v:
                self.value(item)
        elif _is_array(v):
            self.array(v, EXT_NDARRAY)
        elif isinstance(v, np.generic):
            self.array(np.asarray(v), EXT_NPSCALAR)
        elif type(v) is complex:
            payload = (b"\x92" + struct.pack(">Bd", 0xCB, v.real)
                       + struct.pack(">Bd", 0xCB, v.imag))
            self.put(_ext_header(EXT_COMPLEX, len(payload)) + payload)
        elif isinstance(v, ExtType):
            self.put(_ext_header(v.code, len(v.data)) + bytes(v.data))
        else:
            raise TypeError(f"msgpack: cannot write {type(v).__name__} "
                            "(flax turns tuples and lists into dicts "
                            "before packing)")


def pack(tree, out: BinaryIO) -> None:
    """Write `tree` to `out` as flax's `to_bytes` would (a top-level array
    of more than MAX_CHUNK_SIZE bytes is chunked too)."""
    w = _Writer(out)
    w.value(_chunk(tree) if _is_array(tree)
            and _nbytes(tree) > MAX_CHUNK_SIZE else tree)
    w.flush()


def packb(tree) -> bytes:
    out = io.BytesIO()
    pack(tree, out)
    return out.getvalue()
