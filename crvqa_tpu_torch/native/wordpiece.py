"""ctypes binding and build of the native WordPiece encoder (the port's
copy of `crvqa_tpu/native/wordpiece.py`, over `wordpiece.cpp`).

The bulk host-side tokenization path: the ASCII subset of the BERT
algorithm runs in C++ (nearly every VQA question); a row holding any
non-ASCII byte (or a NUL) comes back as None and the caller's Python
tokenizer encodes it (NFD accent stripping, CJK isolation, unicode
categories): that split is the algorithm, not a fallback. The library is
compiled with g++ at first use into `crvqa_tpu_torch/build/` (gitignored)
through `ops._build.build_library`; a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from ..ops import _build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "wordpiece.cpp")
_LIB_NAME = "libwordpiece.so"
_GXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (when stale) and load the library, once per process; raises
    when it does not build."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                lib = ctypes.CDLL(_build.build_library(_SRC, _LIB_NAME,
                                                       _GXX))
                lib.wp_create.restype = ctypes.c_void_p
                lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_int]
                lib.wp_destroy.argtypes = [ctypes.c_void_p]
                lib.wp_encode_batch.restype = ctypes.c_long
                lib.wp_encode_batch.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_long, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_long)]
                _lib = lib
    return _lib


def dense_ids(vocab: dict) -> bool:
    """True when the vocab's ids are exactly 0..n-1, the form the C++
    vocab blob (tokens in id order) needs; a vocab.txt with a repeated
    line is not."""
    return sorted(vocab.values()) == list(range(len(vocab)))


class NativeWordPiece:
    """A native vocab handle; `encode_batch` returns each text's raw
    wordpiece ids (no specials added), None for the rows the Python
    tokenizer encodes."""

    def __init__(self, vocab: dict, specials: Sequence[str], unk_id: int):
        if not dense_ids(vocab):
            raise ValueError("the native encoder needs vocab ids 0..n-1")
        lib = load()
        items = sorted(vocab.items(), key=lambda kv: kv[1])
        blob = "\n".join(t for t, _ in items).encode("utf-8")
        sblob = "\n".join(specials).encode("utf-8")
        self._lib = lib
        self._h = lib.wp_create(blob, sblob, unk_id)
        if not self._h:
            raise RuntimeError("wp_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wp_destroy(h)
            self._h = None

    def encode_batch(self, texts: Sequence[str], cap: int = 512
                     ) -> list[Optional[list[int]]]:
        n = len(texts)
        if n == 0:
            return []
        enc = [t.encode("utf-8", errors="surrogatepass") for t in texts]
        # an embedded NUL would end the C string where Python drops the
        # character: such rows go to the Python tokenizer
        nul = [b"\x00" in e for e in enc]
        arr = (ctypes.c_char_p * n)(
            *[b"" if bad else e for e, bad in zip(enc, nul)])
        out_ids = np.empty((n, cap), np.int32)
        out_lens = np.empty((n,), np.int64)
        self._lib.wp_encode_batch(
            self._h, arr, n, cap,
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
        return [out_ids[i, : out_lens[i]].tolist()
                if out_lens[i] >= 0 and not nul[i] else None
                for i in range(n)]
