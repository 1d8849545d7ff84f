"""ctypes binding and build of the native augmentation ops (the port's copy
of `crvqa_tpu/native/augment_native.py`): the bilinear inverse warp behind
rotate / shear / translate, autocontrast, equalize, sharpness and the CLIP
normalize, each byte-identical to its numpy version in `data/augment.py`.

The library is compiled with g++ at first use into `crvqa_tpu_torch/build/`
(gitignored) through `ops._build.build_library`. Bit-exact fp32 parity with
numpy needs no FMA contraction (`-ffp-contract=off`) and strict IEEE order
(no `-ffast-math`). The first call usually comes from `load_images`' worker
threads at once: `build_library` builds one library under its own lock, and
the load below takes a second one, so they compile and load it once. A
failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops import _build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "augment.cpp")
_LIB_NAME = "libaugment.so"
_GXX = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
        "-fPIC", "-std=c++17"]

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _rgb(img: np.ndarray) -> np.ndarray:
    """`img` as a contiguous uint8 [H, W, 3] array; any other shape raises
    (the C loops read three channels a pixel)."""
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"native augment ops take [H, W, 3] images, got "
                         f"{img.shape}")
    return np.ascontiguousarray(img, np.uint8)


class _Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        i64 = ctypes.c_int64
        lib.affine_inverse_warp_u8.restype = ctypes.c_int
        lib.affine_inverse_warp_u8.argtypes = [_u8p, i64, i64, i64, _f32p,
                                               _u8p, ctypes.c_float]
        lib.normalize_u8.restype = ctypes.c_int
        lib.normalize_u8.argtypes = [_u8p, i64, _f32p, _f32p, _f32p]
        for name in ("autocontrast_u8", "equalize_u8"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [_u8p, i64, _u8p]
        lib.sharpness_u8.restype = ctypes.c_int
        lib.sharpness_u8.argtypes = [_u8p, i64, i64, ctypes.c_float, _u8p]

    def warp(self, img: np.ndarray, inv: np.ndarray,
             fill: float) -> np.ndarray:
        img = _rgb(img)
        h, w, c = img.shape
        inv6 = np.ascontiguousarray(inv, np.float32).reshape(6)
        out = np.empty_like(img)
        if self._lib.affine_inverse_warp_u8(
                _ptr(img, _u8p), h, w, c, _ptr(inv6, _f32p),
                _ptr(out, _u8p), ctypes.c_float(fill)) != 0:
            raise ValueError("affine_inverse_warp_u8 failed")
        return out

    def _chanop(self, name: str, img: np.ndarray) -> np.ndarray:
        img = _rgb(img)
        h, w, _ = img.shape
        out = np.empty_like(img)
        if getattr(self._lib, name)(_ptr(img, _u8p), h * w,
                                    _ptr(out, _u8p)) != 0:
            raise ValueError(f"{name} failed")
        return out

    def autocontrast(self, img: np.ndarray) -> np.ndarray:
        return self._chanop("autocontrast_u8", img)

    def equalize(self, img: np.ndarray) -> np.ndarray:
        return self._chanop("equalize_u8", img)

    def sharpness(self, img: np.ndarray, factor: float) -> np.ndarray:
        img = _rgb(img)
        h, w, _ = img.shape
        out = np.empty_like(img)
        if self._lib.sharpness_u8(_ptr(img, _u8p), h, w,
                                  ctypes.c_float(factor),
                                  _ptr(out, _u8p)) != 0:
            raise ValueError("sharpness_u8 failed")
        return out

    def normalize(self, img: np.ndarray, mean: np.ndarray,
                  std: np.ndarray) -> np.ndarray:
        img = _rgb(img)
        h, w, _ = img.shape
        out = np.empty((h, w, 3), np.float32)
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        self._lib.normalize_u8(_ptr(img, _u8p), h * w, _ptr(mean, _f32p),
                               _ptr(std, _f32p), _ptr(out, _f32p))
        return out


_cached: _Native | None = None
_load_lock = threading.Lock()


def load() -> _Native:
    """Build (when stale) and load the library, once per process; raises
    when it does not build."""
    global _cached
    if _cached is None:
        with _load_lock:
            if _cached is None:
                _cached = _Native(ctypes.CDLL(
                    _build.build_library(_SRC, _LIB_NAME, _GXX)))
    return _cached
