"""ctypes binding and build of the native mmap feature store (the port's
copy of `crvqa_tpu/native/feature_store.py`; same file format, so a `.bin`
written by either package is read by both).

Features live in one packed little-endian file (see `feature_store.cpp`),
mmap'd read-only and gathered by threaded memcpy. The shared library is
compiled with g++ at first use into `crvqa_tpu_torch/build/` (gitignored).
"""
from __future__ import annotations

import ctypes
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from ..ops import _build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "feature_store.cpp")
_GXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread"]


def _load_lib():
    lib = ctypes.CDLL(_build.build_library(_SRC, "libfeature_store.so", _GXX))
    lib.feature_store_open.restype = ctypes.c_void_p
    lib.feature_store_open.argtypes = [ctypes.c_char_p]
    lib.feature_store_close.argtypes = [ctypes.c_void_p]
    for f in ("num_images", "boxes", "feat_dim", "pos_dim"):
        fn = getattr(lib, f"feature_store_{f}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.feature_store_gather.restype = ctypes.c_int
    lib.feature_store_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    return lib


def build_feature_store(out_path: str, features: dict,
                        image_ids: Optional[Sequence[str]] = None) -> list[str]:
    """Pack {image_id: {'feats': [B,F], 'sp_feats': [B,P]}} (the reference's
    pickle payload) into the binary store; the image-id order goes to
    `<out>.ids.txt`. Returns that order."""
    ids = list(image_ids) if image_ids is not None else sorted(features.keys())
    first = features[ids[0]]
    boxes, feat_dim = np.asarray(first["feats"]).shape
    pos_dim = np.asarray(first["sp_feats"]).shape[1]
    with open(out_path, "wb") as f:
        np.asarray([len(ids), boxes, feat_dim, pos_dim], np.int64).tofile(f)
        for i in ids:
            np.asarray(features[i]["feats"], np.float32).tofile(f)
        for i in ids:
            np.asarray(features[i]["sp_feats"], np.float32).tofile(f)
    with open(out_path + ".ids.txt", "w") as f:
        f.write("\n".join(str(i) for i in ids))
    return ids


def convert_pickle(pickle_path: str, out_path: str) -> list[str]:
    """One-shot converter from the reference's feature pickle."""
    with open(pickle_path, "rb") as f:
        features = pickle.load(f)
    return build_feature_store(out_path, features)


class FeatureStore:
    """Drop-in for `data.vqacp.ImageFeatures` backed by the native store:
    O(1) id lookup + threaded batch gather, no per-process RAM copy."""

    def __init__(self, path: str, threads: int = 4):
        self._lib = _load_lib()
        self._handle = self._lib.feature_store_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open feature store {path}")
        self.threads = threads
        self.boxes = self._lib.feature_store_boxes(self._handle)
        self.feat_dim = self._lib.feature_store_feat_dim(self._handle)
        self.pos_dim = self._lib.feature_store_pos_dim(self._handle)
        self.num_images = self._lib.feature_store_num_images(self._handle)
        with open(path + ".ids.txt") as f:
            self._id_to_row = {line.strip(): i
                               for i, line in enumerate(f) if line.strip()}

    def lookup(self, image_ids: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        rows = np.asarray([self._id_to_row[str(i)] for i in image_ids],
                          np.int64)
        return self.gather_rows(rows)

    def ids(self) -> list:
        return list(self._id_to_row.keys())

    def __contains__(self, image_id: str) -> bool:
        return str(image_id) in self._id_to_row

    def gather_rows(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        b = len(rows)
        feats = np.empty((b, self.boxes, self.feat_dim), np.float32)
        pos = np.empty((b, self.boxes, self.pos_dim), np.float32)
        rc = self._lib.feature_store_gather(
            self._handle,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b,
            feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.threads)
        if rc != 0:
            raise IndexError("feature_store_gather: row index out of range")
        return feats, pos

    def close(self) -> None:
        if self._handle:
            self._lib.feature_store_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 3:
        print("usage: python -m crvqa_tpu_torch.native.feature_store "
              "<features.pickle> <out.bin>")
        raise SystemExit(2)
    ids = convert_pickle(sys.argv[1], sys.argv[2])
    print(f"packed {len(ids)} images -> {sys.argv[2]}")
