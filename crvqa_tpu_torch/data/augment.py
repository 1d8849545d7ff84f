"""The eval image transform of mPLUG (the port's copy of what it needs from
`crvqa_tpu/data/augment.py`): bicubic resize, /255, CLIP normalise
(`mPLUG/dataset/__init__.py:37-41`). PIL is imported inside
`test_transform` only. The train-time transforms (`--augment true`) are not
ported yet: `mplug_data.iterate_batches` raises for them."""
from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _normalize_u8(arr: np.ndarray) -> np.ndarray:
    """((arr / 255) - CLIP_MEAN) / CLIP_STD -> float32 [H, W, 3]."""
    return ((arr.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD


def test_transform(img, image_res: int, raw: bool = False) -> np.ndarray:
    """Resize (bicubic) -> /255 -> normalise. `img` is a PIL image;
    `raw=True` returns the resized uint8 pixels for the device-normalise
    path (`models/mplug/vit.clip_normalize_u8`)."""
    from PIL import Image

    arr = np.asarray(img.resize((image_res, image_res), Image.BICUBIC))
    if raw:
        return np.ascontiguousarray(arr.astype(np.uint8, copy=False))
    return _normalize_u8(arr)
