"""mPLUG's image transforms (the port's copy of `crvqa_tpu/data/augment.py`):
the train stack of `mPLUG/dataset/__init__.py:28-35` (RandomResizedCrop,
horizontal flip, RandomAugment(N=2, M=7) over the shipped 10-op list of
`mPLUG/dataset/randaugment.py`) and the eval transform (:37-41): bicubic
resize, /255, CLIP normalise.

Every draw goes through the caller's `np.random.Generator`, in the JAX
module's order, so the pixels are byte-identical to the JAX package's for
the same generator. A uint8 RGB image takes the native ops
(`native/augment_native.py`: the inverse warp behind rotate / shear /
translate, autocontrast, equalize, sharpness, the normalise), which raise
when the library does not build; any other dtype or layout takes the numpy
versions below, which are also the plain versions the tests hold the
native ops against. Magnitudes follow the reference's level_to_args
tables: enhance factor level/10*1.8+0.1, shear level/10*0.3, translate
level/10*10 px, rotate level/10*30 degrees, each sign-flipped with p=0.5,
each op applied with p=0.5. `FULL_AUGS` adds the reference's Solarize /
Color / Contrast / Posterize, which no shipped config selects. PIL is
imported inside the functions that take PIL images only.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

MAX_LEVEL = 10.0
TRANSLATE_CONST = 10.0
FILL = np.array([128, 128, 128], np.float32)

# the list every mPLUG train config ships (dataset/__init__.py:22-24)
SHIPPED_AUGS = ("Identity", "AutoContrast", "Equalize", "Brightness",
                "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
                "Rotate")
# the reference's whole menu (randaugment.py:func_dict)
FULL_AUGS = SHIPPED_AUGS + ("Solarize", "Color", "Contrast", "Posterize")


def _native():
    from ..native.augment_native import load

    return load()


def _u8rgb(img: np.ndarray) -> bool:
    """The native ops take uint8 [H, W, 3] only."""
    return img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == 3


# ------------------------------------------------------------- primitives

def _warp_plain(img: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """Bilinear warp out[y, x] = img[inv @ (x, y, 1)], constant fill
    outside the source."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0i = np.clip(x0, 0, w - 1).astype(np.int32)
    y0i = np.clip(y0, 0, h - 1).astype(np.int32)
    x1i = np.clip(x0i + 1, 0, w - 1)
    y1i = np.clip(y0i + 1, 0, h - 1)
    f = img.astype(np.float32)
    out = (f[y0i, x0i] * (1 - fx) * (1 - fy) + f[y0i, x1i] * fx * (1 - fy)
           + f[y1i, x0i] * (1 - fx) * fy + f[y1i, x1i] * fx * fy)
    out = np.where(valid[..., None], out, FILL)
    return np.clip(out, 0, 255).astype(img.dtype)


def _affine_inverse_warp(img: np.ndarray, inv: np.ndarray) -> np.ndarray:
    if _u8rgb(img):
        return _native().warp(img, np.asarray(inv, np.float32),
                              float(FILL[0]))
    return _warp_plain(img, inv)


def identity(img: np.ndarray) -> np.ndarray:
    return img


def _autocontrast_plain(img: np.ndarray) -> np.ndarray:
    f = img.astype(np.float32)
    lo = f.reshape(-1, 3).min(axis=0)
    hi = f.reshape(-1, 3).max(axis=0)
    scale = np.where(hi > lo, 255.0 / np.maximum(hi - lo, 1e-6), 1.0)
    off = np.where(hi > lo, lo, 0.0)
    return np.clip((f - off) * scale, 0, 255).astype(img.dtype)


def autocontrast(img: np.ndarray) -> np.ndarray:
    """Per-channel min/max stretch to the full [0, 255] range."""
    if _u8rgb(img):
        return _native().autocontrast(img)
    return _autocontrast_plain(img)


def _equalize_plain(img: np.ndarray) -> np.ndarray:
    out = img.copy()
    for c in range(3):
        ch = img[..., c]
        histo = np.bincount(ch.ravel(), minlength=256)
        nonzero = histo[histo != 0]
        if nonzero.size <= 1:
            continue
        step = (histo.sum() - nonzero[-1]) // 255
        if step == 0:
            continue
        cum = np.concatenate([[0], np.cumsum(histo)[:-1]])
        lut = np.minimum((cum + step // 2) // step, 255).astype(img.dtype)
        out[..., c] = lut[ch]
    return out


def equalize(img: np.ndarray) -> np.ndarray:
    """PIL-style per-channel histogram equalisation."""
    if _u8rgb(img):
        return _native().equalize(img)
    return _equalize_plain(img)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend toward black (PIL ImageEnhance.Brightness)."""
    return np.clip(img.astype(np.float32) * factor, 0, 255).astype(img.dtype)


def _smooth3x3(img: np.ndarray) -> np.ndarray:
    """PIL's 3x3 smoothing kernel [[1,1,1],[1,5,1],[1,1,1]]/13, reflect-101
    borders, rounded to uint8 like cv2.filter2D."""
    f = img.astype(np.float32)
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    pad = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="reflect")
    smooth = np.zeros_like(f)
    for dy in range(3):
        for dx in range(3):
            smooth += k[dy, dx] * pad[dy:dy + f.shape[0], dx:dx + f.shape[1]]
    return np.clip(np.rint(smooth), 0, 255).astype(np.uint8)


def _sharpness_plain(img: np.ndarray, factor: float) -> np.ndarray:
    smooth = _smooth3x3(img)
    if factor == 0.0:
        return smooth
    out = img.astype(np.float32)
    deg = smooth.astype(np.float32)[1:-1, 1:-1]
    out[1:-1, 1:-1] = deg + factor * (out[1:-1, 1:-1] - deg)
    # no clip: the reference casts the raw float to uint8
    # (sharpness_func:148), wrapping over- and undershoot around 256
    return out.astype(np.uint8)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend between a 3x3-smoothed copy and the original on the interior
    only; the 1-px border keeps the original pixels (the reference's
    sharpness_func, randaugment.py:131-149)."""
    if factor == 1.0:
        return img
    if _u8rgb(img) and img.shape[0] >= 3 and img.shape[1] >= 3:
        return _native().sharpness(img, float(factor))
    return _sharpness_plain(img, factor)


def solarize(img: np.ndarray, thresh: int = 128) -> np.ndarray:
    """Invert pixels >= thresh (PIL ImageOps.solarize)."""
    lut = np.arange(256)
    lut = np.where(lut < thresh, lut, 255 - lut).clip(0, 255).astype(np.uint8)
    return lut[img]


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """Keep the top `bits` bits per channel (the shift masked to 8 bits)."""
    return np.bitwise_and(img, np.uint8((255 << (8 - bits)) & 0xFF))


# PIL's ITU-R 601-2 luma weights in the BGR order the reference's cv2-based
# functions assume; the pipeline feeds RGB, so channel 0 gets the blue
# weight, as in the reference
_LUMA_BGR = np.array([0.114, 0.587, 0.299], np.float32)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend toward the per-pixel luma gray (PIL ImageEnhance.Color), in
    color_func's fused-matrix form x @ ((I - 1*w^T)*factor + 1*w^T)."""
    m = ((np.eye(3, dtype=np.float32) - _LUMA_BGR[:, None]) * factor
         + _LUMA_BGR[:, None])
    return np.matmul(img, m).clip(0, 255).astype(img.dtype)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend toward the global mean luma (PIL ImageEnhance.Contrast), in
    contrast_func's float64 LUT form."""
    mean = float(np.sum(np.mean(img, axis=(0, 1))
                        * np.array([0.114, 0.587, 0.299], np.float64)))
    lut = ((np.arange(256, dtype=np.float64) - mean) * factor
           + mean).clip(0, 255).astype(np.uint8)
    return lut[img]


def shear_x(img: np.ndarray, mag: float) -> np.ndarray:
    """Forward shear dst_x = src_x + mag*y (cv2's forward matrix)."""
    return _affine_inverse_warp(img, np.array([[1.0, -mag, 0.0],
                                               [0.0, 1.0, 0.0]], np.float32))


def shear_y(img: np.ndarray, mag: float) -> np.ndarray:
    return _affine_inverse_warp(img, np.array([[1.0, 0.0, 0.0],
                                               [-mag, 1.0, 0.0]], np.float32))


def translate_x(img: np.ndarray, px: float) -> np.ndarray:
    return _affine_inverse_warp(img, np.array([[1.0, 0.0, px],
                                               [0.0, 1.0, 0.0]], np.float32))


def translate_y(img: np.ndarray, px: float) -> np.ndarray:
    return _affine_inverse_warp(img, np.array([[1.0, 0.0, 0.0],
                                               [0.0, 1.0, px]], np.float32))


def rotate(img: np.ndarray, degrees: float) -> np.ndarray:
    """Counter-clockwise rotation about (w/2, h/2), positive degrees CCW
    (cv2.getRotationMatrix2D's convention)."""
    h, w = img.shape[:2]
    cx, cy = w / 2.0, h / 2.0
    t = np.deg2rad(degrees)
    cos, sin = np.cos(t), np.sin(t)
    inv = np.array([
        [cos, -sin, cx - cos * cx + sin * cy],
        [sin, cos, cy - sin * cx - cos * cy],
    ], np.float32)
    return _affine_inverse_warp(img, inv)


def _enhance_factor(level: float) -> float:
    return level / MAX_LEVEL * 1.8 + 0.1


def _signed(rng: np.random.Generator, mag: float) -> float:
    return mag * (-1 if rng.random() < 0.5 else 1)


# ------------------------------------------------------------ RandomAugment

def random_augment(img: np.ndarray, rng: np.random.Generator, n: int = 2,
                   m: float = 7.0,
                   augs: Sequence[str] = SHIPPED_AUGS) -> np.ndarray:
    """`n` ops drawn with replacement, each applied with p=0.5 at level `m`
    (`RandomAugment.__call__`, randaugment.py:311-334)."""
    ops = rng.choice(len(augs), size=n)
    for oi in ops:
        if rng.random() > 0.5:
            continue
        name = augs[int(oi)]
        if name == "Identity":
            img = identity(img)
        elif name == "AutoContrast":
            img = autocontrast(img)
        elif name == "Equalize":
            img = equalize(img)
        elif name == "Brightness":
            img = brightness(img, _enhance_factor(m))
        elif name == "Sharpness":
            img = sharpness(img, _enhance_factor(m))
        elif name == "ShearX":
            img = shear_x(img, _signed(rng, m / MAX_LEVEL * 0.3))
        elif name == "ShearY":
            img = shear_y(img, _signed(rng, m / MAX_LEVEL * 0.3))
        elif name == "TranslateX":
            img = translate_x(img, _signed(rng, m / MAX_LEVEL
                                           * TRANSLATE_CONST))
        elif name == "TranslateY":
            img = translate_y(img, _signed(rng, m / MAX_LEVEL
                                           * TRANSLATE_CONST))
        elif name == "Rotate":
            img = rotate(img, _signed(rng, m / MAX_LEVEL * 30.0))
        elif name == "Solarize":
            img = solarize(img, int(m / MAX_LEVEL * 256))
        elif name == "Color":
            img = color(img, _enhance_factor(m))
        elif name == "Contrast":
            img = contrast(img, _enhance_factor(m))
        elif name == "Posterize":
            img = posterize(img, int(m / MAX_LEVEL * 4))
        else:
            raise ValueError(f"unknown aug {name!r}")
    return img


# ---------------------------------------------------------------- pipelines

def random_resized_crop(img, rng: np.random.Generator, size: int,
                        scale: tuple[float, float] = (0.5, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop (10 attempts, then a centre crop at
    the clamped aspect ratio), bicubic resize by PIL. Takes and returns a
    PIL image."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = float(np.exp(log_r))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            box = (x, y, x + cw, y + ch)
            break
    else:
        ar = min(max(w / h, ratio[0]), ratio[1])
        cw = min(w, int(round(h * ar)))
        ch = min(h, int(round(cw / ar)))
        x, y = (w - cw) // 2, (h - ch) // 2
        box = (x, y, x + cw, y + ch)
    return img.resize((size, size), Image.BICUBIC, box=box)


def train_transform(img, rng: np.random.Generator, image_res: int,
                    n: int = 2, m: float = 7.0,
                    raw: bool = False) -> np.ndarray:
    """RandomResizedCrop(scale 0.5-1.0) -> HFlip(0.5) -> RandomAugment(2, 7)
    -> /255 -> CLIP normalise, float32 [H, W, 3] from a PIL image.
    `raw=True` returns the augmented uint8 pixels instead (the
    device-normalise path: every op is uint8 to uint8)."""
    img = random_resized_crop(img, rng, image_res)
    arr = np.asarray(img, np.uint8)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    arr = random_augment(np.ascontiguousarray(arr), rng, n=n, m=m)
    return np.ascontiguousarray(arr) if raw else _normalize_u8(arr)


def test_transform(img, image_res: int, raw: bool = False) -> np.ndarray:
    """Resize (bicubic) -> /255 -> normalise. `img` is a PIL image;
    `raw=True` returns the resized uint8 pixels for the device-normalise
    path (`models/mplug/vit.clip_normalize_u8`)."""
    from PIL import Image

    arr = np.asarray(img.resize((image_res, image_res), Image.BICUBIC))
    if raw:
        return np.ascontiguousarray(arr.astype(np.uint8, copy=False))
    return _normalize_u8(arr)


def _normalize_plain(arr: np.ndarray) -> np.ndarray:
    return ((arr.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD


def _normalize_u8(arr: np.ndarray) -> np.ndarray:
    """((arr / 255) - CLIP_MEAN) / CLIP_STD -> float32 [H, W, 3]."""
    if _u8rgb(arr):
        return _native().normalize(np.ascontiguousarray(arr), CLIP_MEAN,
                                   CLIP_STD)
    return _normalize_plain(arr)
