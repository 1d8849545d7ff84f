"""The port's train-time image transforms (crvqa_tpu_torch/data/augment.py,
native/augment.{cpp,py}) and the augmented mPLUG loaders against the JAX
package's on seeded images: every op of `FULL_AUGS`, `random_augment`,
`random_resized_crop`, `train_transform` (raw and normalised),
`load_images` with 0 and 3 workers and `iterate_batches(augment=True)`
are byte-identical. The native ops agree byte for byte with their numpy
versions (the plain versions), a failed native build raises, and
non-uint8 images take the numpy versions.
"""
import numpy as np
import pytest
from PIL import Image

from crvqa_tpu.data import augment as jaug
from crvqa_tpu.data import mplug_data as jdata
from crvqa_tpu.data.tokenization import WordPieceTokenizer as JTok
from crvqa_tpu_torch.data import augment as taug
from crvqa_tpu_torch.data import mplug_data as tdata
from crvqa_tpu_torch.data.tokenization import WordPieceTokenizer
from crvqa_tpu_torch.native import augment_native
from tests.test_dress_rehearsal_mplug import _fabricate


def _img(seed, h=40, w=52):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", taug.FULL_AUGS)
def test_each_op_is_byte_identical(name):
    """Each op alone at levels 3, 7 and 10, both signs (seeds), through
    `random_augment` (its draws: op, p=0.5, sign), on an image whose
    range autocontrast stretches."""
    img = (_img(0) * 0.7 + 20).astype(np.uint8)
    applied = 0
    for m in (3.0, 7.0, 10.0):
        for seed in range(8):
            want = jaug.random_augment(img, np.random.default_rng(seed),
                                       n=1, m=m, augs=(name,))
            got = taug.random_augment(img, np.random.default_rng(seed),
                                      n=1, m=m, augs=(name,))
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            applied += not np.array_equal(got, img)
    assert (applied > 0) == (name != "Identity")


@pytest.mark.parametrize("augs", ["shipped", "full"])
def test_random_augment_is_byte_identical(augs):
    ops = taug.SHIPPED_AUGS if augs == "shipped" else taug.FULL_AUGS
    assert ops == (jaug.SHIPPED_AUGS if augs == "shipped"
                   else jaug.FULL_AUGS)
    for seed in range(24):
        img = _img(seed, 33, 31)
        want = jaug.random_augment(img, np.random.default_rng(seed),
                                   augs=ops)
        got = taug.random_augment(img, np.random.default_rng(seed),
                                  augs=ops)
        np.testing.assert_array_equal(got, want)


def test_random_resized_crop_and_train_transform():
    """The crop's draws (10 attempts, the centre fallback at an extreme
    aspect), the flip, RandomAugment(2, 7), raw uint8 and normalised
    fp32; the generators end in the same state."""
    for seed in range(12):
        pil = Image.fromarray(_img(seed, 50, 60 if seed % 4 else 400))
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = np.asarray(jaug.random_resized_crop(pil, rj, 24))
        got = np.asarray(taug.random_resized_crop(pil, rt, 24))
        np.testing.assert_array_equal(got, want)
        for raw in (True, False):
            want = jaug.train_transform(pil, rj, 32, raw=raw)
            got = taug.train_transform(pil, rt, 32, raw=raw)
            assert got.dtype == want.dtype == (np.uint8 if raw
                                               else np.float32)
            assert got.shape == (32, 32, 3)
            np.testing.assert_array_equal(got, want)
        assert rj.random() == rt.random()


def test_native_ops_equal_their_numpy_versions():
    img = _img(3, 37, 45)
    inv = np.array([[0.93, 0.21, -4.5], [-0.17, 1.08, 3.25]], np.float32)
    np.testing.assert_array_equal(taug._affine_inverse_warp(img, inv),
                                  taug._warp_plain(img, inv))
    np.testing.assert_array_equal(taug.autocontrast(img),
                                  taug._autocontrast_plain(img))
    np.testing.assert_array_equal(taug.equalize(img),
                                  taug._equalize_plain(img))
    for factor in (0.0, 0.5, 1.9, 3.0):  # 3.0 over- and undershoots
        np.testing.assert_array_equal(taug.sharpness(img, factor),
                                      taug._sharpness_plain(img, factor))
    np.testing.assert_array_equal(taug._normalize_u8(img),
                                  taug._normalize_plain(img))
    flat = np.full((8, 9, 3), 77, np.uint8)  # one value: identity paths
    np.testing.assert_array_equal(taug.autocontrast(flat), flat)
    np.testing.assert_array_equal(taug.equalize(flat), flat)


def test_non_uint8_images_take_the_numpy_versions():
    """Float and single-channel images never reach the native ops; their
    values equal the JAX package's."""
    f = _img(4).astype(np.float32)
    inv = np.array([[1.0, 0.1, 2.0], [0.0, 1.0, -1.0]], np.float32)
    np.testing.assert_array_equal(taug._affine_inverse_warp(f, inv),
                                  jaug._affine_inverse_warp(f, inv))
    np.testing.assert_array_equal(taug.autocontrast(f), jaug.autocontrast(f))
    np.testing.assert_array_equal(taug._normalize_u8(f),
                                  jaug._normalize_u8(f))
    gray = _img(5)[..., :1].copy()
    np.testing.assert_array_equal(taug.rotate(gray, 12.0),
                                  jaug.rotate(gray, 12.0))


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No numpy fallback on a uint8 RGB image: the build's error
    surfaces."""
    bad = tmp_path / "augment.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(augment_native, "_SRC", str(bad))
    monkeypatch.setattr(augment_native, "_LIB_NAME",
                        "libaugment_broken_test.so")
    monkeypatch.setattr(augment_native, "_cached", None)
    with pytest.raises(RuntimeError, match="libaugment_broken_test.so"):
        taug.autocontrast(_img(6))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    _fabricate(root)
    return root


@pytest.mark.parametrize("raw", [True, False])
def test_load_images_is_byte_identical_at_any_width(root, raw):
    """One spawned generator per image: 0 and 3 workers give the JAX
    package's pixels (and each other's)."""
    paths = [str(p) for p in sorted((root / "imgs").iterdir())] * 2
    want = jdata.load_images(paths, 32, rng=np.random.default_rng(9),
                             raw=raw)
    for workers in (0, 3):
        got = tdata.load_images(paths, 32, rng=np.random.default_rng(9),
                                workers=workers, raw=raw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want[0], want[4])  # same file, other draws


def test_iterate_batches_with_augment_is_byte_identical(root):
    vocab = str(root / "vocab.txt")
    kw = dict(q_len=12, a_len=6, answers_per_question=2, vqa_root=str(root))
    want_e = jdata.load_entries([str(root / "vqa_train.json")], JTok(vocab),
                                **kw)
    got_e = tdata.load_entries([str(root / "vqa_train.json")],
                               WordPieceTokenizer(vocab), **kw)
    bkw = dict(shuffle=True, seed=4, drop_last=True, augment=True,
               raw_images=True)
    want = list(jdata.iterate_batches(want_e, 4, 32, workers=2, **bkw))
    got = list(tdata.iterate_batches(got_e, 4, 32, workers=3, **bkw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
    plain = next(iter(tdata.iterate_batches(got_e, 4, 32, shuffle=True,
                                            seed=4, raw_images=True)))
    assert not np.array_equal(plain["images"], got[0]["images"])


def test_concurrent_first_calls_build_once(tmp_path, monkeypatch):
    """The library is first touched from load_images' worker threads: 16
    threads (more than this machine's cores), a short switch interval,
    all calling the ops at once on a library not yet built. g++ runs
    once, every thread gets the same library, every result is right."""
    import os
    import subprocess
    import sys
    import threading

    from crvqa_tpu_torch.ops import _build

    name = f"libaugment_stress_{os.getpid()}.so"
    monkeypatch.setattr(augment_native, "_LIB_NAME", name)
    monkeypatch.setattr(augment_native, "_cached", None)
    runs = []
    real_run = subprocess.run

    def counted(*a, **kw):
        runs.append(a[0][0])
        return real_run(*a, **kw)

    monkeypatch.setattr(_build.subprocess, "run", counted)
    img = _img(7)
    want = taug._autocontrast_plain(img)
    results, errors = [], []
    start = threading.Barrier(16)

    def worker():
        try:
            start.wait(timeout=60)
            results.append(taug.autocontrast(img))
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        for suffix in ("", ".log"):
            path = os.path.join(_build.BUILD_DIR, name + suffix)
            if os.path.exists(path):
                os.unlink(path)
    assert not any(t.is_alive() for t in threads) and not errors
    assert runs == ["g++"] and len(results) == 16
    for r in results:
        np.testing.assert_array_equal(r, want)
