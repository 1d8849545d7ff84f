"""The port's msgpack codec (`crvqa_tpu_torch.core.msgpack`, behind
`core.checkpoint.save_msgpack` / `load_msgpack`) against flax's
`serialization.to_bytes` / `from_bytes`, the JAX package's checkpoint
format. Exact: same dtypes, same bits, same bytes.

The tree hits every encoding flax emits: fixint (positive and negative),
uint / int 8-64, float64, fixstr / str8 / str16, nil, bool, fixmap, map16,
fixarray in the ndarray payloads, fixext 1/2/4/8/16 and ext 8/16/32, the
ndarray, numpy-scalar and complex ext codes, and chunked leaves.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from crvqa_tpu_torch.core import checkpoint as tckpt
from crvqa_tpu_torch.core import msgpack as tmsgpack


def _tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f16": rng.standard_normal(5).astype(np.float16),
        "bf16": jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16),
        "i32": np.arange(-3, 4, dtype=np.int32),
        "i64": np.array([-2 ** 40, 5, 2 ** 62]),
        "u8": rng.integers(0, 256, 300).astype(np.uint8),
        "bool": rng.random(7) > 0.5,
        "zero_d": np.array(3.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        # a float32 0-d payload is exactly 16 bytes: fixext 16 (an ndarray
        # payload's header makes 1, 2, 4 and 8 impossible here; those are
        # covered by test_ext_lengths below); the rest take ext 8 / 16 / 32
        "one_byte": np.array([7], np.uint8),
        "np_f32": np.float32(1.25), "np_i64": np.int64(-7),
        "np_bool": np.bool_(True), "np_f16": np.float16(0.5),
        "complex": 1.5 - 2.25j,
        "ints": {str(i): v for i, v in enumerate(
            [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63])},
        "float": 0.1, "neg_float": -3e300,
        "s31": "x" * 31, "s32": "y" * 32, "s300": "z" * 300,
        "s70000": "w" * 70000, "unicode": "ÉTÉ café",
        "true": True, "false": False, "none": None,
        "tuple": (1, "a", np.float64(2.0)),
        "nested": {"a": {"b": np.arange(4, dtype=np.float32),
                         "c": {}}},
        "wide": {f"k{i}": i for i in range(20)},
        "big": rng.standard_normal(70000).astype(np.float32),
        "mid": rng.standard_normal(100).astype(np.float32),
    }


def _bits(x):
    """(dtype name, shape, raw bytes) of a leaf from either reader."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return ("bfloat16", tuple(x.shape),
                x.view(torch.int16).numpy().tobytes())
    arr = np.asarray(x)
    return (arr.dtype.name, arr.shape, arr.tobytes())


def _assert_same(got, want, path="/"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], path + k + "/")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want,
                                                                "dtype"):
        assert type(got) is type(want) or isinstance(got, torch.Tensor), \
            (path, type(got), type(want))
        assert _bits(got) == _bits(want), path
    else:
        assert type(got) is type(want) and got == want, path


def test_load_msgpack_reads_a_flax_file_bit_for_bit(tmp_path):
    tree = _tree()
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    want = serialization.msgpack_restore(path.read_bytes())
    got = tckpt.load_msgpack(str(path))
    _assert_same(got, want)
    assert isinstance(got["bf16"], torch.Tensor)
    assert got["tuple"] == {"0": 1, "1": "a", "2": np.float64(2.0)}


def test_the_writer_gives_flax_bytes_and_flax_reads_them(tmp_path):
    tree = _tree()
    flax_bytes = serialization.to_bytes(tree)
    decoded = tmsgpack.unpackb(flax_bytes)
    assert tmsgpack.packb(decoded) == flax_bytes
    path = tmp_path / "port.msgpack"
    tckpt.save_msgpack(str(path), decoded, metadata={"step": 3})
    assert path.read_bytes() == flax_bytes
    assert not (tmp_path / "port.msgpack.tmp").exists()
    assert json.loads((tmp_path / "port.msgpack.meta.json").read_text()
                      ) == {"step": 3}
    _assert_same(serialization.from_bytes(tree, path.read_bytes()),
                 serialization.from_bytes(tree, flax_bytes))


def test_chunked_leaves(tmp_path, monkeypatch):
    """A leaf over MAX_CHUNK_SIZE bytes goes in flax's chunked form, both
    ways (the limit set small for the test, on both sides)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((10, 7)).astype(np.float32),
            "bf16": jnp.asarray(rng.standard_normal(50), jnp.bfloat16),
            "small": np.arange(3, dtype=np.int64),
            "deep": {"x": rng.integers(0, 9, (3, 40)).astype(np.int32)}}
    flax_bytes = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in flax_bytes
    got = tmsgpack.unpackb(flax_bytes)
    _assert_same(got, serialization.msgpack_restore(flax_bytes))
    assert tmsgpack.packb(got) == flax_bytes
    restored = serialization.from_bytes(tree, tmsgpack.packb(got))
    np.testing.assert_array_equal(restored["big"], tree["big"])
    np.testing.assert_array_equal(restored["deep"]["x"], tree["deep"]["x"])
    # a chunked top-level array
    arr = rng.standard_normal(33).astype(np.float32)
    top = serialization.to_bytes(arr)
    np.testing.assert_array_equal(tmsgpack.unpackb(top), arr)
    assert tmsgpack.packb(arr) == top


def test_torch_tensors_are_written_as_flax_writes_arrays():
    """The writer's own input: tensors (bf16 as its bits under the name
    'bfloat16', non-contiguous ones in C order) give the bytes of the
    same tree as JAX / numpy arrays."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    port = {"kernel": torch.from_numpy(w).T, "half": torch.from_numpy(
        b).to(torch.bfloat16), "g": torch.tensor([2.0])}
    jax_tree = {"kernel": w.T.copy(), "half": jnp.asarray(b, jnp.bfloat16),
                "g": np.array([2.0], np.float32)}
    assert tmsgpack.packb(port) == serialization.to_bytes(jax_tree)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 255, 256, 65535, 65536])
def test_ext_lengths(n):
    """Every ext length form (fixext 1/2/4/8/16, ext 8/16/32) reads back as
    msgpack writes it, and writes back to the same bytes; an unknown ext
    code stays an ExtType, as flax's reader leaves it."""
    import msgpack

    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    packed = msgpack.packb({"x": msgpack.ExtType(5, data)})
    got = tmsgpack.unpackb(packed)
    assert got == {"x": tmsgpack.ExtType(5, data)}
    assert tmsgpack.packb(got) == packed


@pytest.mark.parametrize("data,error", [
    (b"\x92\x01", "truncated"), (b"\x01\x02", "after the object"),
    (b"\xc1", "unknown type byte")])
def test_malformed_input_raises(data, error):
    with pytest.raises(ValueError, match=error):
        tmsgpack.unpackb(data)
