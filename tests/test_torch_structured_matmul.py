"""The port's head-compact matmuls (crvqa_tpu_torch/ops/structured_matmul.py)
vs the JAX package's: `expand_keep_idx` exactly, `head_compact_matmul`
forward and its dense masked backward (fp32, both sides summing the same
products in another order: 1e-5), and the plain version of the kernel
against the Pallas kernel run interpreted (both round x and wt to bf16 and
sum in fp32: 1e-5 of the largest output), with pad sentinels and an
all-masked mask. Inputs are made with numpy from a seed.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.ops import structured_matmul as jsm
from crvqa_tpu_torch.ops import structured_matmul as tsm

H, HS, K, M = 6, 64, 256, 256
MASKS = {"some": [1, 0, 1, 0, 0, 1], "all_kept": [1] * H,
         "none_kept": [0] * H}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, H * HS)) * 0.05).astype(np.float32)
    g = rng.normal(size=(M, H * HS)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("n_keep", [1, 3, 5, 6])
@pytest.mark.parametrize("mask", list(MASKS))
def test_expand_keep_idx_matches(mask, n_keep):
    hm = np.asarray(MASKS[mask], bool)
    want = np.asarray(jsm.expand_keep_idx(jnp.asarray(hm), n_keep))
    got = tsm.expand_keep_idx(torch.from_numpy(hm), n_keep)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask,extra", [("some", 0), ("some", 2),
                                        ("none_kept", 2)])
def test_head_compact_matmul_forward_and_backward(mask, extra):
    """The XLA-side op: compact forward equal to the dense masked product,
    the dense masked backward (masked head columns of w get zero)."""
    x, w, g = _data(1)
    hm = np.asarray(MASKS[mask], bool)
    n_keep = int(hm.sum()) + extra
    jkeep = jsm.expand_keep_idx(jnp.asarray(hm), n_keep)
    y, vjp = jax.vjp(lambda x, w: jsm.head_compact_matmul(x, w, jkeep, H, HS),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    keep = tsm.expand_keep_idx(torch.from_numpy(hm), n_keep)
    ty = tsm.head_compact_matmul(tx, tw, keep, H, HS)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g))
    for got, want, what in ((ty, y, "y"), (tdx, jdx, "dx"), (tdw, jdw, "dw")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=what)
    dense = tsm.dense_masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(hm), HS)
    torch.testing.assert_close(ty.detach(), dense, rtol=1e-5, atol=1e-5)
    dropped = torch.from_numpy(~np.repeat(hm, HS))
    assert not ty.detach()[:, dropped].any()
    assert not tdw[:, dropped].any()


@pytest.mark.parametrize("mask,extra,dtype", [
    ("some", 0, "float32"), ("some", 3, "bfloat16"),
    ("all_kept", 0, "bfloat16"), ("none_kept", 2, "float32")])
def test_kernel_plain_version_matches_the_pallas_kernel(mask, extra, dtype):
    """wt [N, K] read per kept head; pads (the sentinel H) dropped, every
    other column zero; output in x's dtype."""
    x, w, _ = _data(2)
    hm = np.asarray(MASKS[mask], bool)
    n_keep = int(hm.sum()) + extra
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jsm.head_compact_matmul_pallas(
        jx, jnp.asarray(w.T), jsm.expand_keep_idx(jnp.asarray(hm), n_keep),
        H, HS, bm=128, bk=128, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tsm.head_compact_matmul_pallas(
        tx, torch.from_numpy(np.ascontiguousarray(w.T)),
        tsm.expand_keep_idx(torch.from_numpy(hm), n_keep), H, HS, bm=128,
        bk=128)
    assert got.dtype == tx.dtype and got.shape == (M, H * HS)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=2.0 ** -7 if dtype == "bfloat16"
        else 0.0, atol=1e-5 * max(float(np.abs(want).max()), 1.0))
    if mask == "none_kept":
        assert float(got.abs().max()) == 0.0


def test_kernel_preconditions_and_devices():
    x = torch.zeros(M, K)
    wt = torch.zeros(H * HS, K)
    keep = torch.arange(2)
    with pytest.raises(ValueError, match="multiples"):
        tsm.head_compact_matmul_pallas(x, wt, keep, H, HS, bm=512)
    with pytest.raises(ValueError, match="is not"):
        tsm.head_compact_matmul_pallas(x, wt[:-1], keep, H, HS, bm=128)
    with pytest.raises(ValueError, match="unsupported devices"):
        tsm.head_compact_matmul_pallas(x.to("meta"), wt.to("meta"), keep, H,
                                       HS, bm=128, bk=128)
    assert tsm.head_compact_matmul_pallas.launches == 0
