"""The port's masked matmul (crvqa_tpu_torch/ops/masked_matmul.py) vs the
JAX package's Pallas kernels, run interpreted on the CPU. Inputs are made
with numpy from a seed and fed to both.

Both sides round every operand to bf16 and sum the products in fp32, so
they differ only in summation order: fp32 results are held to 1e-5 of the
largest output; results rounded to bf16 (x, or w for ds, in bf16) to one
bf16 step (2^-7 relative) plus that. w's and the threshold's gradients are
exactly zero, and a score on the fp32 side of a bf16-rounded threshold
keeps its weight, bit for bit.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.ops import masked_matmul as jmm
from crvqa_tpu_torch.ops import masked_matmul as tmm

SHAPES = [(256, 256, 256), (300, 130, 520), (8, 500, 64)]
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("bfloat16", "float32"), ("float32", "bfloat16")]
THRESHOLD = 0.5


def _inputs(m, k, n, x_dtype, w_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    s = rng.random((k, n)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, w_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype))
    return (jx, jw, jnp.asarray(s), jnp.asarray(g).astype(jx.dtype)), (
        tx, tw, torch.from_numpy(s), torch.from_numpy(g).to(tx.dtype))


def _close(got: torch.Tensor, want, bf16: bool, what: str):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7 if bf16 else 0.0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("x_dtype,w_dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_forward_matches_the_pallas_kernel(m, k, n, x_dtype, w_dtype):
    (jx, jw, js, _), (tx, tw, ts, _) = _inputs(m, k, n, x_dtype, w_dtype)
    want = jmm.masked_matmul(jx, jw, js, jnp.float32(THRESHOLD), True)
    got = tmm.masked_matmul(tx, tw, ts, THRESHOLD)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    _close(got, want, x_dtype == "bfloat16", "forward")


@pytest.mark.parametrize("m,k,n,x_dtype,w_dtype", [
    (300, 130, 520, "float32", "float32"),
    (300, 130, 520, "bfloat16", "bfloat16"),
    (8, 500, 64, "bfloat16", "float32")])
def test_gradients_match_the_pallas_kernels(m, k, n, x_dtype, w_dtype):
    """dx and the STE dscores through the custom VJP's kernels; zeros for
    w and the threshold."""
    (jx, jw, js, jg), (tx, tw, ts, tg) = _inputs(m, k, n, x_dtype, w_dtype,
                                                 seed=1)
    t = jnp.float32(THRESHOLD)
    _, vjp = jax.vjp(lambda x, w, s, t: jmm.masked_matmul(x, w, s, t, True),
                     jx, jw, js, t)
    jdx, jdw, jds, jdt = vjp(jg)

    x = tx.clone().requires_grad_(True)
    w = tw.clone().requires_grad_(True)
    s = ts.clone().requires_grad_(True)
    thr = torch.tensor(THRESHOLD, requires_grad=True)
    y = tmm.masked_matmul(x, w, s, thr)
    dx, dw, ds, dt = torch.autograd.grad(y, (x, w, s, thr), tg)
    assert dx.dtype == tx.dtype and ds.dtype == torch.float32
    _close(dx, jdx, x_dtype == "bfloat16", "dx")
    _close(ds, jds, w_dtype == "bfloat16", "dscores")
    assert float(dw.abs().max()) == 0.0 == float(np.abs(jdw).max())
    assert float(dt) == 0.0 == float(jdt)


def test_plain_versions_agree_with_the_xla_reference():
    """At fp32, bf16 rounding of the operands is the only difference from
    x @ (w ⊙ m) (`masked_matmul_reference`)."""
    (_, _, _, _), (tx, tw, ts, _) = _inputs(64, 96, 80, "float32", "float32",
                                            seed=2)
    got = tmm.masked_matmul_fwd(tx, tw, ts, THRESHOLD)
    ref = tmm.masked_matmul_reference(tx, tw, ts, THRESHOLD)
    bf = tmm.masked_matmul_reference(tx.bfloat16().float(),
                                     tw.bfloat16().float(), ts, THRESHOLD)
    torch.testing.assert_close(got, bf, rtol=0, atol=1e-4)
    assert float((got - ref).abs().max()) > 0  # the rounding is real


def test_bf16_threshold_boundary_matches_the_pallas_kernel():
    """A score above the fp32 threshold but below its bf16 rounding keeps
    its weight: the comparison stays fp32 (masked_matmul.py:112-114)."""
    thr = np.float32(0.01)            # bf16 rounds it up to 0.010009765625
    edge = np.float32(0.0100048)      # > thr, < bf16(thr)
    k = 8
    scores = np.full((k, 128), edge, np.float32)
    want = jmm.masked_matmul(jnp.ones((8, k), jnp.bfloat16),
                             jnp.ones((k, 128), jnp.bfloat16),
                             jnp.asarray(scores), jnp.float32(thr), True)
    got = tmm.masked_matmul(torch.ones(8, k, dtype=torch.bfloat16),
                            torch.ones(k, 128, dtype=torch.bfloat16),
                            torch.from_numpy(scores), float(thr))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert float(got[0, 0]) == k  # the edge scores are kept
    # and a score exactly at the threshold is masked (strict >)
    at = torch.full((k, 128), float(thr))
    assert float(tmm.masked_matmul_fwd(torch.ones(8, k), torch.ones(k, 128),
                                       at, float(thr)).abs().max()) == 0.0


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    """No fallback: only a CPU tensor takes the plain version; any other
    device goes to the kernel path, which refuses what is not CUDA."""
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, 16, device="meta")
    for call in (lambda: tmm.masked_matmul_fwd(x, w, w, 0.5),
                 lambda: tmm.masked_matmul_dx(x @ w, w, w, 0.5, x.dtype),
                 lambda: tmm.masked_matmul_ds(x, x @ w, w)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert (tmm.masked_matmul_fwd.launches, tmm.masked_matmul_dx.launches,
            tmm.masked_matmul_ds.launches) == (0, 0, 0)
