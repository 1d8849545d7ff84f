"""The port's CUDA kernels on the card (marker `gpu`; each test skips
without a CUDA device). This file imports no JAX, so it runs on a machine
that has none:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 atol 2e-5 (the same fp32 math, summed in another order);
bf16 atol/rtol 2e-2 (p and the outputs round to bf16, and the plain
version's bf16 matmuls accumulate in another order).
"""
import pytest
import torch

from crvqa_tpu_torch.models import LxmertConfig, build_lxmert
from crvqa_tpu_torch.models import layers
from crvqa_tpu_torch.ops import fused_attention as fa

pytestmark = pytest.mark.gpu

SHAPES = [(14, 14), (36, 36), (14, 36), (36, 14)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(b, sq, sk, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, 768, generator=g)
    k = torch.randn(b, sk, 768, generator=g)
    v = torch.randn(b, sk, 768, generator=g)
    bias = torch.zeros(b, sk)
    bias[1::2, sk // 2:] = -10000.0
    return (q.cuda().to(dtype), k.cuda().to(dtype), v.cuda().to(dtype),
            bias.cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dtype):
    _need_card()
    tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    for sq, sk in SHAPES:
        q, k, v, bias = _inputs(32, sq, sk, dtype, seed=sq + sk)
        before = fa.fused_attention.launches
        out = fa.fused_attention(q, k, v, bias, 12, 64)
        torch.cuda.synchronize()
        assert fa.fused_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        ref = fa.fused_attention_reference(q, k, v, bias, 12, 64)
        torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_kernel_reads_strided_projection_slices():
    """q/k/v as column slices of one fused [B, S, 3*H*D] projection: the
    kernel reads them in place through their row strides."""
    _need_card()
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(8, 36, 3 * 768, generator=g).cuda()
    q, k, v = qkv[..., :768], qkv[..., 768:1536], qkv[..., 1536:]
    bias = torch.zeros(8, 36, device="cuda")
    out = fa.fused_attention(q, k, v, bias, 12, 64)
    ref = fa.fused_attention_reference(q, k, v, bias, 12, 64)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", ["head_size", "dtype", "inner_stride"])
def test_kernel_raises_on_what_it_does_not_take(case):
    _need_card()
    q, k, v, bias = _inputs(2, 14, 14, torch.float32)
    heads, head_size = 12, 64
    if case == "head_size":
        heads, head_size = 24, 32
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q = torch.stack([q, q], dim=-1)[..., 0]  # H*D stride 2
    before = fa.fused_attention.launches
    with pytest.raises((TypeError, ValueError)):
        fa.fused_attention(q, k, v, bias, heads, head_size)
    assert fa.fused_attention.launches == before


def test_lxmert_forward_kernel_matches_plain():
    """A 1/1/1-layer LXMERT at full width (768 hidden, 12x64 heads) in fp32:
    the forward through the kernel (6 launches: 1 language, 1 visual, 4 in
    the cross layer) agrees with the same model on the plain attention."""
    _need_card()
    cfg = LxmertConfig(vocab_size=64, l_layers=1, r_layers=1, x_layers=1,
                       ans_num=16)
    model = build_lxmert(cfg, "cpu", torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    g = torch.Generator().manual_seed(2)
    inputs = dict(
        input_ids=torch.randint(1, 64, (4, 14), generator=g).cuda(),
        visual_feats=torch.randn(4, 36, 2048, generator=g).cuda(),
        visual_pos=torch.rand(4, 36, 4, generator=g).cuda(),
        attention_mask=torch.ones(4, 14, device="cuda"))
    before = fa.fused_attention.launches
    with torch.inference_mode():
        logits, _ = model(**inputs)
    assert fa.fused_attention.launches == before + 6

    def plain(q, k, v, bias, num_heads, head_size, rate=0.0):
        return fa.fused_attention_reference(q, k, v, bias, num_heads,
                                            head_size)

    saved = layers.fused_attention
    layers.fused_attention = plain
    try:
        with torch.inference_mode():
            ref, _ = model(**inputs)
    finally:
        layers.fused_attention = saved
    torch.testing.assert_close(logits, ref, atol=1e-3, rtol=0)
