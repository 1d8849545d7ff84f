"""The output blocks' epilogue, LayerNorm(dropout(y) + residual)
(crvqa_tpu_torch/ops/residual_layernorm.py), on the CPU.

The plain chain is the output blocks' eager code, bit for bit and draw for
draw; the transcriptions of the two kernels agree with autograd of that
chain in fp64; the autograd Function's glue hands each input its gradient;
CPU and `meta` tensors launch nothing. The CUDA kernels themselves run only
on the card: tests/test_torch_gpu.py.
"""
import pytest
import torch

from crvqa_tpu_torch.models import layers
from crvqa_tpu_torch.ops import residual_layernorm as rl
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

EPS = 1e-12


def _old_output_block(block, hidden, residual):
    """The output blocks' forward before the kernels: dense, `Dropout`,
    the add, then `layers.LayerNorm` (fp32 statistics, back to the
    dtype)."""
    x = block.dense(hidden)
    if block.dropout.training:
        x = layers.dropout(x, block.dropout.rate, block.dropout.generator)
    return block.LayerNorm(x + residual)


def _block(kind, dtype, rate, width=32, inner=48):
    g = torch.Generator().manual_seed(5)
    block = (layers.AttentionOutput(width, rate, dtype) if kind == "attention"
             else layers.FFNOutput(inner, width, rate, dtype))
    layers.init_weights_(block, g)
    with torch.no_grad():  # LayerNorm off its ones / zeros init
        block.LayerNorm.weight.normal_(1.0, 0.3, generator=g)
        block.LayerNorm.bias.normal_(0.0, 0.3, generator=g)
    return block


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["attention", "ffn"])
def test_plain_chain_is_the_old_output_block(kind, dtype, rate):
    """Training and eval forwards of `AttentionOutput` / `FFNOutput` return
    what the eager blocks returned, bit for bit, from generators in the
    same state, and leave them in the same state."""
    block = _block(kind, dtype, rate)
    g = torch.Generator().manual_seed(1)
    hidden = torch.randn(3, 7, block.dense.in_features, generator=g).to(dtype)
    residual = torch.randn(3, 7, 32, generator=g).to(dtype)
    for train in (True, False):
        block.train(train)
        block.dropout.generator = torch.Generator().manual_seed(11)
        got = block(hidden, residual)
        after = block.dropout.generator.get_state()
        block.dropout.generator = torch.Generator().manual_seed(11)
        want = _old_output_block(block, hidden, residual)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        assert torch.equal(after, block.dropout.generator.get_state())


def test_training_block_without_generator_raises():
    block = _block("attention", torch.float32, 0.1)
    with pytest.raises(RuntimeError, match="explicit generator"):
        block(torch.randn(2, 3, 32), torch.randn(2, 3, 32))


def _fp64_inputs(rows, width, seed, rate):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(rows, width, generator=g, dtype=torch.float64)
    res = torch.randn(rows, width, generator=g, dtype=torch.float64)
    w = 1.0 + 0.3 * torch.randn(width, generator=g, dtype=torch.float64)
    b = 0.3 * torch.randn(width, generator=g, dtype=torch.float64)
    r = torch.rand(rows, width, generator=g) if rate else None
    go = torch.randn(rows, width, generator=g, dtype=torch.float64)
    return y, res, r, w, b, go


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", [5, 8461])  # one block; every warp 2 rows
def test_bwd_transcription_matches_eager_autograd_fp64(rows, rate):
    """dz, dy and the partial-sum weight and bias gradients of the backward
    kernel's formula, fed the forward transcription's z, mean and rstd,
    against autograd of the eager chain, all in fp64."""
    y, res, r, w, b, go = _fp64_inputs(rows, 24, rows, rate)
    leaves = [t.clone().requires_grad_() for t in (y, res, w, b)]
    out = rl.plain(leaves[0], leaves[1], r, leaves[2], leaves[3], EPS, rate)
    want = torch.autograd.grad(out, leaves, go)
    fout, z, keep, mean, rstd = rl.fwd_reference(y, res, r, w, b, rate, EPS)
    torch.testing.assert_close(fout, out.detach(), rtol=0, atol=1e-12)
    assert (keep is None) == (rate == 0.0)
    dz, dy, dw, db = rl.bwd_reference(go, z, keep, mean, rstd, w, rate)
    for got, ref, name in zip((dy, dz, dw, db), want, ("y", "residual",
                                                       "weight", "bias")):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-12 * max(1.0, rows ** 0.5),
                                   msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_transcription_matches_plain_chain(dtype, rate):
    """The forward kernel's formula gives the eager chain's output: bit for
    bit in bf16 here (both round z, then normalise in fp32), within fp32
    rounding in fp32 (another summation order)."""
    g = torch.Generator().manual_seed(3)
    y = torch.randn(4, 9, 64, generator=g).to(dtype)
    res = torch.randn(4, 9, 64, generator=g).to(dtype)
    w = 1.0 + 0.3 * torch.randn(64, generator=g)
    b = 0.3 * torch.randn(64, generator=g)
    r = torch.rand(y.shape, generator=g) if rate else None
    out, z, keep, mean, rstd = rl.fwd_reference(y, res, r, w, b, rate, EPS)
    want = rl.plain(y, res, r, w, b, EPS, rate)
    assert out.dtype == z.dtype == dtype and mean.shape == (36,)
    if dtype == torch.bfloat16:
        assert torch.equal(out, want)
    else:
        torch.testing.assert_close(out, want, rtol=0, atol=2e-6)
    if rate:
        assert torch.equal(keep, r < 1.0 - rate)


@pytest.mark.parametrize("needs", ["all", "y", "residual", "params", "y_w"])
def test_function_hands_each_input_its_gradient(needs):
    """The autograd Function (its CPU path runs the transcriptions) against
    autograd of the eager chain, with only some inputs needing gradients:
    those get theirs, the others None."""
    rate = 0.1
    y, res, r, w, b, go = _fp64_inputs(6, 16, 2, rate)
    grad_of = {"all": "yrwb", "y": "y", "residual": "r", "params": "wb",
               "y_w": "yw"}[needs]
    args = [t.clone().requires_grad_(c in grad_of)
            for t, c in zip((y, res, w, b), "yrwb")]
    out = rl.ResidualLayerNormFunction.apply(args[0], args[1], r, args[2],
                                             args[3], rate, EPS)
    out.backward(go)
    ref = [t.clone().requires_grad_() for t in (y, res, w, b)]
    rl.plain(ref[0], ref[1], r, ref[2], ref[3], EPS, rate).backward(go)
    for got, want, c in zip(args, ref, "yrwb"):
        if c in grad_of:
            torch.testing.assert_close(got.grad, want.grad, rtol=0,
                                       atol=1e-12, msg=c)
        else:
            assert got.grad is None


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_never_launch(device):
    """CPU and `meta` tensors take the plain chain, forward and backward,
    in training and eval: neither counter moves."""
    block = _block("ffn", torch.bfloat16, 0.1).to(device)
    layers.set_generators(block, torch.Generator(device).manual_seed(0)
                          if device == "cpu" else None, None)
    before = (rl.residual_layernorm.launches,
              rl.residual_layernorm_bwd.launches)
    hidden = torch.randn(2, 5, 48, device=device, dtype=torch.bfloat16,
                         requires_grad=True)
    residual = torch.randn(2, 5, 32, device=device, dtype=torch.bfloat16,
                           requires_grad=True)
    block.train(device == "cpu")  # meta draws nothing: eval there
    block(hidden, residual).float().sum().backward()
    block.eval()
    with torch.no_grad():
        block(hidden, residual)
    assert (rl.residual_layernorm.launches,
            rl.residual_layernorm_bwd.launches) == before


def test_second_order_mplug_runs_the_eager_epilogue():
    """`attention_kernels=False` (the mPLUG setting under AdaHessian)
    reaches every output block of the text, fusion and decoder encoders, as
    it reaches their attentions; the default reaches none."""
    from crvqa_tpu_torch.models.mplug import bert

    for kernels in (True, False):
        c = bert.MPlugBertConfig.tiny(attention_kernels=kernels)
        modules = [bert.BertLayer(c, has_cross=True),
                   bert.FusionLayer(c, stride=False)]
        blocks = [m for mod in modules for m in mod.modules()
                  if isinstance(m, (layers.AttentionOutput,
                                    layers.FFNOutput))]
        assert len(blocks) == 6
        assert all(m.kernels is kernels for m in blocks)


def test_grid_blocks_cover_every_row_once():
    """The kernels' row assignment: warp w of the grid takes rows w,
    w + 8 * blocks, ...; every row exactly once, at most MAX_BLOCKS."""
    for rows in (1, 7, 8, 9, 8448, 8449, 73728):
        blocks = rl.grid_blocks(rows)
        assert 1 <= blocks <= rl.MAX_BLOCKS
        warps = blocks * rl.ROWS_PER_BLOCK
        seen = torch.zeros(rows, dtype=torch.int64)
        for w in range(min(warps, rows)):
            seen[w::warps] += 1
        assert bool((seen == 1).all())
