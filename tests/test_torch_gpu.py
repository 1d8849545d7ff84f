"""The port's CUDA kernels on the card (marker `gpu`; each test skips
without a CUDA device). This file imports no JAX, so it runs on a machine
that has none:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 atol 2e-5 (the same fp32 math, summed in another order);
bf16 atol/rtol 2e-2 (p and the outputs round to bf16, and the plain
version's bf16 matmuls accumulate in another order). The backward's fp32
gradients atol 1e-4: dp = g v^T reaches tens, summed in another order than
cuBLAS sums it. The fp32 residual p atol 1e-6. The mid-length kernel's
bf16 outputs atol 5e-3, rtol 1e-2: its outputs are about 0.07, so a missed
rounding point of p would show. The mid-length backward: fp32 atol 2e-5,
bf16 atol 1e-2 / rtol 2e-2 (gradients about 1; ds, p_t and each output
round to bf16 once). The masked and head-compact matmuls: 1e-5 of the
largest output for sums of up to 768 terms, growing with the square root
of the length, plus one bf16 step where the output is bf16 (see
`_close_to`).
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


def _profiled(fn, cpu=True, sessions=3):
    """A profile of `fn()` (which ends in a synchronise) run twice under one
    profiler, the first pass its warm-up: traced and discarded, so the
    recorded pass does not lose the kernels CUPTI misses while it starts
    (the first launches of a session, or all of them, on the H100). The
    warm-up pass first spends the session's first records on tiny kernels
    (`warm_session`): after many earlier sessions in the process, CUPTI
    can drop them. A session that recorded no device kernel at all (in a
    long process CUPTI can lose a whole session, chip_profile_sessions.py)
    is taken again, up to `sessions` in all: the names it reports come
    from a session that recorded the device."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from crvqa_tpu_torch.utils.profiling import warm_session

    activities = ([ProfilerActivity.CPU] if cpu else []) + [
        ProfilerActivity.CUDA]
    for _ in range(sessions):
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            warm_session("cuda")
            for _ in range(2):
                fn()
                prof.step()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.key_averages()):
            break
    return prof


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 checks in full fp32: no TF32 in matmuls or cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


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


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_train_matches_plain(dtype, rate):
    """The forward for grad: output and fp32 residual against the plain
    version, with the same counter-hash dropout."""
    _need_card()
    tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    for sq, sk in SHAPES:
        q, k, v, bias = _inputs(32, sq, sk, dtype, seed=sq + sk)
        before = fa.fused_attention_fwd_train.launches
        out, p = fa.fused_attention_fwd_train(q, k, v, bias, 12, 64, rate,
                                              seed=-7)
        torch.cuda.synchronize()
        assert fa.fused_attention_fwd_train.launches == before + 1
        ref, pref = fa.fused_attention_train_reference(q, k, v, bias, 12, 64,
                                                       rate, -7)
        assert p.shape == (32, sq, 12 * sk) and p.dtype == torch.float32
        torch.testing.assert_close(p, pref, atol=1e-6, rtol=0)
        torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.parametrize("impl", ["stored", "recompute"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_matches_plain(dtype, rate, impl):
    _need_card()
    tol = (dict(atol=1e-4, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    wrapper = (fa.fused_attention_bwd_stored if impl == "stored"
               else fa.fused_attention_bwd_recompute)
    for sq, sk in SHAPES:
        q, k, v, bias = _inputs(32, sq, sk, dtype, seed=sq * sk)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)
                        ).cuda().to(dtype)
        _, p = fa.fused_attention_fwd_train(q, k, v, bias, 12, 64, rate, 11)
        before = wrapper.launches
        grads = wrapper(q, k, v, p if impl == "stored" else bias, g, 12, 64,
                        rate, 11)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = fa.fused_attention_bwd_reference(q, k, v, p, g, 12, 64, rate,
                                               11)
        for name, got, want in zip("qkv", grads, ref):
            assert got.dtype == dtype, name
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m: f"d{name}: {m}")


def test_autograd_through_kernels_matches_plain_autograd():
    """torch.autograd through the forward-for-grad and stored-backward
    kernels equals autograd of the plain forward, dropout on (fp32)."""
    _need_card()
    q, k, v, bias = _inputs(16, 36, 14, torch.float32, seed=5)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).cuda()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.fused_attention(*leaves, bias, 12, 64, rate=0.1, seed=99)
    grads = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = fa.fused_attention_train_reference(*plain, bias, 12, 64, 0.1, 99)
    want = torch.autograd.grad(ref, plain, g)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    for got, exp in zip(grads, want):
        torch.testing.assert_close(got, exp, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["residual_dtype", "g_dtype", "head_size",
                                  "smem"])
def test_bwd_raises_on_what_it_does_not_take(case):
    _need_card()
    q, k, v, bias = _inputs(2, 14, 14, torch.float32)
    _, p = fa.fused_attention_fwd_train(q, k, v, bias, 12, 64, 0.0, 0)
    g = torch.randn_like(q)
    heads, head_size = 12, 64
    if case == "residual_dtype":  # fp32 and bf16 residuals are taken
        p = p.to(torch.float16)
    elif case == "g_dtype":
        g = g.to(torch.bfloat16)
    elif case == "head_size":
        heads, head_size = 24, 32
    else:  # one head over 1024 keys: the staged tiles exceed 227 KB
        q = torch.randn(1, 1024, 64, device="cuda")
        k = v = g = q
        p = torch.zeros(1, 1024, 1024, device="cuda")
        heads = 1
    before = fa.fused_attention_bwd_stored.launches
    with pytest.raises((TypeError, ValueError)):
        fa.fused_attention_bwd_stored(q, k, v, p, g, heads, head_size, 0.0, 0)
    assert fa.fused_attention_bwd_stored.launches == before


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

    def plain(q, k, v, bias, num_heads, head_size, rate=0.0, seed=0,
              row0=0, head0=0):
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


def test_train_step_kernels_match_plain_versions():
    """One stage-2 step (loss and gradients) of a 1/1/1-layer LXMERT at
    full width, fp32, dropout on, through the kernels (6 forward-for-grad
    launches; 4 backward: the cross layer's visual branch does not reach
    the logits) and through the plain versions, from the same generators:
    the counter-hash dropout makes them the same function. Loss within
    1e-5 relative, score gradients within 1e-3 of their largest."""
    _need_card()
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.train import stage2

    cfg = LxmertConfig(vocab_size=64, l_layers=1, r_layers=1, x_layers=1,
                       ans_num=16)
    masker = Masker.create(lxmert_mask_specs(1, 1, 1),
                           ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7),
                           controlled_init="magnitude")
    params = build_lxmert(cfg, "cpu",
                          torch.Generator().manual_seed(0)).state_dict()
    sc = stage2.Stage2Config(masker_type="lmh", hidden_size=768)
    model = stage2.lxmert_meta_model(cfg)
    state, _ = stage2.init_state(model, masker, params, sc, 0, "cuda")
    batch = to_device(synthetic_batch(batch_size=8, vocab_size=64, ans_num=16,
                                      seed=1), torch.device("cuda"))
    fn = stage2.make_loss_and_grads(model, masker, sc)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    fwd, bwd = fa.fused_attention_fwd_train, fa.fused_attention_bwd_stored
    before = (fwd.launches, bwd.launches)
    loss_k, _, grads_k = fn(state, batch)
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (6, 4)
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])

    def plain(q, k, v, bias, num_heads, head_size, rate=0.0, seed=0,
              row0=0, head0=0):
        return fa.fused_attention_train_reference(
            q, k, v, bias, num_heads, head_size, rate, seed, row0, head0)[0]

    saved = layers.fused_attention
    layers.fused_attention = plain
    try:
        loss_p, _, grads_p = fn(state, batch)
    finally:
        layers.fused_attention = saved
    assert fwd.launches - before[0] == 6
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    scores = [k for k in grads_k if k.startswith("scores/")]
    gmax = max(grads_p[k].abs().max().item() for k in scores)
    for k in scores:
        torch.testing.assert_close(grads_k[k], grads_p[k], rtol=0,
                                   atol=1e-3 * gmax, msg=k)


# --------------------------------------- short attention, bf16 on tensor cores

# (heads, Sq, Sk): ragged and edge shapes of the short scope, LXMERT's 12
# heads and stage 3's compacted 6. At (170, 170) only the recompute
# backward's block fits 227 KB.
SHORT_EDGE = [(12, 1, 1), (12, 14, 36), (12, 36, 14), (12, 25, 25),
              (12, 85, 85), (6, 36, 36), (6, 170, 170)]
SHORT_COUNTERS = ("fused_attention", "fused_attention_fwd_train",
                  "fused_attention_bwd_stored", "fused_attention_bwd_recompute")
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _launches():
    return [getattr(fa, name).launches for name in SHORT_COUNTERS]


def _short_inputs(b, sq, sk, heads, seed):
    g = torch.Generator().manual_seed(seed)
    d = heads * 64
    q, k, v, gq = (torch.randn(b, s, d, generator=g) for s in (sq, sk, sk, sq))
    bias = torch.zeros(b, sk)
    bias[1::2, sk // 2:] = -10000.0
    return [t.cuda().bfloat16() for t in (q, k, v, gq)] + [bias.cuda()]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("heads,sq,sk", SHORT_EDGE)
def test_short_bf16_kernels_at_edge_shapes(heads, sq, sk, rate):
    """The bf16 primal, forward for grad (output and fp32 residual p) and
    both backwards against their plain versions; stored and recompute
    gradients bit-identical, and two launches of each the same bits."""
    _need_card()
    q, k, v, g, bias = _short_inputs(4, sq, sk, heads, seed=sq * 100 + sk)
    args = (heads, 64, rate, -7)
    out = fa.fused_attention(q, k, v, bias, heads, 64, rate, -7)
    out_t, p = fa.fused_attention_fwd_train(q, k, v, bias, *args)
    torch.cuda.synchronize()
    ref, pref = fa.fused_attention_train_reference(q, k, v, bias, *args)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    assert torch.equal(out, out_t)
    torch.testing.assert_close(p, pref, atol=1e-6, rtol=0)
    want = fa.fused_attention_bwd_reference(q, k, v, p, g, *args)
    recomp = fa.fused_attention_bwd_recompute(q, k, v, bias, g, *args)
    again = fa.fused_attention_bwd_recompute(q, k, v, bias, g, *args)
    torch.cuda.synchronize()
    for name, a, b, c in zip("qkv", recomp, want, again):
        assert torch.equal(a, c), f"d{name} differs between launches"
        torch.testing.assert_close(a.float(), b.float(), **BF16_TOL,
                                   msg=lambda m: f"d{name}: {m}")
    if fa.bwd_smem_bytes(sq, sk, torch.bfloat16, True) > 232448:
        before = _launches()
        with pytest.raises(ValueError, match="shared memory"):
            fa.fused_attention_bwd_stored(q, k, v, p, g, *args)
        assert _launches() == before
        return
    stored = fa.fused_attention_bwd_stored(q, k, v, p, g, *args)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", stored, recomp):
        assert torch.equal(a, b), f"stored and recompute d{name} differ"


def test_short_bf16_kernels_read_strided_projection_slices():
    """bf16 q/k/v as column slices of one fused [B, S, 3*H*D] projection:
    forward and backward read them in place through their row strides."""
    _need_card()
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(8, 36, 3 * 768, generator=g).cuda().bfloat16()
    q, k, v = qkv[..., :768], qkv[..., 768:1536], qkv[..., 1536:]
    assert not q.is_contiguous() and k.storage_offset() == 768
    gq = torch.randn(8, 36, 768, generator=g).cuda().bfloat16()
    bias = torch.zeros(8, 36, device="cuda")
    bias[::3, 30:] = -10000.0
    args = (12, 64, 0.1, 5)
    out, p = fa.fused_attention_fwd_train(q, k, v, bias, *args)
    grads = fa.fused_attention_bwd_stored(q, k, v, p, gq, *args)
    dense = [t.contiguous() for t in (q, k, v)]
    ref, pref = fa.fused_attention_train_reference(*dense, bias, *args)
    want = fa.fused_attention_bwd_reference(*dense, p, gq, *args)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    torch.testing.assert_close(p, pref, atol=1e-6, rtol=0)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a.float(), b.float(), **BF16_TOL)


def test_short_routes_bf16_to_tensor_cores_and_fp32_to_scalar_kernels():
    """The profiler names what ran: bf16 the mma kernels, fp32 the scalar
    ones, forward and backward."""
    _need_card()
    ran = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias = _inputs(4, 36, 36, dtype)
        g = torch.randn_like(q)
        _, p = fa.fused_attention_fwd_train(q, k, v, bias, 12, 64, 0.1, 3)
        torch.cuda.synchronize()

        def run():
            fa.fused_attention(q, k, v, bias, 12, 64)
            fa.fused_attention_fwd_train(q, k, v, bias, 12, 64, 0.1, 3)
            fa.fused_attention_bwd_stored(q, k, v, p, g, 12, 64, 0.1, 3)
            fa.fused_attention_bwd_recompute(q, k, v, bias, g, 12, 64, 0.1,
                                             3)
            torch.cuda.synchronize()

        prof = _profiled(run, cpu=False)
        ran[dtype] = " ".join(e.key for e in prof.key_averages())
    for name in ("fused_attention_fwd_mma_kernel",
                 "fused_attention_bwd_mma_kernel"):
        assert name in ran[torch.bfloat16] and name not in ran[torch.float32]
    for name in ("fused_attention_fwd_kernel", "fused_attention_bwd_kernel"):
        assert name in ran[torch.float32] and name not in ran[torch.bfloat16]


@pytest.mark.parametrize("case", ["offset", "row_stride"])
def test_short_bf16_refuses_unaligned_tiles(case):
    """The bf16 kernels stage 16 bytes a thread: a start or a row stride
    off the 16-byte grid raises before any launch, every counter unmoved."""
    _need_card()
    q, k, v, bias = _inputs(2, 14, 36, torch.bfloat16)
    if case == "offset":  # starts 2 bytes past the grid
        k = torch.randn(2, 36, 769, device="cuda").bfloat16()[..., 1:]
    else:  # rows of 772 elements
        k = torch.randn(2, 36, 772, device="cuda").bfloat16()[..., :768]
    p = torch.zeros(2, 14, 12 * 36, device="cuda")
    before = _launches()
    calls = [lambda: fa.fused_attention(q, k, v, bias, 12, 64),
             lambda: fa.fused_attention_fwd_train(q, k, v, bias, 12, 64,
                                                  0.1, 1),
             lambda: fa.fused_attention_bwd_stored(q, k, v, p, q, 12, 64,
                                                   0.1, 1),
             lambda: fa.fused_attention_bwd_recompute(q, k, v, bias, q, 12,
                                                      64, 0.1, 1)]
    for call in calls:
        with pytest.raises(ValueError, match="16-byte"):
            call()
    assert _launches() == before


# ------------------------------------------------- mid-length attention

MIDSEQ_SHAPES = [(577, 577), (25, 577), (602, 602), (1, 602), (120, 602)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_midseq_kernel_matches_plain(dtype, rate):
    """The mid-length forward at the ViT, cross, joint and rank shapes of
    mPLUG (batch 4): against the plain version with the same dropout."""
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
           else dict(atol=5e-3, rtol=1e-2))
    for sq, sk in MIDSEQ_SHAPES:
        q, k, v, bias = _inputs(4, sq, sk, dtype, seed=sq + sk)
        before = ma.midseq_attention.launches
        out = ma.midseq_attention(q, k, v, bias, 12, 64, rate, -31)
        torch.cuda.synchronize()
        assert ma.midseq_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        ref = ma.midseq_attention_reference(q, k, v, bias, 12, 64, rate, -31)
        torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_midseq_kernel_reads_strided_projection_slices():
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 577, 3 * 768, generator=g).cuda()
    q, k, v = qkv.chunk(3, dim=-1)
    bias = torch.zeros(2, 577, device="cuda")
    out = ma.midseq_attention(q, k, v, bias, 12, 64)
    ref = ma.midseq_attention_reference(q, k, v, bias, 12, 64)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", ["head_size", "dtype", "inner_stride",
                                  "smem"])
def test_midseq_raises_on_what_it_does_not_take(case):
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    q, k, v, bias = _inputs(2, 25, 577, torch.float32)
    heads, head_size = 12, 64
    error = (TypeError, ValueError)
    if case == "head_size":
        heads, head_size = 24, 32
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "inner_stride":
        q = torch.stack([q, q], dim=-1)[..., 0]  # H*D stride 2
    else:  # 16 probability rows of 4096 keys: 256 KB
        k = v = torch.randn(2, 4096, 768, device="cuda")
        bias = torch.zeros(2, 4096, device="cuda")
    before = ma.midseq_attention.launches
    with pytest.raises(error):
        ma.midseq_attention(q, k, v, bias, heads, head_size)
    with pytest.raises(error):  # needing a gradient changes nothing
        ma.midseq_attention(q.requires_grad_(), k, v, bias, heads, head_size)
    assert ma.midseq_attention.launches == before


# mPLUG's training shapes: ViT, fusion cross, stride joint, and the
# decoder's grouped cross-attention (5 answers x 8 tokens over 602)
MIDSEQ_TRAIN_SHAPES = [(577, 577), (25, 577), (602, 602), (40, 602)]
# fp32: the same sums in another order than cuBLAS (gradients about 1);
# bf16: ds, p_t and each output round once
MIDSEQ_BWD_TOL = {torch.float32: dict(atol=2e-5, rtol=0),
                  torch.bfloat16: dict(atol=1e-2, rtol=2e-2)}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_midseq_backward_kernel_matches_plain(dtype, rate):
    """The recompute backward at mPLUG's training shapes (batch 4) against
    its plain version with the same dropout; two launches give the same
    bits (no atomics)."""
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    for sq, sk in MIDSEQ_TRAIN_SHAPES:
        q, k, v, bias = _inputs(4, sq, sk, dtype, seed=sq + sk)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            sq)).cuda().to(dtype)
        before = ma.midseq_attention_bwd.launches
        got = ma.midseq_attention_bwd(q, k, v, bias, g, 12, 64, rate, -31)
        again = ma.midseq_attention_bwd(q, k, v, bias, g, 12, 64, rate, -31)
        torch.cuda.synchronize()
        assert ma.midseq_attention_bwd.launches == before + 2
        want = ma.midseq_attention_bwd_reference(q, k, v, bias, g, 12, 64,
                                                 rate, -31)
        for name, a, b, c in zip("qkv", got, want, again):
            assert a.dtype == dtype and a.shape == b.shape
            assert torch.equal(a, c), f"d{name} differs between launches"
            torch.testing.assert_close(a.float(), b.float(),
                                       **MIDSEQ_BWD_TOL[dtype],
                                       msg=lambda m: f"d{name} {sq, sk}: {m}")


def test_midseq_autograd_launches_both_kernels():
    """On CUDA tensors that need a gradient the wrapper goes through
    `MidseqAttentionFunction`: one forward and one backward launch, on
    column slices of one fused projection, equal to autograd through the
    plain forward (fp32, dropout 0.1)."""
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    gen = torch.Generator().manual_seed(2)
    qkv = torch.randn(2, 577, 3 * 768, generator=gen).cuda().requires_grad_()
    g = torch.randn(2, 577, 768, generator=gen).cuda()
    bias = torch.zeros(2, 577, device="cuda")
    bias[1, 500:] = -10000.0
    before = (ma.midseq_attention.launches, ma.midseq_attention_bwd.launches)
    out = ma.midseq_attention(*qkv.chunk(3, dim=-1), bias, 12, 64, 0.1, 77)
    (got,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert (ma.midseq_attention.launches - before[0],
            ma.midseq_attention_bwd.launches - before[1]) == (1, 1)
    ref = ma.midseq_attention_reference(*qkv.chunk(3, dim=-1), bias, 12, 64,
                                        0.1, 77)
    (want,) = torch.autograd.grad(ref, qkv, g)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", ["g_dtype", "g_stride", "smem", "g_shape"])
def test_midseq_backward_raises_on_what_it_does_not_take(case):
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    q, k, v, bias = _inputs(2, 25, 577, torch.float32)
    g = torch.randn_like(q)
    if case == "g_dtype":
        g = g.bfloat16()
    elif case == "g_stride":
        g = torch.stack([g, g], dim=-1)[..., 0]
    elif case == "smem":  # two planes of 16 x 2048 keys: 270 KB
        k = v = torch.randn(2, 2048, 768, device="cuda")
        bias = torch.zeros(2, 2048, device="cuda")
    else:
        g = g[:, :24]
    before = ma.midseq_attention_bwd.launches
    with pytest.raises((TypeError, ValueError)):
        ma.midseq_attention_bwd(q, k, v, bias, g, 12, 64)
    assert ma.midseq_attention_bwd.launches == before


# The bf16 tensor-core kernels at ragged shapes: query counts of one warp,
# of one-warp blocks and of four-warp blocks; key counts of 577 and 602
# (ragged last tiles) and 70 (a tile and 6 keys: a whole 32-key chunk past
# Sk). At batch 3 the (577 / 602)-row launches take four-warp blocks and
# the others one-warp blocks.
RAGGED_SQ = (1, 25, 40, 577, 602)
RAGGED_SK = (577, 602, 70)


def _strided_inputs(b, sq, sk, seed):
    """q, k, v as column slices of fused projections (row strides 2304 and
    1536), bf16, with -10000 pads on alternate rows."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, 2 * 768, generator=g).cuda().bfloat16()[..., 768:]
    kv = torch.randn(b, sk, 3 * 768, generator=g).cuda().bfloat16()
    k, v = kv[..., 768:1536], kv[..., 2 * 768:]
    bias = torch.zeros(b, sk)
    bias[1::2, sk // 2:] = -10000.0
    return q, k, v, bias.cuda()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_midseq_bf16_kernels_at_ragged_shapes(rate):
    """Forward and backward of the bf16 kernels against their plain
    versions on strided projection slices, at every (Sq, Sk) of
    RAGGED_SQ x RAGGED_SK; two launches of each give the same bits."""
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    for sq in RAGGED_SQ:
        for sk in RAGGED_SK:
            q, k, v, bias = _strided_inputs(3, sq, sk, seed=sq * 1000 + sk)
            assert q.stride(0) == sq * 2 * 768 and k.stride(1) == 3 * 768
            assert q.storage_offset() == 768 and not k.is_contiguous()
            g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
                sq)).cuda().bfloat16()
            args = (12, 64, rate, -31)
            out = ma.midseq_attention(q, k, v, bias, *args)
            again = ma.midseq_attention(q, k, v, bias, *args)
            grads = ma.midseq_attention_bwd(q, k, v, bias, g, *args)
            grads2 = ma.midseq_attention_bwd(q, k, v, bias, g, *args)
            torch.cuda.synchronize()
            assert torch.equal(out, again), (sq, sk)
            torch.testing.assert_close(
                out.float(), ma.midseq_attention_reference(
                    q, k, v, bias, *args).float(), atol=5e-3, rtol=1e-2,
                msg=lambda m: f"out {sq, sk}: {m}")
            want = ma.midseq_attention_bwd_reference(q, k, v, bias, g, *args)
            for name, a, b, c in zip("qkv", grads, want, grads2):
                assert torch.equal(a, c), f"d{name} {sq, sk} differs"
                torch.testing.assert_close(
                    a.float(), b.float(), **MIDSEQ_BWD_TOL[torch.bfloat16],
                    msg=lambda m: f"d{name} {sq, sk}: {m}")


def test_midseq_routes_bf16_to_tensor_cores_and_fp32_to_scalar_kernels():
    """The profiler names what ran: bf16 the mma kernels, fp32 the scalar
    ones, forward and backward."""
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    ran = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias = _inputs(3, 577, 577, dtype)
        g = torch.randn_like(q)

        def run():
            ma.midseq_attention(q, k, v, bias, 12, 64)
            ma.midseq_attention_bwd(q, k, v, bias, g, 12, 64)
            torch.cuda.synchronize()

        run()  # builds and loads both kernels before the profiler
        # CPU activity too: a CUDA-only session that follows another
        # profiler session in the same process can come back without the
        # kernels (seen on the H100 after the short-kernel test above)
        prof = _profiled(run)
        ran[dtype] = " ".join(e.key for e in prof.key_averages())
    for name in ("midseq_fwd_mma_kernel", "midseq_bwd_dq_mma_kernel",
                 "midseq_bwd_dkv_mma_kernel"):
        assert name in ran[torch.bfloat16] and name not in ran[torch.float32]
    for name in ("midseq_attention_fwd_kernel", "midseq_bwd_dq_kernel",
                 "midseq_bwd_dkv_kernel"):
        assert name in ran[torch.float32] and name not in ran[torch.bfloat16]


@pytest.mark.parametrize("case", ["offset", "row_stride"])
def test_midseq_bf16_refuses_unaligned_tiles(case):
    """The bf16 kernels stage 16 bytes a thread: a start or a row stride
    off the 16-byte grid raises before any launch; the same Sk as 4096
    keys, over the fp32 kernels' shared-memory bound, runs."""
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    q, k, v, bias = _inputs(2, 25, 577, torch.bfloat16)
    if case == "offset":  # starts 2 bytes past the grid
        k = torch.randn(2, 577, 769, device="cuda").bfloat16()[..., 1:]
    else:  # rows of 772 elements
        k = torch.randn(2, 577, 772, device="cuda").bfloat16()[..., :768]
    before = (ma.midseq_attention.launches, ma.midseq_attention_bwd.launches)
    with pytest.raises(ValueError, match="16-byte"):
        ma.midseq_attention(q, k, v, bias, 12, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ma.midseq_attention_bwd(q, k, v, bias, q, 12, 64)
    assert (ma.midseq_attention.launches,
            ma.midseq_attention_bwd.launches) == before
    q, k, v, bias = _inputs(2, 25, 4096, torch.bfloat16)
    out = ma.midseq_attention(q, k, v, bias, 12, 64)
    torch.testing.assert_close(
        out.float(), ma.midseq_attention_reference(q, k, v, bias, 12,
                                                   64).float(),
        atol=5e-3, rtol=1e-2)


def test_mplug_encode_launch_counts_and_plain_agreement():
    """One full-width mPLUG encode (ViT-B-16 at 384 px, 12+6+6 layers) in
    bf16 at batch 2 on seeded weights: 18 mid-length launches (12 ViT at
    (577,577), 5 fusion cross at (25,577), 1 stride joint at (602,602))
    and 11 short ones (6 text encoder, 5 fusion self at (25,25)). The same
    encode in fp32 through the kernels and through the plain versions
    agrees within 2e-3 (fp32, 24 layers, summed in another order)."""
    _need_card()
    import dataclasses

    from crvqa_tpu_torch.models.mplug import MPlugConfig, build_mplug
    from crvqa_tpu_torch.ops import midseq_attention as ma

    cfg = MPlugConfig()
    model = build_mplug(cfg, "cpu", torch.Generator().manual_seed(0))
    state = model.state_dict()
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 384, 384, 3), dtype=torch.uint8,
                           generator=g).cuda()
    ids = torch.randint(1000, 2000, (2, 25), generator=g).cuda()
    mask = torch.ones(2, 25, device="cuda")
    mask[1, 10:] = 0.0
    bf16 = dataclasses.replace(
        cfg, bert=dataclasses.replace(cfg.bert, dtype=torch.bfloat16),
        vit=dataclasses.replace(cfg.vit, dtype=torch.bfloat16))
    model_bf16 = build_mplug(bf16, "cuda")
    model_bf16.load_state_dict(state)
    before = (ma.midseq_attention.launches, fa.fused_attention.launches)
    with torch.inference_mode():
        states, _ = model_bf16.eval().encode(images, ids, mask)
    assert (ma.midseq_attention.launches - before[0],
            fa.fused_attention.launches - before[1]) == (18, 11)
    assert states.shape == (2, 602, 768) and bool(states.isfinite().all())

    model = model.cuda().eval()
    with torch.inference_mode():
        got, _ = model.encode(images, ids, mask)
    saved = (layers.midseq_attention, layers.fused_attention)
    layers.midseq_attention = (
        lambda q, k, v, b, h, d, rate=0.0, seed=0, row0=0, head0=0:
        ma.midseq_attention_reference(q, k, v, b, h, d, rate, seed, row0,
                                      head0))
    layers.fused_attention = (
        lambda q, k, v, b, h, d, rate=0.0, seed=0, row0=0, head0=0:
        fa.fused_attention_reference(q, k, v, b, h, d))
    try:
        with torch.inference_mode():
            want, _ = model.encode(images, ids, mask)
    finally:
        layers.midseq_attention, layers.fused_attention = saved
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def test_mplug_train_step_launch_counts():
    """One full-width mPLUG mask-training step (bf16, batch 2, 5 answers of
    8 tokens, dropout on) on seeded weights. The forward launches the
    mid-length kernel 30 times (12 ViT, 5 fusion cross, 1 stride joint, 12
    decoder cross at (40,602)) and the short forward for grad 11 times (6
    text encoder, 5 fusion self); the backward runs for all of them but the
    first ViT block's attention, which no trained leaf precedes (the ViT's
    masks are on its MLPs): 29 mid-length and 11 short backward launches.
    The scores move and the loss is finite."""
    _need_card()
    from crvqa_tpu_torch.cli import vqa_mplug
    from crvqa_tpu_torch.data.mplug_data import synthetic_mplug_batch
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.ops import midseq_attention as ma
    from crvqa_tpu_torch.train import mplug_train

    args = vqa_mplug.build_parser().parse_args(
        ["--output_dir", "unused", "--dtype", "bfloat16", "--seed", "0"])
    config, _, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    cfg = vqa_mplug.train_config(args, 4)
    state = mplug_train.init_state(
        model, vqa_mplug.initial_params(args, config), cfg, "cuda",
        masker=masker, seed=0, train=True)
    batch = to_device(synthetic_mplug_batch(
        batch_size=2, image_res=384, vocab_size=30522, q_len=25, a_len=8,
        answers_per_question=5, seed=1, uint8_images=True),
        torch.device("cuda"))
    counters = (ma.midseq_attention, ma.midseq_attention_bwd,
                fa.fused_attention_fwd_train, fa.fused_attention_bwd_stored,
                fa.fused_attention)
    before = [c.launches for c in counters]
    key = next(iter(state.scores))
    old = state.scores[key].detach().clone()
    step = mplug_train.make_train_step(model, cfg, masker)
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        30, 29, 11, 11, 0]
    assert bool(torch.isfinite(loss)) and state.step == 1
    assert not torch.equal(state.scores[key], old)


# ------------------------------------------- masked and head-compact matmul
#
# Both sides round the operands to bf16 and sum exact products in fp32, the
# tensor cores in 32-term steps in sequence, cuBLAS in another order: fp32
# results within 1e-5 of the largest output for sums of up to 768 terms,
# sqrt(terms / 768) times that beyond; bf16 results one bf16 step (2^-7
# relative) more.

def _close_to(got, want, bf16, terms):
    got, want = got.float(), want.float()
    tol = (1e-5 * max(1.0, terms / 768) ** 0.5 * want.abs().max()
           + (2.0 ** -7 if bf16 else 0.0) * want.abs())
    assert bool(((got - want).abs() <= tol).all()), (
        (got - want).abs().max().item())


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("m,k,n", [(9216, 768, 768), (1000, 700, 300)])
def test_masked_matmul_kernels_match_plain(m, k, n, x_dtype, w_dtype):
    """Forward, dx and the STE ds under autograd; zero gradients for w and
    the threshold; scores on the threshold are masked."""
    _need_card()
    from crvqa_tpu_torch.ops import masked_matmul as mm

    g = torch.Generator().manual_seed(m + n)
    x = torch.randn(m, k, generator=g).cuda().to(x_dtype)
    w = (torch.randn(k, n, generator=g) * 0.05).cuda().to(w_dtype)
    s = torch.rand(k, n, generator=g)
    s.view(-1)[::7] = 0.7
    s = s.cuda()
    t = torch.tensor(0.7, device="cuda")
    gy = torch.randn(m, n, generator=g).cuda().to(x_dtype)
    leaves = [v.clone().requires_grad_(True) for v in (x, w, s, t)]
    before = (mm.masked_matmul_fwd.launches, mm.masked_matmul_dx.launches,
              mm.masked_matmul_ds.launches)
    y = mm.masked_matmul(*leaves)
    dx, dw, ds, dt = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    assert (mm.masked_matmul_fwd.launches, mm.masked_matmul_dx.launches,
            mm.masked_matmul_ds.launches) == tuple(b + 1 for b in before)
    assert y.dtype == dx.dtype == x_dtype and ds.dtype == torch.float32
    bf = x_dtype == torch.bfloat16
    _close_to(y, mm.masked_matmul_fwd_reference(x, w, s, t), bf, k)
    _close_to(dx, mm.masked_matmul_dx_reference(gy, w, s, t, x_dtype), bf,
              n)
    _close_to(ds, mm.masked_matmul_ds_reference(x, gy.float(), w),
              w_dtype == torch.bfloat16, m)
    assert not dw.any() and float(dt) == 0.0


def test_masked_matmul_kernels_read_transposed_operands():
    """x as a transposed view and g as a column slice: read in place
    through their strides."""
    _need_card()
    from crvqa_tpu_torch.ops import masked_matmul as mm

    g = torch.Generator().manual_seed(3)
    x = torch.randn(384, 512, generator=g).cuda().T  # [512, 384], strided
    w = torch.randn(384, 256, generator=g).cuda()
    s = torch.rand(384, 256, generator=g).cuda()
    gy = torch.randn(512, 512, generator=g).cuda()[:, :256]
    _close_to(mm.masked_matmul_fwd(x, w, s, 0.5),
              mm.masked_matmul_fwd_reference(x, w, s, 0.5), False, 384)
    _close_to(mm.masked_matmul_dx(gy, w, s, 0.5, x.dtype),
              mm.masked_matmul_dx_reference(gy, w, s, 0.5, x.dtype), False,
              256)
    _close_to(mm.masked_matmul_ds(x, gy, w),
              mm.masked_matmul_ds_reference(x, gy, w), False, 512)


MM_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
             (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]


def _mm_inputs(m, k, n, x_dtype, w_dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).cuda().to(x_dtype)
    w = (torch.randn(k, n, generator=g) * 0.05).cuda().to(w_dtype)
    s = torch.rand(k, n, generator=g)
    s.view(-1)[::7] = 0.7
    gy = torch.randn(m, n, generator=g).cuda().to(x_dtype)
    return x, w, s.cuda(), torch.tensor(0.7, device="cuda"), gy


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (8, 63, 65), (64, 64, 64), (65, 127, 129), (127, 129, 200),
    (200, 8, 63), (129, 200, 1), (63, 65, 8)])
def test_masked_matmul_kernels_at_edge_shapes(m, k, n):
    """Forward, dx and ds under autograd around the 128 x 128 x 64 tiles
    (ragged rows, columns and reduction), every dtype pair, against the
    plain versions with `_close_to`'s tolerance."""
    _need_card()
    from crvqa_tpu_torch.ops import masked_matmul as mm

    for x_dtype, w_dtype in MM_DTYPES:
        x, w, s, t, gy = _mm_inputs(m, k, n, x_dtype, w_dtype, m + k + n)
        leaves = [v.clone().requires_grad_(True) for v in (x, w, s, t)]
        y = mm.masked_matmul(*leaves)
        dx, dw, ds, dt = torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
        bf = x_dtype == torch.bfloat16
        _close_to(y, mm.masked_matmul_fwd_reference(x, w, s, t), bf, k)
        _close_to(dx, mm.masked_matmul_dx_reference(gy, w, s, t, x_dtype),
                  bf, n)
        _close_to(ds, mm.masked_matmul_ds_reference(x, gy.float(), w),
                  w_dtype == torch.bfloat16, m)
        assert not dw.any() and float(dt) == 0.0


@pytest.mark.parametrize("m,k,n", [(9216, 768, 768), (4096, 768, 3072),
                                   (1000, 700, 300)])
def test_masked_matmul_ds_is_deterministic(m, k, n):
    """ds splits its sum over M and adds the splits in order: two calls
    give the same bits, and a bf16 cotangent the bits of its fp32 copy."""
    _need_card()
    from crvqa_tpu_torch.ops import masked_matmul as mm

    for x_dtype, w_dtype in MM_DTYPES:
        x, w, _, _, gy = _mm_inputs(m, k, n, x_dtype, w_dtype, 11)
        a = mm.masked_matmul_ds(x, gy, w)
        b = mm.masked_matmul_ds(x, gy, w)
        c = mm.masked_matmul_ds(x, gy.float(), w)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a, c)


def test_masked_matmul_runs_on_the_wgmma_product_kernel():
    """The profiler names what ran: every dtype pair goes through the
    operand pass and the three TMA + wgmma product instantiations
    (forward, dx, ds) and ds's split reduction, and no masked-matmul call
    runs the old `tile_gemm_kernel`. (Names, not counts: a profiler
    session in a long process can drop a kernel event; chip_smoke.py
    checks the counts of one run.)"""
    _need_card()
    from crvqa_tpu_torch.ops import masked_matmul as mm

    for x_dtype, w_dtype in MM_DTYPES:
        x, w, s, t, gy = _mm_inputs(9216, 768, 768, x_dtype, w_dtype, 2)
        leaves = [v.clone().requires_grad_(True) for v in (x, w, s, t)]
        torch.autograd.grad(mm.masked_matmul(*leaves), leaves, gy)
        torch.cuda.synchronize()

        def run():
            for _ in range(3):
                torch.autograd.grad(mm.masked_matmul(*leaves), leaves, gy)
            torch.cuda.synchronize()

        prof = _profiled(run)
        ran = " ".join(e.key for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        for name in ("wgmma_gemm_kernel<false, true>",
                     "wgmma_gemm_kernel<false, false>",
                     "wgmma_gemm_kernel<true, true>",
                     "masked_operand_pass_kernel", "ds_split_reduce_kernel"):
            assert name in ran, (x_dtype, w_dtype, name, ran)
        assert "tile_gemm_kernel" not in ran


@pytest.mark.parametrize("case", ["x_dtype", "scores_dtype", "device",
                                  "shape"])
def test_masked_matmul_raises_before_any_launch(case):
    """What the kernels do not take raises before any launch, every
    counter unmoved."""
    _need_card()
    from crvqa_tpu_torch.ops import masked_matmul as mm

    x, w, s, t, gy = _mm_inputs(64, 32, 48, torch.bfloat16, torch.bfloat16, 3)
    if case == "x_dtype":
        x, gy = x.half(), gy.half()
    elif case == "scores_dtype":
        s = s.double()
    elif case == "shape":  # x and w do not chain; g and w differ in N
        w, s, gy = w[:-1], s[:-1], gy[:, :-1]
    else:
        w = w.cpu()
    counters = (mm.masked_matmul_fwd, mm.masked_matmul_dx,
                mm.masked_matmul_ds, mm.operand_pass)
    before = [c.launches for c in counters]
    calls = [lambda: mm.masked_matmul_fwd(x, w, s, t),
             lambda: mm.masked_matmul_dx(gy, w, s, t, x.dtype)]
    if case != "scores_dtype":
        calls.append(lambda: mm.masked_matmul_ds(x, gy, w))
    for call in calls:
        with pytest.raises((TypeError, ValueError)):
            call()
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before


def _hc_inputs(m, k, x_dtype, w_dtype, seed, heads=12):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).cuda().to(x_dtype)
    wt = (torch.randn(heads * 64, k, generator=g) * 0.05).cuda().to(w_dtype)
    return x, wt


def _hc_keep(kept, pads, heads=12, seed=0):
    """The heads `kept` in a seeded shuffled order, then `pads` sentinels."""
    g = torch.Generator().manual_seed(seed)
    order = torch.tensor(kept, dtype=torch.int64)[
        torch.randperm(len(kept), generator=g)]
    return torch.cat([order, torch.full((pads,), heads)]).cuda()


def _hc_check(x, wt, keep, heads=12):
    """One kernel call: one launch, and one operand pass for each operand
    TMA cannot read in place; y in x's dtype within `_close_to` of the
    plain version; the dropped heads' columns exactly 0; the same bits
    from a second call."""
    from crvqa_tpu_torch.ops import structured_matmul as sm

    counters = (sm.head_compact_matmul_pallas, sm.operand_pass)
    before = [c.launches for c in counters]
    y = sm.head_compact_matmul_pallas(x, wt, keep, heads, 64, bm=1, bk=1)
    torch.cuda.synchronize()
    passes = sum(sm.rounded_operands(x, wt))
    assert [c.launches for c in counters] == [before[0] + 1,
                                              before[1] + passes]
    assert y.dtype == x.dtype and y.shape == (x.shape[0], heads * 64)
    _close_to(y, sm.head_compact_matmul_pallas_reference(x, wt, keep, heads,
                                                         64),
              x.dtype == torch.bfloat16, x.shape[1])
    kept = torch.zeros(heads, dtype=torch.bool)
    kept[keep[keep < heads].cpu()] = True
    assert not y[:, ~kept.cuda().repeat_interleave(64)].any()
    assert torch.equal(y, sm.head_compact_matmul_pallas(x, wt, keep, heads,
                                                        64, bm=1, bk=1))
    return y


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["kept4", "pad2", "none"])
def test_head_compact_kernel_matches_plain(case, dtype):
    """At the smoke's shape, x [9216, 768], 12 heads: 4 kept, the same
    padded by 2 sentinels, and none kept (2 sentinels)."""
    _need_card()
    from crvqa_tpu_torch.ops import structured_matmul as sm

    x, wt = _hc_inputs(9216, 768, dtype, dtype, 7)
    hm = torch.zeros(12, dtype=torch.bool)
    if case != "none":
        hm[torch.tensor([1, 4, 5, 10])] = True
    n_keep = {"kept4": 4, "pad2": 6, "none": 2}[case]
    _hc_check(x, wt, sm.expand_keep_idx(hm, n_keep).cuda())


@pytest.mark.parametrize("n_kept", range(13))
def test_head_compact_kernel_at_every_kept_count(n_kept):
    """0 to 12 of 12 heads kept, in shuffled order with a pad slot after
    them, so odd counts leave half a slot pair to a pad and even ones a
    whole pair of pads."""
    _need_card()
    x, wt = _hc_inputs(256, 768, torch.bfloat16, torch.bfloat16, n_kept)
    g = torch.Generator().manual_seed(n_kept)
    kept = torch.randperm(12, generator=g)[:n_kept].tolist()
    _hc_check(x, wt, _hc_keep(kept, 1 + n_kept % 2, seed=n_kept))


@pytest.mark.parametrize("m", [1, 8, 63, 64, 65, 127, 129, 200])
def test_head_compact_kernel_at_edge_shapes(m):
    """Rows around the 128-row tile and reductions around the 64-deep step
    (K in {64, 72, 200, 768}), every (x, wt) dtype pair, 5 of 12 heads
    kept out of order with a pad between them."""
    _need_card()
    for k in (64, 72, 200, 768):
        for x_dtype, w_dtype in MM_DTYPES:
            x, wt = _hc_inputs(m, k, x_dtype, w_dtype, m + k)
            keep = torch.tensor([9, 2, 12, 7, 0, 11]).cuda()
            _hc_check(x, wt, keep)


def _hc_unaligned(rows, cols, dtype, offset):
    """A [rows, cols] matrix starting `offset` elements past a 16-byte
    boundary (rows `cols` apart)."""
    buf = torch.randn(rows * cols + offset).cuda().to(dtype)
    return buf[offset:].view(rows, cols)


@pytest.mark.parametrize("case", [
    "x_transposed", "x_row_slice", "x_misaligned", "x_pitch_not_8",
    "wt_transposed", "wt_row_slice", "wt_misaligned", "wt_fp32_column_slice"])
def test_head_compact_kernel_reads_any_layout(case):
    """Transposed views, column slices of wider rows, starts off the
    16-byte grid and pitches TMA cannot take go through the operand pass;
    bf16 row slices on the grid are read in place (`_hc_check` counts the
    passes)."""
    _need_card()
    from crvqa_tpu_torch.ops import structured_matmul as sm

    m, k = 200, 200
    x, wt = _hc_inputs(m, k, torch.bfloat16, torch.bfloat16, 5)
    wide = lambda rows, dt: torch.randn(rows, k + 56).cuda().to(dt)[:, :k]
    x = {"x_transposed": torch.randn(k, m).cuda().bfloat16().T,
         "x_row_slice": wide(m, torch.bfloat16),
         "x_misaligned": _hc_unaligned(m, k, torch.bfloat16, 3),
         "x_pitch_not_8": torch.randn(m, k + 3).cuda().bfloat16()[:, :k]
         }.get(case, x)
    wt = {"wt_transposed": torch.randn(k, 768).cuda().bfloat16().T,
          "wt_row_slice": wide(768, torch.bfloat16),
          "wt_misaligned": _hc_unaligned(768, k, torch.bfloat16, 1),
          "wt_fp32_column_slice": wide(768, torch.float32)}.get(case, wt)
    rounded = sm.rounded_operands(x, wt)
    assert sum(rounded) == (0 if case.endswith("row_slice") else 1), rounded
    _hc_check(x, wt, _hc_keep([3, 8, 1], 1))


def test_head_compact_kernel_reads_keep_on_the_device():
    """A call captured in a CUDA graph follows a new keep list written into
    the same device buffer: nothing about keep is read on the host."""
    _need_card()
    from crvqa_tpu_torch.ops import structured_matmul as sm

    x, wt = _hc_inputs(512, 768, torch.bfloat16, torch.bfloat16, 9)
    keep = torch.tensor([2, 5, 12, 12], dtype=torch.int32).cuda()
    call = lambda: sm.head_compact_matmul_pallas(x, wt, keep, 12, 64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = call()
    for new in ([2, 5, 12, 12], [11, 0, 7, 4], [12, 12, 12, 12]):
        keep.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, sm.head_compact_matmul_pallas(x, wt, keep, 12,
                                                            64)), new


def test_head_compact_runs_on_the_wgmma_kernel():
    """The profiler names what ran: the head-compact TMA + wgmma kernel,
    its operand pass for fp32 operands, and no `tile_gemm_kernel`."""
    _need_card()
    from crvqa_tpu_torch.ops import structured_matmul as sm

    keep = _hc_keep([1, 4, 5, 10], 0)
    for dtype in (torch.bfloat16, torch.float32):
        x, wt = _hc_inputs(9216, 768, dtype, dtype, 2)
        sm.head_compact_matmul_pallas(x, wt, keep, 12, 64)
        torch.cuda.synchronize()

        def run():
            for _ in range(3):
                sm.head_compact_matmul_pallas(x, wt, keep, 12, 64)
            torch.cuda.synchronize()

        prof = _profiled(run)
        ran = " ".join(e.key for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        assert "head_compact_kernel" in ran, (dtype, ran)
        assert ("head_compact_operand_pass_kernel" in ran) == (
            dtype == torch.float32), (dtype, ran)
        assert "tile_gemm_kernel" not in ran


@pytest.mark.parametrize("case", ["dtype", "device", "shape", "head_size"])
def test_head_compact_kernel_raises_before_any_launch(case):
    """What the kernel does not take raises before any launch, both
    counters unmoved."""
    _need_card()
    from crvqa_tpu_torch.ops import structured_matmul as sm

    x, wt = _hc_inputs(64, 64, torch.float32, torch.float32, 3)
    heads, hs = 12, 64
    if case == "dtype":
        x = x.half()
    elif case == "device":
        wt = wt.cpu()
    elif case == "shape":
        wt = wt[:, :-8]
    else:
        heads, hs = 24, 32
    counters = (sm.head_compact_matmul_pallas, sm.operand_pass)
    before = [c.launches for c in counters]
    with pytest.raises((TypeError, ValueError)):
        sm.head_compact_matmul_pallas(x, wt, _hc_keep([1], 1), heads, hs,
                                      bm=1, bk=1)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before


def test_stage3_structured_step_at_six_heads_keeps_masks_zero():
    """A full-width stage-3 step on the compacted model (6 language heads,
    FFN 1536) with a constant mask on the rest: the short kernels run at
    H = 6 and H = 12, 34 forward-for-grad and 32 backward launches, and
    the masked weights stay exactly 0."""
    _need_card()
    import numpy as np

    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.masking import compaction
    from crvqa_tpu_torch.masking.masker import magnitude_masks
    from crvqa_tpu_torch.train import stage1
    from crvqa_tpu_torch.train.stage2 import lxmert_meta_model

    config = LxmertConfig(dtype=torch.bfloat16)
    params = cli_common.lxmert_initial_params(config, 0, None)
    rng = np.random.default_rng(0)
    head = np.stack([rng.permutation(np.arange(12) < 6) for _ in range(9)])
    ffn = np.stack([rng.permutation(np.arange(3072) < 1536)
                    for _ in range(9)])
    params, nh = compaction.compact_lang_heads(params, head, 64)
    params, ni = compaction.compact_lang_ffns(params, ffn)
    small = LxmertConfig(dtype=torch.bfloat16, lang_num_heads=nh,
                         lang_intermediate_size=ni)
    assert (nh, ni) == (6, 1536)
    masker = cli_common.lxmert_uniform_masker(config, 0.7)
    specs = [s for s in masker.specs if ".encoder.layer." not in s.torch_name]
    masks = magnitude_masks(params, specs, masker.zerorate_dict)
    params = {k: v * masks[k] if k in masks else v for k, v in params.items()}
    cfg = stage1.Stage1Config(ft_type="lmh", warmup_steps=0,
                              hidden_size=768)
    state, tx = stage1.init_state(params, cfg, 0, "cuda", masks=masks)
    batch = to_device(synthetic_batch(batch_size=64, seed=0),
                      torch.device("cuda"), float_dtype=torch.bfloat16)
    step = stage1.make_train_step(lxmert_meta_model(small), cfg, tx)
    heads_seen = set()
    launch = fa._launch_fwd_train

    def spy(q, k, v, bias, num_heads, *rest):
        heads_seen.add(num_heads)
        return launch(q, k, v, bias, num_heads, *rest)

    fa._launch_fwd_train = spy
    try:
        before = (fa.fused_attention_fwd_train.launches,
                  fa.fused_attention_bwd_stored.launches)
        for _ in range(2):
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
    finally:
        fa._launch_fwd_train = launch
    assert heads_seen == {6, 12}
    assert (fa.fused_attention_fwd_train.launches - before[0],
            fa.fused_attention_bwd_stored.launches - before[1]) == (68, 64)
    assert torch.isfinite(metrics.loss)
    for name, m in masks.items():
        assert not state.params[name][~m.cuda()].any(), name


# ------------------------------------------------- VisualBERT's single stream

VB_SHAPE = (50, 50)  # 14 text tokens + 36 boxes, 12 heads


def _one_hot(b, n, heads, dtype):
    """[b, n, heads*64] with row r one at column h*64 + r of every head."""
    return (torch.eye(n, 64).repeat(1, heads).expand(b, n, heads * 64)
            .contiguous().cuda().to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_kernels_at_visualbert_shape(dtype):
    """(50, 50) at 12 heads, rows over the 48 keys the bf16 backward takes
    in one chunk: every short kernel against its plain version at dropout
    0 and 0.1; the keep mask each kernel applies, read out through one-hot
    v (forward) and one-hot g (dv of both backwards), equal to `keep_mask`
    bit for bit; the p the recompute backward rebuilds (dv at rate 0) equal
    to the forward's fp32 residual (bf16: to its bf16 rounding)."""
    _need_card()
    heads, (sq, sk), b = 12, VB_SHAPE, 8
    fwd_tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
               else BF16_TOL)
    bwd_tol = (dict(atol=1e-4, rtol=0) if dtype == torch.float32
               else BF16_TOL)
    for rate in (0.0, 0.1):
        q, k, v, bias = _inputs(b, sq, sk, dtype, seed=50 + int(10 * rate))
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)
                        ).cuda().to(dtype)
        args = (heads, 64, rate, -7)
        if rate == 0.0:
            out = fa.fused_attention(q, k, v, bias, heads, 64)
            ref = fa.fused_attention_reference(q, k, v, bias, heads, 64)
            torch.testing.assert_close(out.float(), ref.float(), **fwd_tol)
        out, p = fa.fused_attention_fwd_train(q, k, v, bias, *args)
        ref, pref = fa.fused_attention_train_reference(q, k, v, bias, *args)
        torch.testing.assert_close(out.float(), ref.float(), **fwd_tol)
        torch.testing.assert_close(p, pref, atol=1e-6, rtol=0)
        want = fa.fused_attention_bwd_reference(q, k, v, p, g, *args)
        stored = fa.fused_attention_bwd_stored(q, k, v, p, g, *args)
        recomp = fa.fused_attention_bwd_recompute(q, k, v, bias, g, *args)
        for name, a, r in zip("qkv", stored + recomp, want + want):
            torch.testing.assert_close(a.float(), r.float(), **bwd_tol,
                                       msg=lambda m: f"d{name}: {m}")
        if dtype == torch.bfloat16:
            for a, r in zip(stored, recomp):
                assert torch.equal(a, r)

    q, k, _, _ = _inputs(b, sq, sk, dtype, seed=7)
    bias = torch.zeros(b, sk, device="cuda")
    v, go = _one_hot(b, sk, heads, dtype), _one_hot(b, sq, heads, dtype)
    by_row = lambda dv: dv.view(b, sk, heads, 64)[..., :sq].permute(0, 3, 2, 1)
    args = (heads, 64, 0.1, -7)
    keep = fa.keep_mask(torch.arange(b, device="cuda"), sq, heads * sk, 0.1,
                        -7).view(b, sq, heads, sk)
    out, p = fa.fused_attention_fwd_train(q, k, v, bias, *args)
    assert torch.equal(out.view(b, sq, heads, 64)[..., :sk] != 0, keep)
    dv = fa.fused_attention_bwd_stored(q, k, v, p, go, *args)[2]
    assert torch.equal(by_row(dv) != 0, keep)
    dv = fa.fused_attention_bwd_recompute(q, k, v, bias, go, *args)[2]
    assert torch.equal(by_row(dv) != 0, keep)
    _, p0 = fa.fused_attention_fwd_train(q, k, v, bias, heads, 64, 0.0, 0)
    dv = fa.fused_attention_bwd_recompute(q, k, v, bias, go, heads, 64, 0.0,
                                          0)[2]
    assert torch.equal(by_row(dv), p0.view(b, sq, heads, sk).to(dtype))


def _visualbert_inputs(b=4, vocab=64):
    g = torch.Generator().manual_seed(2)
    return dict(input_ids=torch.randint(1, vocab, (b, 14), generator=g).cuda(),
                visual_embeds=torch.randn(b, 36, 2048, generator=g).cuda(),
                attention_mask=torch.ones(b, 14, device="cuda"))


def test_visualbert_forward_kernel_matches_plain():
    """A 2-layer VisualBERT at full width (768 hidden, 12x64 heads, 2048-d
    visual features) in fp32, batch 4: the forward through the kernel (one
    launch a layer at (50, 50)) agrees with the same model on the plain
    attention."""
    _need_card()
    from crvqa_tpu_torch.models import VisualBertConfig, build_visualbert

    cfg = VisualBertConfig(vocab_size=64, num_hidden_layers=2, ans_num=16)
    model = build_visualbert(cfg, "cpu", torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    inputs = _visualbert_inputs()
    before = fa.fused_attention.launches
    with torch.inference_mode():
        logits, _ = model(**inputs)
    assert fa.fused_attention.launches == before + 2

    def plain(q, k, v, bias, num_heads, head_size, rate=0.0, seed=0,
              row0=0, head0=0):
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


def test_visualbert_train_step_kernels_match_plain_versions():
    """One VisualBERT stage-2 step (uniform zero rate 0.7, LMH, the head
    under `cls`) of 2 layers at full width, fp32, dropout on, through the
    kernels (2 forward-for-grad and 2 stored-backward launches) and
    through the plain versions from the same generators: loss within 1e-5
    relative, score gradients within 1e-3 of their largest."""
    _need_card()
    from crvqa_tpu_torch.cli.common import visualbert_uniform_masker
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.models import VisualBertConfig, build_visualbert
    from crvqa_tpu_torch.train import stage2

    cfg = VisualBertConfig(vocab_size=64, num_hidden_layers=2, ans_num=16)
    masker = visualbert_uniform_masker(cfg, 0.7, controlled_init="magnitude")
    params = build_visualbert(cfg, "cpu",
                              torch.Generator().manual_seed(0)).state_dict()
    sc = stage2.Stage2Config(masker_type="lmh", hidden_size=768,
                             classifier_key="cls")
    model = stage2.visualbert_meta_model(cfg)
    state, _ = stage2.init_state(model, masker, params, sc, 0, "cuda")
    batch = to_device(synthetic_batch(batch_size=8, vocab_size=64, ans_num=16,
                                      seed=1, style="visualbert"),
                      torch.device("cuda"))
    fn = stage2.make_loss_and_grads(model, masker, sc)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    fwd, bwd = fa.fused_attention_fwd_train, fa.fused_attention_bwd_stored
    before = (fwd.launches, bwd.launches)
    loss_k, _, grads_k = fn(state, batch)
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (2, 2)
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])

    def plain(q, k, v, bias, num_heads, head_size, rate=0.0, seed=0,
              row0=0, head0=0):
        return fa.fused_attention_train_reference(
            q, k, v, bias, num_heads, head_size, rate, seed, row0, head0)[0]

    saved = layers.fused_attention
    layers.fused_attention = plain
    try:
        loss_p, _, grads_p = fn(state, batch)
    finally:
        layers.fused_attention = saved
    assert fwd.launches - before[0] == 2
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    scores = [k for k in grads_k if k.startswith("scores/")]
    gmax = max(grads_p[k].abs().max().item() for k in scores)
    for k in scores:
        torch.testing.assert_close(grads_k[k], grads_p[k], rtol=0,
                                   atol=1e-3 * gmax, msg=k)


# ----------------------------------------------- structured mask training

def test_structured_stage2_step_launch_counts():
    """One structured ("heads") stage-2 step of a 1/1/1-layer LXMERT at
    full width, bf16, through the kernels: 6 forward-for-grad and 4
    stored-backward launches (the last cross layer's visual branch never
    reaches the logits), (12,) gates on the 'self' specs, a finite loss
    and moved gates."""
    _need_card()
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.masking.structured import StructuredMasker
    from crvqa_tpu_torch.train import stage2

    cfg = LxmertConfig(vocab_size=64, l_layers=1, r_layers=1, x_layers=1,
                       ans_num=16, dtype=torch.bfloat16)
    masker = StructuredMasker.create(
        lxmert_mask_specs(1, 1, 1),
        ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7),
        controlled_init="magnitude", structured_masking="heads")
    params = build_lxmert(LxmertConfig(vocab_size=64, l_layers=1,
                                       r_layers=1, x_layers=1, ans_num=16),
                          "cpu", torch.Generator().manual_seed(0)
                          ).state_dict()
    sc = stage2.Stage2Config(masker_type="lmh", hidden_size=768,
                             learning_rate=1e-2)
    model = stage2.lxmert_meta_model(cfg)
    state, tx = stage2.init_state(model, masker, params, sc, 0, "cuda")
    state = stage2.make_threshold_reset(masker)(state)
    gates = {k: v.detach().clone() for k, v in state.scores.items()
             if tuple(v.shape) == (12,)}
    assert sorted(gates) == sorted(s.key for s in masker.specs
                                   if masker._is_structured(s))
    batch = to_device(synthetic_batch(batch_size=8, vocab_size=64,
                                      ans_num=16, seed=1),
                      torch.device("cuda"), float_dtype=torch.bfloat16)
    fwd, bwd = fa.fused_attention_fwd_train, fa.fused_attention_bwd_stored
    before = (fwd.launches, bwd.launches)
    state, metrics = stage2.make_train_step(model, masker, tx, sc)(state,
                                                                    batch)
    torch.cuda.synchronize()
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (6, 4)
    assert torch.isfinite(metrics.loss)
    assert any(not torch.equal(state.scores[k], g) for k, g in gates.items())


def test_scan_layout_forward_and_step_are_the_unrolled_ones():
    """The scan layout (`--scan_layers`) of a 2/1/1-layer LXMERT at full
    width, bf16, on the card: a forward at batch 8 and one stage-2 train
    step (dropout on, from one seed) launch the same kernels as the
    unrolled model, and give its logits, loss and trained scores bit for
    bit."""
    _need_card()
    from torch.func import functional_call

    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import (lxmert_mask_specs,
                                              lxmert_scan_mask_specs)
    from crvqa_tpu_torch.models.lxmert_scan import stack_params
    from crvqa_tpu_torch.train import stage2

    dims = dict(vocab_size=64, l_layers=2, r_layers=1, x_layers=1,
                ans_num=16)
    cfg = LxmertConfig(dtype=torch.bfloat16, **dims)
    params = build_lxmert(LxmertConfig(**dims), "cpu",
                          torch.Generator().manual_seed(0)).state_dict()
    batch = to_device(synthetic_batch(batch_size=8, vocab_size=64,
                                      ans_num=16, seed=1),
                      torch.device("cuda"), float_dtype=torch.bfloat16)
    inputs = {k: batch[k] for k in ("input_ids", "visual_feats",
                                    "visual_pos")}
    counters = (fa.fused_attention, fa.fused_attention_fwd_train,
                fa.fused_attention_bwd_stored)
    rates = ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7)
    sc = stage2.Stage2Config(masker_type="lmh", hidden_size=768,
                             learning_rate=1e-2)
    out = {}
    for scan in (False, True):
        layout = stack_params(params, cfg) if scan else params
        model = stage2.lxmert_meta_model(cfg, scan=scan).eval()
        before = [c.launches for c in counters]
        dtypes = stage2.param_dtypes(model)
        logits = functional_call(model, {k: v.cuda().to(dtypes[k])
                                         for k, v in layout.items()}, (),
                                 inputs)[0]
        specs = (lxmert_scan_mask_specs(2, 1, 1) if scan
                 else lxmert_mask_specs(2, 1, 1))
        masker = Masker.create(specs, rates, controlled_init="magnitude")
        state, tx = stage2.init_state(model, masker, layout, sc, 0, "cuda")
        state, metrics = stage2.make_train_step(model, masker, tx, sc)(
            state, batch)
        torch.cuda.synchronize()
        out[scan] = (logits, metrics.loss, state.scores,
                     [c.launches - b for c, b in zip(counters, before)])
    lu, loss_u, scores_u, launches_u = out[False]
    ls, loss_s, scores_s, launches_s = out[True]
    # 2 + 1 + 4 attentions a forward; the last cross layer's visual
    # branch (2 of them) never reaches the logits, so has no backward
    assert launches_s == launches_u == [7, 7, 5]
    assert torch.equal(ls, lu) and torch.equal(loss_s, loss_u)
    names = {s.torch_name: s.key for s in lxmert_mask_specs(2, 1, 1)}
    for s in lxmert_scan_mask_specs(2, 1, 1):
        want = (torch.stack([scores_u[names[s.torch_name.format(i)]]
                             for i in range(s.stacked)]) if s.stacked
                else scores_u[names[s.torch_name]])
        assert torch.equal(scores_s[s.key], want), s.key


def test_profile_window_traces_the_active_steps_kernels(tmp_path):
    """`ProfileWindow` on the card (start 2, 2 steps): the session opens
    at tick 1 and discards step 2 as its warm-up; the Chrome trace holds
    the primal attention kernel of steps 3 and 4 and of no other step."""
    _need_card()
    import argparse
    import json

    from crvqa_tpu_torch.cli.common import ProfileWindow

    args = argparse.Namespace(profile_dir=str(tmp_path), device="cuda",
                              profile_start_step=2, profile_steps=2)
    window = ProfileWindow(args)
    q, k, v, bias = _inputs(4, 14, 14, torch.bfloat16)
    before = fa.fused_attention.launches
    for step in range(1, 8):
        fa.fused_attention(q, k, v, bias, 12, 64)
        window.tick(step)
    window.close()
    assert fa.fused_attention.launches - before == 7
    events = json.load(open(window.path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "fused_attention" in e.get("name", "")]
    assert len(kernels) == 2


# ------------------------------------------ the runtime's mask offsets

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_kernels_are_the_global_kernels_sliced(dtype):
    """A data-parallel rank's rows (row0) and a tensor-parallel rank's
    heads (head0), run alone through the training kernels: the forward's
    output and residual, and both backwards, equal the same slice of the
    whole batch's run (every (row, head) block is computed alone, so bit
    for bit), the short kernels at LXMERT's (36, 36) and the mid-length
    ones at (577, 577), dropout 0.1."""
    _need_card()
    from crvqa_tpu_torch.ops import midseq_attention as ma

    rows, cols = slice(4, 8), slice(6 * 64, 12 * 64)  # rows 4-7, heads 6-11
    part = lambda t: t[rows, :, cols].contiguous()
    for sq, sk, fwd, bwd in (
            (36, 36, lambda *a, **o: fa.fused_attention_fwd_train(*a, **o),
             fa.fused_attention_bwd_recompute),
            (577, 577, lambda *a, **o: (ma.midseq_attention(*a, **o), None),
             ma.midseq_attention_bwd)):
        q, k, v, bias = _inputs(8, sq, sk, dtype, seed=sq)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                        ).cuda().to(dtype)
        out, p = fwd(q, k, v, bias, 12, 64, 0.1, -99)
        grads = bwd(q, k, v, bias, g, 12, 64, 0.1, -99)
        pq, pk, pv, pg = part(q), part(k), part(v), part(g)
        out2, p2 = fwd(pq, pk, pv, bias[rows].contiguous(), 6, 64, 0.1, -99,
                       row0=4, head0=6)
        grads2 = bwd(pq, pk, pv, bias[rows].contiguous(), pg, 6, 64, 0.1,
                     -99, row0=4, head0=6)
        assert torch.equal(out2, out[rows, :, cols])
        if p is not None:
            whole = p.view(8, sq, 12, sk)[rows, :, 6:]
            assert torch.equal(p2.view(4, sq, 6, sk), whole)
        for a, b in zip(grads2, grads):
            assert torch.equal(a, b[rows, :, cols])
        # and against the plain versions with the same offsets
        ref = (fa.fused_attention_train_reference(
            pq, pk, pv, bias[rows], 6, 64, 0.1, -99, 4, 6)[0] if p is not None
            else ma.midseq_attention_reference(pq, pk, pv, bias[rows], 6, 64,
                                               0.1, -99, 4, 6))
        tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
               else dict(atol=2e-2, rtol=2e-2))
        torch.testing.assert_close(out2.float(), ref.float(), **tol)


def test_offset_keep_bits_are_the_global_keep_mask():
    """The short forward-for-grad kernel's keep bits with row0 and head0,
    read out through one-hot v (output column h*64 + k is the dropped
    probability of key k; bias 0, so nonzero iff kept), equal the plain
    `keep_mask` of those global rows and heads bit for bit."""
    _need_card()
    b, sq, sk, heads, row0, head0 = 4, 36, 36, 6, 12, 6
    g = torch.Generator().manual_seed(5)
    q = torch.randn(b, sq, heads * 64, generator=g).cuda()
    k = torch.randn(b, sk, heads * 64, generator=g).cuda()
    v = (torch.eye(sk, 64)[None].repeat(1, 1, heads).expand(b, sk, -1)
         .contiguous().cuda())
    out, _ = fa.fused_attention_fwd_train(q, k, v, torch.zeros(b, sk).cuda(),
                                          heads, 64, 0.1, 1234, row0=row0,
                                          head0=head0)
    keep = out.view(b, sq, heads, 64)[..., :sk] != 0
    want = fa.keep_mask(torch.arange(row0, row0 + b).cuda(), sq, heads * sk,
                        0.1, 1234, col0=head0 * sk).view(b, sq, heads, sk)
    assert torch.equal(keep, want)


# ------------------------------- output-block epilogue (residual LayerNorm)
#
# The kernels against the eager chain (`residual_layernorm.plain`) from the
# same generators. Both round z alike; the row statistics and the
# LayerNorm backward's sums run in another order, so each output and dz
# lies within one step of its dtype (bf16: one step at the larger of the
# two values' binades; fp32: 1e-5 relative) plus 1e-4 of the largest (fp32
# cancellation in W * gg - s1 - xh * s2). dy = T(dz * inv_keep) rounds
# twice, so a step of dz reaches two steps of dy. The weight and bias
# gradients sum up to 2048 x 50 rows in fp32 in another order: 1e-4
# relative.

EPILOGUE_SHAPES = [(2048, 14), (2048, 36), (2048, 50), (1, 13)]


def _ulp_close(got, want, dtype, what, steps=1):
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
        tol = steps * torch.exp2(torch.floor(torch.log2(big)) - 7)
    else:
        tol = 1e-5 * want.abs()
    err = (got - want).abs()
    assert bool((err <= tol + 1e-4 * want.abs().max()).all()), (
        what, err.max().item())


def _epilogue_inputs(b, s, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(b, s, 768, generator=g).cuda().to(dtype)
    res = torch.randn(b, s, 768, generator=g).cuda().to(dtype)
    w = (1.0 + 0.3 * torch.randn(768, generator=g)).cuda()
    bias = (0.3 * torch.randn(768, generator=g)).cuda()
    go = torch.randn(b, s, 768, generator=g).cuda().to(dtype)
    return y, res, w, bias, go


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", EPILOGUE_SHAPES)
def test_residual_layernorm_kernels_match_eager_chain(b, s, dtype, rate):
    """One forward and one backward launch at LXMERT's and VisualBERT's
    stage-2 sites and a 13-row call: the output and the gradients of y, the
    residual, the weight and the bias against autograd of the eager chain
    from a generator in the same state; the generator's offset after the
    call is the eager chain's; dy is zero exactly where the draw drops
    (or dz is 0: W * gg - s1 - xh * s2 cancels to exactly 0 in fp32 at a
    few of 10^7 elements, in either chain at its own)."""
    _need_card()
    from crvqa_tpu_torch.ops import residual_layernorm as rl

    y, res, w, bias, go = _epilogue_inputs(b, s, dtype, seed=b + s)
    leaves = [t.clone().requires_grad_() for t in (y, res, w, bias)]
    gen = torch.Generator("cuda").manual_seed(7)
    before = (rl.residual_layernorm.launches,
              rl.residual_layernorm_bwd.launches)
    out = rl.residual_layernorm(*leaves, 1e-12, rate, gen)
    out.backward(go)
    torch.cuda.synchronize()
    assert (rl.residual_layernorm.launches - before[0],
            rl.residual_layernorm_bwd.launches - before[1]) == (1, 1)
    ref_leaves = [t.clone().requires_grad_() for t in (y, res, w, bias)]
    ref_gen = torch.Generator("cuda").manual_seed(7)
    r = (torch.rand(y.shape, generator=ref_gen, device="cuda") if rate
         else None)
    want = rl.plain(ref_leaves[0], ref_leaves[1], r, ref_leaves[2],
                    ref_leaves[3], 1e-12, rate)
    want.backward(go)
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert out.dtype == dtype and out.shape == y.shape
    _ulp_close(out, want, dtype, "out")
    _ulp_close(leaves[0].grad, ref_leaves[0].grad, dtype, "y", steps=2)
    _ulp_close(leaves[1].grad, ref_leaves[1].grad, dtype, "residual")
    for got, ref, name in zip(leaves[2:], ref_leaves[2:], ("weight", "bias")):
        torch.testing.assert_close(got.grad, ref.grad, rtol=1e-4,
                                   atol=1e-4 * ref.grad.abs().max().item(),
                                   msg=name)
    if rate:  # dy = keep ? T(dz * inv_keep) : 0, and dz is the residual's
        assert torch.equal(leaves[0].grad == 0, (r >= 1.0 - rate)
                           | (leaves[1].grad == 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_layernorm_keep_mask_is_the_eager_draw(dtype):
    """The forward kernel's saved keep mask is `torch.rand(...) < keep_prob`
    bit for bit, z is the eager chain's rounded sum bit for bit, and mean
    and rstd are those of z."""
    _need_card()
    from crvqa_tpu_torch.ops import residual_layernorm as rl

    y, res, w, bias, _ = _epilogue_inputs(2048, 36, dtype, seed=3)
    r = torch.rand(y.shape, generator=torch.Generator("cuda").manual_seed(1),
                   device="cuda")
    out, z, keep, mean, rstd = rl._launch_fwd(y, res, r, w, bias, 0.1, 1e-12,
                                              save=True)
    assert keep.dtype == torch.bool and torch.equal(keep, r < 0.9)
    want_z = torch.where(r < 0.9, y / 0.9,
                         torch.zeros((), dtype=dtype, device="cuda")) + res
    assert torch.equal(z, want_z)
    zf = z.float().view(-1, 768)
    torch.testing.assert_close(mean, zf.mean(-1), rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, torch.rsqrt(zf.var(-1, unbiased=False)
                                                 + 1e-12), rtol=1e-5, atol=0)


def test_residual_layernorm_eval_writes_only_the_output():
    """Without gradients (eval, serving, the KD teacher) one forward launch
    and no backward; the output is the eager chain's."""
    _need_card()
    from crvqa_tpu_torch.ops import residual_layernorm as rl

    y, res, w, bias, _ = _epilogue_inputs(64, 36, torch.bfloat16, seed=4)
    before = (rl.residual_layernorm.launches,
              rl.residual_layernorm_bwd.launches)
    with torch.inference_mode():
        out = rl.residual_layernorm(y, res, w, bias, 1e-12)
    assert (rl.residual_layernorm.launches - before[0],
            rl.residual_layernorm_bwd.launches - before[1]) == (1, 0)
    _ulp_close(out, rl.plain(y, res, None, w, bias, 1e-12, 0.0),
               torch.bfloat16, "out")


def test_residual_layernorm_checkpointed_recompute_is_identical():
    """An FFN output block at full width, bf16, dropout on, under
    `layers.checkpointed`: the recompute redraws the same mask, so the
    gradients equal the stored run's bit for bit (two forward launches,
    one backward)."""
    _need_card()
    from crvqa_tpu_torch.ops import residual_layernorm as rl

    block = layers.FFNOutput(3072, 768, 0.1, torch.bfloat16)
    layers.init_weights_(block, torch.Generator().manual_seed(0))
    block = block.cuda().train()
    g = torch.Generator().manual_seed(1)
    hidden = torch.randn(256, 36, 3072, generator=g).cuda().bfloat16()
    residual = torch.randn(256, 36, 768, generator=g).cuda().bfloat16()
    go = torch.randn(256, 36, 768, generator=g).cuda().bfloat16()
    grads = []
    for checkpoint in (False, True):
        layers.set_generators(block, torch.Generator("cuda").manual_seed(3),
                              torch.Generator().manual_seed(3))
        h, r = (t.clone().requires_grad_() for t in (hidden, residual))
        block.zero_grad(set_to_none=True)
        before = (rl.residual_layernorm.launches,
                  rl.residual_layernorm_bwd.launches)
        out = (layers.checkpointed(block, h, r) if checkpoint
               else block(h, r))
        out.backward(go)
        assert (rl.residual_layernorm.launches - before[0],
                rl.residual_layernorm_bwd.launches - before[1]) == (
            1 + checkpoint, 1)
        grads.append([h.grad, r.grad, block.dense.weight.grad,
                      block.LayerNorm.weight.grad, block.LayerNorm.bias.grad])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["width", "dtype", "weight_dtype", "shape"])
def test_residual_layernorm_raises_on_what_it_does_not_take(case):
    """A width the kernels were not built for, fp16, bf16 LayerNorm
    parameters, a residual of another shape: raised before any launch."""
    _need_card()
    from crvqa_tpu_torch.ops import residual_layernorm as rl

    width = 512 if case == "width" else 768
    dtype = torch.float16 if case == "dtype" else torch.bfloat16
    y = torch.randn(4, 14, width, device="cuda", dtype=dtype)
    res = torch.randn(4, 7 if case == "shape" else 14, width, device="cuda",
                      dtype=dtype)
    w = torch.ones(width, device="cuda", dtype=torch.bfloat16
                   if case == "weight_dtype" else torch.float32)
    bias = torch.zeros(width, device="cuda")
    before = rl.residual_layernorm.launches
    with pytest.raises((ValueError, TypeError)):
        rl.residual_layernorm(y, res, w, bias, 1e-12)
    assert rl.residual_layernorm.launches == before


def _stage2_full_depth(model_name):
    """(loss-and-grads fn, state, batch) of a full-depth stage-2 step at
    full width, fp32, batch 8: LXMERT 9/5/5 or VisualBERT 12 layers."""
    from crvqa_tpu_torch.cli.common import visualbert_uniform_masker
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.models import VisualBertConfig, build_visualbert
    from crvqa_tpu_torch.train import stage2

    gen = torch.Generator().manual_seed(0)
    if model_name == "lxmert":
        cfg = LxmertConfig(vocab_size=64, ans_num=16)
        masker = Masker.create(
            lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers),
            ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7),
            controlled_init="magnitude")
        params = build_lxmert(cfg, "cpu", gen).state_dict()
        sc = stage2.Stage2Config(masker_type="lmh", hidden_size=768)
        model = stage2.lxmert_meta_model(cfg)
        style = {}
    else:
        cfg = VisualBertConfig(vocab_size=64, ans_num=16)
        masker = visualbert_uniform_masker(cfg, 0.7,
                                           controlled_init="magnitude")
        params = build_visualbert(cfg, "cpu", gen).state_dict()
        sc = stage2.Stage2Config(masker_type="lmh", hidden_size=768,
                                 classifier_key="cls")
        model = stage2.visualbert_meta_model(cfg)
        style = dict(style="visualbert")
    state, _ = stage2.init_state(model, masker, params, sc, 0, "cuda")
    batch = to_device(synthetic_batch(batch_size=8, vocab_size=64,
                                      ans_num=16, seed=1, **style),
                      torch.device("cuda"))
    return stage2.make_loss_and_grads(model, masker, sc), state, batch


@pytest.mark.parametrize("model_name,fwd,bwd", [("lxmert", 58, 55),
                                                ("visualbert", 24, 24)])
def test_stage2_step_runs_the_epilogue_kernels_at_every_site(model_name, fwd,
                                                             bwd):
    """A full-depth stage-2 step launches the forward kernel at every
    output block (LXMERT: 18 language, 10 visual, 30 cross sites; the
    shared cross attention's output block runs twice) and the backward at
    every one that reaches the loss (not the last cross layer's three
    visual sites); VisualBERT 24 and 24. Loss and score gradients agree
    with the same step on the eager epilogue, from the same generators:
    loss within 1e-5 relative, score gradients within 1e-3 of their
    largest."""
    _need_card()
    from crvqa_tpu_torch.ops import residual_layernorm as rl

    fn, state, batch = _stage2_full_depth(model_name)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    before = (rl.residual_layernorm.launches,
              rl.residual_layernorm_bwd.launches)
    loss_k, _, grads_k = fn(state, batch)
    torch.cuda.synchronize()
    assert (rl.residual_layernorm.launches - before[0],
            rl.residual_layernorm_bwd.launches - before[1]) == (fwd, bwd)
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])
    saved = layers.residual_layernorm
    layers.residual_layernorm = (
        lambda *a, kernels=True: rl.residual_layernorm(*a, kernels=False))
    try:
        loss_p, _, grads_p = fn(state, batch)
    finally:
        layers.residual_layernorm = saved
    assert rl.residual_layernorm.launches - before[0] == fwd
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    scores = [k for k in grads_k if k.startswith("scores/")]
    gmax = max(grads_p[k].abs().max().item() for k in scores)
    for k in scores:
        torch.testing.assert_close(grads_k[k], grads_p[k], rtol=0,
                                   atol=1e-3 * gmax, msg=k)


def test_mplug_step_at_published_widths_launches_and_records():
    """One bf16 mPLUG mask step of the benchmark's program
    (`portbench/families/mplug.py`, the `vqa_mplug` CLI's objects) at the
    published widths and the cell's batch of 128: 30 mid-length forward
    launches (12 ViT, 5 fusion cross, the stride layer, 12 decoder cross)
    and 29 backward (the ViT's first block has no gradient); the spans'
    tree, each with device time, the step's children covering at least
    98% of it (the host's work between them can leave the card idle
    inside the step; the benchmark's traced run reports the coverage of
    its recorded steps, 99.3-99.6%)."""
    _need_card()
    from crvqa_tpu_torch.ops.midseq_attention import (midseq_attention,
                                                      midseq_attention_bwd)
    from crvqa_tpu_torch.train import mplug_train
    from crvqa_tpu_torch.utils import profiling
    from portbench.families import mplug as family
    from portbench.harness.cells import Benchmark
    from portbench.harness.inputs import make_weights
    from portbench.harness.mplug_inputs import make_pool
    from portbench.reference import mplug as ref

    bench, seed = Benchmark(), 2718281829
    cfg = bench.config("mplug-base")
    trf = dict(bench.traffic("mplug-mask-b128"), pool_batches=1)
    prog = family.build(cfg, trf, make_weights(ref.param_table(cfg), seed,
                                               "cuda"), seed, "cuda")
    batch = make_pool(cfg, trf, seed, "cuda")[0]
    step = mplug_train.make_train_step(prog.model, prog.config, prog.masker)
    for _ in range(3):  # builds the kernels, then steady steps
        step(prog.state, batch)
    fwd, bwd = midseq_attention.launches, midseq_attention_bwd.launches
    profiling.tracing(True)
    try:
        step(prog.state, batch)
    finally:
        profiling.tracing(False)
    torch.cuda.synchronize()
    recs = profiling.spans()
    profiling.clear()
    assert midseq_attention.launches - fwd == 30
    assert midseq_attention_bwd.launches - bwd == 29
    assert [(r.name, r.parent) for r in recs] == [
        ("train_step", None), ("mask_apply", 0), ("forward", 0),
        ("visual_encoder", 2), ("text_fusion", 2), ("decoder", 2),
        ("backward", 0), ("optimizer", 0)]
    assert all(r.device_ms is not None and r.device_ms >= 0 for r in recs)
    kids = sum(r.device_ms for r in recs if r.parent == 0)
    assert kids >= 0.98 * recs[0].device_ms, (kids, recs[0].device_ms)
