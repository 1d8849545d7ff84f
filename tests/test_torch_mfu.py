"""The port's MFU accounting (crvqa_tpu_torch/utils/mfu.py) on the CPU:

- the peak table by the card names `torch.cuda.get_device_name()` gives
  (H100 SXM5, PCIe, NVL; an unknown card raises and names it) and `mfu`'s
  math and None, as tests/test_mfu.py checks the JAX package's;
- `count_flops` on the `meta` device: a plain matmul counts exactly
  2*M*K*N; each kernel wrapper's plain path counts exactly the model's
  work, 4 * B*H*Sq*Sk*D forward and 8 backward for the short pair (both
  `BWD_IMPL`s) and the mid-length pair at mPLUG's (577, 577) and (1, 602),
  2*M*K*N per product for the masked and head-compact matmuls, and
  launches no kernel;
- a `make_multi_step` window of 3 counts 3 steps (the JAX package's
  `lax.scan` window counts its body once), batch 2 counts twice batch 1,
  and a checkpointed mPLUG step counts the same as a plain one (its
  recompute counts on the CPU, not on `meta`);
- one LXMERT forward and backward at hidden 256 (2/1/1 layers, batch 2,
  14 tokens, 36 boxes) counts exactly the matmuls worked out from the
  config. The JAX package's `lowered_flops` of the same function counts
  11.9% less here: XLA drops the last cross layer's dead visual branch,
  whose forward torch computes (14.1% of the port's count at one cross
  layer), and counts the elementwise work (softmax, layer norms,
  activations, the weight norm: +2.2%). So XLA's count lies between the
  port's count without the dead branch and 3% above it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.utils.mfu import lowered_flops
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.models import LxmertConfig, build_lxmert
from crvqa_tpu_torch.ops import fused_attention as fa
from crvqa_tpu_torch.ops import masked_matmul as mm
from crvqa_tpu_torch.ops import midseq_attention as ms
from crvqa_tpu_torch.ops import structured_matmul as sm
from crvqa_tpu_torch.utils.mfu import count_flops, mfu, peak_flops
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

SXM = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("name,bf16,fp32", [
    (SXM, 989e12, 67e12), ("NVIDIA H100 PCIe", 756e12, 51e12),
    ("NVIDIA H100 NVL", 835e12, 60e12)])
def test_peak_flops_by_card_name(name, bf16, fp32):
    assert peak_flops(name) == peak_flops(name, torch.bfloat16) == bf16
    assert peak_flops(name, torch.float16) == bf16
    assert peak_flops(name, torch.float32) == fp32


def test_unknown_card_or_dtype_raises():
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        peak_flops("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="TPU v5 lite"):
        peak_flops("TPU v5 lite")
    with pytest.raises(ValueError, match="int8"):
        peak_flops(SXM, torch.int8)


def test_mfu_math():
    assert mfu(0.0, 4, 1.0, SXM) is None
    assert mfu(989e12, 4, 0.0, SXM) is None
    assert mfu(989e12, 1, 2.0, SXM) == pytest.approx(0.5)
    assert mfu(989e12, 4, 4.0, SXM) == pytest.approx(1.0)
    assert mfu(67e12, 1, 1.0, SXM, torch.float32) == pytest.approx(1.0)


def test_plain_matmul_counts_2mkn():
    m, k, n = 128, 256, 512
    a, b = torch.ones(m, k), torch.ones(k, n)
    assert count_flops(torch.matmul, a, b) == 2 * m * k * n
    assert a.device.type == "cpu"  # the arguments are left as they were


def _attention(fn, b, sq, sk, heads=12, d=64, rate=0.1):
    q = torch.randn(b, sq, heads * d, requires_grad=True)
    kv = [torch.randn(b, sk, heads * d, requires_grad=True)
          for _ in range(2)]
    bias = torch.zeros(b, sk)

    def fwd(q, k, v, bias):
        return fn(q, k, v, bias, heads, d, rate, 7)

    def fwd_bwd(q, k, v, bias):
        fwd(q, k, v, bias).sum().backward()

    n = b * heads * sq * sk * d
    return (count_flops(fwd, q, *kv, bias) / n,
            count_flops(fwd_bwd, q, *kv, bias) / n)


def _launches():
    return [f.launches for f in (
        fa.fused_attention, fa.fused_attention_fwd_train,
        fa.fused_attention_bwd_stored, fa.fused_attention_bwd_recompute,
        ms.midseq_attention, ms.midseq_attention_bwd, mm.masked_matmul_fwd,
        mm.masked_matmul_dx, mm.masked_matmul_ds,
        sm.head_compact_matmul_pallas)]


@pytest.mark.parametrize("impl", ["stored", "recompute"])
@pytest.mark.parametrize("shape", [(14, 36), (50, 50)])
def test_short_attention_counts_4_forward_and_8_backward(impl, shape,
                                                         monkeypatch):
    monkeypatch.setattr(fa, "BWD_IMPL", impl)
    before = _launches()
    fwd, both = _attention(fa.fused_attention, 2, *shape)
    assert (fwd, both - fwd) == (4, 8)
    assert _launches() == before


@pytest.mark.parametrize("shape", [(577, 577), (1, 602)])
def test_midseq_attention_counts_4_forward_and_8_backward(shape):
    before = _launches()
    fwd, both = _attention(ms.midseq_attention, 2, *shape)
    assert (fwd, both - fwd) == (4, 8)
    assert _launches() == before


def test_matmul_kernels_count_2mkn_per_product():
    m, k, n = 64, 128, 96
    x = torch.randn(m, k, requires_grad=True)
    w, s = torch.randn(k, n), torch.randn(k, n, requires_grad=True)
    before = _launches()
    # forward; forward, dx and the straight-through ds
    assert count_flops(lambda x, w, s: mm.masked_matmul(x, w, s, 0.0),
                       x, w, s) == 2 * m * k * n
    assert count_flops(
        lambda x, w, s: mm.masked_matmul(x, w, s, 0.0).sum().backward(),
        x, w, s) == 3 * 2 * m * k * n
    heads, hs, kept = 12, 64, 5
    keep = sm.expand_keep_idx(torch.arange(heads) % 2 == 0, kept)
    xm, wt = torch.randn(512, 256), torch.randn(heads * hs, 256)
    assert count_flops(
        lambda x, wt, keep: sm.head_compact_matmul_pallas(x, wt, keep,
                                                          heads, hs),
        xm, wt, keep) == 2 * 512 * 256 * kept * hs
    assert _launches() == before


def _stage2(batch_size):
    import chip_smoke

    return chip_smoke._stage2_setup(torch, LxmertConfig.tiny(),
                                    torch.device("cpu"), 0, batch_size)


def test_window_and_batch_scale_the_stage2_step():
    from crvqa_tpu_torch.cli.common import stack_window
    from crvqa_tpu_torch.train import stage2

    one, two = [], []
    for bs, out in ((1, one), (2, two)):
        model, masker, cfg, state, tx, batch = _stage2(bs)
        step = stage2.make_train_step(model, masker, tx, cfg)
        out.append(count_flops(step, state, batch))
    assert state.step == 0  # the count stepped a copy
    assert one[0] > 0 and two[0] == 2 * one[0]
    multi = stage2.make_multi_step(model, masker, tx, cfg, 3)
    assert count_flops(multi, state, stack_window([batch] * 3)) == 3 * two[0]


def test_checkpointed_mplug_step_counts_as_the_plain_step():
    from crvqa_tpu_torch.cli import vqa_mplug as tcli
    from crvqa_tpu_torch.data.mplug_data import synthetic_mplug_batch
    from crvqa_tpu_torch.train import mplug_train

    b = synthetic_mplug_batch(batch_size=2, image_res=32, vocab_size=128,
                              seed=1, uint8_images=True)
    batch = {k: torch.from_numpy(v) for k, v in b.items() if k != "qid"}
    for k in ("question_ids", "answer_ids"):
        batch[k] = batch[k].long()
    counts = {}
    for use_checkpoint in (False, True):
        args = tcli.build_parser().parse_args([
            "--tiny", "--dtype", "float32", "--output_dir", "unused",
            "--device", "cpu", "--seed", "3", "--use_checkpoint",
            str(use_checkpoint)])
        config, _, model = tcli.build_model(args)
        masker = tcli.build_masker(args, config)
        cfg = tcli.train_config(args, 4)
        state = mplug_train.init_state(
            model, tcli.initial_params(args, config), cfg, "cpu",
            masker=masker, seed=3, train=True)
        step = mplug_train.make_train_step(model, cfg, masker)
        with FlopCounterMode(display=False) as on_cpu:
            step(state, batch)
        counts[use_checkpoint] = (count_flops(step, state, batch),
                                  on_cpu.get_total_flops())
    assert config.vit.use_checkpoint
    assert counts[True][0] == counts[False][0] == counts[False][1] > 0
    # on the CPU the recompute runs, and counts
    assert counts[True][1] > counts[False][1]


# ----------------------------------------- LXMERT against the JAX package

WIDE = dict(hidden_size=256, num_attention_heads=4, intermediate_size=1024,
            visual_feat_dim=512, ans_num=300, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, classifier_dropout=0.0)
B, T, N = 2, 14, 36


def _lin(m, k, n):
    return 2 * m * k * n


def lxmert_matmul_flops(c) -> tuple[int, int]:
    """(forward and backward, the last cross layer's dead visual branch's
    forward) of `logits.sum()` of `LxmertForVQA` at config `c`, batch B, T
    tokens and N boxes, differentiated in every parameter: each product
    2*M*K*N forward and twice that backward (both operands' gradients),
    once for the feature projections (their inputs take none); the dead
    branch (vision queries of the last cross attention, its self
    attention and FFN) has no backward."""
    h, i = c.hidden_size, c.intermediate_size

    def attention(sq, sk):  # q and out on sq rows, k and v on sk
        return (2 * _lin(B * sq, h, h) + 2 * _lin(B * sk, h, h)
                + 4 * B * sq * sk * h)

    def ffn(s):
        return _lin(B * s, h, i) + _lin(B * s, i, h)

    def layer(s):
        return attention(s, s) + ffn(s)

    feats = _lin(B * N, c.visual_feat_dim, h) + _lin(B * N,
                                                     c.visual_pos_dim, h)
    live = (c.l_layers * layer(T) + c.r_layers * layer(N)
            + c.x_layers * (attention(T, N) + layer(T))
            + (c.x_layers - 1) * (attention(N, T) + layer(N))
            + _lin(B, h, h) + _lin(B, h, 2 * h) + _lin(B, 2 * h, c.ans_num))
    dead = attention(N, T) + layer(N)
    return 3 * live + 2 * feats + dead, dead


@pytest.fixture(scope="module")
def wide():
    jcfg = JaxConfig.tiny(**WIDE)
    rng = np.random.default_rng(0)
    inputs = dict(input_ids=rng.integers(1, jcfg.vocab_size, (B, T)),
                  visual_feats=rng.normal(size=(B, N, jcfg.visual_feat_dim)
                                          ).astype(np.float32),
                  visual_pos=rng.random((B, N, jcfg.visual_pos_dim)
                                        ).astype(np.float32))
    jmodel = JaxLxmert(jcfg)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), **jin)["params"]
    return jcfg, jmodel, params, inputs, jin


def test_lxmert_counts_its_matmuls_and_tracks_xla(wide):
    jcfg, jmodel, params, inputs, jin = wide
    config = LxmertConfig.tiny(**WIDE)
    model = build_lxmert(config, "cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    model.train()
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    tin["input_ids"] = tin["input_ids"].long()

    def step(params, inputs):
        out = torch.func.functional_call(model, params, (), inputs)
        out[0].sum().backward()

    leaves = {k: v.detach().requires_grad_(True)
              for k, v in model.named_parameters()}
    got = count_flops(step, leaves, tin)
    want, dead = lxmert_matmul_flops(config)
    assert got == want

    def loss(params, inputs):
        logits, _ = jmodel.apply({"params": params}, **inputs,
                                 deterministic=True)
        return logits.sum()

    xla = lowered_flops(jax.jit(jax.grad(loss)), params, jin)
    # XLA: every live product and the elementwise work, no dead branch
    assert 0 < dead < got and xla < got
    assert got - dead < xla < 1.03 * (got - dead)
