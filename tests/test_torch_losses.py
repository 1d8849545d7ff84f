"""The port's debias losses and optimizer vs the JAX package's
(`crvqa_tpu.losses`, `crvqa_tpu.train.common`), on the same numpy inputs.

- Every loss of LOSS_NAMES and its gradient w.r.t. the logits (and the
  pooled hidden state for LMH): fp32, rtol 1e-5 / atol 1e-6 (the same
  formulas; transcendental functions differ in the last bits).
- hf_adamw after clip-by-global-norm with the linear warmup schedule, over
  six steps, with weight decay and with bf16 moments: rtol 1e-5 /
  atol 1e-6 on parameters of magnitude up to 2 (a few fp32 ulps: the clip
  factor and the step size are rounded at other points, and each step
  rounds p + u).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu import losses as jlosses
from crvqa_tpu.train import common as jcommon
from crvqa_tpu_torch import losses as tlosses
from crvqa_tpu_torch.losses import vqa_losses as tvl
from crvqa_tpu_torch.train import common as tcommon
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

B, A, H = 6, 11, 8


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    labels = np.zeros((B, A), np.float32)
    for i in range(B):
        idx = rng.choice(A, size=2, replace=False)
        labels[i, idx] = rng.choice([0.3, 0.6, 1.0], size=2)
    return dict(
        logits=rng.normal(size=(B, A)).astype(np.float32) * 2,
        pooled=rng.normal(size=(B, H)).astype(np.float32),
        labels=labels,
        bias=(rng.random((B, A)) * 0.5).astype(np.float32),
        max_label=labels.argmax(1).astype(np.int32))


def _lmh(seed=1):
    rng = np.random.default_rng(seed)
    kernel = rng.uniform(-0.3, 0.3, size=(H, 1)).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, size=(1,)).astype(np.float32)
    smooth = np.full((1,), -1.0, np.float32)
    jax_p = {"bias_lin": {"kernel": jnp.asarray(kernel),
                          "bias": jnp.asarray(bias)},
             "smooth_param": jnp.asarray(smooth)}
    torch_p = {"bias_lin.weight": torch.from_numpy(kernel.T.copy()),
               "bias_lin.bias": torch.from_numpy(bias),
               "smooth_param": torch.from_numpy(smooth)}
    return jax_p, torch_p


@pytest.mark.parametrize("name", tlosses.LOSS_NAMES)
def test_loss_and_gradient_match_jax(name):
    b = _batch()
    jlmh, tlmh = _lmh()
    assert tlosses.LOSS_NAMES == jlosses.LOSS_NAMES

    def jloss(logits, pooled):
        return jlosses.dispatch_loss(
            name, logits=logits, pooled=pooled,
            labels=jnp.asarray(b["labels"]), bias=jnp.asarray(b["bias"]),
            max_label=jnp.asarray(b["max_label"]), lmh_params=jlmh)

    jl, (jgl, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(b["logits"]), jnp.asarray(b["pooled"]))
    logits = torch.from_numpy(b["logits"]).requires_grad_()
    pooled = torch.from_numpy(b["pooled"]).requires_grad_()
    tl = tlosses.dispatch_loss(
        name, logits=logits, pooled=pooled,
        labels=torch.from_numpy(b["labels"]), bias=torch.from_numpy(b["bias"]),
        max_label=torch.from_numpy(b["max_label"]), lmh_params=tlmh)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(jgl),
                               rtol=1e-5, atol=1e-6)
    if name == "lmh":
        np.testing.assert_allclose(pooled.grad.numpy(), np.asarray(jgp),
                                   rtol=1e-5, atol=1e-6)


def test_cosine_rep_loss_matches_jax():
    rng = np.random.default_rng(2)
    s, t = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    s[0] = 0.0  # the 1e-8 clamp of a zero denominator
    want = float(jlosses.cosine_rep_loss(jnp.asarray(s), jnp.asarray(t)))
    got = float(tlosses.cosine_rep_loss(torch.from_numpy(s),
                                        torch.from_numpy(t)))
    assert got == pytest.approx(want, rel=1e-6)


def test_learned_mixin_init_distribution():
    p = tvl.learned_mixin_init(torch.Generator().manual_seed(0), 768)
    bound = 1 / np.sqrt(768)
    assert p["bias_lin.weight"].shape == (1, 768)
    assert p["bias_lin.weight"].abs().max() <= bound
    assert p["bias_lin.bias"].shape == (1,)
    assert float(p["smooth_param"]) == -1.0


@pytest.mark.parametrize("wd,moment_dtype,warmup", [
    (0.0, None, 0), (0.01, None, 2), (0.0, "bf16", 0), (0.05, "bf16", 3)])
def test_hf_adamw_clip_schedule_trajectory_matches_jax(wd, moment_dtype,
                                                       warmup):
    """Six steps of make_adamw (clip 1.0 -> hf_adamw with the linear warmup
    schedule) vs the port's clip_by_global_norm_ + HfAdamW.step on the same
    gradients; some steps clip (large gradients), some do not."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * (3.0 if i % 2 else 0.05)
                  ).astype(np.float32) for k, v in p0.items()}
             for i in range(6)]
    lr, total = 1e-2, 10
    tx = jcommon.make_adamw(lr, warmup, total, weight_decay=wd,
                            max_grad_norm=1.0, eps=1e-8,
                            moment_dtype=(jnp.bfloat16 if moment_dtype
                                          else None))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = jax.tree.map(lambda x, u: x + u, jp, upd)

    opt = tcommon.HfAdamW(
        tcommon.linear_warmup_schedule(lr, warmup, total), eps=1e-8,
        weight_decay=wd,
        moment_dtype=torch.bfloat16 if moment_dtype else None)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = opt.init(tp)
    for g in grads:
        tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        tcommon.clip_by_global_norm_(list(tg.values()), 1.0)
        opt.step(tp, tg, state)
    assert state.count == 6
    if moment_dtype:
        assert state.mu["a"].dtype == torch.bfloat16
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_schedule_matches_optax():
    for warmup, total in ((0, 10), (3, 10), (4, 4)):
        sched = jcommon.linear_warmup_schedule(1e-3, warmup, total)
        ours = tcommon.linear_warmup_schedule(1e-3, warmup, total)
        for c in range(0, 14):
            assert ours(c) == pytest.approx(float(sched(c)), rel=1e-6,
                                            abs=1e-12), (warmup, total, c)


def test_grad_mask_and_abs_sum():
    """grad_mask multiplies gradients before the moments; with no mask,
    accumulate_abs_grad integrates |g| (optimization.py:81-101)."""
    p = {"w": torch.zeros(1, 2), "b": torch.zeros(1)}
    g1 = {"w": torch.tensor([[1.0, -2.0]]), "b": torch.tensor([3.0])}
    g2 = {"w": torch.tensor([[-1.0, 1.0]]), "b": torch.tensor([-1.0])}
    opt = tcommon.HfAdamW(1e-2, accumulate_abs_grad=True)
    st = opt.init(p)
    opt.step(p, g1, st)
    opt.step(p, g2, st)
    torch.testing.assert_close(st.abs_grad_sum["w"], torch.tensor([[2.0,
                                                                     3.0]]))
    torch.testing.assert_close(st.abs_grad_sum["b"], torch.tensor([4.0]))
    masked = {"w": torch.zeros(1, 2), "b": torch.zeros(1)}
    optm = tcommon.HfAdamW(1e-2, grad_mask={"w": torch.tensor([[0.0, 1.0]]),
                                            "b": torch.tensor([1.0])})
    stm = optm.init(masked)
    optm.step(masked, g1, stm)
    assert float(masked["w"][0, 0]) == 0.0 and float(masked["w"][0, 1]) != 0
    assert stm.abs_grad_sum is None


def test_batch_score_matches_jax():
    b = _batch(4)
    want = float(jcommon.batch_score(jnp.asarray(b["logits"]),
                                     jnp.asarray(b["labels"])))
    got = float(tcommon.batch_score(torch.from_numpy(b["logits"]),
                                    torch.from_numpy(b["labels"])))
    assert got == pytest.approx(want)
