"""The port's `--opt` table (crvqa_tpu_torch/train/optim.py, timm_optim.py
and `mplug_train.make_two_group_adamw`) against the JAX package's
`make_two_group_adamw` (optax and its timm_optim) on the CPU.

Every name of the JAX table (crvqa_tpu/train/mplug_train.py:303-340), a
`lookahead_` prefix and adahessian run four steps on one two-group tree
(a visual and a body group with their own warm-up cosine schedules, bias
leaves undecayed, a 128 x 130 leaf that Adafactor factors, a 4-D leaf for
AdaP's views), the gradients clipped by one global norm first. Tolerance:
rtol 1e-5 / atol 1e-7 on the parameters after each step (fp32; the two
sides round the same formulas in another order). Also: `hutchinson` on a
diagonal quadratic gives the exact diagonal; `AdaHessian` fed one fixed
(grads, hess) pair; the Hessian-vector product of the straight-through
binarizers, reverse-over-reverse here, equals the JAX package's (so the
surrogate Hessian is symmetric and AdaHessian's port is sound); the
PlateauLR decisions and `dynamic_scale` against the JAX classes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from crvqa_tpu.masking import binarizers as jbin
from crvqa_tpu.masking import structured as jstruct
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu.train import timm_optim as jtimm
from crvqa_tpu_torch.masking import binarizers as tbin
from crvqa_tpu_torch.masking import structured as tstruct
from crvqa_tpu_torch.train import mplug_train as ttrain
from crvqa_tpu_torch.train import optim as toptim
from crvqa_tpu_torch.train import timm_optim as ttimm
from crvqa_tpu_torch.train.common import clip_by_global_norm_
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

SHAPES = {"visual_encoder/a/kernel": (6, 5), "visual_encoder/a/bias": (5,),
          "b/kernel": (5, 4), "b/bias": (4,), "c/kernel": (128, 130),
          "d/kernel": (4, 3, 2, 2)}
JAX_TABLE = ["sgd", "nesterov", "momentum", "adam", "adamw", "fusedadam",
             "fusedadamw", "nadam", "radam", "adadelta", "adafactor",
             "rmsprop", "novograd", "fusedlamb", "lamb", "adamp", "sgdp",
             "rmsproptf"]


def _config(opt):
    return dict(opt=opt, lr1=3e-2, lr2=1e-2, weight_decay=0.05,
                warmup_steps=2, total_steps=8, min_lr=1e-4, sched="cosine",
                max_grad_norm=2.0, opt_momentum=0.8)


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    return params, rng


def _grads(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(tp, jp, step):
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"{k} after step {step}")


def _run_both(opt, steps, hess_fn=None):
    kw = _config(opt)
    jtx = jtrain.make_two_group_adamw(jtrain.MPlugTrainConfig(**kw))
    # jitted, as the JAX trainer runs it (XLA's float32 power of an int32
    # count differs between eager and jit; RAdam's rho_t amplifies it)
    jupdate = jax.jit(jtx.update)
    params, rng = _trees(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    cfg = ttrain.MPlugTrainConfig(**kw)
    ttx = ttrain.make_two_group_adamw(cfg, tp)
    tst = ttx.init(tp)
    for step in range(steps):
        g = _grads(rng, scale=1.5)
        if hess_fn is None:
            upd, jst = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp)
            tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
            clip_by_global_norm_(list(tg.values()), cfg.max_grad_norm)
            ttx.step(tp, tg, tst)
        else:
            h = hess_fn(rng)
            upd, jst = jupdate(
                ({k: jnp.asarray(v) for k, v in g.items()},
                 {k: jnp.asarray(v) for k, v in h.items()}), jst, jp)
            ttx.step(tp, ({k: torch.from_numpy(v) for k, v in g.items()},
                          {k: torch.from_numpy(v) for k, v in h.items()}),
                     tst)
        jp = optax.apply_updates(jp, upd)
        _close(tp, jp, step)
    assert tst.count == steps
    return tp, jp


@pytest.mark.parametrize("opt", JAX_TABLE + ["lookahead_adamw",
                                             "lookahead_lamb"])
def test_four_steps_equal_the_jax_table(opt):
    tp, _ = _run_both(opt, 4)
    params, _ = _trees(0)
    assert any(not np.array_equal(tp[k].numpy(), params[k]) for k in SHAPES)


def test_radam_past_its_rectifier_threshold():
    """rho_t reaches 5 at the sixth step: eight steps cover the rectified
    branch (its scalars formed in float32, as optax forms them)."""
    _run_both("radam", 8)


def test_adahessian_two_group_equals_jax():
    """Fed (grads, hess) pairs: the clip of the gradients alone, the
    per-group rates, the decayed leaves."""
    _run_both("adahessian", 4,
              hess_fn=lambda rng: {k: np.abs(rng.normal(size=s)).astype(
                  np.float32) for k, s in SHAPES.items()})


def test_unknown_opt_raises_as_the_jax_factory():
    with pytest.raises(ValueError, match="unsupported opt 'adamq'"):
        ttrain.make_two_group_adamw(ttrain.MPlugTrainConfig(opt="adamq"),
                                    ["params/a.weight"])
    with pytest.raises(ValueError, match="unsupported opt 'adamq'"):
        jtrain.make_two_group_adamw(jtrain.MPlugTrainConfig(opt="adamq"))
    assert toptim.is_second_order("lookahead_adahessian")
    assert not toptim.is_second_order("adamw")


def test_hutchinson_on_a_diagonal_quadratic():
    """f(x) = sum(a * x^2) / 2 + <c, x>: H = diag(a), so z * (H z) = a
    exactly for any +-1 probe; the gradients are a * x + c."""
    rng = np.random.default_rng(4)
    a = {k: rng.uniform(0.5, 2.0, size=s).astype(np.float32)
         for k, s in (("u", (3, 4)), ("v", (5,)))}
    c = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in a.items()}
    x = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in a.items()}

    def jloss(t):
        return sum(jnp.sum(0.5 * a[k] * t[k] ** 2 + c[k] * t[k]) for k in t)

    def tloss(t):
        return sum(torch.sum(0.5 * torch.from_numpy(a[k]) * t[k] ** 2
                             + torch.from_numpy(c[k]) * t[k]) for k in t)

    tx = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in x.items()}
    loss, grads, hess = ttimm.hutchinson(
        tloss, tx, torch.Generator().manual_seed(0))
    jl, jg, jh = jtimm.hutchinson(jloss, {k: jnp.asarray(v)
                                          for k, v in x.items()},
                                  jax.random.PRNGKey(0))
    for k in a:
        np.testing.assert_array_equal(hess[k].numpy(), a[k])
        np.testing.assert_array_equal(np.asarray(jh[k]), a[k])
        np.testing.assert_allclose(grads[k].numpy(), a[k] * x[k] + c[k],
                                   rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    z = ttimm.rademacher_like(torch.Generator().manual_seed(1), tx)
    assert all(set(np.unique(v.numpy())) <= {-1.0, 1.0} for v in z.values())
    assert all(v.dtype == torch.float32 for v in z.values())


def _ste_problem(seed, n=6):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, n)).astype(np.float32)
    s = rng.normal(size=(n, n)).astype(np.float32)
    x = rng.normal(size=(3, n)).astype(np.float32)
    z = np.where(rng.random(size=(n, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    return w, s, x, z


@pytest.mark.parametrize("name", ["ste", "sign", "head"])
def test_binarizer_hvp_equals_jax(name):
    """H @ z of a loss through each straight-through binarizer: the port's
    reverse-over-reverse against the JAX package's forward-over-reverse
    (`jax.jvp` of the gradient, what its `hutchinson` runs; the head
    binarizer is a custom_vjp, so JAX takes it reverse-over-reverse too).
    Equal products mean the surrogate Hessian the two modes see is the same
    symmetric matrix. Tolerance 1e-5 relative to the largest entry."""
    w, s, x, z = _ste_problem({"ste": 0, "sign": 1, "head": 2}[name])
    if name == "head":
        s = s[:2, :3]  # an [L, H] head-score matrix of 6 heads
        z = z[:2, :3]
    thr = np.float32(0.1)

    # a head matrix's entry owns 6 weights (one row of w)
    jexp = ((lambda t: jnp.repeat(t.reshape(-1), 6).reshape(6, 6))
            if name == "head" else (lambda t: t))
    texp = ((lambda t: torch.repeat_interleave(t.reshape(-1), 6).reshape(
        6, 6)) if name == "head" else (lambda t: t))

    def jmask(sc):
        if name == "ste":
            return jbin.binarize_ste(sc, thr)
        if name == "sign":
            return jbin.binarize_sign(sc, thr)
        return jstruct.binarize_head_ste(sc, 2)

    def tmask(sc):
        if name == "ste":
            return tbin.binarize_ste(sc, torch.tensor(thr))
        if name == "sign":
            return tbin.binarize_sign(sc, torch.tensor(thr))
        return tstruct.binarize_head_ste(sc, 2)

    def jloss(sc):
        h = jnp.tanh(jnp.asarray(x) @ (jnp.asarray(w) * jexp(jmask(sc) * sc)))
        return jnp.sum(h ** 2)

    def tloss(sc):
        h = torch.tanh(torch.from_numpy(x)
                       @ (torch.from_numpy(w) * texp(tmask(sc) * sc)))
        return torch.sum(h ** 2)

    if name == "head":
        want = jax.grad(lambda sc: jnp.vdot(jax.grad(jloss)(sc),
                                            jnp.asarray(z)))(jnp.asarray(s))
    else:
        want = jax.jvp(jax.grad(jloss), (jnp.asarray(s),),
                       (jnp.asarray(z),))[1]
    ts = torch.from_numpy(s.copy()).requires_grad_(True)
    _, _, hess = ttimm.hutchinson(lambda t: tloss(t["s"]), {"s": ts}, None,
                                  z={"s": torch.from_numpy(z)})
    got = hess["s"].numpy() * z  # z * (H z) * z = H z
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_plateau_lr_decisions_equal_jax():
    """Long sequences of metrics through both controllers (max and min
    modes, patience, cooldown, a floor): the same scale at every call."""
    rng = np.random.default_rng(5)
    for mode, kw in (("max", dict(patience=2, cooldown=1)),
                     ("min", dict(patience=0, cooldown=2, min_scale=0.01)),
                     ("max", dict(patience=1, threshold=0.05))):
        jp = jtimm.PlateauLR(decay_rate=0.5, mode=mode, **kw)
        tp = ttimm.PlateauLR(decay_rate=0.5, mode=mode, **kw)
        metrics = np.cumsum(rng.normal(size=40) * 0.1) + 1.0
        for m in metrics:
            assert tp.step(float(m)) == jp.step(float(m))
            assert (tp.num_bad, tp.cooldown_left, tp.best) == (
                jp.num_bad, jp.cooldown_left, jp.best)
        assert tp.scale < 1.0


def test_dynamic_scale_equals_jax():
    rng = np.random.default_rng(6)
    u = {"a": rng.normal(size=(3, 2)).astype(np.float32)}
    jtx = jtimm.dynamic_scale()
    jst = jtimm.set_dynamic_scale((jtx.init(u), optax.EmptyState()), 0.25)
    jout, _ = jtx.update({k: jnp.asarray(v) for k, v in u.items()}, jst[0])
    ttx = ttimm.dynamic_scale()
    tst = ttimm.set_dynamic_scale((ttx.init(), {"other": 1}), 0.25)
    assert tst[1] == {"other": 1}
    tout = ttx.update({k: torch.from_numpy(v) for k, v in u.items()}, tst[0])
    np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
    assert ttx.update({"a": torch.ones(1)}, ttx.init())["a"].item() == 1.0
