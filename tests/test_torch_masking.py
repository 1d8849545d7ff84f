"""The port's masking (crvqa_tpu_torch/masking, ops/kthvalue.py) vs the JAX
package's, on the same weights: a tiny JAX LXMERT's params carried across
with `state_dict_from_jax`. Scores compare in the torch layout (the JAX
[in, out] kernels transposed).

Deterministic inits, thresholds, masks, reports and the masked weights are
exact (the same k-th values and comparisons of the same fp32 numbers);
the straight-through gradients are exact too. The random inits (none,
uniform, double_uniform) and scheme 3's bernoulli draw from other
generators than JAX's, so they are held to their distributions only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.masking import Masker as JaxMasker
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking import binarizers as jbin
from crvqa_tpu.masking import lxmert_mask_specs as jax_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.ops import kthvalue as jkth
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.masking import binarizers as tbin
from crvqa_tpu_torch.masking.masker import Masker, bias_key
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
from crvqa_tpu_torch.ops import kthvalue as tkth
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def weights():
    cfg = JaxConfig.tiny()
    params = jax.jit(JaxLxmert(cfg).init)(
        jax.random.PRNGKey(0), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_feats=jnp.zeros((2, 8, cfg.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 8, cfg.visual_pos_dim)))["params"]
    # non-zero biases, so bias masks have something to rank
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.01 * jax.random.normal(
            jax.random.PRNGKey(len(str(p))), x.shape)
            if p[-1].key == "bias" else x), params)
    params = jax.tree.map(np.asarray, params)
    return cfg, params, state_dict_from_jax(params)


def _maskers(cfg, **kw):
    sp = (0.3, 0.3, 0.3, 0.7)
    zr = kw.pop("uniform", None)
    jsp = (JaxSparsity.uniform(zr, ("Lang", "Vis", "Fus", "P")) if zr
           else JaxSparsity.from_compression(*sp))
    tsp = (ModalSparsity.uniform(zr, ("Lang", "Vis", "Fus", "P")) if zr
           else ModalSparsity.from_compression(*sp))
    js = jax_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers)
    ts = lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers)
    return JaxMasker.create(js, jsp, **kw), Masker.create(ts, tsp, **kw)


def _torch_layout(spec, arr):
    arr = np.asarray(arr)
    return arr if spec.is_embedding or arr.ndim < 2 else arr.T


def _assert_scores_equal(tmasker, jscores, tscores):
    for spec in tmasker.specs:
        np.testing.assert_array_equal(
            tscores[spec.key].detach().numpy(),
            _torch_layout(spec, jscores[spec.key]), err_msg=spec.key)


@pytest.mark.parametrize("init,kw", [
    ("magnitude", {}), ("magnitude_soft", {}),
    ("magnitude_global", {"uniform": 0.6}),
    ("magnitude", {"mask_biases": True})])
def test_controlled_init_matches_jax(weights, init, kw):
    cfg, params, sd = weights
    jm, tm = _maskers(cfg, controlled_init=init, **kw)
    jscores, jthr = jm.init(params)
    tscores, tthr = tm.init(sd)
    assert set(tscores) == set(jscores)
    _assert_scores_equal(tm, jscores, tscores)
    if tm.mask_biases:
        bkeys = [k for k in jscores if k.endswith("/bias")]
        assert bkeys and set(bkeys) == {bias_key(s) for s in tm.specs
                                        if not s.is_embedding}
        for k in bkeys:
            np.testing.assert_array_equal(tscores[k].numpy(),
                                          np.asarray(jscores[k]))
    for k in jthr:
        assert float(tthr[k]) == float(jthr[k]), k


@pytest.mark.parametrize("init", [None, "uniform", "double_uniform"])
def test_random_inits_match_jax_zero_rates(weights, init):
    """Other bits, the same distribution: the achieved zero rates agree
    with the JAX masker's (the random inits sit near the target; the
    with-replacement draw of double_uniform near 1 - exp(-target))."""
    cfg, params, sd = weights
    jm, tm = _maskers(cfg, controlled_init=init)
    jrep = jm.sparsity_report(*jm.init(params, jax.random.PRNGKey(0)))
    scores, thr = tm.init(sd, torch.Generator().manual_seed(0))
    report = tm.sparsity_report(scores, thr)
    for modality in jrep:
        assert abs(report[modality] - float(jrep[modality])) <= 0.05, (
            modality, report, jrep)


def _perturbed(jm, tm, params, sd, seed=1):
    """Scores spread out by noise made with numpy, the same on both sides
    (layout-aware), so thresholds and masks are non-trivial."""
    jscores, jthr = jm.init(params)
    tscores, tthr = tm.init(sd)
    rng = np.random.default_rng(seed)
    for spec in tm.specs:
        noise = rng.normal(size=np.asarray(jscores[spec.key]).shape).astype(
            np.float32) * 0.01
        jscores[spec.key] = jnp.asarray(np.asarray(jscores[spec.key]) + noise)
        tscores[spec.key] = torch.from_numpy(
            np.array(_torch_layout(spec, jscores[spec.key])))
    return jscores, jthr, tscores, tthr


@pytest.mark.parametrize("global_prune", [False, True])
def test_reset_masks_reports_match_jax(weights, global_prune):
    cfg, params, sd = weights
    kw = {"global_prune": True, "uniform": 0.7} if global_prune else {}
    jm, tm = _maskers(cfg, **kw)
    jscores, jthr0, tscores, tthr0 = _perturbed(jm, tm, params, sd)
    jthr = jm.reset_thresholds(jscores)
    tthr = tm.reset_thresholds(tscores)
    for k in jthr:
        assert float(tthr[k]) == float(jthr[k]), k
    jmasks = jm.binary_masks(jscores, jthr)
    tmasks = tm.binary_masks(tscores, tthr)
    for spec in tm.specs:
        np.testing.assert_array_equal(tmasks[spec.key].numpy(),
                                      _torch_layout(spec, jmasks[spec.key]))
    jrep = jm.sparsity_report(jscores, jthr)
    trep = tm.sparsity_report(tscores, tthr)
    assert set(trep) == set(jrep)
    for k in jrep:
        assert trep[k] == pytest.approx(float(jrep[k]), abs=1e-6)
        if k == "all" or not global_prune:  # global: one overall rate
            assert abs(trep[k] - 0.7) < 0.02
    jold = jm.binary_masks(jscores, jthr0)
    told = tm.binary_masks(tscores, tthr0)
    assert tm.mask_drift(tscores, tthr, told) == pytest.approx(
        float(jm.mask_drift(jscores, jthr, jold)), abs=1e-7)


@pytest.mark.parametrize("mask_biases", [False, True])
def test_apply_masks_matches_jax(weights, mask_biases):
    cfg, params, sd = weights
    jm, tm = _maskers(cfg, mask_biases=mask_biases)
    jscores, jthr, tscores, tthr = _perturbed(jm, tm, params, sd)
    if mask_biases:
        rng = np.random.default_rng(2)
        for k in [k for k in jscores if k.endswith("/bias")]:
            noise = rng.normal(size=jscores[k].shape).astype(np.float32)
            jscores[k] = jnp.asarray(np.asarray(jscores[k]) + 0.01 * noise)
            tscores[k] = torch.from_numpy(np.asarray(jscores[k]).copy())
    jmasked = state_dict_from_jax(jax.tree.map(
        np.asarray, jm.apply_masks(params, jscores, jthr)))
    tmasked = tm.apply_masks(sd, tscores, tthr)
    assert set(tmasked) == set(jmasked)
    for name, want in jmasked.items():
        torch.testing.assert_close(tmasked[name], want, rtol=0, atol=0,
                                   msg=name)


def test_kth_smallest_and_threshold_match_jax():
    x = np.random.default_rng(3).normal(size=(37, 11)).astype(np.float32)
    for k in (1, 5, 200, 407):
        assert float(tkth.kth_smallest(torch.from_numpy(x), k)) == float(
            jkth.kth_smallest(jnp.asarray(x), k))
    for sp in (0.0, 0.3, 0.7, 0.999):
        assert float(tkth.sparsity_threshold(torch.from_numpy(x), sp)) == \
            float(jkth.sparsity_threshold(jnp.asarray(x), sp))


@pytest.mark.parametrize("name,fn", [("MaskedLinear1", jbin.binarize_ste),
                                     ("MaskedLinear2", jbin.binarize_sign)])
def test_binarizer_forward_and_ste_gradient_match_jax(name, fn):
    rng = np.random.default_rng(4)
    s = rng.normal(size=(9, 7)).astype(np.float32) * 1.5
    s[0, :3] = 0.25  # ties at the threshold are zeroed (strict >)
    w = rng.normal(size=s.shape).astype(np.float32)
    t = np.float32(0.25)
    jfwd = np.asarray(fn(jnp.asarray(s), jnp.asarray(t)))
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(
        fn(x, jnp.asarray(t)) * jnp.asarray(w)))(jnp.asarray(s)))
    ts = torch.from_numpy(s).requires_grad_()
    out = tbin.get_binarizer(name)(ts, torch.tensor(t))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), jfwd)
    np.testing.assert_array_equal(ts.grad.numpy(), jgrad)


def test_clamp_scores_sign_matches_jax():
    s = np.linspace(-3, 3, 25, dtype=np.float32)
    got = tbin.clamp_scores_sign_(torch.from_numpy(s.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jbin.clamp_scores_sign(jnp.asarray(s))))


def test_bernoulli_binarizer_statistics_and_identity_gradient():
    """scheme 3: the mean of the drawn mask is sigmoid(scores) (within
    five standard errors) and the gradient passes through unchanged."""
    s = torch.linspace(-2, 2, 9).repeat(20000, 1).requires_grad_()
    binarize = tbin.get_binarizer("MaskedLinear3",
                                  torch.Generator().manual_seed(0))
    m = binarize(s, torch.tensor(0.0))
    p = torch.sigmoid(s[0].detach())
    se = torch.sqrt(p * (1 - p) / s.shape[0])
    assert torch.all((m.detach().mean(0) - p).abs() <= 5 * se)
    g = torch.randn(s.shape, generator=torch.Generator().manual_seed(1))
    (m * g).sum().backward()
    torch.testing.assert_close(s.grad, g, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        tbin.get_binarizer("MaskedLinear3")
