"""Stage-2 knowledge distillation of the port (`Stage2Config.use_kd`,
`kd_mode`, `kd_weight`; crvqa_tpu_torch/train/stage2.py, and the models'
`collect_hidden`) against the JAX package's `make_train_step` with the
same settings, from one JAX state carried into the port through the JAX
checkpoint layout (`core/convert.stage2_state_from_jax`), on the same
numpy batches: 'pooled' and 'layerwise' on the unrolled LXMERT and its
scan layout (tests/test_torch_kd_scan.py, with the dropout run), 'layerwise'
on VisualBERT, under `grad_accum_steps` 2 and in a window of 2 steps
(`make_multi_step`). The JAX end state is carried the same way and
compared leaf by leaf.

Setup: the tiny models in fp32, the LMH loss, compression 0.3/0.3/0.3 at
zero rate 0.7 (VisualBERT: uniform 0.7) with the magnitude init, every
dropout 0; one run has the attention kernels' counter-hash dropout on
(rate 0.1; the JAX side's Pallas kernels interpreted): both sides take the
same int32 seeds, one per attention call in call order, so their keep
masks are the same bits.

Tolerances, fp32 (tests/test_torch_stage2.py's): losses rtol 1e-4;
scores, classifier and thresholds atol 2 * lr * steps; Adam first moments
atol 1e-7 + rtol 1e-3 and second moments atol 1e-10 + rtol 1e-3
(tests/test_torch_parallel_jax.py). `kd_weight` 0 equals `use_kd` False
bit for bit.

The stage-2 checks of joint cross attention (`models.layers.
JOINT_CROSS_ATTENTION`, tests/test_torch_joint_cross.py) share these JAX
states: two steps with the flag on in both packages, at the tolerances
above (the scan layout's in tests/test_torch_kd_scan.py), and the port's
joint loss and gradients against its two-call path, fp32, within atol
1e-6 + rtol 1e-4 (the projections and the output block run over a
[B, 50] concatenation instead of [B, 14] and [B, 36] blocks, so a
product may sum in another order).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.masking import Masker as JaxMasker
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking import lxmert_mask_specs as jax_lxmert_specs
from crvqa_tpu.masking import visualbert_mask_specs as jax_vb_specs
from crvqa_tpu.masking.spec import lxmert_scan_mask_specs as jax_scan_specs
from crvqa_tpu.models import layers as jl
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.models.lxmert_scan import ScanLxmertForVQA as JaxScan
from crvqa_tpu.models.lxmert_scan import stack_params as jax_stack
from crvqa_tpu.models.visualbert import VisualBertConfig as JaxVBConfig
from crvqa_tpu.models.visualbert import VisualBertForVQA as JaxVisualBert
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu_torch.core import checkpoint as tckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.masking.masker import Masker
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import (lxmert_mask_specs,
                                          lxmert_scan_mask_specs,
                                          visualbert_mask_specs)
from crvqa_tpu_torch.models import LxmertConfig, VisualBertConfig
from crvqa_tpu_torch.models import layers as tl
from crvqa_tpu_torch.train import stage2
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
KERNEL_DROPOUT = dict(NO_DROPOUT, attention_probs_dropout_prob=0.1)
LR = 1e-3
STEPS = 2
SPARSITY = (0.3, 0.3, 0.3, 0.7)


def _batches(kind, cfg, n, seed0):
    extra = (dict(feat_dim=cfg.visual_embedding_dim, style="visualbert")
             if kind == "visualbert" else
             dict(feat_dim=cfg.visual_feat_dim, pos_dim=cfg.visual_pos_dim))
    return [synthetic_batch(batch_size=4, seed=seed0 + i,
                            vocab_size=cfg.vocab_size, ans_num=cfg.ans_num,
                            **extra) for i in range(n)]


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items() if k != "valid"}


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()
           if k not in ("valid", "question_id")}
    out["input_ids"] = out["input_ids"].long()
    return out


_PARAMS: dict = {}  # the JAX initial params by model family


def _init_params(jmodel, b0, inputs):
    """The family's jitted init from PRNGKey(0), once per test process:
    its params do not depend on the dropout rates, and the scan layout
    stacks the unrolled model's."""
    family = type(jmodel).__name__
    if family not in _PARAMS:
        _PARAMS[family] = jax.jit(jmodel.init)(
            jax.random.PRNGKey(0),
            **{k: jnp.asarray(b0[k]) for k in inputs})["params"]
    return _PARAMS[family]


class Kind:
    """One model family's two sides: the JAX model, masker and initial
    state (every dropout 0 unless `dropout` says otherwise), and the
    port's meta model, masker and a state carried from any JAX state of
    this kind."""

    def __init__(self, kind, tmp, dropout=NO_DROPOUT):
        self.kind, self.tmp = kind, tmp
        vb = kind == "visualbert"
        jcfg = (JaxVBConfig if vb else JaxConfig).tiny(**dropout)
        tcfg = (VisualBertConfig if vb else LxmertConfig).tiny(**dropout)
        self.jcfg = jcfg
        b0 = _batches(kind, jcfg, 1, 0)[0]
        if vb:
            jmodel = JaxVisualBert(jcfg)
            params = _init_params(jmodel, b0, ("input_ids", "visual_embeds"))
            jspecs = jax_vb_specs(jcfg.num_hidden_layers)
            specs = visualbert_mask_specs(tcfg.num_hidden_layers)
            jrates = JaxSparsity.uniform(0.7)
            rates = ModalSparsity.uniform(0.7)
        else:
            jmodel = JaxLxmert(jcfg)
            params = _init_params(jmodel, b0, ("input_ids", "visual_feats",
                                               "visual_pos"))
            dims = (jcfg.l_layers, jcfg.r_layers, jcfg.x_layers)
            jspecs, specs = jax_lxmert_specs(*dims), lxmert_mask_specs(*dims)
            if kind == "scan":
                jmodel, params = JaxScan(jcfg), jax_stack(params, jcfg)
                jspecs = jax_scan_specs(*dims)
                specs = lxmert_scan_mask_specs(*dims)
            jrates = JaxSparsity.from_compression(*SPARSITY)
            rates = ModalSparsity.from_compression(*SPARSITY)
        self.jmodel = jmodel
        self.jmasker = JaxMasker.create(jspecs, jrates,
                                        controlled_init="magnitude")
        self.masker = Masker.create(specs, rates, controlled_init="magnitude")
        self.key = "cls" if vb else "classifier"
        self.base = dict(masker_type="lmh", learning_rate=LR, total_steps=20,
                         hidden_size=jcfg.hidden_size,
                         classifier_key=self.key)
        self.jstate, self.tx = jstage2.init_state(
            jmodel, self.jmasker, params, jstage2.Stage2Config(**self.base),
            jax.random.PRNGKey(1))
        # one jitted reset per kind: every case's state has one structure
        self.jreset = jstage2.make_threshold_reset(self.jmasker)
        self.params = convert.stage2_from_jax(
            jax.tree.map(np.asarray, self.jstate.frozen_params),
            jax.tree.map(np.asarray, self.jstate.train_params),
            jax.tree.map(np.asarray, self.jstate.scores),
            jax.tree.map(np.asarray, self.jstate.thresholds), jspecs,
            classifier_key=self.key)["params"]
        self.model = (stage2.visualbert_meta_model(tcfg) if vb else
                      stage2.lxmert_meta_model(tcfg, scan=kind == "scan"))
        self._files = itertools.count()

    def configs(self, **kd):
        return (jstage2.Stage2Config(**self.base, **kd),
                stage2.Stage2Config(**self.base, **kd))

    def as_port(self, jstate, tsc):
        """A port state carrying `jstate` (through the JAX file layout)."""
        path = str(self.tmp / f"ckpt_{next(self._files)}")
        jckpt.save_checkpoint(path, jstate)
        state, opt = stage2.init_state(self.model, self.masker, self.params,
                                       tsc, seed=0, device="cpu")
        convert.stage2_state_from_jax(
            state, tckpt.load_jax_training_state(path), self.masker.specs,
            tsc)
        return state, opt


@pytest.fixture(scope="module")
def kinds(tmp_path_factory):
    cache = {}

    def get(kind, dropout=NO_DROPOUT):
        key = (kind, tuple(sorted(dropout.items())))
        if key not in cache:
            cache[key] = Kind(kind, tmp_path_factory.mktemp(kind), dropout)
        return cache[key]

    return get


def _assert_states_match(got, want, masker, steps):
    """Two port states (the JAX end state carried across as `want`) at
    the module's tolerances."""
    atol = 2 * LR * steps
    assert got.step == want.step == steps
    for spec in masker.specs:
        k = spec.key
        np.testing.assert_allclose(got.scores[k].detach().numpy(),
                                   want.scores[k].detach().numpy(),
                                   atol=atol, rtol=0, err_msg=k)
        np.testing.assert_allclose(got.thresholds[k].numpy(),
                                   want.thresholds[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)
    for k, t in want.train_params["classifier"].items():
        np.testing.assert_allclose(
            got.train_params["classifier"][k].detach().numpy(),
            t.detach().numpy(), atol=atol, rtol=0, err_msg=k)
    assert sorted(got.opt_state.mu) == sorted(want.opt_state.mu)
    for k, t in want.opt_state.mu.items():
        np.testing.assert_allclose(got.opt_state.mu[k].numpy(), t.numpy(),
                                   atol=1e-7, rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(got.opt_state.nu[k].numpy(),
                                   want.opt_state.nu[k].numpy(),
                                   atol=1e-10, rtol=1e-3, err_msg=k)


def _window(batches, stack):
    return {k: stack([b[k] for b in batches]) for k in batches[0]}


CASES = {
    "pooled": ("lxmert", dict(kd_mode="pooled")),
    "layerwise": ("lxmert", dict(kd_mode="layerwise")),
    "scan-pooled": ("scan", dict(kd_mode="pooled")),
    "scan-layerwise": ("scan", dict(kd_mode="layerwise")),
    "visualbert-layerwise": ("visualbert", dict(kd_mode="layerwise")),
    "accum-layerwise": ("lxmert", dict(kd_mode="layerwise",
                                       grad_accum_steps=2)),
    "window-layerwise": ("lxmert", dict(kd_mode="layerwise", kd_weight=0.5)),
}
# the scan layout's cases and the kernel-dropout run are in
# tests/test_torch_kd_scan.py (each file a short job for one worker)
SCAN_CASES = ["scan-pooled", "scan-layerwise"]


@pytest.mark.parametrize("case", [c for c in CASES if c not in SCAN_CASES])
def test_kd_steps_match_jax(kinds, case):
    """Two KD steps and a threshold reset on both sides."""
    kd_steps_match_jax(kinds, case)


def kd_steps_match_jax(kinds, case):
    kind, kd = CASES[case]
    side = kinds(kind)
    jsc, tsc = side.configs(use_kd=True, **kd)
    batches = _batches(kind, side.jcfg, STEPS, 30)
    js = jax.tree.map(jnp.array, side.jstate)  # the step donates
    state, opt = side.as_port(side.jstate, tsc)
    if case.startswith("window"):
        jmulti = jstage2.make_multi_step(side.jmodel, side.jmasker, side.tx,
                                         jsc, STEPS)
        js, jlosses, _ = jmulti(js, _window([_jax_batch(b) for b in batches],
                                            jnp.stack))
        multi = stage2.make_multi_step(side.model, side.masker, opt, tsc,
                                       STEPS)
        state, losses, _ = multi(state, _window(
            [_torch_batch(b) for b in batches], torch.stack))
        jlosses, losses = np.asarray(jlosses), losses.numpy()
    else:
        jstep = jstage2.make_train_step(side.jmodel, side.jmasker, side.tx,
                                        jsc)
        step = stage2.make_train_step(side.model, side.masker, opt, tsc)
        jlosses, losses = [], []
        for b in batches:
            js, jm = jstep(js, _jax_batch(b))
            state, m = step(state, _torch_batch(b))
            jlosses.append(float(jm.loss))
            losses.append(float(m.loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    js = side.jreset(js)
    state = stage2.make_threshold_reset(side.masker)(state)
    want, _ = side.as_port(js, tsc)
    _assert_states_match(state, want, side.masker, STEPS)


@pytest.mark.parametrize("mode", ["pooled", "layerwise"])
def test_kd_weight_zero_equals_no_kd(kinds, mode):
    """`kd_weight` 0: the KD term adds exact zeros to the loss and every
    gradient; the teacher draws nothing, so the state after two steps
    equals the plain run's bit for bit."""
    side = kinds("lxmert")
    batches = [_torch_batch(b) for b in _batches("lxmert", side.jcfg,
                                                 STEPS, 40)]
    states = []
    for kd in (dict(use_kd=False), dict(use_kd=True, kd_mode=mode,
                                        kd_weight=0.0)):
        _, tsc = side.configs(**kd)
        state, opt = side.as_port(side.jstate, tsc)
        step = stage2.make_train_step(side.model, side.masker, opt, tsc)
        losses = [step(state, b)[1].loss for b in batches]
        states.append((losses, state))
    (a_losses, a), (b_losses, b) = states
    assert [float(x) for x in a_losses] == [float(x) for x in b_losses]
    for part in ("scores",):
        for k, v in getattr(a, part).items():
            assert torch.equal(getattr(b, part)[k], v), k
    for k, v in a.opt_state.mu.items():
        assert torch.equal(b.opt_state.mu[k], v), k
        assert torch.equal(b.opt_state.nu[k], a.opt_state.nu[k]), k


def test_collect_hidden_lists_match_jax(kinds):
    """The hidden-state lists themselves: 1 + l + x language states for
    LXMERT (5 at the tiny widths; its scan layout's in
    tests/test_torch_kd_scan.py), 1 + layers for VisualBERT, each within
    1e-5 of the JAX model's (fp32), and the outputs without
    `collect_hidden` unchanged."""
    for kind in ("lxmert", "visualbert"):
        collect_hidden_lists_match_jax(kinds, kind)


def collect_hidden_lists_match_jax(kinds, kind):
    from torch.func import functional_call

    from crvqa_tpu.train.common import model_inputs as jax_inputs
    from crvqa_tpu_torch.train.common import model_inputs

    side = kinds(kind)
    b = _batches(kind, side.jcfg, 1, 60)[0]
    jparams = jstage2.merge_params(side.jstate.frozen_params,
                                   side.jstate.train_params, side.key)
    apply = jax.jit(side.jmodel.apply,
                    static_argnames=("deterministic", "collect_hidden"))
    jout = apply({"params": jparams}, **jax_inputs(_jax_batch(b)),
                 deterministic=True, collect_hidden=True)
    state, _ = side.as_port(side.jstate, stage2.Stage2Config(
        **side.base))
    params = stage2.dense_params(stage2.param_dtypes(side.model), state,
                                 side.key)
    side.model.eval()
    with torch.no_grad():
        inputs = model_inputs(_torch_batch(b))
        out = functional_call(side.model, params, (),
                              dict(inputs, collect_hidden=True))
        plain = functional_call(side.model, params, (), inputs)
    side.model.train()
    expect = (1 + side.jcfg.num_hidden_layers if kind == "visualbert"
              else 1 + side.jcfg.l_layers + side.jcfg.x_layers)
    assert len(out) == 3 and len(out[2]) == len(jout[2]) == expect
    for got, want in zip(out[2], jout[2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0, err_msg=kind)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]),
                               atol=1e-5, rtol=0, err_msg=kind)
    assert len(plain) == 2
    assert torch.equal(plain[0], out[0]) and torch.equal(plain[1],
                                                         out[1])


# ------------------------------------------------ joint cross attention

@pytest.mark.parametrize("kind", ["lxmert"])
def test_joint_stage2_steps_match_jax(kinds, kind, monkeypatch):
    """`JOINT_CROSS_ATTENTION` on in both packages: two stage-2 steps and
    a threshold reset (the scan layout's in tests/test_torch_kd_scan.py)."""
    joint_stage2_steps_match_jax(kinds, kind, monkeypatch)


def joint_stage2_steps_match_jax(kinds, kind, monkeypatch):
    monkeypatch.setattr(jl, "JOINT_CROSS_ATTENTION", True)
    monkeypatch.setattr(tl, "JOINT_CROSS_ATTENTION", True)
    side = kinds(kind)
    jsc, tsc = side.configs()
    batches = _batches(kind, side.jcfg, STEPS, 80)
    js = jax.tree.map(jnp.array, side.jstate)
    jstep = jstage2.make_train_step(side.jmodel, side.jmasker, side.tx, jsc)
    state, opt = side.as_port(side.jstate, tsc)
    step = stage2.make_train_step(side.model, side.masker, opt, tsc)
    jlosses, losses = [], []
    for b in batches:
        js, jm = jstep(js, _jax_batch(b))
        state, m = step(state, _torch_batch(b))
        jlosses.append(float(jm.loss))
        losses.append(float(m.loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    js = side.jreset(js)
    state = stage2.make_threshold_reset(side.masker)(state)
    want, _ = side.as_port(js, tsc)
    _assert_states_match(state, want, side.masker, STEPS)


def both_paths(monkeypatch, fn):
    """`fn()` on the port's two-call path, then on its joint path."""
    out = []
    for joint in (False, True):
        monkeypatch.setattr(tl, "JOINT_CROSS_ATTENTION", joint)
        out.append(fn())
    return out


def test_joint_equals_two_calls_in_the_port(kinds, monkeypatch):
    side = kinds("lxmert")
    _, tsc = side.configs()
    b = _torch_batch(_batches("lxmert", side.jcfg, 1, 90)[0])
    fn = stage2.make_loss_and_grads(side.model, side.masker, tsc)
    (l2, _, g2), (l1, _, g1) = both_paths(
        monkeypatch, lambda: fn(side.as_port(side.jstate, tsc)[0], b))
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    assert g1.keys() == g2.keys()
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=k)
