"""tests/test_torch_kd.py's KD checks in the scan layout
(`--scan_layers`: stacked [L, ...] leaves, per-layer thresholds) and with
the attention kernels' counter-hash dropout on, in a file of their own so
that each file stays a short job for one test worker; that file's setup
(`Kind`), cases and tolerances. The dropout run: both sides' kernels keyed
on the same int32 seeds, one per attention call in call order (JAX's
Pallas kernels interpreted), so their keep masks are the same bits. Joint
cross attention's two stage-2 steps in the scan layout share the scan
state here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crvqa_tpu.models import layers as jl
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu_torch.models import layers as tl
from crvqa_tpu_torch.train import stage2
from tests.test_torch_kd import (  # noqa: F401 (a fixture)
    KERNEL_DROPOUT, SCAN_CASES, _assert_states_match, _batches, _jax_batch,
    _torch_batch, collect_hidden_lists_match_jax, joint_stage2_steps_match_jax,
    kd_steps_match_jax, kinds)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_kd_steps_match_jax(kinds, case):
    """Two KD steps and a threshold reset on both sides."""
    kd_steps_match_jax(kinds, case)


@pytest.mark.parametrize("kind", ["scan"])
def test_joint_stage2_steps_match_jax(kinds, kind, monkeypatch):
    """`JOINT_CROSS_ATTENTION` on in both packages: two stage-2 steps and
    a threshold reset in the scan layout (`_ScanXLayer` reuses
    `LxmertXLayer`)."""
    joint_stage2_steps_match_jax(kinds, kind, monkeypatch)


def test_collect_hidden_lists_match_jax(kinds):
    """The scan layout's hidden-state list: the unrolled model's
    contract, 1 + l + x language states."""
    collect_hidden_lists_match_jax(kinds, "scan")


def test_kd_with_kernel_dropout_matches_jax(kinds, monkeypatch):
    """Layerwise KD with the attention kernels' counter-hash dropout on
    (rate 0.1, every other dropout 0): one step, both sides' kernels keyed
    on the same seeds; the teacher draws none (its attentions run at rate
    0 on both sides)."""
    side = kinds("lxmert", KERNEL_DROPOUT)
    jsc, tsc = side.configs(use_kd=True, kd_mode="layerwise")
    seeds = [-7, 123, 2 ** 31 - 1, -2 ** 31, 5, 99, 4321, -88]
    monkeypatch.setattr(jl, "FUSED_ATTENTION", True)
    monkeypatch.setattr(jl, "FUSED_ATTENTION_INTERPRET", True)
    jseq, tseq = iter(seeds), iter(seeds)
    drawn = []
    original = jl.kernel_bias_and_seed

    def jax_seed(module, attention_bias, q, k, deterministic, rate=None):
        # the original at deterministic=True: the bias, no rng drawn
        bias2d, zero, _ = original(module, attention_bias, q, k, True, rate)
        rate = module.dropout_rate if rate is None else rate
        if deterministic or rate == 0.0:
            return bias2d, zero, 0.0
        return bias2d, jnp.asarray([next(jseq)], jnp.int32), rate

    def port_seed(rate, seed_generator, what):
        if rate == 0.0:
            return 0
        drawn.append(rate)
        return next(tseq)

    monkeypatch.setattr(jl, "kernel_bias_and_seed", jax_seed)
    monkeypatch.setattr(tl, "kernel_seed", port_seed)
    b = _batches("lxmert", side.jcfg, 1, 50)[0]
    js = jax.tree.map(jnp.array, side.jstate)
    js, jm = jstage2.make_train_step(side.jmodel, side.jmasker, side.tx,
                                     jsc)(js, _jax_batch(b))
    state, opt = side.as_port(side.jstate, tsc)
    state, m = stage2.make_train_step(side.model, side.masker, opt,
                                      tsc)(state, _torch_batch(b))
    # 7 attention calls in the tiny model's student forward, none in the
    # teacher's
    assert drawn == [0.1] * 7
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-4)
    want, _ = side.as_port(js, tsc)
    _assert_states_match(state, want, side.masker, 1)
