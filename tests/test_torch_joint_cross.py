"""Joint cross attention (`models.layers.JOINT_CROSS_ATTENTION`): LXMERT's
shared `visual_attention` projects q, k and v once over [lang; visn] and
attends twice, lang first, in the port as in the JAX package.

- The tiny LXMERT with the flag on in both packages, fp32, same params and
  numpy inputs: logits and pooled output within rtol/atol 1e-4
  (tests/test_torch_lxmert.py's), JAX's attention on XLA and on its
  interpreted kernel.
- Two stage-2 steps with the flag on in both packages (unrolled and scan
  layouts) from one carried state, and the port's joint stage-2 loss and
  gradients against its two-call path: in tests/test_torch_kd.py and
  tests/test_torch_kd_scan.py, whose JAX states they share.
- The port's joint path against its two-call path, fp32: with the
  attention kernels' counter-hash dropout on (rate 0.1, hidden dropout 0)
  and the same seed generator state, the same seeds are drawn in the same
  order, so the logits agree within atol 1e-6 (the projections and the
  output block run over a [B, 50] concatenation instead of [B, 14] and
  [B, 36] blocks, so a product may sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.models import layers as jl
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.models import LxmertConfig, build_lxmert
from crvqa_tpu_torch.models import layers as tl
from crvqa_tpu_torch.models.layers import set_generators
from tests.test_torch_kd import both_paths
from tests.test_torch_lxmert import _inputs
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


def _port_inputs(inputs):
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    tin["input_ids"] = tin["input_ids"].long()
    return tin


@pytest.mark.parametrize("fused", [False, True])
def test_joint_logits_match_jax(fused, monkeypatch):
    monkeypatch.setattr(jl, "FUSED_ATTENTION", fused)
    monkeypatch.setattr(jl, "FUSED_ATTENTION_INTERPRET", True)
    monkeypatch.setattr(jl, "JOINT_CROSS_ATTENTION", True)
    monkeypatch.setattr(tl, "JOINT_CROSS_ATTENTION", True)
    jcfg = JaxConfig.tiny()
    jmodel = JaxLxmert(jcfg)
    inputs = _inputs(jcfg, 5)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5), **jin)["params"]
    apply = jax.jit(jmodel.apply, static_argnames="deterministic")
    jlogits, jpooled = apply({"params": params}, deterministic=True, **jin)
    model = build_lxmert(LxmertConfig.tiny())
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                           params)),
                          strict=True)
    model.eval()
    with torch.inference_mode():
        logits, pooled = model(**_port_inputs(inputs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               rtol=1e-4, atol=1e-4)


def test_joint_draws_the_two_call_seeds(monkeypatch):
    """Attention dropout 0.1 through the kernels' counter-hash masks (the
    plain versions on the CPU), hidden dropout 0, from one seed generator
    state: the joint path draws lang's seed, then visn's, as the two-call
    path does."""
    cfg = LxmertConfig.tiny(hidden_dropout_prob=0.0, classifier_dropout=0.0,
                            attention_probs_dropout_prob=0.1)
    model = build_lxmert(cfg, generator=torch.Generator().manual_seed(0))
    inputs = _port_inputs(_inputs(JaxConfig.tiny(), 3))
    params = dict(model.named_parameters())

    def run():
        model.train()
        set_generators(model, torch.Generator().manual_seed(1),
                       torch.Generator().manual_seed(2))
        with torch.no_grad():
            return functional_call(model, params, (), inputs)[0]

    two, joint = both_paths(monkeypatch, run)
    np.testing.assert_allclose(joint.numpy(), two.numpy(), atol=1e-6, rtol=0)
    model.eval()
    with torch.no_grad():
        assert not torch.allclose(model(**inputs)[0], two, atol=1e-3)
