"""The port's data- and tensor-parallel stage-2 step against the JAX
package's mesh step: two steps of a global batch of 8 on the JAX mesh
(the 8-device virtual CPU mesh of tests/conftest.py, the setups of
tests/test_multidevice.py and tests/test_tensor_parallel.py) and on 2
gloo ranks of the port laid out alike (tests/torch_parallel_worker.py
`stage2_steps`): `data=2` (each rank on its 4 rows) and `data=1,
model=2` (each rank on half of every attention's heads and FFN's units,
the JAX side placed by `shard_params_tp` / `shard_scores_tp`), with
`--zero_opt` off and on (the JAX side shards its moments with
`shard_opt_state`), from one state carried across (`core/convert.py`).

Setup: the tiny LXMERT (4 heads, hidden 32, intermediate 64) in fp32 with
every dropout 0, the LMH loss at 0.3/0.3/0.3 and zero rate 0.7.

Tolerances, fp32 (as tests/test_torch_stage2.py): losses rtol 1e-4;
scores, classifier and thresholds atol 2 * lr * steps (AdamW moves a score
whose gradient is within rounding of zero by about lr either way); first
moments atol 1e-7 + rtol 1e-3 and second moments atol 1e-10 + rtol 1e-3
(gradients agree to 1e-4 relative). The port's ZeRO run equals its
unsharded run bit for bit: whole-leaf ownership runs each leaf's own
arithmetic.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.masking import Masker as JaxMasker
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking import lxmert_mask_specs as jax_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.parallel import (MeshConfig, make_mesh, replicated_sharding,
                                shard_batch)
from crvqa_tpu.parallel.tp import shard_params_tp, shard_scores_tp
from crvqa_tpu.parallel.zero import shard_opt_state
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu_torch.core import checkpoint as tckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.masking.masker import Masker
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
from crvqa_tpu_torch.models import LxmertConfig
from crvqa_tpu_torch.parallel.dryrun import free_port
from crvqa_tpu_torch.train import stage2
from tests.torch_parallel_worker import run_ranks

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
LR = 1e-3
SPARSITY = (0.3, 0.3, 0.3, 0.7)
STEPS = 2


def _batches(cfg):
    return [synthetic_batch(batch_size=8, seed=40 + i,
                            vocab_size=cfg.vocab_size, ans_num=cfg.ans_num,
                            feat_dim=cfg.visual_feat_dim,
                            pos_dim=cfg.visual_pos_dim)
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny(**NO_DROPOUT)
    jmodel = JaxLxmert(jcfg)
    batches = _batches(jcfg)
    b0 = batches[0]
    params = jmodel.init(jax.random.PRNGKey(0),
                         input_ids=jnp.asarray(b0["input_ids"]),
                         visual_feats=jnp.asarray(b0["visual_feats"]),
                         visual_pos=jnp.asarray(b0["visual_pos"]))["params"]
    jmasker = JaxMasker.create(
        jax_specs(jcfg.l_layers, jcfg.r_layers, jcfg.x_layers),
        JaxSparsity.from_compression(*SPARSITY), controlled_init="magnitude")
    kw = dict(masker_type="lmh", learning_rate=LR, total_steps=20,
              hidden_size=jcfg.hidden_size)
    jsc = jstage2.Stage2Config(**kw)
    jstate, tx = jstage2.init_state(jmodel, jmasker, params, jsc,
                                    jax.random.PRNGKey(1))
    carried = convert.stage2_from_jax(
        jax.tree.map(np.asarray, jstate.frozen_params),
        jax.tree.map(np.asarray, jstate.train_params),
        jax.tree.map(np.asarray, jstate.scores),
        jax.tree.map(np.asarray, jstate.thresholds), jmasker.specs)
    tcfg = LxmertConfig.tiny(**NO_DROPOUT)
    masker = Masker.create(
        lxmert_mask_specs(tcfg.l_layers, tcfg.r_layers, tcfg.x_layers),
        ModalSparsity.from_compression(*SPARSITY),
        controlled_init="magnitude")
    tsc = stage2.Stage2Config(**kw)
    model = stage2.lxmert_meta_model(tcfg)

    def jax_as_port(tree):
        state, _ = stage2.init_state(model, masker, carried["params"], tsc,
                                     seed=0, device="cpu")
        convert.stage2_state_from_jax(state, tree, masker.specs, tsc)
        return state

    return dict(jmodel=jmodel, jmasker=jmasker, jsc=jsc, jstate=jstate,
                tx=tx, batches=batches, carried=carried, kw=kw,
                jax_as_port=jax_as_port)


def _run(setup, tmp, data, model):
    """The JAX steps on its (data, model) mesh, without and with ZeRO, and
    the port's on 2 gloo ranks laid out alike."""
    mesh = make_mesh(MeshConfig(data=data, model=model), jax.devices()[:2])
    jmasker, jstate = setup["jmasker"], setup["jstate"]
    jax_runs = {}
    for name, zero in (("plain", False), ("zero", True)):
        js = jax.device_put(jax.tree.map(jnp.array, jstate),
                            replicated_sharding(mesh))
        if model > 1:
            js = js.replace(
                frozen_params=shard_params_tp(
                    jax.device_get(js.frozen_params), mesh),
                scores=shard_scores_tp(jax.device_get(js.scores),
                                       jmasker.specs, mesh))
        if zero:
            js = js.replace(opt_state=shard_opt_state(js.opt_state, mesh))
        step = jstage2.make_train_step(setup["jmodel"], jmasker, setup["tx"],
                                       setup["jsc"],
                                       mesh=mesh if zero else None)
        losses = []
        for b in setup["batches"]:
            js, m = step(js, shard_batch(mesh, {k: v for k, v in b.items()
                                                if k != "valid"}))
            losses.append(float(m.loss))
        js = jstage2.make_threshold_reset(jmasker)(js)
        path = str(tmp / f"jax_{name}")
        jckpt.save_checkpoint(path, js)
        jax_runs[name] = (losses, setup["jax_as_port"](
            tckpt.load_jax_training_state(path)))
    torch.save({"carried": setup["carried"], "batches": setup["batches"],
                "config": NO_DROPOUT, "sparsity": SPARSITY,
                "stage2": setup["kw"], "mesh": (data, model)},
               tmp / "inputs.pt")
    port = free_port()
    run_ranks(lambda r: [sys.executable, "-m", "tests.torch_parallel_worker",
                         "stage2_steps", str(r), "2", str(port), str(tmp)], 2)
    return jax_runs, torch.load(tmp / "result.pt", weights_only=False)


@pytest.fixture(scope="module", params=[(2, 1), (1, 2)], ids=["dp", "tp"])
def runs(request, setup, tmp_path_factory):
    data, model = request.param
    jax_runs, result = _run(setup, tmp_path_factory.mktemp("mesh"), data,
                            model)
    return model, jax_runs, result


@pytest.mark.parametrize("name", ["plain", "zero"])
def test_two_ranks_match_the_jax_mesh(runs, name):
    _, jax_runs, result = runs
    jlosses, want = jax_runs[name]
    got = result[name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    atol = 2 * LR * STEPS
    for k, t in want.scores.items():
        np.testing.assert_allclose(got["scores"][k].detach().numpy(),
                                   t.detach().numpy(), atol=atol, rtol=0,
                                   err_msg=k)
        assert float(got["thresholds"][k]) == pytest.approx(
            float(want.thresholds[k]), abs=atol)
    for k, t in want.train_params["classifier"].items():
        np.testing.assert_allclose(got["classifier"][k].detach().numpy(),
                                   t.detach().numpy(), atol=atol, rtol=0,
                                   err_msg=k)
    for k, t in want.opt_state.mu.items():
        np.testing.assert_allclose(got["mu"][k].numpy(), t.numpy(),
                                   atol=1e-7, rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(got["nu"][k].numpy(),
                                   want.opt_state.nu[k].numpy(),
                                   atol=1e-10, rtol=1e-3, err_msg=k)


def test_zero_state_equals_the_unsharded_state(runs):
    model, _, result = runs
    plain, zero = result["plain"], result["zero"]
    assert zero["losses"] == plain["losses"]
    for part in ("scores", "classifier", "mu", "nu", "thresholds"):
        assert list(zero[part]) == list(plain[part])
        for k in plain[part]:
            assert torch.equal(zero[part][k], plain[part][k]), (part, k)
    # rank 0 kept only its own leaves' moments (a data group of one rank
    # under tensor parallelism owns them all)
    if model == 1:
        assert 0 < len(zero["owned"]) < len(plain["owned"])
    else:
        assert zero["owned"] == plain["owned"]


def test_tensor_parallel_ranks_hold_their_slices(runs):
    """Under tensor parallelism rank 0 trains half of every score matrix of
    an attention or FFN projection and the whole of the others; the data-
    parallel mesh splits nothing."""
    model, _, result = runs
    local, whole = result["plain"]["local_shapes"], result["plain"]["scores"]
    for k, shape in local.items():
        full = tuple(whole[k].shape)
        split = any(m in k for m in ("query", "key", "value", "intermediate",
                                     "inter", "output"))
        if model == 1 or not split:
            assert shape == full, k
        else:
            assert 2 * np.prod(shape) == np.prod(full), k
