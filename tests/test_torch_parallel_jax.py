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
On the same ranks the port's steps also run as one window
(`make_multi_step`, `--steps_per_dispatch`), equal to the steps one by one
bit for bit, and with `--structured_masking heads` from a JAX
`StructuredMasker` state, held to the JAX mesh's structured steps at data
1 x model 2: under tensor parallelism every rank keeps the whole (4,)
head gates, as the JAX rule replicates them. The scan layout
(`--scan_layers`, stacked [L, ...] leaves) runs on the same ranks from a
JAX `ScanLxmertForVQA` state: nothing splits, each rank of the model
group runs the whole model, and both ranks end alike. Layer-wise KD
(`Stage2Config.use_kd`) runs on the same ranks and is held to the JAX
mesh's KD steps at data 1 x model 2. Both meshes run in one spawn of the
ranks.

Setup: the tiny LXMERT (4 heads, hidden 32, intermediate 64) in fp32 with
every dropout 0, the LMH loss at 0.3/0.3/0.3 and zero rate 0.7.

Tolerances, fp32 (as tests/test_torch_stage2.py): losses rtol 1e-4;
scores, classifier and thresholds atol 2 * lr * steps (AdamW moves a score
whose gradient is within rounding of zero by about lr either way); first
moments atol 1e-7 + rtol 1e-3 and second moments atol 1e-10 + rtol 1e-3
(gradients agree to 1e-4 relative), for every leaf, structured gates
included. The port's ZeRO run equals its
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
from crvqa_tpu.masking.spec import lxmert_scan_mask_specs as jax_scan_specs
from crvqa_tpu.masking.structured import StructuredMasker as JaxStructured
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.models.lxmert_scan import ScanLxmertForVQA as JaxScan
from crvqa_tpu.models.lxmert_scan import stack_params as jax_stack
from crvqa_tpu.parallel import (MeshConfig, make_mesh, replicated_sharding,
                                shard_batch)
from crvqa_tpu.parallel.tp import shard_params_tp, shard_scores_tp
from crvqa_tpu.parallel.zero import shard_opt_state
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu_torch.core import checkpoint as tckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.masking.masker import Masker
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import (lxmert_mask_specs,
                                          lxmert_scan_mask_specs)
from crvqa_tpu_torch.masking.structured import (StructuredMasker,
                                                lang_head_mask)
from crvqa_tpu_torch.models import LxmertConfig
from crvqa_tpu_torch.parallel.dryrun import free_port
from crvqa_tpu_torch.train import stage2
from tests.torch_parallel_worker import run_ranks
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

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
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), input_ids=jnp.asarray(b0["input_ids"]),
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
    jsmasker = JaxStructured.create(
        jax_specs(jcfg.l_layers, jcfg.r_layers, jcfg.x_layers),
        JaxSparsity.from_compression(*SPARSITY), controlled_init="magnitude",
        structured_masking="heads", num_heads=jcfg.num_attention_heads)
    jsstate, _ = jstage2.init_state(jmodel, jsmasker, params, jsc,
                                    jax.random.PRNGKey(1))
    dims = (jcfg.l_layers, jcfg.r_layers, jcfg.x_layers)
    jscan = JaxScan(jcfg)
    jscan_masker = JaxMasker.create(
        jax_scan_specs(*dims), JaxSparsity.from_compression(*SPARSITY),
        controlled_init="magnitude")
    jscan_state, _ = jstage2.init_state(jscan, jscan_masker,
                                        jax_stack(params, jcfg), jsc,
                                        jax.random.PRNGKey(1))

    def carry(st, specs):
        return convert.stage2_from_jax(
            jax.tree.map(np.asarray, st.frozen_params),
            jax.tree.map(np.asarray, st.train_params),
            jax.tree.map(np.asarray, st.scores),
            jax.tree.map(np.asarray, st.thresholds), specs)

    carried = {"plain": carry(jstate, jmasker.specs),
               "structured": carry(jsstate, jsmasker.specs),
               "scan": carry(jscan_state, jscan_masker.specs)}
    tcfg = LxmertConfig.tiny(**NO_DROPOUT)
    rates = ModalSparsity.from_compression(*SPARSITY)
    maskers = {
        "plain": Masker.create(lxmert_mask_specs(*dims), rates,
                               controlled_init="magnitude"),
        "structured": StructuredMasker.create(
            lxmert_mask_specs(*dims), rates, controlled_init="magnitude",
            structured_masking="heads",
            num_heads=tcfg.num_attention_heads),
        "scan": Masker.create(lxmert_scan_mask_specs(*dims), rates,
                              controlled_init="magnitude")}
    tsc = stage2.Stage2Config(**kw)

    def jax_as_port(tree, kind="plain"):
        """A JAX `kind` state (a file's tree) in the port's layout."""
        model = stage2.lxmert_meta_model(tcfg, scan=kind == "scan")
        masker = maskers[kind]
        state, _ = stage2.init_state(model, masker, carried[kind]["params"],
                                     tsc, seed=0, device="cpu")
        convert.stage2_state_from_jax(state, tree, masker.specs, tsc)
        return state

    return dict(jmodel=jmodel, jmasker=jmasker, jsc=jsc, jstate=jstate,
                tx=tx, batches=batches, carried=carried["plain"], kw=kw,
                jax_as_port=jax_as_port, jsmasker=jsmasker, jsstate=jsstate,
                structured=carried["structured"], jscan=jscan,
                jscan_masker=jscan_masker, jscan_state=jscan_state,
                scan=carried["scan"], tcfg=tcfg)


def _jax_steps(setup, mesh, model, jmasker, jstate, zero=False,
               jmodel=None, jsc=None):
    """The JAX steps of `jmodel` (the unrolled model by default) on `mesh`
    (tensor-parallel placement at model > 1, ZeRO with `zero`) under `jsc`
    (the setup's config by default) and a threshold reset: (losses, final
    state)."""
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
    step = jstage2.make_train_step(jmodel or setup["jmodel"], jmasker,
                                   setup["tx"], jsc or setup["jsc"],
                                   mesh=mesh if zero else None)
    losses = []
    for b in setup["batches"]:
        js, m = step(js, shard_batch(mesh, {k: v for k, v in b.items()
                                            if k != "valid"}))
        losses.append(float(m.loss))
    return losses, jstage2.make_threshold_reset(jmasker)(js)


def _as_port(setup, js, path, kind):
    """A JAX state written to `path` and read back in the port's layout."""
    jckpt.save_checkpoint(path, js)
    return setup["jax_as_port"](tckpt.load_jax_training_state(path), kind)


@pytest.fixture(scope="module")
def jax_structured(setup, tmp_path_factory):
    """The JAX mesh's structured steps at data 1 x model 2: the losses,
    gates and scores, thresholds and binary masks after the reset, and
    the whole state in the port's layout (its Adam moments)."""
    mesh = make_mesh(MeshConfig(data=1, model=2), jax.devices()[:2])
    losses, js = _jax_steps(setup, mesh, 2, setup["jsmasker"],
                            setup["jsstate"])
    state = _as_port(setup, js, str(tmp_path_factory.mktemp("jstruct")
                                    / "ckpt"), "structured")
    return (losses, jax.device_get(js.scores), jax.device_get(js.thresholds),
            jax.device_get(setup["jsmasker"].binary_masks(js.scores,
                                                          js.thresholds)),
            state)


@pytest.fixture(scope="module")
def jax_kd(setup, tmp_path_factory):
    """The JAX mesh's layer-wise KD steps at data 1 x model 2: the losses
    and the state in the port's layout."""
    mesh = make_mesh(MeshConfig(data=1, model=2), jax.devices()[:2])
    jsc = jstage2.Stage2Config(**setup["kw"], use_kd=True,
                               kd_mode="layerwise")
    losses, js = _jax_steps(setup, mesh, 2, setup["jmasker"],
                            setup["jstate"], jsc=jsc)
    return losses, _as_port(setup, js, str(tmp_path_factory.mktemp("jkd")
                                           / "ckpt"), "plain")


MESHES = {"dp": (2, 1), "tp": (1, 2)}


def _jax_runs(setup, tmp, data, model):
    """The JAX steps on its (data, model) mesh, without and with ZeRO and
    in the scan layout, each end state in the port's layout."""
    mesh = make_mesh(MeshConfig(data=data, model=model), jax.devices()[:2])
    jax_runs = {}
    for name, zero in (("plain", False), ("zero", True)):
        losses, js = _jax_steps(setup, mesh, model, setup["jmasker"],
                                setup["jstate"], zero)
        jax_runs[name] = (losses, _as_port(setup, js, str(tmp / f"jax_{name}"),
                                           "plain"))
    losses, js = _jax_steps(setup, mesh, model, setup["jscan_masker"],
                            setup["jscan_state"], jmodel=setup["jscan"])
    jax_runs["scan"] = (losses, _as_port(setup, js, str(tmp / "jax_scan"),
                                         "scan"))
    return jax_runs


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    """The JAX runs on both meshes, and the port's on 2 gloo ranks laid
    out alike, both meshes in one spawn of the ranks: {mesh id: (JAX
    runs, the ranks' results)}."""
    tmp = tmp_path_factory.mktemp("mesh")
    jax_runs = {k: _jax_runs(setup, tmp / k, *mesh)
                for k, mesh in MESHES.items()}
    torch.save({"carried": setup["carried"], "batches": setup["batches"],
                "structured": setup["structured"], "scan": setup["scan"],
                "config": NO_DROPOUT, "sparsity": SPARSITY,
                "stage2": setup["kw"], "meshes": list(MESHES.values())},
               tmp / "inputs.pt")
    port = free_port()
    run_ranks(lambda r: [sys.executable, "-m", "tests.torch_parallel_worker",
                         "stage2_steps", str(r), "2", str(port), str(tmp)], 2)
    out = {}
    for k, (data, model) in MESHES.items():
        result = torch.load(tmp / f"result_{data}x{model}.pt",
                            weights_only=False)
        result["scan_rank1"] = torch.load(
            tmp / f"scan_rank1_{data}x{model}.pt", weights_only=False)
        out[k] = (jax_runs[k], result)
    return out


@pytest.fixture(scope="module", params=list(MESHES), ids=list(MESHES))
def runs(request, setup, spawned):
    jax_runs, result = spawned[request.param]
    return MESHES[request.param][1], jax_runs, result, setup


def _assert_moments_match(got, want):
    """The port's gathered Adam moments against a JAX state's, every leaf
    (scores, gates, classifier) at the moments' tolerances."""
    assert sorted(got["mu"]) == sorted(want.opt_state.mu)
    for k, t in want.opt_state.mu.items():
        np.testing.assert_allclose(got["mu"][k].numpy(), t.numpy(),
                                   atol=1e-7, rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(got["nu"][k].numpy(),
                                   want.opt_state.nu[k].numpy(),
                                   atol=1e-10, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("name", ["plain", "zero", "scan"])
def test_two_ranks_match_the_jax_mesh(runs, name):
    """The unrolled runs without and with ZeRO, and the scan layout's
    (stacked [L, ...] leaves and [L] thresholds, whole on every rank
    under tensor parallelism as the JAX rule replicates 3-D leaves)."""
    _, jax_runs, result, _ = runs
    jlosses, want = jax_runs[name]
    got = result[name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    atol = 2 * LR * STEPS
    for k, t in want.scores.items():
        np.testing.assert_allclose(got["scores"][k].detach().numpy(),
                                   t.detach().numpy(), atol=atol, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got["thresholds"][k].numpy(),
                                   want.thresholds[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)
    for k, t in want.train_params["classifier"].items():
        np.testing.assert_allclose(got["classifier"][k].detach().numpy(),
                                   t.detach().numpy(), atol=atol, rtol=0,
                                   err_msg=k)
    _assert_moments_match(got, want)


def test_scan_ranks_run_the_whole_model_alike(runs):
    """In the scan layout no leaf splits (`tensor_parallel` is None at
    model 2 too): each rank trains the whole stacked leaves, and both
    ranks end with the same state bit for bit."""
    _, _, result, setup = runs
    scan, other = result["scan"], result["scan_rank1"]
    assert scan["tp"] is None and other["tp"] is None
    assert scan["local_shapes"] == {k: tuple(v.shape) for k, v in
                                    setup["scan"]["scores"].items()}
    assert any(len(shape) == 3 for shape in scan["local_shapes"].values())
    assert scan["losses"] == other["losses"]
    for part in ("scores", "classifier", "mu", "nu", "thresholds"):
        assert list(scan[part]) == list(other[part])
        for k in scan[part]:
            assert torch.equal(scan[part][k], other[part][k]), (part, k)


def test_zero_state_equals_the_unsharded_state(runs):
    model, _, result, _ = runs
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
    model, _, result, _ = runs
    local, whole = result["plain"]["local_shapes"], result["plain"]["scores"]
    for k, shape in local.items():
        full = tuple(whole[k].shape)
        split = any(m in k for m in ("query", "key", "value", "intermediate",
                                     "inter", "output"))
        if model == 1 or not split:
            assert shape == full, k
        else:
            assert 2 * np.prod(shape) == np.prod(full), k


def test_window_equals_the_steps_one_by_one(runs):
    """The same two steps as one window (`make_multi_step` over each
    rank's stacked blocks) on the same ranks: bit for bit."""
    _, _, result, _ = runs
    plain, window = result["plain"], result["window"]
    assert window["losses"] == plain["losses"]
    for part in ("scores", "classifier", "mu", "nu", "thresholds"):
        assert list(window[part]) == list(plain[part])
        for k in plain[part]:
            assert torch.equal(window[part][k], plain[part][k]), (part, k)


def test_structured_heads_match_the_jax_mesh(runs, jax_structured):
    """`--structured_masking heads` on the 2 ranks (data 2, and data 1 x
    model 2) against the JAX mesh at data 1 x model 2: the losses, the
    (4,) head gates (whole on every rank under tensor parallelism: the
    rank keeps its own heads' part of each, and the gates' gradients are
    summed over the model group), the unstructured scores, the Adam
    moments of both, the thresholds, and the language layers' head mask
    (the stage-3 `head_mask.npy`); the masks expand over the whole
    weights."""
    _, _, result, setup = runs
    jlosses, jscores, jthresholds, jmasks, jstate = jax_structured
    got = result["structured"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    heads = setup["tcfg"].num_attention_heads
    atol = 2 * LR * STEPS
    gates = 0
    for k, t in got["scores"].items():
        want = np.asarray(jscores[k])
        want = want.T if want.ndim == 2 and "embedding" not in k else want
        assert t.shape == want.shape, k
        np.testing.assert_allclose(t.detach().numpy(), want, atol=atol,
                                   rtol=0, err_msg=k)
        if tuple(t.shape) == (heads,):
            gates += 1
            assert got["local_shapes"][k] == (heads,), k  # whole
        assert float(got["thresholds"][k]) == pytest.approx(
            float(jthresholds[k]), abs=atol)
    assert gates > 0
    # every gate's and score's Adam moments: a gate stepped from only this
    # rank's heads' part of its gradient leaves the others' moments at 0
    _assert_moments_match(got, jstate)
    assert sum(k.startswith("scores/") and tuple(t.shape) == (heads,)
               for k, t in jstate.opt_state.mu.items()) == gates
    masker = StructuredMasker.create(
        lxmert_mask_specs(2, 1, 1), ModalSparsity.from_compression(
            *SPARSITY), structured_masking="heads", num_heads=heads)
    want = lang_head_mask(masker, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in jmasks.items()}, 2, heads)
    np.testing.assert_array_equal(got["head_mask"], want)
    assert got["whole_shapes"] == {
        k: tuple(v.shape) for k, v in setup["carried"]["params"].items()
        if not k.startswith("classifier.")}


def test_layerwise_kd_matches_the_jax_mesh(runs, jax_kd):
    """`Stage2Config(use_kd=True, kd_mode="layerwise")` on the 2 ranks
    (data 2, and data 1 x model 2: the dense teacher runs the same
    tensor-parallel forward on each rank's frozen slices) against the JAX
    mesh's KD steps at data 1 x model 2: losses, scores, classifier,
    thresholds and every Adam moment."""
    _, _, result, _ = runs
    jlosses, want = jax_kd
    got = result["kd"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    assert got["losses"] != result["plain"]["losses"]  # the KD term counts
    atol = 2 * LR * STEPS
    for k, t in want.scores.items():
        np.testing.assert_allclose(got["scores"][k].detach().numpy(),
                                   t.detach().numpy(), atol=atol, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got["thresholds"][k].numpy(),
                                   want.thresholds[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)
    for k, t in want.train_params["classifier"].items():
        np.testing.assert_allclose(got["classifier"][k].detach().numpy(),
                                   t.detach().numpy(), atol=atol, rtol=0,
                                   err_msg=k)
    _assert_moments_match(got, want)
