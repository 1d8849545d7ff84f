"""The scan layout (`--scan_layers`): the port's `models/lxmert_scan.py`,
its stacked mask specs and per-layer thresholds, and the stage-2 CLI's
files, against the JAX package's `ScanLxmertForVQA`,
`lxmert_scan_mask_specs` and `--scan_layers` CLI and against the port's
own unrolled layout, at `LxmertConfig.tiny()` in fp32.

Tolerances: the forward against JAX rtol 1e-5 (the same math through 4
layers in another order of sums); against the port's unrolled model, the
stacked specs' init, thresholds and exported mask.pt, bit for bit (each
layer is the unrolled layer on views of the same numbers). A JAX scan
`ckpt_2` resumed by the port equals the file leaf for leaf; two steps on
from it are held to the JAX `ckpt_4` at the tolerances of
tests/test_torch_resume_interchange.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from crvqa_tpu.cli import prune_debias_vqa as jax_cli
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.masking import Masker as JaxMasker
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking.spec import lxmert_scan_mask_specs as jax_scan_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.models.lxmert_scan import ScanLxmertForVQA as JaxScan
from crvqa_tpu.models.lxmert_scan import stack_params as jax_stack
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu_torch.cli import prune_debias_vqa
from crvqa_tpu_torch.core import checkpoint as ckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.masking.masker import Masker, magnitude_masks
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import (lxmert_mask_specs,
                                          lxmert_scan_mask_specs)
from crvqa_tpu_torch.models import LxmertConfig
from crvqa_tpu_torch.models.lxmert_scan import stack_params, unstack_params
from crvqa_tpu_torch.train import stage2
from tests.test_torch_resume_interchange import (_array, assert_bit_equal,
                                                 flat, moment_scale)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

LR = 1e-3
SPARSITY = (0.3, 0.3, 0.3, 0.7)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
DROPOUT_0 = ["--hidden_dropout_prob", "0", "--attention_probs_dropout_prob",
             "0", "--classifier_dropout", "0"]
BASE = ["--tiny", "--dtype", "float32", "--seed", "0", "--synthetic", "16",
        "--synthetic_pool", "2", "--train_batch_size", "8",
        "--eval_batch_size", "8", "--num_train_epochs", "2",
        "--logging_steps", "2", "--save_steps", "2", "--learning_rate",
        str(LR)]
ARGV = BASE + ["--scan_layers", "true"] + DROPOUT_0


@pytest.fixture(scope="module")
def nets():
    jcfg = JaxConfig.tiny(**NO_DROPOUT)
    b = synthetic_batch(batch_size=4, seed=3, vocab_size=jcfg.vocab_size,
                        ans_num=jcfg.ans_num, feat_dim=jcfg.visual_feat_dim,
                        pos_dim=jcfg.visual_pos_dim)
    jb = {k: jnp.asarray(b[k]) for k in ("input_ids", "visual_feats",
                                          "visual_pos")}
    params = jax.jit(JaxLxmert(jcfg).init)(jax.random.PRNGKey(0),
                                           **jb)["params"]
    tcfg = LxmertConfig.tiny(**NO_DROPOUT)
    unrolled = convert.state_dict_from_jax(jax.tree.map(np.asarray, params))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, unrolled=unrolled,
                jb=jb, tb={k: torch.from_numpy(np.asarray(v))
                           for k, v in jb.items()})


def test_forward_matches_jax_and_the_unrolled_model(nets):
    jcfg, tcfg = nets["jcfg"], nets["tcfg"]
    stacked_jax = jax_stack(nets["params"], jcfg)
    jlogits, jpooled = jax.jit(JaxScan(jcfg).apply)(
        {"params": stacked_jax}, **nets["jb"])
    stacked = stack_params(nets["unrolled"], tcfg)
    # the JAX scan tree carried across names and lays out the same leaves
    carried = convert.state_dict_from_jax(jax.tree.map(np.asarray,
                                                       stacked_jax))
    assert set(carried) == set(stacked)
    for k, t in stacked.items():
        assert torch.equal(carried[k], t), k
    scan = stage2.lxmert_meta_model(tcfg, scan=True).eval()
    inputs = dict(nets["tb"], input_ids=nets["tb"]["input_ids"].long())
    logits, pooled = functional_call(scan, stacked, (), inputs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               rtol=1e-5, atol=1e-6)
    unrolled = stage2.lxmert_meta_model(tcfg).eval()
    ulogits, upooled = functional_call(unrolled, nets["unrolled"], (),
                                       inputs)
    assert torch.equal(logits, ulogits) and torch.equal(pooled, upooled)
    back = unstack_params(stacked)
    assert list(back) == list(nets["unrolled"])
    assert all(torch.equal(back[k], t) for k, t in nets["unrolled"].items())


def test_stacked_specs_init_and_thresholds_are_the_unrolled_ones(nets):
    tcfg = nets["tcfg"]
    dims = (tcfg.l_layers, tcfg.r_layers, tcfg.x_layers)
    specs = lxmert_scan_mask_specs(*dims)
    jspecs = jax_scan_specs(*dims)
    assert [(s.path, s.torch_name, s.weight_type, s.modality, s.stacked,
             s.is_embedding) for s in specs] == [
        (s.path, s.torch_name, s.weight_type, s.modality, s.stacked,
         s.is_embedding) for s in jspecs]
    rates = ModalSparsity.from_compression(*SPARSITY)
    scan = Masker.create(specs, rates)
    flat_masker = Masker.create(lxmert_mask_specs(*dims), rates)
    by_name = {s.torch_name: s.key for s in flat_masker.specs}

    def layers(spec):  # the unrolled keys of a spec's layers, in order
        if not spec.stacked:
            return [by_name[spec.torch_name]]
        return [by_name[spec.torch_name.format(i)]
                for i in range(spec.stacked)]

    def stacked(spec, tree):
        return (torch.stack([tree[k] for k in layers(spec)]) if spec.stacked
                else tree[layers(spec)[0]])

    # the magnitude init, layer by layer
    scores, thresholds = scan.init(stack_params(nets["unrolled"], tcfg))
    uscores, _ = flat_masker.init(nets["unrolled"])
    for s in specs:
        assert torch.equal(scores[s.key], stacked(s, uscores)), s.key
        assert thresholds[s.key].shape == ((s.stacked,) if s.stacked
                                           else ())
    # per-layer resets over random scores: the unrolled thresholds and
    # the JAX package's batched k-th values, exactly
    rng = np.random.default_rng(0)
    uscores = {k: torch.from_numpy(rng.standard_normal(
        tuple(v.shape)).astype(np.float32)) for k, v in uscores.items()}
    scores = {s.key: stacked(s, uscores) for s in specs}
    got = scan.reset_thresholds(scores)
    want = flat_masker.reset_thresholds(uscores)
    jmasker = JaxMasker.create(jspecs, JaxSparsity.from_compression(
        *SPARSITY))
    jgot = jmasker.reset_thresholds({
        s.key: jnp.asarray(scores[s.key].numpy() if s.is_embedding
                           else scores[s.key].transpose(-1, -2).numpy())
        for s in specs})
    for s in specs:
        assert torch.equal(got[s.key], stacked(s, want)), s.key
        np.testing.assert_array_equal(got[s.key].numpy(),
                                      np.asarray(jgot[s.key]), err_msg=s.key)
    # binary masks, zero rates and magnitude masks follow
    masks = scan.binary_masks(scores, got)
    umasks = flat_masker.binary_masks(uscores, want)
    for s in specs:
        assert torch.equal(masks[s.key], stacked(s, umasks)), s.key
    mag = magnitude_masks(stack_params(nets["unrolled"], tcfg), specs,
                          scan.zerorate_dict)
    umag = magnitude_masks(nets["unrolled"], flat_masker.specs,
                           scan.zerorate_dict)
    assert stack_params(umag, tcfg).keys() == mag.keys()
    for name, m in stack_params(umag, tcfg).items():
        assert torch.equal(mag[name], m), name
    assert scan.sparsity_report(scores, got) == flat_masker.sparsity_report(
        uscores, want)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI under --scan_layers: 4 steps, ckpt_2 and ckpt_4."""
    root = tmp_path_factory.mktemp("scan")
    jax_cli.main(["--output_dir", str(root / "jax"), "--do_train"] + ARGV)
    return root


def _port(root, name, *more):
    return prune_debias_vqa.main(
        ["--output_dir", str(root / name), "--device", "cpu", *ARGV,
         *more])


def _scan_model_specs():
    cfg = LxmertConfig.tiny(dtype=torch.float32)
    return (stage2.lxmert_meta_model(cfg, scan=True),
            lxmert_scan_mask_specs(cfg.l_layers, cfg.r_layers,
                                   cfg.x_layers), stage2.Stage2Config())


def test_scan_cli_exports_the_unrolled_mask_pt(jax_run, tmp_path):
    """The port's scan run and its unrolled run from one --seed (dropout
    on), 4 steps with two resets: the same losses, every trained score
    and threshold the unrolled one's layer by layer, and a byte-identical
    mask.pt, whose names are the JAX scan CLI's."""
    runs = {}
    for name, extra in (("unrolled", []), ("scan", ["--scan_layers",
                                                    "true"])):
        runs[name] = prune_debias_vqa.main(
            ["--output_dir", str(tmp_path / name), "--device", "cpu",
             "--do_train", *BASE, *extra])
    assert runs["scan"]["losses"] == runs["unrolled"]["losses"]
    scan, unrolled = runs["scan"]["state"], runs["unrolled"]["state"]
    by_name = {s.torch_name: s.key for s in lxmert_mask_specs(2, 1, 1)}
    for s in lxmert_scan_mask_specs(2, 1, 1):
        keys = ([by_name[s.torch_name.format(i)] for i in range(s.stacked)]
                if s.stacked else [by_name[s.torch_name]])
        for part in ("scores", "thresholds"):
            got = getattr(scan, part)[s.key]
            want = [getattr(unrolled, part)[k] for k in keys]
            assert torch.equal(got, torch.stack(want) if s.stacked
                               else want[0]), (part, s.key)
    a = (tmp_path / "scan" / "mask.pt").read_bytes()
    assert a == (tmp_path / "unrolled" / "mask.pt").read_bytes()
    mine = torch.load(tmp_path / "scan" / "mask.pt", weights_only=True)
    theirs = torch.load(jax_run / "jax" / "mask.pt", weights_only=True)
    assert list(mine) == list(theirs)
    assert all(mine[k].shape == theirs[k].shape for k in mine)


def test_port_resumes_the_jax_scan_checkpoint(jax_run):
    """The JAX scan `ckpt_2` resumed by the port CLI: written back in the
    JAX layout it equals the file bit for bit; two steps on from it match
    the JAX `ckpt_4`."""
    model, specs, cfg = _scan_model_specs()
    state = _port(jax_run, "load", "--resume_from",
                  str(jax_run / "jax" / "ckpt_2"))["state"]
    assert state.step == 2
    assert_bit_equal(convert.jax_from_stage2_state(state, model, specs, cfg),
                     ckpt.load_jax_training_state(
                         str(jax_run / "jax" / "ckpt_2")))
    summary = _port(jax_run, "cont", "--do_train", "--resume_from",
                    str(jax_run / "jax" / "ckpt_2"))
    state = summary["state"]
    ckpt.load_checkpoint(str(jax_run / "cont" / "ckpt_4"), state)
    got = flat(convert.jax_from_stage2_state(state, model, specs, cfg))
    want = flat(ckpt.load_jax_training_state(str(jax_run / "jax" /
                                                 "ckpt_4")))
    assert set(got) == set(want)
    jloss = [m["loss"] for m in map(json.loads, open(
        jax_run / "jax" / "metrics.jsonl")) if m.get("step") == 4
        and "loss" in m]
    np.testing.assert_allclose(summary["losses"][1], jloss[0], rtol=1e-4)
    for k, w in want.items():
        if k.startswith("/frozen_params") or k == "/rng" or w is None \
                or isinstance(w, dict):
            continue
        a, b = _array(got[k]), _array(w)
        if k.startswith(("/opt_state/1/mu", "/opt_state/1/nu")):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-3 * moment_scale(want, k), err_msg=k)
        elif k.endswith("count") or k == "/step":
            assert int(a) == int(b) == 4, k
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * 2,
                                       err_msg=k)


def test_port_scan_state_loads_in_the_jax_package(jax_run, tmp_path):
    """The port's own scan checkpoint, written in the JAX layout, read by
    the JAX package's `load_checkpoint` into its scan CLI's state
    template: the leaves of the port's state."""
    model, specs, cfg = _scan_model_specs()
    state = _port(jax_run, "own", "--do_train")["state"]
    tree = convert.jax_from_stage2_state(state, model, specs, cfg)
    path = tmp_path / "ckpt_4"
    ckpt.save_jax_training_state(str(path), tree, metadata={"step": 4})
    jcfg = JaxConfig.tiny(**NO_DROPOUT)
    params = jax.jit(JaxLxmert(jcfg).init)(
        jax.random.PRNGKey(0), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_feats=jnp.zeros((2, 8, jcfg.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 8, jcfg.visual_pos_dim)))["params"]
    masker = JaxMasker.create(jax_scan_specs(jcfg.l_layers, jcfg.r_layers,
                                             jcfg.x_layers),
                              JaxSparsity.from_compression(*SPARSITY))
    template, _ = jstage2.init_state(
        JaxScan(jcfg), masker, jax_stack(params, jcfg),
        jstage2.Stage2Config(hidden_size=jcfg.hidden_size),
        jax.random.PRNGKey(1))
    loaded = jckpt.load_checkpoint(str(path), template)
    assert int(loaded.step) == 4
    for spec in specs:
        want = state.scores[spec.key].detach()
        got = torch.from_numpy(np.asarray(loaded.scores[spec.key]))
        if spec.stacked or not spec.is_embedding:
            got = got.transpose(-1, -2)
        assert torch.equal(got, want), spec.key
        assert np.array_equal(np.asarray(loaded.thresholds[spec.key]),
                              state.thresholds[spec.key].numpy()), spec.key
    frozen = convert.state_dict_from_jax(
        jax.tree.map(np.asarray, loaded.frozen_params))
    assert set(frozen) == set(state.frozen)
    for name, t in state.frozen.items():
        assert torch.equal(frozen[name], t), name


@pytest.mark.parametrize("kind", ["heads", "layers"])
def test_structured_masking_over_the_scan_layout_raises_in_both(tmp_path,
                                                                kind):
    """`--structured_masking` with `--scan_layers`: the JAX CLI raises a
    TypeError before its first step (its binary_masks reshapes a gate's
    () threshold to the group's [L]); the port raises the same error at
    the same point, and neither writes a checkpoint."""
    argv = ["--tiny", "--synthetic", "16", "--train_batch_size", "8",
            "--num_train_epochs", "1", "--logging_steps", "1",
            "--save_steps", "1", "--do_train", "--dtype", "float32",
            "--scan_layers", "true", "--structured_masking", kind]
    with pytest.raises(TypeError):
        jax_cli.main(["--output_dir", str(tmp_path / "jax"), *argv])
    with pytest.raises(TypeError, match="threshold for a stacked spec"):
        prune_debias_vqa.main(["--output_dir", str(tmp_path / "port"),
                               "--device", "cpu", *argv])
    for d in ("jax", "port"):
        assert not list((tmp_path / d).glob("ckpt_*"))
