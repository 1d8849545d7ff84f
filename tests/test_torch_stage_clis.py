"""The paper's LXMERT pipeline through the port's CLIs on the CPU, tiny
widths, on the fabricated VQA-CP files of tests/test_dress_rehearsal.py:
`run_vqa_stage1` -> `prune_debias_vqa --stage1_ckpt` -> `run_vqa_stage3`
with the trained mask, the reference-scope random mask, and structured
head / FFN masks.

Checked: the artifacts and their names (the JAX CLIs' names, the stage-1
`.msgpack` twin included); the stage-1 `.bin` loads in the JAX package's
loader; stage 3 keeps its pruned weights exactly zero and
reports the mask's zero rate; the structured run compacts the language
branch; `--resume_from` continues the step count; unported flags raise;
`--model_type visualbert`, which the JAX CLIs parse and never read, is
refused; without a card the CLIs raise unless given `--device cpu`.
"""
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.cli import common as jcommon
from crvqa_tpu.cli import prune_debias_vqa as jstage2_cli
from crvqa_tpu.cli import run_vqa_stage1 as jstage1_cli
from crvqa_tpu.cli import run_vqa_stage3 as jstage3_cli
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu_torch.cli import prune_debias_vqa, run_vqa_stage1, run_vqa_stage3
from crvqa_tpu_torch.core.torch_compat import load_state_dict_file
from crvqa_tpu_torch.masking.masker import weight_name
from crvqa_tpu_torch.masking.prune import lxmert_specs_for
from crvqa_tpu_torch.models import LxmertConfig
from tests.test_dress_rehearsal import _fabricate
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

# what the JAX stage-1 CLI writes for these flags
STAGE1_FILES = {"args.txt", "best_eval_results_vqa_noMASK.txt", "ckpt_4",
                "ckpt_4.meta.json", "ckpt_8", "ckpt_8.meta.json",
                "eval_results_vqa.txt", "metrics.jsonl", "test.json",
                "run_FTlmh_only.bin", "run_FTlmh_only.bin.msgpack"}


def _data(root):
    return ["--tiny", "--device", "cpu", "--dataroot", str(root),
            "--img_root", str(root / "vqa_img_feature_trainval.pickle"),
            "--vocab_file", str(root / "vocab.txt"),
            "--train_batch_size", "8", "--eval_batch_size", "8",
            "--dtype", "float32", "--seed", "0"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("stages")
    _fabricate(root)
    s1 = run_vqa_stage1.main(
        ["--output_dir", str(root / "s1"), *_data(root), "--FT_type", "lmh",
         "--num_train_epochs", "2", "--logging_steps", "2", "--save_steps",
         "4", "--do_train", "--do_eval", "--evaluate_during_training"])
    bin1 = str(root / "s1" / "run_FTlmh_only.bin")
    prune_debias_vqa.main(
        ["--output_dir", str(root / "s2"), *_data(root), "--stage1_ckpt",
         bin1, "--num_train_epochs", "1", "--do_train"])
    s2 = root / "s2"
    stage3 = ["--stage1_ckpt", bin1, "--classifier_bin",
              str(s2 / "classifier4masker.bin"), "--FT_type", "lmh",
              "--num_train_epochs", "1", "--do_train", "--do_eval"]
    trained = run_vqa_stage3.main(
        ["--output_dir", str(root / "s3_trained"), *_data(root), *stage3,
         "--mask_pt", str(s2 / "mask.pt")])
    rand = run_vqa_stage3.main(
        ["--output_dir", str(root / "s3_rand"), *_data(root), *stage3,
         "--training_type", "FT_randMask", "--rand_scope", "reference"])
    rng = np.random.default_rng(0)
    cfg = LxmertConfig.tiny()
    head = np.stack([rng.permutation([1, 1, 0, 0]) for _ in
                     range(cfg.l_layers)]).astype(np.float32)
    ffn = (rng.random((cfg.l_layers, cfg.intermediate_size)) < 0.5
           ).astype(np.float32)
    np.save(root / "head.npy", head)
    np.save(root / "ffn.npy", ffn)
    structured = run_vqa_stage3.main(
        ["--output_dir", str(root / "s3_struct"), *_data(root), *stage3,
         "--head_mask_npy", str(root / "head.npy"), "--ffn_mask_npy",
         str(root / "ffn.npy")])
    return dict(root=root, s1=s1, trained=trained, rand=rand,
                structured=structured)


def test_stage1_writes_the_jax_clis_artifacts(chain):
    out = chain["root"] / "s1"
    assert set(os.listdir(out)) == STAGE1_FILES
    assert "run" + jstage1_cli._SUFFIX["lmh"] in STAGE1_FILES
    s1 = chain["s1"]
    assert s1["step"] == 8 and all(np.isfinite(s1["losses"]))
    preds = json.load(open(out / "test.json"))
    assert sorted(p["question_id"] for p in preds) == list(range(5000, 5020))
    # the best-eval save is the state at a save step: a full state_dict
    saved = load_state_dict_file(str(out / "run_FTlmh_only.bin"))
    assert set(saved) == set(s1["state"].params)
    assert all(t.dtype == torch.float32 for t in saved.values())


def test_stage1_bin_loads_in_the_jax_loader(chain):
    """The interop artifact loads through the JAX package's torch loader
    (`load_params_any`, as `load_stage1_params` calls it) into the JAX
    tree, every leaf equal to the port's tensor."""
    config = JaxConfig.tiny()
    model = JaxLxmert(config)
    ids = jnp.zeros((2, 8), jnp.int32)
    template = jax.jit(model.init)(
        jax.random.PRNGKey(0), input_ids=ids,
        visual_feats=jnp.zeros((2, 4, config.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 4, config.visual_pos_dim)))["params"]
    path = str(chain["root"] / "s1" / "run_FTlmh_only.bin")
    loaded = jcommon.load_params_any(path, template)
    port = load_state_dict_file(path)
    q = loaded["lxmert"]["encoder"]["layer_0"]["attention"]["self"]["query"]
    np.testing.assert_array_equal(
        np.asarray(q["kernel"]),
        port["lxmert.encoder.layer.0.attention.self.query.weight"].numpy().T)


def test_stage3_trained_mask_keeps_pruned_weights_zero(chain):
    out = chain["root"] / "s3_trained"
    name = "run" + "_FT_trainedMask.bin"
    assert f'"{name[3:]}"' in inspect.getsource(jstage3_cli)
    assert {name, "test.json", "eval_results_vqa.txt"} <= set(
        os.listdir(out))
    assert abs(chain["trained"]["zero_rate"] - 0.7) < 0.01
    saved = load_state_dict_file(str(out / name))
    masks = torch.load(chain["root"] / "s2" / "mask.pt")
    assert len(masks) == len(lxmert_specs_for(LxmertConfig.tiny()))
    for key, m in masks.items():
        assert not saved[key][~m].any(), key
    assert all(np.isfinite(chain["trained"]["losses"]))


def test_stage3_rand_mask_prunes_the_reference_scope(chain):
    out = chain["root"] / "s3_rand"
    name = "run" + "FT_randMask.bin"  # no underscore: the reference's spelling
    assert f'"{name[3:]}"' in inspect.getsource(jstage3_cli)
    assert name in os.listdir(out)
    saved = load_state_dict_file(str(out / name))
    for spec in lxmert_specs_for(LxmertConfig.tiny()):
        w = saved[weight_name(spec)]
        rate = float((w == 0).float().mean())
        if ".encoder.layer." in spec.torch_name or "word_emb" in spec.torch_name:
            assert abs(rate - 0.7) < 0.02, spec.torch_name
        elif ".x_layers." in spec.torch_name:
            assert rate < 0.05, spec.torch_name  # outside the scope: dense
    assert 0.1 < chain["rand"]["zero_rate"] < 0.7


def test_stage3_structured_compacts_the_language_branch(chain):
    s = chain["structured"]
    assert s["lang_num_heads"] == 2 and s["zero_rate"] is None
    inter = s["lang_intermediate_size"]
    assert inter == 64  # padded up to the JAX package's multiple of 128, capped
    saved = load_state_dict_file(
        str(chain["root"] / "s3_struct" / "run_FT_trainedMask.bin"))
    hs = LxmertConfig.tiny().head_size
    for l in range(LxmertConfig.tiny().l_layers):
        pre = f"lxmert.encoder.layer.{l}."
        assert saved[pre + "attention.self.query.weight"].shape[0] == 2 * hs
        assert saved[pre + "attention.output.dense.weight"].shape[1] == 2 * hs
    # the cross layers keep every head
    assert saved["lxmert.encoder.x_layers.0.lang_self_att.self.query.weight"
                 ].shape[0] == 4 * hs
    assert all(np.isfinite(s["losses"]))


def test_stage1_resume_continues_the_step_count(chain, tmp_path):
    root = chain["root"]
    summary = run_vqa_stage1.main(
        ["--output_dir", str(tmp_path), *_data(root), "--FT_type", "lmh",
         "--num_train_epochs", "1", "--do_train", "--resume_from",
         str(root / "s1" / "ckpt_8")])
    assert summary["step"] == 12


@pytest.mark.parametrize("cli", [run_vqa_stage1, run_vqa_stage3])
@pytest.mark.parametrize("flag,value,error,match", [
    pytest.param("--model_type", "visualbert", NotImplementedError,
                 "not yet ported", id="--model_type-visualbert"),
    # the runtime's flags are ported; in one process they raise the
    # mesh's and the launcher's own errors instead of training alone
    pytest.param("--mesh_data", "2", ValueError, "does not cover 1 devices",
                 id="--mesh_data-2"),
    pytest.param("--multihost", "true", ValueError, "torchrun",
                 id="--multihost-true")])
def test_unported_flags_raise(tmp_path, monkeypatch, cli, flag, value, error,
                              match):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(error, match=match):
        cli.main(["--output_dir", str(tmp_path), "--tiny", "--device", "cpu",
                  "--synthetic", "8", flag, value])


@pytest.mark.parametrize("cli,jax_cli", [
    (run_vqa_stage1, jstage1_cli), (run_vqa_stage3, jstage3_cli),
    (prune_debias_vqa, jstage2_cli)], ids=["stage1", "stage3", "stage2"])
def test_model_type_visualbert_diverges_from_the_jax_cli(tmp_path, cli,
                                                         jax_cli):
    """The divergence, named: the JAX CLI accepts `--model_type visualbert`
    and never reads it (its source names the flag only where it parses it),
    so it would train LXMERT; the port refuses the flag and says so."""
    args = jax_cli.build_parser().parse_args(
        ["--output_dir", str(tmp_path), "--model_type", "visualbert"])
    assert args.model_type == "visualbert"
    source = inspect.getsource(jax_cli)
    assert source.count("model_type") == source.count(
        'add_argument("--model_type"') + source.count("FTmodel_type")
    assert "LxmertForVQA" in source
    name = jax_cli.__name__.rsplit(".", 1)[1]
    with pytest.raises(NotImplementedError,
                       match=f"JAX package's {name} parses this flag and "
                             "never reads it, so it builds LXMERT"):
        cli.main(["--output_dir", str(tmp_path), "--tiny", "--device", "cpu",
                  "--synthetic", "8", "--model_type", "visualbert"])
    assert "prune_debias_vqa_visualbert" in cli.build_parser().format_help()


def test_stage3_trained_mask_needs_a_mask(tmp_path):
    with pytest.raises(ValueError, match="--mask_pt"):
        run_vqa_stage3.main(["--output_dir", str(tmp_path), "--tiny",
                             "--device", "cpu", "--synthetic", "8"])


@pytest.mark.parametrize("cli", [run_vqa_stage1, run_vqa_stage3])
def test_without_a_card_the_default_device_raises(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--output_dir", str(tmp_path), "--tiny", "--synthetic",
                  "8"])
