"""`crvqa_tpu_torch.cli.serve_vqa` end to end vs the JAX server, on the same
argv (the port adds `--device cpu`) and the same artifacts: a stage-1
checkpoint exported from JAX params (`save_torch_state_dict`), a stage-2
`mask.pt` (`export_mask_pt`) and a `classifier4masker.bin`
(`export_classifier_bin`), over the fabricated VQA-CP files of
tests/test_dress_rehearsal.py, with both feature-store backends.

Responses must match in order and answer, with prob within 1e-5 (fp32;
the two forwards differ only in summation order).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.cli import serve_vqa as jserve
from crvqa_tpu.core import torch_compat as jcompat
from crvqa_tpu.data import tokenization as jtok
from crvqa_tpu.data import vqacp as jvqacp
from crvqa_tpu.masking import lxmert_mask_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.native import feature_store as jstore
from crvqa_tpu_torch.cli import serve_vqa as tserve
from crvqa_tpu_torch.core import torch_compat as tcompat
from crvqa_tpu_torch.data import vqacp as tvqacp
from crvqa_tpu_torch.models import LxmertConfig, build_lxmert
from crvqa_tpu_torch.ops.fused_attention import fused_attention
from tests.test_dress_rehearsal import _fabricate
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


def _jax_params(seed):
    cfg = JaxConfig.tiny()
    return jax.jit(JaxLxmert(cfg).init)(
        jax.random.PRNGKey(seed), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_feats=jnp.zeros((2, 8, cfg.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 8, cfg.visual_pos_dim)))["params"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    _fabricate(root)
    params = _jax_params(11)
    jcompat.save_torch_state_dict(str(root / "stage1.bin"), params)
    cfg = JaxConfig.tiny()
    specs = lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = {tuple(k.key for k in path): np.asarray(v) for path, v in flat}
    rng = np.random.default_rng(5)
    masks = {s.key: rng.random(leaves[s.path].shape) > 0.7 for s in specs}
    jcompat.export_mask_pt(str(root / "mask.pt"), masks, specs)
    jcompat.export_classifier_bin(str(root / "classifier4masker.bin"),
                                  _jax_params(12)["classifier"])
    with open(root / "vqa_img_feature_trainval.pickle", "rb") as f:
        import pickle

        jstore.build_feature_store(str(root / "features.bin"),
                                   pickle.load(f))
    questions = json.load(open(root / "vqacp_v2_test_questions.json"))[:10]
    reqs = [{"question_id": q["question_id"], "question": q["question"],
             "image_id": q["image_id"]} for q in questions]
    reqs.insert(3, {"question_id": 77, "question": "what?",
                    "image_id": "no_such"})
    with open(root / "requests.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    return root


def _argv(root, store, out):
    return ["--tiny", "--dtype", "float32", "--seed", "3",
            "--dataroot", str(root), "--img_root", str(root / store),
            "--vocab_file", str(root / "vocab.txt"),
            "--ckpt", str(root / "stage1.bin"),
            "--mask_pt", str(root / "mask.pt"),
            "--classifier_bin", str(root / "classifier4masker.bin"),
            "--input", str(root / "requests.jsonl"), "--output", str(out),
            "--serve_batch_size", "4", "--max_wait_ms", "1"]


@pytest.mark.parametrize("store", ["vqa_img_feature_trainval.pickle",
                                   "features.bin"])
def test_serve_matches_jax_server(artifacts, store):
    root = artifacts
    jserve.main(_argv(root, store, root / f"jax_{store}.jsonl"))
    before = fused_attention.launches
    stats = tserve.main(_argv(root, store, root / f"torch_{store}.jsonl")
                        + ["--device", "cpu"])
    assert fused_attention.launches == before
    want = [json.loads(line) for line in open(root / f"jax_{store}.jsonl")]
    got = [json.loads(line) for line in open(root / f"torch_{store}.jsonl")]
    assert stats["requests"] == len(got) == len(want) == 11
    assert [g["question_id"] for g in got] == [w["question_id"] for w in want]
    assert "no_such" in got[3]["error"] and "no_such" in want[3]["error"]
    for g, w in zip(got, want):
        if "error" in w:
            continue
        assert g["answer"] == w["answer"]
        assert abs(g["prob"] - w["prob"]) <= 1e-5


def test_served_weights_are_pruned_and_overlaid(artifacts):
    """The stage-2 artifacts reach the model: masked weights are exactly
    zero where mask.pt says so, and the classifier is the .bin's."""
    root = artifacts
    args = tserve.build_parser().parse_args(
        _argv(root, "features.bin", root / "unused.jsonl")
        + ["--device", "cpu"])
    model = tserve.build_serving_model(args, torch.device("cpu"))
    sd = model.state_dict()
    raw_masks = torch.load(root / "mask.pt")
    assert len(raw_masks) == 3 + 6 * 2 + 6 * 1 + 16 * 1 + 1
    for name, mask in raw_masks.items():
        assert torch.all(sd[name][~mask] == 0), name
        assert torch.all(sd[name][mask] != 0), name
    clf = tcompat.load_state_dict_file(str(root / "classifier4masker.bin"))
    for name, t in clf.items():
        assert torch.equal(sd["classifier." + name].reshape(t.shape), t)


def test_tokenize_questions_matches_jax(artifacts):
    vocab = str(artifacts / "vocab.txt")
    questions = ["Is this a dog?", "How many cats are there?",
                 "what color is the frisbee , green or blue ?",
                 "ÉTÉ café [MASK] unknownword", "", "is this a " * 9]
    got, got_len = tvqacp.tokenize_questions(
        questions, tvqacp.make_tokenizer(vocab))
    want, want_len = jvqacp.tokenize_questions(
        questions, jtok.WordPieceTokenizer(vocab_file=vocab, native=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)


def test_main_without_device_flag_needs_a_card(artifacts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(_argv(artifacts, "features.bin",
                          artifacts / "never.jsonl"))


def _cpu_argv(root, **io):
    return ["--tiny", "--dtype", "float32", "--device", "cpu",
            "--dataroot", str(root),
            "--img_root", str(root / "vqa_img_feature_trainval.pickle"),
            "--vocab_file", str(root / "vocab.txt"),
            *[a for k, v in io.items() for a in (f"--{k}", str(v))]]


def test_bad_requests_get_error_responses(artifacts, tmp_path):
    """A bad request gets an error response and its batch survives; a
    malformed JSON line is dropped without hanging the server."""
    good = json.loads(open(artifacts / "requests.jsonl").readline())
    req = tmp_path / "req.jsonl"
    with open(req, "w") as f:
        f.write(json.dumps(good) + "\n")
        f.write("{not json at all\n")
        f.write(json.dumps({"question_id": 78}) + "\n")
    out = tmp_path / "out.jsonl"
    tserve.main(_cpu_argv(artifacts, input=req, output=out,
                          serve_batch_size=4, max_wait_ms=1))
    got = [json.loads(line) for line in open(out)]
    assert len(got) == 2
    assert got[0]["question_id"] == good["question_id"] and "answer" in got[0]
    assert got[1] == {"question_id": 78,
                      "error": "request needs question and image_id"}


def test_streaming_flushes_partial_batches(artifacts, tmp_path, monkeypatch):
    """Requests arriving through a pipe slower than --max_wait_ms come
    back in order without waiting for a full batch, and the server exits
    on EOF."""
    import os
    import threading
    import time

    reqs = [json.loads(line)
            for line in open(artifacts / "requests.jsonl")][:3]
    r_fd, w_fd = os.pipe()
    reader, writer = os.fdopen(r_fd, "r"), os.fdopen(w_fd, "w")

    def feed():
        for r in reqs:
            writer.write(json.dumps(r) + "\n")
            writer.flush()
            time.sleep(0.08)
        writer.close()

    monkeypatch.setattr("sys.stdin", reader)
    out = tmp_path / "stream.jsonl"
    feeder = threading.Thread(target=feed)
    feeder.start()
    stats = tserve.main(_cpu_argv(artifacts, output=out, serve_batch_size=8,
                                  max_wait_ms=10))
    feeder.join(timeout=30)
    assert not feeder.is_alive()
    reader.close()
    got = [json.loads(line) for line in open(out)]
    assert [g["question_id"] for g in got] == [r["question_id"] for r in reqs]
    assert stats["requests"] == 3


@pytest.mark.parametrize("extra,error", [
    (["--model_type", "visualbert", "--ckpt", "JAX_CKPT"],
     "cannot read one either"),
    (["--ckpt", "JAX_CKPT"], "cannot read one either"),
])
def test_unported_options_raise(artifacts, extra, error):
    """msgpack params files serve (tests/test_torch_checkpoint_interchange.py);
    the JAX package's msgpack training state `ckpt_<step>` as `--ckpt` is
    refused for either model, as the JAX package's `load_params_any`
    refuses it (a params file or `--resume_from` takes it instead)."""
    from crvqa_tpu.core import checkpoint as jckpt

    ckpt = str(artifacts / "ckpt_4")
    jckpt.save_checkpoint(ckpt, {"step": np.int32(4),
                                 "params": _jax_params(11),
                                 "opt_state": {"count": np.int32(4)}})
    extra = [ckpt if a == "JAX_CKPT" else a for a in extra]
    with pytest.raises(ValueError, match="training state.*" + error):
        tserve.main(_argv(artifacts, "features.bin",
                          artifacts / "never.jsonl")
                    + ["--device", "cpu"] + extra)


def test_whole_module_classifier_pickle_loads_without_its_class(tmp_path,
                                                                monkeypatch):
    """A classifier4masker.bin pickled as a whole module whose class cannot
    be imported at load time (the reference's case) loads through the stub
    unpickler into the same tensors."""
    import sys
    import types

    from crvqa_tpu_torch.models.classifier import SimpleClassifier

    mod = types.ModuleType("reference_only_classifier")

    class RefClassifier(SimpleClassifier):
        pass

    RefClassifier.__module__ = mod.__name__
    RefClassifier.__qualname__ = "RefClassifier"
    mod.RefClassifier = RefClassifier
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    clf = build_lxmert(LxmertConfig.tiny(),
                       generator=torch.Generator().manual_seed(0)).classifier
    clf.__class__ = RefClassifier
    path = str(tmp_path / "classifier4masker.bin")
    torch.save(clf, path)
    monkeypatch.delitem(sys.modules, mod.__name__)

    template = {k: torch.zeros_like(v) for k, v in clf.state_dict().items()}
    got = tcompat.load_torch_params(path, template)
    for name, t in clf.state_dict().items():
        assert torch.equal(got[name], t), name
