"""`serve_mplug --ckpt` of the JAX package's mPLUG `ckpt_final` in the port
(`cli/common.resume_any` into a serving state: every parameter, the
scores and thresholds, as the JAX server keeps them), against the JAX
server on the same file, on the JAX mPLUG rehearsal's fabricated files at
the tiny config, fp32: the same answer for every request by beam search
and by ranking the answer list.

The file is the JAX trainer's state as its `init_state` builds it (weights
from another seed than the served --seed, mask scores moved off their
magnitude init by seeded noise, so the served masks are the file's),
written by the JAX package's `save_checkpoint` as its CLI writes
`ckpt_final`.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crvqa_tpu.cli import serve_mplug as jserve
from crvqa_tpu.cli import vqa_mplug as jvqa_mplug
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.data.mplug_data import synthetic_mplug_batch
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu_torch.cli import serve_mplug
from tests.test_dress_rehearsal_mplug import ANSWERS, _fabricate
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

ARGV = ["--tiny", "--dtype", "float32", "--seed", "11", "--mode", "mask",
        "--beam_size", "2", "--max_answer_len", "6", "--serve_batch_size",
        "4", "--max_wait_ms", "1"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_jax_ckpt")
    _fabricate(root)
    args = jserve.build_parser().parse_args(
        ARGV + ["--vocab_file", str(root / "vocab.txt"), "--output_dir",
                str(root / "j")])
    config, _, model = jvqa_mplug.build_model(args)
    masker, _ = jvqa_mplug.build_masker(args, config)
    b0 = synthetic_mplug_batch(batch_size=1, image_res=config.vit.image_res,
                               vocab_size=config.bert.vocab_size)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(3), b0["images"], b0["question_ids"],
        b0["question_mask"], b0["answer_ids"], b0["answer_mask"],
        b0["weights"])["params"]
    state, _ = jtrain.init_state(model, params,
                                 jtrain.MPlugTrainConfig(mode="mask"),
                                 jax.random.PRNGKey(5), masker=masker)
    rng = np.random.default_rng(0)
    state = state.replace(scores={
        k: v + jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                           * float(jnp.std(v)))
        for k, v in state.scores.items()})
    jckpt.save_checkpoint(str(root / "ckpt_final"), state)
    records = json.load(open(root / "vqa_test.json"))[:6]
    with open(root / "req.jsonl", "w") as f:
        for r in records:
            f.write(json.dumps({"question_id": r["question_id"],
                                "question": r["question"],
                                "image": str(root / r["image"])}) + "\n")
    return root


def _serve(main, root, tag, extra):
    out = root / f"out_{tag}.jsonl"
    main(ARGV + ["--vocab_file", str(root / "vocab.txt"), "--output_dir",
                 str(root / tag), "--ckpt", str(root / "ckpt_final"),
                 "--input", str(root / "req.jsonl"), "--output", str(out)]
         + extra)
    return [json.loads(line) for line in open(out)]


@pytest.mark.parametrize("method", ["beam", "rank"])
def test_served_answers_equal_the_jax_servers(root, method):
    extra = ([] if method == "beam" else
             ["--eval_method", "rank", "--answer_list",
              str(root / "answer_list.json"), "--k_test", "3"])
    want = _serve(jserve.main, root, f"jax_{method}", extra)
    got = _serve(serve_mplug.main, root, f"port_{method}",
                 extra + ["--device", "cpu"])
    assert len(got) == 6 and got == want
    assert all("answer" in o for o in got)
    if method == "rank":
        assert all(o["answer"] in ANSWERS for o in got)
