"""The port's mPLUG server (`crvqa_tpu_torch.cli.serve_mplug`) end to end on
the CPU at tiny widths, on the files the JAX package's mPLUG rehearsal
fabricates (real JPEGs, a toy WordPiece vocab, an answer list): responses
in arrival order, answers invariant to the serve batch size (padding
cannot change a real row), an unreadable image errors only its own
request, rank mode, and --init_ckpt / --use_checkpoint / the runtime's
flags parsed and not read,
as the JAX server does (`--ckpt` is served: tests/test_torch_vqa_mplug.py).
The same checks as tests/test_serving_mplug.py makes of the JAX server."""
import json

import pytest

from crvqa_tpu_torch.cli import serve_mplug
from tests.test_dress_rehearsal_mplug import ANSWERS, _fabricate


def _args(root, extra=()):
    return ["--tiny", "--dtype", "float32", "--seed", "11", "--mode", "mask",
            "--vocab_file", str(root / "vocab.txt"), "--beam_size", "2",
            "--max_answer_len", "6", "--output_dir", str(root / "out"),
            "--device", "cpu", "--data_workers", "2", *extra]


def _serve(root, reqs, batch_size, tag, extra=()):
    req_path = root / f"req_{tag}.jsonl"
    out_path = root / f"out_{tag}.jsonl"
    with open(req_path, "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")
    stats = serve_mplug.main(_args(root, [
        "--input", str(req_path), "--output", str(out_path),
        "--serve_batch_size", str(batch_size), "--max_wait_ms", "1",
        *extra]))
    assert stats["requests"] == len(reqs)
    return [json.loads(line) for line in open(out_path)]


def _requests(root, n):
    records = json.load(open(root / "vqa_test.json"))[:n]
    return [{"question_id": r["question_id"], "question": r["question"],
             "image": str(root / r["image"])} for r in records]


@pytest.fixture
def root(tmp_path):
    _fabricate(tmp_path)
    return tmp_path


def test_serve_order_batch_invariance_and_bad_requests(root):
    reqs = _requests(root, 5)
    out = _serve(root, reqs, 2, "b2")  # 5 requests at batch 2: padded tail
    assert [o["question_id"] for o in out] == [r["question_id"] for r in reqs]
    assert all(isinstance(o["answer"], str) for o in out)
    out_full = _serve(root, reqs, 5, "b5")
    assert [o["answer"] for o in out_full] == [o["answer"] for o in out]

    bad = [{"question_id": 1, "question": "is this a dog?",
            "image": str(root / "missing.jpg")}, reqs[0],
           {"question_id": 2, "image": reqs[1]["image"]}]
    out_bad = _serve(root, bad, 3, "bad")
    assert "unreadable image" in out_bad[0]["error"]
    assert out_bad[1]["answer"] == out[0]["answer"]
    assert "needs question" in out_bad[2]["error"]


@pytest.mark.parametrize("extra", [["--decode_cache", "false"],
                                   ["--device_normalize", "false"]])
def test_serve_variants_answer_the_same(root, extra):
    """The uncached decode, and images normalised on the host instead of
    shipped as uint8 (the same fp32 arithmetic), answer as the default."""
    reqs = _requests(root, 3)
    default = _serve(root, reqs, 3, "default")
    variant = _serve(root, reqs, 3, "variant", extra=extra)
    assert [o["answer"] for o in variant] == [o["answer"] for o in default]


@pytest.mark.parametrize("k_test", ["0", "3"])
def test_serve_rank_mode(root, k_test):
    reqs = _requests(root, 4)
    extra = ["--eval_method", "rank", "--answer_list",
             str(root / "answer_list.json"), "--k_test", k_test]
    out = _serve(root, reqs, 2, "rank2", extra=extra)
    assert [o["question_id"] for o in out] == [r["question_id"] for r in reqs]
    assert all(o["answer"] in ANSWERS for o in out)
    out_full = _serve(root, reqs, 4, "rank4", extra=extra)
    assert [o["answer"] for o in out_full] == [o["answer"] for o in out]


@pytest.mark.parametrize("flag", [["--init_ckpt", "mplug_base.pth"],
                                  ["--use_checkpoint", "true"],
                                  ["--mesh_data", "2"],
                                  ["--multihost", "true"]])
def test_training_flags_are_parsed_and_not_read(root, flag, caplog):
    """As the JAX server parses --init_ckpt, --use_checkpoint and the
    runtime's flags and never reads them (crvqa_tpu/cli/serve_mplug.py:
    41-95): the same answers as without the flag (the .pth named here does
    not even exist; no process group comes up), and a logged line says the
    flag is not read."""
    reqs = _requests(root, 3)
    default = _serve(root, reqs, 3, "default")
    with caplog.at_level("INFO", logger="crvqa_tpu_torch"):
        flagged = _serve(root, reqs, 3, "flagged", extra=flag)
    assert flagged == default
    assert any(f"{flag[0]} is not read" in r.getMessage()
               for r in caplog.records)


def test_without_a_card_the_default_device_raises(root, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = [a for a in _args(root) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_mplug.main(argv)


def test_data_layer_matches_jax(root):
    """What the server feeds the model, against the JAX package's own
    functions on the same files: the eval image transform (uint8 and
    normalised), question splicing, fixed-length tokenization (with the
    rank list's extra [SEP]), decoding, and the synthetic batch."""
    import numpy as np

    from crvqa_tpu.data import mplug_data as jdata
    from crvqa_tpu.data.tokenization import WordPieceTokenizer as JTok
    from crvqa_tpu_torch.data import mplug_data as tdata
    from crvqa_tpu_torch.data.tokenization import WordPieceTokenizer

    records = json.load(open(root / "vqa_test.json"))
    paths = [str(root / r["image"]) for r in records[:4]]
    for raw in (True, False):
        want = jdata.load_images(paths, 40, raw=raw)
        got = tdata.load_images(paths, 40, workers=2, raw=raw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    vocab = str(root / "vocab.txt")
    tj, tt = JTok(vocab), WordPieceTokenizer(vocab)
    texts = [tdata.augment_question(r, True, True) for r in records]
    assert texts == [jdata.augment_question(r, True, True) for r in records]
    for width, extra in ((25, False), (6, True), (3, False)):
        for a, b in zip(tdata._tokenize_fixed(tt, texts, width,
                                              extra_eos=extra),
                        jdata._tokenize_fixed(tj, texts, width,
                                              extra_eos=extra)):
            np.testing.assert_array_equal(a, b)
    ids = list(range(0, 128, 3))
    assert tt.decode(ids) == tj.decode(ids)
    assert tdata.question_token_len(True, 40) == 40
    assert tdata.question_token_len(False, 40) == 25

    for uint8 in (True, False):
        want = jdata.synthetic_mplug_batch(batch_size=3, seed=2,
                                           uint8_images=uint8)
        got = tdata.synthetic_mplug_batch(batch_size=3, seed=2,
                                          uint8_images=uint8)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
