"""The port's offline tools (`crvqa_tpu_torch.evals`, `data/preprocess.py`)
against the JAX package's on fabricated predictions, annotations and
masks. Host code on both sides: every result must be equal, dicts and
floats exactly.

The answer strings mix digit words and digits, articles, contractions
without their apostrophe, punctuation around and inside words, numbers
with commas and periods, case, tabs and newlines, and seeded random
strings over that alphabet.
"""
import json
import pickle
import sys

import numpy as np
import pytest
import torch

from crvqa_tpu.data import preprocess as jpre
from crvqa_tpu.evals import compare_mask as jcm
from crvqa_tpu.evals import scoring as jsc
from crvqa_tpu.evals import vqa_eval as jve
from crvqa_tpu_torch.core import torch_compat as tcompat
from crvqa_tpu_torch.data import preprocess as tpre
from crvqa_tpu_torch.evals import compare_mask as tcm
from crvqa_tpu_torch.evals import scoring as tsc
from crvqa_tpu_torch.evals import vqa_eval as tve
from crvqa_tpu_torch.masking.masker import weight_name
from crvqa_tpu_torch.masking.prune import lxmert_specs_for
from crvqa_tpu_torch.models import LxmertConfig, build_lxmert
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXED = ["Two", "two dogs", "2", "the dog", "A cat.", "an apple!",
         "dont know", "isnt it", "yes", "no", "Yes.", "10,000", "3.5",
         "5 .", "ten", "none", "zero", "red/blue", "(left)", "it's",
         "youre right", "  spaced\tout\n", "what?", "one-way", "#1",
         "well,done", "o'clock", "oclock", "", "a", "e.g. this"]
ALPHABET = list("abcdefghij0123456789 .,;:!?/-'\"()") + [
    " two", " the", " a", " dont", " 1,0", "."]


def _answers(seed, n):
    rng = np.random.default_rng(seed)
    rand = ["".join(rng.choice(ALPHABET, size=int(rng.integers(1, 9))))
            for _ in range(n)]
    return FIXED + rand


def _vqa_rows(seed, n=60):
    """(predictions, annotations in the official format, target-count
    annotations): ten human answers each, some unanimous."""
    rng = np.random.default_rng(seed)
    pool = _answers(seed, 40)
    preds, annos, counts = [], [], []
    for qid in range(n):
        humans = [pool[int(i)] for i in rng.integers(0, len(pool), 10)]
        if qid % 7 == 0:
            humans = [humans[0]] * 10
        atype = ["yes/no", "number", "other"][qid % 3]
        pred = humans[int(rng.integers(0, 10))] if qid % 2 else pool[
            int(rng.integers(0, len(pool)))]
        preds.append({"question_id": qid, "answer": pred})
        annos.append({"question_id": qid, "question_type": f"what {qid % 4}",
                      "answer_type": atype,
                      "answers": [{"answer": h, "answer_id": i + 1}
                                  for i, h in enumerate(humans)]})
        tally = {}
        for h in humans:
            tally[h] = tally.get(h, 0) + 1
        counts.append({"question_id": qid, "answers_word": list(tally),
                       "answer_count": tally, "answer_type": atype})
    return preds, annos, counts


@pytest.mark.parametrize("fn", ["normalize_answer", "process_punctuation",
                                "process_digit_article"])
def test_normalization_matches_jax(fn):
    for s in _answers(0, 500):
        assert getattr(tve, fn)(s) == getattr(jve, fn)(s), repr(s)


@pytest.mark.parametrize("seed", [0, 1])
def test_vqa_eval_matches_jax(seed):
    preds, annos, _ = _vqa_rows(seed)
    port, jax_ = tve.VQAEval(), jve.VQAEval()
    assert port.evaluate(preds, annos) == jax_.evaluate(preds, annos)
    assert port.eval_qa == jax_.eval_qa
    assert port.accuracy["overall"] > 0


def test_vqacp_scores_match_jax():
    preds, _, counts = _vqa_rows(2)
    got = tsc.compute_vqacp_scores(preds[:-3], counts)
    assert got == jsc.compute_vqacp_scores(preds[:-3], counts)
    assert got["matched"] == len(counts) - 3


def test_vqavs_scores_match_jax():
    preds, _, counts = _vqa_rows(3, n=90)
    rng = np.random.default_rng(3)
    payload = {"annotations": counts}
    for s in tsc.VQAVS_SPLITS:
        payload[f"{s}_qid"] = [int(q) for q in rng.choice(90, 40, False)]
    got = tsc.compute_vqavs_scores(preds, payload)
    assert got == jsc.compute_vqavs_scores(preds, payload)
    assert tsc.VQAVS_SPLITS == jsc.VQAVS_SPLITS
    with pytest.raises(ValueError, match="lack predictions"):
        tsc.compute_vqavs_scores(preds[1:], payload)


def test_file_scorers_and_cli_match_jax(tmp_path, monkeypatch, capsys):
    preds, annos, counts = _vqa_rows(4)
    pred_path = tmp_path / "pred.json"
    pred_path.write_text(json.dumps(preds))
    torch.save(counts, tmp_path / "test_target_count.pth")
    labels = [{"question_id": p["question_id"],
               "label": {p["answer"]: 0.3 * (p["question_id"] % 4)}}
              for p in preds[::2]]
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    anno_pth = str(tmp_path / "test_target_count.pth")
    assert tsc.load_target_count_annotations(anno_pth) == counts
    assert (tsc.score_prediction_file(str(pred_path), anno_pth)
            == jsc.score_prediction_file(str(pred_path), anno_pth))
    assert (tsc.cal_metric(preds, str(tmp_path / "labels.json"))
            == jsc.cal_metric(preds, str(tmp_path / "labels.json")))
    payload = {"annotations": counts, **{f"{s}_qid": list(range(0, 60, 3))
                                         for s in tsc.VQAVS_SPLITS}}
    (tmp_path / "vs.json").write_text(json.dumps(payload))
    for task, anno in (("vqacp", anno_pth), ("vqavs", tmp_path / "vs.json"),
                       ("mplug", tmp_path / "labels.json")):
        argv = ["--input", str(pred_path), "--anno", str(anno), "--task",
                task]
        tsc._main(argv)
        port_out = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["scoring"] + argv)
        jsc._main()
        assert port_out == capsys.readouterr().out != ""


def _port_masks(tmp_path, name, seed, rate):
    config = LxmertConfig.tiny()
    shapes = build_lxmert(config, "meta").state_dict()
    specs = lxmert_specs_for(config)
    g = torch.Generator().manual_seed(seed)
    masks = {s.key: torch.rand(shapes[weight_name(s)].shape, generator=g)
             > rate for s in specs}
    path = tmp_path / name
    tcompat.export_mask_pt(str(path), masks, specs)
    return str(path)


def test_compare_mask_matches_jax(tmp_path, capsys):
    a = _port_masks(tmp_path, "a.pt", 0, 0.7)
    b = _port_masks(tmp_path, "b.pt", 1, 0.5)
    paths = {"a": a, "b": b, "a_again": a}
    got = tcm.compare_mask_files(paths, str(tmp_path / "port.json"))
    want = jcm.compare_mask_files(paths, str(tmp_path / "jax.json"))
    assert got == want
    assert got["a"][0] == got["a"][2] == 1.0 and 0 < got["a"][1] < 1
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()
    ma, mb = tcompat.load_mask_dict_bool(a), tcompat.load_mask_dict_bool(b)
    assert tcm.compare_mask_dicts(ma, mb, show_every_matrix=True) == \
        jcm.compare_mask_dicts(ma, mb, show_every_matrix=True)
    printed = capsys.readouterr().out.splitlines()
    assert printed[:len(ma)] == printed[len(ma):]
    argv = [f"a={a}", b, "--output", str(tmp_path / "main.json")]
    tcm.main(argv)
    port_out = capsys.readouterr().out
    jcm.main(argv)
    assert port_out == capsys.readouterr().out
    assert port_out.splitlines()[0].startswith("a 1.00000\t")


def _raw_annotations(path, seed, n):
    rng = np.random.default_rng(seed)
    pool = _answers(seed, 20)
    annos = [{"question_id": 100 * seed + i, "image_id": 7 + i % 3,
              "question_type": f"how {i % 3}",
              "answer_type": ["yes/no", "number", "other"][i % 3],
              "answers": [{"answer": pool[int(j)], "answer_id": k + 1}
                          for k, j in enumerate(rng.integers(0, 12, 10))]}
             for i in range(n)]
    path.write_text(json.dumps({"annotations": annos}))
    return str(path)


def test_preprocess_build_cache_matches_jax(tmp_path, capsys):
    train = _raw_annotations(tmp_path / "train.json", 1, 30)
    test = _raw_annotations(tmp_path / "test.json", 2, 20)
    assert (tpre.build_answer_vocab([train, test], 3)
            == jpre.build_answer_vocab([train, test], 3))
    tpre.main(["--dataroot", str(tmp_path / "port"), "--train_anno", train,
               "--test_anno", test, "--min_occurrence", "3"])
    port_out = capsys.readouterr().out
    jpre.main(["--dataroot", str(tmp_path / "jax"), "--train_anno", train,
               "--test_anno", test, "--min_occurrence", "3"])
    assert port_out == capsys.readouterr().out
    assert json.loads(port_out)["ans_num"] > 2
    names = sorted(p.name for p in (tmp_path / "port" / "cache").iterdir())
    assert names == sorted(
        p.name for p in (tmp_path / "jax" / "cache").iterdir())
    for name in names:
        got, want = (tmp_path / d / "cache" / name for d in ("port", "jax"))
        if name.endswith(".pkl"):
            assert pickle.loads(got.read_bytes()) == pickle.loads(
                want.read_bytes()), name
        else:
            assert torch.load(got) == torch.load(want, weights_only=False), \
                name
