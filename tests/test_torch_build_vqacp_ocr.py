"""The port's `build_vqacp_ocr` (crvqa_tpu_torch/data/build_vqacp_ocr.py)
against the JAX package's module on fabricated VQA-v2 annotations, OCR
records and VQA-CP split files (tests/test_mplug_data.py's fixture idea):
every output file is byte for byte the JAX module's, under two seeds of
the val-split sample."""
import json

import pytest

from crvqa_tpu.data import build_vqacp_ocr as jbuild
from crvqa_tpu_torch.data import build_vqacp_ocr as tbuild
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

OUTPUTS = ("train.json", "test.json", "val.json", "train_bias.json",
           "test_labels.json", "val_labels.json")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocr")
    ocr = [{"question_id": i, "image": f"train2014/img_{i}.jpg",
            "question": f"q{i}",
            "answer": (["yes", "yes", "no"] if i % 3 == 0 else
                       ["2", "2", "3"] if i % 3 == 1 else ["red"] * 3),
            "ocr": [[[0, 0], "tok"]]} for i in range(40)]
    anns = {"annotations": [
        {"question_id": i, "question_type": ["is this", "how many",
                                             "what color"][i % 3],
         "answer_type": ["yes/no", "number", "other"][i % 3]}
        for i in range(40)]}
    (root / "ocr.json").write_text(json.dumps(ocr))
    (root / "anns.json").write_text(json.dumps(anns))
    (root / "cp_train.json").write_text(
        json.dumps([{"question_id": i} for i in range(0, 40, 2)]))
    (root / "cp_test.json").write_text(
        json.dumps([{"question_id": i} for i in range(1, 40, 2)] +
                   [{"question_id": 99}]))  # not in the OCR data
    return root


@pytest.mark.parametrize("seed", ["0", "7"])
def test_outputs_are_the_jax_modules_byte_for_byte(files, seed, capsys):
    argv = ["--vqa_ocr_files", str(files / "ocr.json"),
            "--vqa_annotation_files", str(files / "anns.json"),
            "--vqacp_train_questions", str(files / "cp_train.json"),
            "--vqacp_test_questions", str(files / "cp_test.json"),
            "--val_size", "8", "--seed", seed]
    jbuild.main(argv + ["--output_dir", str(files / f"jax{seed}")])
    jax_line = capsys.readouterr().out
    tbuild.main(argv + ["--output_dir", str(files / f"port{seed}")])
    assert capsys.readouterr().out == jax_line
    for name in OUTPUTS:
        assert ((files / f"port{seed}" / name).read_bytes()
                == (files / f"jax{seed}" / name).read_bytes()), name
    val = json.load(open(files / f"port{seed}" / "val.json"))
    assert len(val) == 8
