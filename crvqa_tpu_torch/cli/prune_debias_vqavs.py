"""Stage 2 of LXMERT on VQA-VS (counterpart of
`crvqa_tpu/cli/prune_debias_vqavs.py`, the reference's
`prune_debias_VQAvs.py`; same argv plus `--device`).

    python -m crvqa_tpu_torch.cli.prune_debias_vqavs --output_dir out \\
        --dataroot DATA --img_root FEATS --vocab_file vocab.txt \\
        --train_batch_size 256 --do_train --evaluate_during_training

`prune_debias_vqa` with `--dataset vqavs` as its default: the same masking
machinery on the VQA-VS splits (`data/vqavs.py`). After the run the
prediction dump `test.json` is copied to the reference's (typo'd, kept for
its scorer) `prefictions_VQAvs_test.json` (`prune_debias_VQAvs.py:
1031-1061`); score it with `python -m crvqa_tpu_torch.evals.scoring
--task vqavs`.
"""
from __future__ import annotations

import os
import shutil

from ..parallel.mesh import is_main_process
from . import prune_debias_vqa


def main(argv=None) -> dict:
    parser = prune_debias_vqa.build_parser()
    parser.set_defaults(dataset="vqavs")
    args = parser.parse_args(argv)
    summary = prune_debias_vqa.run(args)
    test_json = os.path.join(args.output_dir, "test.json")
    if is_main_process() and os.path.exists(test_json):
        shutil.copy(test_json, os.path.join(args.output_dir,
                                            "prefictions_VQAvs_test.json"))
    return summary


if __name__ == "__main__":
    main()
