"""Mask similarity analysis (counterpart of `crvqa_tpu/evals/compare_mask.py`,
the reference's `compare_mask.py`).

Per-matrix and average Jaccard similarity between `mask.pt` files
(`compare_mask.py:31-43`): sim = |m1 & m2| / |m1 | m2|. Reads the port's
exports, the JAX package's and the reference's (one format). Host code
only: no device.

    python -m crvqa_tpu_torch.evals.compare_mask a=run1/mask.pt \
        b=run2/mask.pt [--output sim.json]
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np


def jaccard(m1: np.ndarray, m2: np.ndarray) -> float:
    inter = np.logical_and(m1, m2).sum()
    union = np.logical_or(m1, m2).sum()
    return float(inter) / float(union) if union else 1.0


def compare_mask_dicts(mask1: dict, mask2: dict,
                       show_every_matrix: bool = False) -> float:
    # pair BY KEY: iteration orders differ between our exports (spec
    # order) and reference mask.pt files (torch module traversal), and the
    # matrices often share shapes so an order zip fails silently
    assert set(mask1) == set(mask2), sorted(
        set(mask1).symmetric_difference(mask2))[:5]
    sims = []
    for k in mask1:
        s = jaccard(np.asarray(mask1[k]).astype(bool),
                    np.asarray(mask2[k]).astype(bool))
        sims.append(s)
        if show_every_matrix:
            print(k, s)
    return float(np.mean(sims))


def _load_mask(path: str) -> dict:
    from ..core.torch_compat import load_mask_dict_bool

    return load_mask_dict_bool(path)


def compare_mask_files(paths: dict[str, str],
                       output_json: Optional[str] = None) -> dict:
    """Pairwise similarity matrix over named mask.pt files
    (`compare_mask.py:main`)."""
    masks = {name: _load_mask(p) for name, p in paths.items()}
    sim_mat = {name: [] for name in masks}
    for k1 in masks:
        for k2 in masks:
            sim_mat[k1].append(compare_mask_dicts(masks[k1], masks[k2]))
    if output_json:
        with open(output_json, "w") as f:
            json.dump(sim_mat, f)
    return sim_mat


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser("compare_mask")
    p.add_argument("masks", nargs="+", help="name=path pairs or paths")
    p.add_argument("--output", type=str, default=None)
    args = p.parse_args(argv)
    paths = {}
    for i, item in enumerate(args.masks):
        if "=" in item:
            name, path = item.split("=", 1)
        else:
            name, path = f"mask{i}", item
        paths[name] = path
    sim = compare_mask_files(paths, args.output)
    for name, row in sim.items():
        print(name, "\t".join(f"{x:.5f}" for x in row))


if __name__ == "__main__":
    main()
