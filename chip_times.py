#!/usr/bin/env python3
"""Times the short attention kernels, the masked-matmul kernels and the
head-compact kernel of the checkout this file sits in, through
`chip_smoke.py`'s own kernel phases (`phase_kernel`,
`phase_train_kernels`, `phase_masked_matmul_kernel`,
`phase_head_compact_kernel`: every point checked against its plain
version, then timed under CUDA-graph replay), and sums the attention
kernels per LXMERT forward and train step.

    python3 chip_times.py OUT.json [--build] [--masked-only | --compact-only]

prints one line `SUMMARY <checkout> {...}` (bf16; the primal per forward
at batch 32; the forward for grad, both backwards and
`scaled_dot_product_attention` per train step at batch 256 and 64, dropout
0.1; the masked-matmul forward, dx and ds per call at x [9216, 768], w
[768, 768], beside cuBLAS) and writes every row to OUT.json. `--build`
rebuilds the kernels first (chip_smoke's `build` phase, with its
per-kernel report); `--masked-only` times the masked-matmul kernels alone;
`--compact-only` the masked-matmul kernels and the head-compact kernel (at
x [9216, 768], 4 of 12 heads kept, bf16 and fp32, beside cuBLAS on w *
mask and the gather + cuBLAS + scatter op).

To compare two commits on one card, unpack the other one beside this
checkout (`git archive <commit> | tar -x -C <dir>`), copy this script
into it, and run both copies in turns (parent, change, change, parent) in
one session on the card: each times its own checkout's kernels. Needs
one CUDA card.
"""
from __future__ import annotations

import json
import os
import sys


def main(argv: list[str]) -> int:
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_times: needs a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as smoke
    from crvqa_tpu_torch.models import LxmertConfig

    dev = torch.device("cuda")
    smoke.phase_device(torch, False)
    if "--build" in argv:
        smoke.phase_build()
    masked = smoke.phase_masked_matmul_kernel(torch, dev, False, 0)
    row = next(r for r in masked["rows"]
               if (r["m"], r["k"], r["n"]) == tuple(smoke.MM_SHAPES[0])
               and r["x_dtype"] == r["w_dtype"] == "bfloat16")
    summary = {"masked_b9216": {key: row.get(key) for key in (
        "fwd_ms", "dx_ms", "ds_ms", "ds_bf16g_ms", "fwd_library_ms",
        "dx_library_ms", "ds_library_ms", "fwd_bwd_ms",
        "fwd_bwd_library_ms")}}
    if "--masked-only" in argv or "--compact-only" in argv:
        out = {"masked": masked}
        if "--compact-only" in argv:
            out["compact"] = smoke.phase_head_compact_kernel(torch, dev,
                                                             False, 0)
            for r in out["compact"]["rows"]:
                if r["case"] == "kept4" and "ms" in r:
                    summary[f"compact_{r['dtype']}"] = {key: r[key] for key in (
                        "ms", "plain_ms", "library_ms", "compact_torch_ms",
                        "bound_ms")}
        out["summary"] = summary
        print("SUMMARY", here, json.dumps(summary), flush=True)
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1)
        return 0
    rows = smoke.phase_kernel(torch, dev, False, 0)
    train = smoke.phase_train_kernels(torch, dev, False, 0)
    fwd_mult, bwd_mult = smoke.launch_mult(LxmertConfig())

    def pick(rs, batch, rate=None):
        return [r for r in rs if r["batch"] == batch
                and r["dtype"] == "bfloat16" and r.get("heads", 12) == 12
                and (r["sq"], r["sk"]) in fwd_mult
                and (rate is None or r["rate"] == rate)]

    def total(rs, key, mult):
        return sum(r[key] * mult[(r["sq"], r["sk"])] for r in rs)

    primal = pick(rows, smoke.SERVE_BATCH)
    summary["primal_b32"] = {key: total(primal, key, fwd_mult)
                             for key in ("ms", "plain_ms", "library_ms")}
    for batch in (smoke.TRAIN_BATCH, smoke.S1_BATCH):
        rs = pick(train, batch, smoke.MAIN_RATE)
        summary[f"b{batch}"] = {
            "fwd": total(rs, "fwd_ms", fwd_mult),
            "sdpa_fwd": total(rs, "library_fwd_ms", fwd_mult),
            "stored": total(rs, "stored_ms", bwd_mult),
            "recompute": total(rs, "recompute_ms", bwd_mult),
            "sdpa_fwd_bwd": total(rs, "library_fwd_bwd_ms", bwd_mult)}
    print("SUMMARY", here, json.dumps(summary), flush=True)
    with open(argv[0], "w") as f:
        json.dump({"rows": rows, "train": train, "masked": masked,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
