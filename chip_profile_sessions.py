#!/usr/bin/env python3
"""How many of its kernels a torch.profiler session records on the card,
in a fresh process and after the card tests' full run in the same process
(the fault `ProfileWindow` and the card tests' profiler helper work around
with `crvqa_tpu_torch.utils.profiling.warm_session`).

    python3 chip_profile_sessions.py [--json out.json] [--reps 6]

Each session (CPU and CUDA activity) launches `warm` one-element kernels
(`warm_session` with WARMUP_KERNELS = warm; 0, 64 and 1024), then the
primal short attention kernel twice, synchronises and stops; the count is
the attention kernels in its Chrome trace (2 when nothing was dropped).
The same sessions run once before and once after
`pytest --noconftest -m gpu tests/test_torch_gpu.py` in this process; the
tests' own result is printed too. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
WARM = (0, 64, 1024)


def sessions(torch, reps: int, tmp: str, tag: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from crvqa_tpu_torch.ops import fused_attention as fa
    from crvqa_tpu_torch.utils import profiling

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 14, 768, generator=g).cuda().bfloat16()
               for _ in range(3))
    bias = torch.zeros(4, 14, device="cuda")
    saved = profiling.WARMUP_KERNELS
    counts: dict = {}
    try:
        for r in range(reps):
            for warm in WARM:
                profiling.WARMUP_KERNELS = warm
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                profiling.warm_session("cuda")
                fa.fused_attention(q, k, v, bias, 12, 64)
                fa.fused_attention(q, k, v, bias, 12, 64)
                torch.cuda.synchronize()
                prof.stop()
                path = os.path.join(tmp, f"{tag}_{warm}_{r}.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
                counts.setdefault(warm, []).append(sum(
                    1 for e in events if e.get("cat") == "kernel"
                    and "fused_attention" in e.get("name", "")))
    finally:
        profiling.WARMUP_KERNELS = saved
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--reps", type=int, default=6)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_profile_sessions: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pytest

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="profile_sessions_") as tmp:
        out["fresh"] = sessions(torch, args.reps, tmp, "fresh")
        print("fresh process:", json.dumps(out["fresh"]), flush=True)
        rc = pytest.main(["--noconftest", "-q", "-m", "gpu", "-p",
                          "no:cacheprovider",
                          os.path.join(REPO, "tests", "test_torch_gpu.py")])
        out["card_tests_rc"] = int(rc)
        out["after_card_tests"] = sessions(torch, args.reps, tmp, "after")
        print(f"after the card tests (rc {int(rc)}):",
              json.dumps(out["after_card_tests"]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
