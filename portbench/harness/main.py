"""The benchmark's command line: one run of one cell on the card it is
started on; the result is the last line of standard output, the compared
numbers with their limits the last lines of standard error."""
from __future__ import annotations

import argparse
import json
import sys

# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "crvqa_tpu")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names in `sys.modules`, compared whole
    (`crvqa_tpu_torch` is not `crvqa_tpu`)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    from .cells import Benchmark

    bench = Benchmark()
    cell = bench.cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {found} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from .core import run_cell

    result, rows = run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t0, report=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
