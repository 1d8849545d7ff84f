"""The readings the `mplug-mask-b128` output check's limits are set
from, on the card at the cell's own size, all in one process:

    python3 portbench/calibrate_mplug.py [--workload mplug-mask-b128] \\
        --seeds 1,2,... [--control-seeds 7,8,9] [--fault-seeds 4,5,6] \\
        [--seconds 3]

- each of `--seeds`: a sound run (`run_cell` with a short window), its
  compared numbers;
- each of `--control-seeds`: the control, the plain reference in float8
  (`reference.common.Precision("fp8")`) in the program's place, against
  the float32 reference;
- each of `--fault-seeds`: a run with half of every batch left out of the
  step (`mplug_train.make_train_step` handed the first half of each
  batch, the loss the sum over it over its questions).

One JSON line per reading on standard output. The benchmark's own runs
never run this."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def half_batch_fault():
    """Patch the program: every train step sees the first half of its
    batch. Returns the undo."""
    from crvqa_tpu_torch.train import mplug_train

    make = mplug_train.make_train_step

    def half(batch):
        n = batch["weights"].shape[0]
        return {k: v[:n // 2] for k, v in batch.items()}

    def train_step(*a, **k):
        step = make(*a, **k)
        return lambda state, batch: step(state, half(batch))

    mplug_train.make_train_step = train_step
    return lambda: setattr(mplug_train, "make_train_step", make)


def control_readings(bench, workload: str, seed: int, device) -> dict:
    """The control's numbers: the float8 reference against the float32
    one, on the cell's inputs from `seed`."""
    import torch

    from portbench.drivers.mplug_mask_train import reference_outputs
    from portbench.harness import cells
    from portbench.harness.check import training_readings
    from portbench.harness.core import Run
    from portbench.reference.common import Precision

    cell = bench.cell(workload)
    cfg, trf = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    run = Run(bench, cell, cfg, trf, cells.family(cfg), seed, 0.0, False,
              torch.device(device), 0.0, bench.limits(workload))
    return training_readings(reference_outputs(run, Precision("fp8")),
                             reference_outputs(run))


def main(argv) -> int:
    p = argparse.ArgumentParser("calibrate_mplug")
    p.add_argument("--workload", default="mplug-mask-b128")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import gc

    import torch

    from portbench.harness.cells import Benchmark
    from portbench.harness.core import run_cell

    if not torch.cuda.is_available():
        print("calibrate_mplug: no CUDA card", file=sys.stderr)
        return 2
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    bench = Benchmark()

    def emit(kind, seed, readings, t):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "readings": readings,
                          "seconds": round(time.perf_counter() - t, 3)}),
              flush=True)

    def program(kind, seed):
        t = time.perf_counter()
        out, _ = run_cell(bench, args.workload, seed, args.seconds, False,
                          "cuda", t)
        emit(kind, seed, {k: v["value"] for k, v in out["checks"].items()},
             t)

    for seed in seeds(args.seeds):
        program("program", seed)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        t = time.perf_counter()
        emit("control", seed, control_readings(bench, args.workload, seed,
                                               "cuda"), t)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds(args.fault_seeds):
        undo = half_batch_fault()
        try:
            program("half_batch", seed)
        finally:
            undo()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
