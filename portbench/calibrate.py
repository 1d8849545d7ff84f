"""The readings the output check's limits are set from, on the card at a
cell's own size, all in one process:

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault-seeds 4,5,6] [--seconds 3]

- each of `--seeds`: a sound run (`run_cell` with a short window), its
  compared numbers;
- each of `--control-seeds`: the control, the plain reference in float8
  (`reference.common.Precision("fp8")`) in the program's place, against
  the float32 reference;
- each of `--fault-seeds`: a run with half of every batch left out of the
  step and the mean taken over the rest (training), or half of every
  batch's answers left out (answering).

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


def half_batch_faults():
    """Patch the program: every train step sees the first half of its
    batch (the loss the mean over it); every eval step computes the first
    half's answers and leaves the rest 0."""
    import torch

    from crvqa_tpu_torch.train import stage2

    make_train, make_eval = stage2.make_train_step, stage2.make_eval_step

    def half(batch):
        n = batch["input_ids"].shape[0]
        return {k: v[:n // 2] for k, v in batch.items()}

    def train_step(*a, **k):
        step = make_train(*a, **k)
        return lambda state, batch: step(state, half(batch))

    def eval_step(*a, **k):
        step = make_eval(*a, **k)

        def halved(state, batch):
            logits = step(state, half(batch))
            return torch.cat([logits, torch.zeros_like(logits)])
        return halved

    stage2.make_train_step, stage2.make_eval_step = train_step, eval_step
    return lambda: (setattr(stage2, "make_train_step", make_train),
                    setattr(stage2, "make_eval_step", make_eval))


def control_readings(bench, workload: str, seed: int, device) -> dict:
    """The control's numbers: the float8 reference against the float32
    one, on the cell's inputs from `seed`."""
    import torch

    from portbench.harness import cells
    from portbench.harness.check import answer_readings, training_readings
    from portbench.harness.core import Run
    from portbench.reference.common import Precision

    cell = bench.cell(workload)
    cfg, trf = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    run = Run(bench, cell, cfg, trf, cells.family(cfg), seed, 0.0, False,
              torch.device(device), 0.0, bench.limits(workload))
    fp8 = Precision("fp8")
    if trf["driver"] == "stage2_train":
        from portbench.drivers.stage2_train import reference_outputs

        return training_readings(reference_outputs(run, fp8),
                                 reference_outputs(run))
    from portbench.drivers.answer import reference_logits

    js = set(range(trf["pool_batches"]))
    low = reference_logits(run, js, fp8)
    ref = reference_logits(run, js)
    rows = torch.arange(trf["batch_size"])
    return answer_readings([(j, rows, low[j]) for j in sorted(js)], ref, 0)


def main(argv) -> int:
    p = argparse.ArgumentParser("calibrate")
    p.add_argument("--workload", required=True)
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
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    bench = Benchmark()

    def emit(kind, seed, readings, t):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "readings": readings,
                          "seconds": round(time.perf_counter() - t, 3)}),
              flush=True)

    for seed in seeds(args.seeds):
        t = time.perf_counter()
        out, _ = run_cell(bench, args.workload, seed, args.seconds, False,
                          "cuda", t)
        emit("program", seed, {k: v["value"] for k, v in
                               out["checks"].items()}, t)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        t = time.perf_counter()
        emit("control", seed, control_readings(bench, args.workload, seed,
                                               "cuda"), t)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds(args.fault_seeds):
        t = time.perf_counter()
        undo = half_batch_faults()
        try:
            out, _ = run_cell(bench, args.workload, seed, args.seconds,
                              False, "cuda", t)
        finally:
            undo()
        emit("half_batch", seed, {k: v["value"] for k, v in
                                  out["checks"].items()}, t)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
