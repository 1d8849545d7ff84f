"""Launch helpers and rank bodies for the port's multi-process tests
(tests/test_torch_parallel_*.py): each rank is its own interpreter, as
torchrun starts them, on gloo over 127.0.0.1. Each test module spawns its
ranks once and runs all its cases in them. This module imports no JAX.

    python -m tests.torch_parallel_worker units RANK WORLD PORT OUT_DIR
    python -m tests.torch_parallel_worker clis RANK WORLD PORT RUNS_JSON
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every rank and the collectives it runs are bounded by this
TIMEOUT_S = 240


def rank_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def run_ranks(argv_of_rank, world: int, timeout: float = TIMEOUT_S,
              env: dict | None = None) -> list[str]:
    """Start `world` processes (`argv_of_rank(rank)` each), wait for all,
    kill every one of them at `timeout`, and raise with each failed rank's
    output; returns their outputs."""
    procs = [subprocess.Popen(argv_of_rank(r), cwd=REPO,
                              env=env or rank_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, o[-3000:]) for r, (p, o) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{o}"
                                       for r, rc, o in bad))
    return outs


def cli_argv(module: str, port: int, world: int, rank: int, *args) -> list:
    """A CLI's argv for one rank of a gloo run."""
    return [sys.executable, "-m", module, "--device", "cpu", "--multihost",
            "true", "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", str(world), "--process_id", str(rank), *args]


def run_clis_ranks(runs: list, world: int = 2) -> list[str]:
    """CLI runs over `world` gloo ranks, in one spawn of the ranks
    (`clis`): `runs` lists (module, args, out_dir), run in turn; rank 0
    writes into out_dir, rank r > 0 is given `<out_dir>_rank<r>` (which
    must stay empty: only rank 0 writes). Returns the ranks' outputs."""
    from crvqa_tpu_torch.parallel.dryrun import free_port

    port = free_port()
    spec = f"{runs[0][2]}_runs.json"
    with open(spec, "w") as f:
        json.dump([[m, list(a), str(o)] for m, a, o in runs], f)
    return run_ranks(lambda r: [sys.executable, "-m",
                                "tests.torch_parallel_worker", "clis", str(r),
                                str(world), str(port), spec], world)


def metric_lines(out_dir, key: str) -> list:
    """(step, value) of every metrics.jsonl line that has `key`."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    return [(x["step"], x[key]) for x in lines if key in x]


def files_written(path) -> list:
    """Every file under `path` (a missing directory holds none)."""
    return [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs]


# ------------------------------------------------------------ rank bodies

def units(rank: int, world: int, port: int, out_dir: str) -> None:
    """The runtime's units over 2 ranks (the JAX package's
    tests/mp_worker.py `run_units`); rank r writes units_<r>.json."""
    import datetime
    import signal

    import torch

    from crvqa_tpu_torch.cli import common
    from crvqa_tpu_torch.core import checkpoint as ckpt
    from crvqa_tpu_torch.parallel import mesh as pm
    from crvqa_tpu_torch.parallel.zero import ZeroPartition
    from crvqa_tpu_torch.train.common import HfAdamW, allreduce_mean_

    pm.initialize_multihost(f"127.0.0.1:{port}", world, rank, "cpu",
                            timeout=datetime.timedelta(seconds=60))
    mesh = pm.make_mesh(pm.MeshConfig(data=world), torch.device("cpu"))
    res: dict = {"rank": rank, "data_index": mesh.data_index}

    glob = {"x": np.arange(8 * 3).reshape(8, 3), "s": np.int64(5)}
    local = pm.process_local_slice(glob, mesh)
    res["rows"] = local["x"][:, 0].tolist()
    res["scalar"] = int(local["s"])
    # device-array gather of the rank's rows -> the global rows in order
    res["gathered"] = pm.host_all_gather(
        torch.from_numpy(local["x"]), mesh).tolist()
    res["gathered_local"] = pm.host_all_gather_local(
        np.arange(3) + 10 * rank, mesh).tolist()
    res["gathered_bool"] = pm.host_all_gather_local(
        np.array([rank == 0, True]), mesh).tolist()
    try:
        pm.process_local_slice({"x": np.zeros((3, 2))}, mesh)
        res["odd_batch"] = None
    except ValueError as e:
        res["odd_batch"] = str(e)

    t = torch.full((3,), float(rank + 1))
    allreduce_mean_([t], mesh)
    res["mean"] = t.tolist()

    # exactly one rank writes; every rank returns after the write
    rank_dir = os.path.join(out_dir, f"rank{rank}")
    ckpt.save_msgpack(os.path.join(rank_dir, "tree"),
                      {"a": np.ones(2, np.float32)}, {"step": 1})

    # preemption: only rank 1 signalled, both agree and save
    guard = common.PreemptionGuard(mesh)
    if rank == 1:
        os.kill(os.getpid(), signal.SIGTERM)
    saved = []
    args = type("A", (), {"output_dir": rank_dir})()
    res["stopped"] = guard.save_and_stop(
        args, 3, lambda path, meta: saved.append((os.path.basename(path),
                                                  meta["preempted"])))
    res["saved"] = saved

    # ZeRO: whole leaves dealt over the ranks, the gathered state whole
    params = {"a": torch.ones(4, 3), "b": torch.ones(8), "c": torch.ones(2),
              "d": torch.ones(5, 5)}
    zero = ZeroPartition(params, mesh)
    opt = HfAdamW(1e-3, accumulate_abs_grad=True)
    state = opt.init(params)
    for k, v in state.mu.items():
        v.fill_(float(ord(k)))
    zero.shard_state(state)
    res["owned"] = sorted(state.mu)
    full = zero.gather_state(state)
    res["full_mu"] = {k: v.flatten().tolist() for k, v in full.mu.items()}
    res["full_order"] = list(full.mu)
    res["full_abs"] = sorted(full.abs_grad_sum)
    with open(os.path.join(out_dir, f"units_{rank}.json"), "w") as f:
        json.dump(res, f)
    pm.shutdown()


def stage2_steps(rank: int, world: int, port: int, out_dir: str) -> None:
    """The stage-2 steps of test_torch_parallel_jax.py over `world` ranks
    laid out as each of `inputs.pt`'s meshes (data x model) in turn, over
    one process group (`_stage2_runs`): without and with ZeRO, from the
    state the test carried over from the JAX package; then through one
    window of the steps (`make_multi_step`), with structured head gates
    from their own carried state, in the scan layout (`--scan_layers`)
    from its own, and with layer-wise KD (`Stage2Config(use_kd=True,
    kd_mode="layerwise")`). Rank 0 writes `result_<data>x<model>.pt` for
    each mesh: per run the losses, the whole trained leaves, the gathered
    Adam moments, the thresholds after a reset and the split leaves' keys
    (`tp`, None where nothing splits); the structured run also its
    language head mask and the whole weights' shapes. Every rank writes
    its scan run to `scan_rank<r>_<data>x<model>.pt`."""
    import datetime

    import torch

    from crvqa_tpu_torch.parallel import mesh as pm

    pm.initialize_multihost(f"127.0.0.1:{port}", world, rank, "cpu",
                            timeout=datetime.timedelta(seconds=60))
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    for data, model_size in inp["meshes"]:
        tag = f"{data}x{model_size}"
        result = _stage2_runs(inp, pm.make_mesh(
            pm.MeshConfig(data=data, model=model_size), torch.device("cpu")))
        torch.save(result["scan"], os.path.join(
            out_dir, f"scan_rank{rank}_{tag}.pt"))
        if rank == 0:
            torch.save(result, os.path.join(out_dir, f"result_{tag}.pt"))
    pm.barrier()
    pm.shutdown()


def _stage2_runs(inp: dict, mesh) -> dict:
    """`stage2_steps`' runs on one mesh: {run name: its result}."""
    import dataclasses

    import torch

    from crvqa_tpu_torch.cli.common import stack_window
    from crvqa_tpu_torch.core.convert import carry_into_state
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import (lxmert_mask_specs,
                                              lxmert_scan_mask_specs)
    from crvqa_tpu_torch.masking.structured import (StructuredMasker,
                                                    lang_head_mask)
    from crvqa_tpu_torch.models import LxmertConfig
    from crvqa_tpu_torch.parallel import mesh as pm
    from crvqa_tpu_torch.parallel.tp import enable_tp, tensor_parallel
    from crvqa_tpu_torch.parallel.zero import zero_optimizer
    from crvqa_tpu_torch.train import stage2

    config = LxmertConfig.tiny(**inp["config"])
    dims = (config.l_layers, config.r_layers, config.x_layers)
    specs = lxmert_mask_specs(*dims)
    rates = ModalSparsity.from_compression(*inp["sparsity"])
    cfg = stage2.Stage2Config(**inp["stage2"])
    runs = {"plain": (False, False), "zero": (True, False),
            "window": (False, True), "structured": (False, False),
            "scan": (False, False), "kd": (False, False)}
    result = {}
    for name, (zero_on, window) in runs.items():
        run_cfg = (dataclasses.replace(cfg, use_kd=True, kd_mode="layerwise")
                   if name == "kd" else cfg)
        if name == "structured":
            masker = StructuredMasker.create(
                specs, rates, controlled_init="magnitude",
                structured_masking="heads",
                num_heads=config.num_attention_heads)
            carried = inp["structured"]
        elif name == "scan":
            masker = Masker.create(lxmert_scan_mask_specs(*dims), rates,
                                   controlled_init="magnitude")
            carried = inp["scan"]
        else:
            masker = Masker.create(specs, rates, controlled_init="magnitude")
            carried = inp["carried"]
        model = stage2.lxmert_meta_model(config, scan=name == "scan")
        state, tx = stage2.init_state(model, masker, carried["params"],
                                      run_cfg, seed=0, device="cpu")
        carry_into_state(state, carried)
        tp = tensor_parallel(mesh, state.frozen, masker.specs,
                             config.num_attention_heads, state.scores)
        if tp is not None:
            enable_tp(model, tp)
            stage2.shard_state_tp(state, tp)
        zero = None
        if zero_on:
            tx, zero = zero_optimizer(tx, stage2.trainable(state, run_cfg),
                                      mesh)
            state.opt_state = zero.shard_state(state.opt_state)
        local = [pm.shard_batch(mesh, b) for b in inp["batches"]]
        if window:
            multi = stage2.make_multi_step(model, masker, tx, run_cfg,
                                           len(local), mesh, tp)
            state, losses, _ = multi(state, stack_window(local))
            losses = [float(x) for x in losses]
        else:
            step = stage2.make_train_step(model, masker, tx, run_cfg, mesh,
                                          tp)
            losses = [float(step(state, b)[1].loss) for b in local]
        state = stage2.make_threshold_reset(masker, tp)(state)
        opt = state.opt_state if zero is None else zero.gather_state(
            state.opt_state)
        whole = (lambda d: d) if tp is None else tp.gather
        result[name] = {
            "losses": losses, "scores": whole(state.scores),
            "classifier": state.train_params["classifier"],
            "mu": whole(opt.mu), "nu": whole(opt.nu),
            "thresholds": state.thresholds,
            "owned": sorted(state.opt_state.mu),
            "tp": None if tp is None else sorted(tp.dims),
            "local_shapes": {k: tuple(v.shape)
                             for k, v in state.scores.items()}}
        if name == "structured":
            masks = masker.binary_masks(whole(state.scores),
                                        state.thresholds)
            result[name]["head_mask"] = lang_head_mask(
                masker, masks, config.l_layers, config.num_attention_heads)
            shapes = ({k: v.shape for k, v in state.frozen.items()}
                      if tp is None else tp.whole_shapes(state.frozen))
            result[name]["whole_shapes"] = {k: tuple(v)
                                            for k, v in shapes.items()}
    return result


def clis(rank: int, world: int, port: int, spec: str) -> None:
    """The CLI runs of `run_clis_ranks`' `spec` in turn in this rank, each
    with `--multihost` (`cli_argv`), over one process group: the first run
    brings it up and `initialize_multihost` leaves it up for the others."""
    import importlib

    with open(spec) as f:
        runs = json.load(f)
    for module, args, out_dir in runs:
        out = out_dir if rank == 0 else f"{out_dir}_rank{rank}"
        argv = cli_argv(module, port, world, rank, "--output_dir", out,
                        *args)
        importlib.import_module(module).main(argv[3:])


if __name__ == "__main__":
    name, rank, world, port, out = sys.argv[1:6]
    {"units": units, "stage2_steps": stage2_steps, "clis": clis}[name](
        int(rank), int(world), int(port), out)
