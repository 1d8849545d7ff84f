"""Launch helpers and rank bodies for the port's multi-process tests
(tests/test_torch_parallel_*.py): each rank is its own interpreter, as
torchrun starts them, on gloo over 127.0.0.1. This module imports no JAX.

    python -m tests.torch_parallel_worker units RANK WORLD PORT OUT_DIR
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


def run_cli_ranks(module: str, args: list, out_dir, world: int = 2) -> str:
    """`module`'s CLI over `world` gloo ranks; rank 0 writes into
    `out_dir`, rank r > 0 is given `<out_dir>_rank<r>` (which must stay
    empty: only rank 0 writes). Returns rank 0's output."""
    from crvqa_tpu_torch.parallel.dryrun import free_port

    port = free_port()

    def argv(r):
        out = str(out_dir) if r == 0 else f"{out_dir}_rank{r}"
        return cli_argv(module, port, world, r, "--output_dir", out, *args)

    return run_ranks(argv, world)[0]


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
    laid out as `inputs.pt`'s mesh (data x model), without and with ZeRO,
    from the state the test carried over from the JAX package; rank 0
    writes `result.pt`: per run the losses, the whole trained leaves, the
    gathered Adam moments and the thresholds after a reset."""
    import datetime

    import torch

    from crvqa_tpu_torch.core.convert import carry_into_state
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.models import LxmertConfig
    from crvqa_tpu_torch.parallel import mesh as pm
    from crvqa_tpu_torch.parallel.tp import enable_tp, tensor_parallel
    from crvqa_tpu_torch.parallel.zero import zero_optimizer
    from crvqa_tpu_torch.train import stage2

    pm.initialize_multihost(f"127.0.0.1:{port}", world, rank, "cpu",
                            timeout=datetime.timedelta(seconds=60))
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    data, model_size = inp["mesh"]
    mesh = pm.make_mesh(pm.MeshConfig(data=data, model=model_size),
                        torch.device("cpu"))
    config = LxmertConfig.tiny(**inp["config"])
    masker = Masker.create(
        lxmert_mask_specs(config.l_layers, config.r_layers, config.x_layers),
        ModalSparsity.from_compression(*inp["sparsity"]),
        controlled_init="magnitude")
    cfg = stage2.Stage2Config(**inp["stage2"])
    result = {}
    for zero_on in (False, True):
        model = stage2.lxmert_meta_model(config)
        state, tx = stage2.init_state(model, masker, inp["carried"]["params"],
                                      cfg, seed=0, device="cpu")
        carry_into_state(state, inp["carried"])
        tp = tensor_parallel(mesh, state.frozen, masker.specs,
                             config.num_attention_heads)
        if tp is not None:
            enable_tp(model, tp)
            stage2.shard_state_tp(state, tp)
        zero = None
        if zero_on:
            tx, zero = zero_optimizer(tx, stage2.trainable(state, cfg), mesh)
            state.opt_state = zero.shard_state(state.opt_state)
        step = stage2.make_train_step(model, masker, tx, cfg, mesh, tp)
        losses = []
        for b in inp["batches"]:
            state, m = step(state, pm.shard_batch(mesh, b))
            losses.append(float(m.loss))
        state = stage2.make_threshold_reset(masker, tp)(state)
        opt = state.opt_state if zero is None else zero.gather_state(
            state.opt_state)
        whole = (lambda d: d) if tp is None else tp.gather
        result["zero" if zero_on else "plain"] = {
            "losses": losses, "scores": whole(state.scores),
            "classifier": state.train_params["classifier"],
            "mu": whole(opt.mu), "nu": whole(opt.nu),
            "thresholds": state.thresholds,
            "owned": sorted(state.opt_state.mu),
            "local_shapes": {k: tuple(v.shape)
                             for k, v in state.scores.items()}}
    if rank == 0:
        torch.save(result, os.path.join(out_dir, "result.pt"))
    pm.barrier()
    pm.shutdown()


if __name__ == "__main__":
    name, rank, world, port, out = sys.argv[1:6]
    {"units": units, "stage2_steps": stage2_steps}[name](
        int(rank), int(world), int(port), out)
