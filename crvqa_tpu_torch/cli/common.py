"""Shared CLI plumbing (counterpart of `crvqa_tpu/cli/common.py`): the
training argv, data assembly, logging and the step-cadence helpers.

The argv is the JAX CLIs' (`add_common_args`), so one command line drives
either package. Flags of paths the port has not reached yet are parsed and
raise "not yet ported" when set away from their defaults
(`reject_unported`); the JAX-only switches that select nothing here
(`--prng_impl`, `--fused_attention`, `--midseq_attention`) are accepted
and ignored: on the card the short and the mid-length attention kernels
always run where their scope admits the shape.

Multi-device runs (`--multihost`, `--mesh_data`, `--mesh_model`) are one
process per device (`parallel/`): `init_distributed` brings the process
group up first, `make_run_mesh` lays the ranks out, each rank feeds its
block of every global batch (`build_data`), and only rank 0 logs at INFO,
prints step lines and writes files.
"""
from __future__ import annotations

import argparse
import atexit
import json
import logging
import os
import signal
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import (MeshConfig, any_process, initialize_multihost,
                             is_main_process, make_mesh, process_local_slice,
                             shutdown)

logger = logging.getLogger("crvqa_tpu_torch")


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def dict_parser(s: Optional[str]) -> dict:
    """The 'k=v,k2=v2' mini-DSL of `--masking_scheduler_conf`
    (`utils/param_parser.py:dict_parser` of the reference)."""
    out: dict = {}
    for item in (s or "").split(","):
        if not item.strip():
            continue
        k, _, v = item.partition("=")
        v = v.strip()
        if v.lower() in ("true", "false"):
            out[k.strip()] = v.lower() == "true"
            continue
        for cast in (int, float):
            try:
                out[k.strip()] = cast(v)
                break
            except ValueError:
                pass
        else:
            out[k.strip()] = v
    return out


def add_kernel_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' attention-kernel switches, parsed so the same argv
    works on both packages. In the port they select nothing: on the card
    the short (fused) and the mid-length attention kernels always run
    where their scope admits the shape."""
    p.add_argument("--fused_attention", type=str2bool, default=False,
                   help="accepted for argv compatibility; the port always "
                        "runs its attention kernels")
    p.add_argument("--midseq_attention", type=str2bool, default=False,
                   help="accepted for argv compatibility; the port always "
                        "runs its mid-length attention kernel")


def add_moment_dtype_flag(p: argparse.ArgumentParser) -> None:
    """Storage dtype of the Adam moments (every LXMERT trainer); each
    step's math stays fp32."""
    p.add_argument("--moment_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])


def add_dense_train_flags(p: argparse.ArgumentParser) -> None:
    """Flags of the dense (stage-1/3) train step, shared by both drivers."""
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    add_moment_dtype_flag(p)


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The JAX package's training flags (crvqa_tpu/cli/common.py:125-237)
    plus `--device`."""
    p.add_argument("--dataroot", type=str, default=None)
    p.add_argument("--img_root", type=str, default=None,
                   help="image-feature pickle or native .bin store")
    p.add_argument("--vocab_file", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--label4save", type=str, default="run")
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--per_gpu_train_batch_size", "--train_batch_size",
                   dest="train_batch_size", type=int, default=64)
    p.add_argument("--per_gpu_eval_batch_size", "--eval_batch_size",
                   dest="eval_batch_size", type=int, default=64)
    p.add_argument("--num_train_epochs", type=float, default=20)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--save_steps", type=int, default=1712)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_predict", action="store_true")
    p.add_argument("--evaluate_during_training", action="store_true")
    p.add_argument("--gamma", type=float, default=5.0)
    p.add_argument("--ans_num", type=int, default=2274)
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="data-parallel ranks (-1: every rank --mesh_model "
                        "leaves); data x model must equal the world size")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="ranks per model replica, which see the same rows: "
                        "prune_debias_vqa splits heads and FFN units over "
                        "them (tensor parallelism); elsewhere they "
                        "replicate the compute, as in the JAX CLIs")
    p.add_argument("--multihost", type=str2bool, default=False,
                   help="bring up torch.distributed (NCCL on --device "
                        "cuda, gloo on cpu), one process per device, from "
                        "the three flags below or torchrun's environment")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 (tcp://) under --multihost")
    p.add_argument("--num_processes", type=int, default=None,
                   help="the world size under --multihost")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank under --multihost")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--backbone_dtype", type=str, default="float32",
                   choices=["bfloat16", "float32"],
                   help="storage dtype of the masked frozen weights")
    p.add_argument("--prng_impl", type=str, default="threefry2x32",
                   choices=["threefry2x32", "rbg", "unsafe_rbg"],
                   help="accepted for argv compatibility: the port draws "
                        "from torch generators seeded by --seed")
    add_kernel_flags(p)
    p.add_argument("--transfer_dtype", type=str, default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="host->device dtype of the visual inputs; 'auto' = "
                        "bfloat16 iff --dtype bfloat16 (the first matmul "
                        "casts them to it anyway)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic examples instead of real data")
    p.add_argument("--synthetic_pool", type=int, default=0,
                   help="cycle this many pre-generated synthetic train "
                        "batches instead of regenerating each step")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="batches prepared and copied to the device ahead "
                        "on a producer thread; 0 disables")
    p.add_argument("--resume_from", type=str, default=None,
                   help="a ckpt_<step> written by this port or by the JAX "
                        "package's CLI of the same name (its msgpack "
                        "training state)")
    p.add_argument("--train_shuffle", type=str2bool, default=True)
    p.add_argument("--hidden_dropout_prob", type=float, default=None)
    p.add_argument("--attention_probs_dropout_prob", type=float, default=None)
    p.add_argument("--classifier_dropout", type=float, default=None)
    p.add_argument("--wandb_project", type=str, default=None,
                   help="mirror step metrics to wandb (optional; absent "
                        "wandb degrades to JSONL/TB with a notice)")
    p.add_argument("--tensorboard_dir", type=str, default=None,
                   help="also write the scalar metrics as a TensorBoard "
                        "event file into this dir (utils/tb_events.py; "
                        "metrics.jsonl stays the default sink)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of a "
                        "training-step window into this dir "
                        "(ProfileWindow)")
    p.add_argument("--profile_start_step", type=int, default=10,
                   help="the trace window opens at the first step at or "
                        "past this one")
    p.add_argument("--profile_steps", type=int, default=5,
                   help="trace window length in steps")
    p.add_argument("--tiny", action="store_true",
                   help="tiny 2/1/1-layer config for smoke tests")
    p.add_argument("--dataset", type=str, default="vqacp",
                   choices=["vqacp", "vqavs"])
    p.add_argument("--data_ratio", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")


# the runtime's flags and their defaults (the servers parse and ignore them)
MESH_FLAGS = {"mesh_data": -1, "mesh_model": 1, "multihost": False,
              "coordinator_address": None, "num_processes": None,
              "process_id": None}


MODEL_TYPE_HELP = ("lxmert. The JAX package parses this flag, never reads "
                   "it and builds LXMERT; the port refuses visualbert "
                   "rather than train LXMERT under it (VisualBERT stage 2 "
                   "is crvqa_tpu_torch.cli.prune_debias_vqa_visualbert)")


def reject_model_type(args: argparse.Namespace, cli: str) -> None:
    """The LXMERT stage CLIs' `--model_type`: the JAX package's `cli`
    parses it and never reads it, so it builds LXMERT whatever the flag
    says. The port refuses anything but lxmert instead of running LXMERT
    under a VisualBERT flag."""
    if args.model_type != "lxmert":
        raise NotImplementedError(
            f"--model_type {args.model_type}: the JAX package's {cli} parses "
            f"this flag and never reads it, so it builds LXMERT here; the "
            f"port refuses it rather than train LXMERT under it. VisualBERT "
            f"under this CLI is not yet ported (the JAX package has no "
            f"VisualBERT stage 1 or 3); VisualBERT stage 2 is "
            f"crvqa_tpu_torch.cli.prune_debias_vqa_visualbert")


def reject_unported(args: argparse.Namespace, defaults: dict) -> None:
    for name, default in defaults.items():
        value = getattr(args, name)
        if value != default:
            raise NotImplementedError(
                f"--{name} {value}: not yet ported to crvqa_tpu_torch "
                f"(ROADMAP); leave it at {default!r}")


def init_distributed(args: argparse.Namespace) -> None:
    """--multihost: bring up the process group (`parallel.
    initialize_multihost`; the reference's `utils.init_distributed_mode`,
    `mPLUG/utils.py:238-262`). The first call of every training CLI. A
    WORLD_SIZE above 1 in the environment without --multihost raises:
    every process would train alone and race on --output_dir."""
    if getattr(args, "multihost", False):
        initialize_multihost(args.coordinator_address, args.num_processes,
                             args.process_id, args.device)
        atexit.register(shutdown)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} in the environment "
            "without --multihost true: each process would train alone and "
            "write the same --output_dir; pass --multihost true")


def make_run_mesh(args: argparse.Namespace, device: torch.device):
    """The run's mesh from --mesh_data / --mesh_model over the live world
    (world 1 without --multihost); raises when they do not cover it."""
    return make_mesh(MeshConfig(data=args.mesh_data, model=args.mesh_model),
                     device)


def setup_logging(output_dir: str) -> None:
    """INFO on rank 0, WARN elsewhere (prune_debias_VQA.py:714-719)."""
    os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO if is_main_process()
                        else logging.WARN,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")


def dump_args(args: argparse.Namespace, output_dir: str) -> None:
    """`args.txt`: every flag (prune_debias_VQA.py:953-957); rank 0."""
    if not is_main_process():
        return
    with open(os.path.join(output_dir, "args.txt"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)


_metrics_writer = None


def init_metrics(args: argparse.Namespace) -> None:
    """The run's MetricsWriter (`metrics.jsonl`, plus a TensorBoard event
    file with `--tensorboard_dir` and wandb with `--wandb_project`); every
    later `log_step` writes into it. Rank 0 only: elsewhere there is
    none."""
    global _metrics_writer
    from ..utils.profiling import MetricsWriter

    if _metrics_writer is not None:
        _metrics_writer.close()
        _metrics_writer = None
    if not is_main_process():
        return
    _metrics_writer = MetricsWriter(
        args.output_dir, tensorboard_dir=getattr(args, "tensorboard_dir",
                                                 None),
        wandb_project=getattr(args, "wandb_project", None))


def log_step(step: int, **metrics) -> None:
    """A JSON line on stdout, numbers rounded to 6 places; the unrounded
    values go to the MetricsWriter when `init_metrics` ran. Rank 0
    prints."""
    payload = {"step": step}
    payload.update({k: (round(float(v), 6)
                        if isinstance(v, (int, float, np.floating)) else v)
                    for k, v in metrics.items()})
    if is_main_process():
        print(json.dumps(payload), flush=True)
    if _metrics_writer is not None:
        _metrics_writer.write(step, **metrics)


class ProfileWindow:
    """Drives `--profile_dir`: a torch.profiler trace of the steps between
    the first `tick(step)` at or past `profile_start_step` and the first
    at or past start + `profile_steps` (the JAX package's window: the
    host counter may stride over the bounds). Call `tick` once per
    iteration after the step; one-shot; `close()` ends an open window.

    Two departures from the JAX trace:

    - warm-up step: CUPTI loses what launches while a session starts, so
      the session opens one tick earlier (the tick whose step plus the
      last stride reaches the start) and that step is traced and
      discarded (`schedule(wait=0, warmup=1, active=1)`, the active
      window one profiler step); the active steps are exactly the JAX
      package's. A window that opens at the first tick has no earlier
      tick and so no warm-up step.
    - synchronised edges: on a CUDA device the window synchronises before
      it turns active and before it stops, so the trace holds the active
      steps' kernels and no others.

    The Chrome trace goes into `profile_dir` when the window stops; rank 0
    alone traces."""

    def __init__(self, args: argparse.Namespace):
        self.dir = (getattr(args, "profile_dir", None) if is_main_process()
                    else None)
        self.start = getattr(args, "profile_start_step", 10)
        self.stop_at = self.start + getattr(args, "profile_steps", 5)
        self.device = torch.device(getattr(args, "device", "cpu"))
        self.active = False
        self.path: Optional[str] = None  # the written trace
        self._prof = None
        self._last: Optional[int] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _open(self, warmup: int) -> None:
        from torch.profiler import profile, schedule

        from ..utils.profiling import activities

        # the whole active window is one profiler step
        sched = (schedule(wait=0, warmup=1, active=1, repeat=1)
                 if warmup else None)
        self._prof = profile(activities=activities(self.device),
                             schedule=sched)
        self._prof.start()

    def tick(self, step: int) -> None:
        if self.dir is None:
            return
        stride = 1 if self._last is None else step - self._last
        self._last = step
        if self._prof is None:
            if step >= self.start:  # no earlier tick: no warm-up step
                self._open(warmup=0)
                self.active = True
            elif step + stride >= self.start:
                self._open(warmup=1)
        elif not self.active:
            if step >= self.start:
                self._sync()
                self._prof.step()  # warm-up -> active
                self.active = True
        elif step >= self.stop_at:
            self.close()

    def close(self) -> None:
        """Stop an open window (short runs, preemption) and write its
        trace; a window still warming up writes none."""
        if self._prof is None:
            return
        self._sync()
        self._prof.stop()
        if self.active:
            from ..utils.profiling import export_trace

            self.path = export_trace(self._prof, self.dir)
        self._prof = None
        self.active = False
        self.dir = None  # one-shot


class PreemptionGuard:
    """SIGTERM latches a flag the train loop polls once per step: the step
    in flight finishes, one checkpoint is written and the driver returns
    for a `--resume_from` restart. SIGINT keeps its meaning.

    Under a process group SIGTERM may reach only some ranks, and the save
    and the next step are both collectives: acting on a rank's own flag
    would mismatch them and hang the run. `save_and_stop` therefore agrees
    first: every rank shares its flag at the same loop point every step
    (one int over the gloo control group) and all act iff any rank was
    signalled (crvqa_tpu/cli/common.py:357-410)."""

    def __init__(self, mesh=None):
        self.triggered = False
        self.mesh = mesh
        try:
            signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:
            pass  # not the main thread

    def _on_signal(self, signum, frame):
        self.triggered = True

    def _any_process_triggered(self) -> bool:
        """The flag agreed over every rank (a collective: every rank calls
        it at the same loop point)."""
        return any_process(self.triggered, self.mesh)

    def save_and_stop(self, args, step: int,
                      save: Callable[[str, dict], None]) -> bool:
        """When any rank was signalled: `save(path, metadata)` writes
        ckpt_<step> with the preempted marker (collectively), the step is
        logged, and True tells the loop to return."""
        if not self._any_process_triggered():
            return False
        path = os.path.join(args.output_dir, f"ckpt_{step}")
        save(path, {"step": step, "preempted": True})
        log_step(step, preempted=True, checkpoint=path)
        return True


def write_eval_results(output_dir: str, name: str, **results) -> None:
    """`key = value` lines (prune_debias_VQA.py:979-986); rank 0."""
    if not is_main_process():
        return
    with open(os.path.join(output_dir, name), "w") as f:
        for k, v in results.items():
            f.write("%s = %s\n" % (k, v))


def config_overrides(args: argparse.Namespace) -> dict:
    """Model-config kwargs from the optional dropout overrides."""
    return {k: getattr(args, k) for k in
            ("hidden_dropout_prob", "attention_probs_dropout_prob",
             "classifier_dropout") if getattr(args, k, None) is not None}


def scheduler_horizon(n_train: int, batch_size: int, epochs: float) -> int:
    """The reference's LR horizon `int(int(n / bs + 1) * epochs)`
    (prune_debias_VQA.py:626-628): one step per epoch longer than the steps
    run, so the decay never reaches 0 in training."""
    return int(int(n_train / batch_size + 1) * epochs)


def crossed(step: int, prev: int, every) -> bool:
    """True when (prev, step] contains a multiple of `every`."""
    return bool(every) and step // every > prev // every


def transfer_dtype(args) -> Optional[torch.dtype]:
    """--transfer_dtype resolved: bf16 iff chosen, or 'auto' under a bf16
    model; None = no cast."""
    choice = args.transfer_dtype
    if choice == "auto":
        choice = "bfloat16" if args.dtype == "bfloat16" else "float32"
    return torch.bfloat16 if choice == "bfloat16" else None


def local_batches(batches: Iterator[dict], mesh) -> Iterator[dict]:
    """This rank's block of every global batch (`parallel.
    process_local_slice`; the JAX package's `wrap_process_local`), before
    the prefetcher so that it stages only those rows."""
    return (process_local_slice(b, mesh) for b in batches)


def build_data(args, config, device: torch.device, mesh=None):
    """(train_batches(epoch), eval_batches(), label2ans, n_train): VQA-CP
    or (`--dataset vqavs`) VQA-VS from --dataroot/--img_root, else
    --synthetic N examples. Batches arrive as device tensors through the
    prefetcher (`data/prefetch.py`). As in the JAX package, the VQA-VS
    train split ignores --data_ratio and loads with seed 0. Batch sizes
    are global: with a data-parallel `mesh` every rank derives the same
    batches and keeps its block of each."""
    from ..data.prefetch import prefetch_batches
    from ..data.synthetic import synthetic_batch

    cast = transfer_dtype(args)
    depth = args.prefetch_batches

    def staged(batches: Iterator[dict]) -> Iterator[dict]:
        return prefetch_batches(local_batches(batches, mesh), device, depth,
                                float_dtype=cast)

    if args.synthetic:
        n = args.synthetic
        label2ans = [f"ans_{i}" for i in range(config.ans_num)]
        pool: list = []

        def make(bs: int, seed: int) -> dict:
            return synthetic_batch(
                batch_size=bs, seed=seed, vocab_size=config.vocab_size,
                ans_num=config.ans_num, feat_dim=config.visual_feat_dim,
                pos_dim=config.visual_pos_dim)

        def train_iter(epoch: int) -> Iterator[dict]:
            bs = args.train_batch_size
            for i in range(max(n // bs, 1)):
                if args.synthetic_pool > 0:
                    if not pool:
                        pool.extend(make(bs, j)
                                    for j in range(args.synthetic_pool))
                    yield pool[i % args.synthetic_pool]
                else:
                    yield make(bs, epoch * 10000 + i)

        def eval_iter() -> Iterator[dict]:
            bs = args.eval_batch_size
            for i in range(max(n // bs, 1)):
                yield make(bs, 777000 + i)

        return (lambda epoch: staged(train_iter(epoch)),
                lambda: staged(eval_iter()), label2ans, n)

    from ..data import vqacp

    tokenizer = vqacp.make_tokenizer(args.vocab_file)
    if args.dataset == "vqavs":
        from ..data import vqavs

        ans2label, label2ans = vqavs.load_answer_vocab(args.dataroot)
        ans_num = len(ans2label)
        train = vqavs.load_entries(args.dataroot, "train", tokenizer, ans_num)
        test = vqavs.load_entries(args.dataroot, "test", tokenizer, ans_num)
    else:
        ans2label, label2ans = vqacp.load_answer_vocab(args.dataroot)
        ans_num = len(ans2label)
        train = vqacp.load_entries(args.dataroot, "train", tokenizer,
                                   ans_num, ratio=args.data_ratio,
                                   seed=args.seed)
        test = vqacp.load_entries(args.dataroot, "test", tokenizer, ans_num)
    priors = vqacp.compute_bias_priors(train, ans_num)
    vqacp.attach_bias(train, priors, ans_num)
    vqacp.attach_bias(test, priors, ans_num)
    features = vqacp.open_image_features(args.img_root)

    def train_batches(epoch: int) -> Iterator[dict]:
        return staged(vqacp.iterate_batches(
            train, features, args.train_batch_size,
            shuffle=args.train_shuffle, seed=args.seed + epoch,
            drop_last=True))

    def eval_batches() -> Iterator[dict]:
        return staged(vqacp.iterate_batches(test, features,
                                            args.eval_batch_size))

    return train_batches, eval_batches, label2ans, len(train)


def lxmert_initial_params(config, seed: int, path: Optional[str]
                          ) -> dict[str, torch.Tensor]:
    """fp32 LXMERT params on the CPU: a seeded init from `seed`, overlaid
    by the checkpoint at `path` (the stage-1 loading switch,
    prune_debias_VQA.py:767-818)."""
    import dataclasses

    from ..models import build_lxmert

    fp32 = dataclasses.replace(config, dtype=torch.float32)
    state = build_lxmert(fp32, "cpu",
                         torch.Generator().manual_seed(seed)).state_dict()
    return load_params_any(path, state)


def visualbert_initial_params(config, seed: int, path: Optional[str]
                              ) -> dict[str, torch.Tensor]:
    """fp32 VisualBERT params on the CPU: a seeded init from `seed`,
    overlaid by the checkpoint at `path` (the JAX package's
    `init_visualbert_params` + `load_params_any`)."""
    import dataclasses

    from ..models import build_visualbert

    fp32 = dataclasses.replace(config, dtype=torch.float32)
    state = build_visualbert(fp32, "cpu",
                             torch.Generator().manual_seed(seed)).state_dict()
    return load_params_any(path, state)


def visualbert_uniform_masker(config, zero_rate: float, **kw):
    """The uniform-rate VisualBERT masker over K/Q/V/AO/I/O/P/E
    (prune_debias_VQA_visualBERT.py:127-190) whose specs key its
    `mask.pt`; `kw` goes to `Masker.create`."""
    from ..masking.masker import Masker
    from ..masking.sparsity_control import ModalSparsity
    from ..masking.spec import visualbert_mask_specs

    return Masker.create(visualbert_mask_specs(config.num_hidden_layers),
                         ModalSparsity.uniform(zero_rate), **kw)


def lxmert_uniform_masker(config, zero_rate: float):
    """The uniform-rate LXMERT masker whose specs key `mask.pt` (the
    stage-2 artifact contract: stage 3 and serving build the same one)."""
    from ..masking.masker import Masker
    from ..masking.sparsity_control import ModalSparsity
    from ..masking.spec import lxmert_mask_specs

    specs = lxmert_mask_specs(config.l_layers, config.r_layers,
                              config.x_layers)
    return Masker.create(specs, ModalSparsity.uniform(
        zero_rate, ("Lang", "Vis", "Fus", "P")))


def load_params_any(path: Optional[str], state: dict[str, torch.Tensor],
                    torch_loader: Optional[Callable] = None,
                    from_jax: Optional[Callable] = None
                    ) -> dict[str, torch.Tensor]:
    """Overlay a params checkpoint onto `state` (a state_dict), by the
    JAX package's dispatch (`crvqa_tpu/cli/common.py:load_params_any`):
    `.bin`/`.pt`/`.pth` are reference torch artifacts (state_dicts or
    whole-module pickles); every other path is a msgpack params file of
    the JAX package's (the stage-1 `.msgpack` twin, the stage-3
    `_FT_trainedMask.bin.msgpack`), carried over by `state_dict_from_jax`.
    Either way every key of `state` must be present at its shape. A
    training state (the JAX package's `ckpt_<step>`: the step, the
    parameters, the optimizer's state) is refused, as the JAX function
    refuses it (it goes to `--resume_from`, `resume_any`).

    `torch_loader(path, state)` replaces the torch branch for a model's own
    name shims (the mPLUG importer, as the JAX function's hook);
    `from_jax(tree)` replaces `state_dict_from_jax` for a model whose JAX
    tree needs renames beyond its rule (`mplug_state_dict_from_jax`)."""
    if path is None:
        return state
    from ..core import torch_compat

    if path.endswith((".bin", ".pt", ".pth")):
        if torch_loader is not None:
            return torch_loader(path, state)
        return torch_compat.load_torch_params(path, state)
    from ..core.checkpoint import load_msgpack
    from ..core.convert import state_dict_from_jax

    tree = load_msgpack(path)
    if isinstance(tree, dict) and {"step", "opt_state"} <= set(tree):
        raise ValueError(
            f"{path}: a training state (the JAX package's ckpt_<step>: the "
            "step, the parameters, the optimizer's state), not a params "
            "file; the JAX package's load_params_any cannot read one either "
            "(its from_bytes into a params template fails). Resume it with "
            "--resume_from, or pass the params file its stage 1 or 3 wrote "
            "(<label4save>_FT*.bin.msgpack)")
    return torch_compat.fill_state_dict(
        (from_jax or state_dict_from_jax)(tree), state)


def resume_any(path: str, state, kind: str, config, specs=()):
    """`--resume_from` of either package's checkpoint into `state` (built
    by the run's `init_state`), in place; returns it. A zip archive is this
    port's own checkpoint (`core/checkpoint.py`); a msgpack map is the JAX
    package's training state (`ckpt_<step>`, `ckpt_final`), carried over
    by `core/convert.py`, whose parameters replace the run's (the JAX
    CLIs' `load_checkpoint` replaces the whole state). `kind`: 'stage2',
    'stage1' (stages 1 and 3) or 'mplug' (a training or a serving state);
    `config` the state's training config, `specs` the masker's."""
    from ..core import checkpoint as ckpt
    from ..core import convert

    if ckpt.checkpoint_format(path) == "port":
        return {"stage2": ckpt.load_checkpoint,
                "stage1": ckpt.load_stage1_checkpoint,
                "mplug": ckpt.load_mplug_checkpoint}[kind](path, state)
    tree = ckpt.load_jax_training_state(path)
    if kind == "stage2":
        convert.stage2_state_from_jax(state, tree, specs, config)
    elif kind == "stage1":
        convert.stage1_state_from_jax(state, tree, config, specs)
    else:
        convert.mplug_state_from_jax(state, tree, config, specs)
    logger.info("resumed from the JAX package's training state %s at step "
                "%d", path, int(tree["step"]))
    return state


def save_params_msgpack(path: str, state: dict[str, torch.Tensor],
                        model: torch.nn.Module) -> None:
    """Write a state_dict as the JAX package's msgpack params file (its
    nested tree, `convert.jax_tree_from_state_dict` over `model`'s
    modules), readable by its `load_params_any`."""
    from ..core.checkpoint import save_msgpack
    from ..core.convert import jax_tree_from_state_dict

    save_msgpack(path, jax_tree_from_state_dict(state, model))


def overlay_classifier(state: dict[str, torch.Tensor], classifier_bin: str,
                       key: str = "classifier") -> dict[str, torch.Tensor]:
    """Swap in the stage-2 classifier (`classifier4masker.bin`,
    mask_trainer_Robust_VQA.py:734-740) under `key` (VisualBERT's head is
    `cls`: the reference saves `model.cls`)."""
    from ..core import torch_compat

    prefix = key + "."
    template = {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}
    head = torch_compat.load_torch_params(classifier_bin, template)
    out = dict(state)
    out.update({prefix + k: v for k, v in head.items()})
    return out
