"""`dryrun_multichip(n)`: the runtime driven over `n` gloo ranks on the CPU
(counterpart of `__graft_entry__.dryrun_multichip`).

Each rank runs, at tiny sizes with the global batch split over `data`:
one stage-2 train step under ZeRO with the threshold reset and a gathered
evaluation, then one mPLUG mask-train step (ZeRO, as `vqa_mplug` always
shards) with a threshold reset and a beam-search eval batch. As in the
JAX dry run, an even `n` of 4 or more lays the ranks out as `data = n /
2, model = 2`, and stage 2 then splits its heads over the model axis.
Any rank's failure raises here.

    python -c "from crvqa_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2)"
"""
from __future__ import annotations

import datetime
import socket

import numpy as np
import torch

_TIMEOUT = datetime.timedelta(seconds=120)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stage2(mesh) -> None:
    from ..cli.common import lxmert_initial_params
    from ..data.synthetic import synthetic_batch
    from ..masking.masker import Masker
    from ..masking.sparsity_control import ModalSparsity
    from ..masking.spec import lxmert_mask_specs
    from ..models import LxmertConfig
    from ..train import stage2
    from ..train.evaluation import predict
    from .mesh import shard_batch
    from .tp import enable_tp, tensor_parallel
    from .zero import zero_optimizer

    config = LxmertConfig.tiny(dtype=torch.float32)
    masker = Masker.create(
        lxmert_mask_specs(config.l_layers, config.r_layers, config.x_layers),
        ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7),
        controlled_init="magnitude")
    cfg = stage2.Stage2Config(masker_type="lmh", total_steps=10,
                              hidden_size=config.hidden_size)
    model = stage2.lxmert_meta_model(config)
    state, tx = stage2.init_state(model, masker,
                                  lxmert_initial_params(config, 0, None),
                                  cfg, 1, mesh.device)
    tp = tensor_parallel(mesh, state.frozen, masker.specs,
                         config.num_attention_heads)
    if tp is not None:
        enable_tp(model, tp)
        stage2.shard_state_tp(state, tp)
    tx, zero = zero_optimizer(tx, stage2.trainable(state, cfg), mesh)
    state.opt_state = zero.shard_state(state.opt_state)
    step = stage2.make_train_step(model, masker, tx, cfg, mesh, tp)
    batch = synthetic_batch(
        batch_size=4 * mesh.data, seed=0, vocab_size=config.vocab_size,
        ans_num=config.ans_num, feat_dim=config.visual_feat_dim,
        pos_dim=config.visual_pos_dim)
    state, metrics = step(state, shard_batch(mesh, batch))
    state = stage2.make_threshold_reset(masker, tp)(state)
    out = predict(stage2.make_eval_step(model, masker), state,
                  [shard_batch(mesh, batch)], mesh)
    if not np.isfinite(float(metrics.loss)):
        raise RuntimeError("dryrun stage 2: non-finite loss")
    if out["logits"].shape != (4 * mesh.data, config.ans_num) or not (
            np.isfinite(out["logits"]).all()):
        raise RuntimeError(f"dryrun stage 2: gathered logits "
                           f"{out['logits'].shape}")


def _mplug(mesh) -> None:
    from ..cli import vqa_mplug
    from ..data.mplug_data import synthetic_mplug_batch
    from ..train import mplug_train
    from .mesh import shard_batch
    from .zero import ZeroPartition

    args = vqa_mplug.build_parser().parse_args([
        "--tiny", "--dtype", "float32", "--output_dir", "unused",
        "--device", "cpu", "--init_sparsity", "0.5"])
    config, _, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    cfg = vqa_mplug.train_config(args, 2)
    state = mplug_train.init_state(model, vqa_mplug.initial_params(args,
                                                                   config),
                                   cfg, mesh.device, masker=masker, seed=1,
                                   train=True)
    zero = ZeroPartition(mplug_train.trainable(state, cfg), mesh)
    state.opt_state = zero.shard_state(state.opt_state)
    step = mplug_train.make_train_step(model, cfg, masker=masker, mesh=mesh,
                                       zero=zero)
    bs = 2 * mesh.data
    batch = synthetic_mplug_batch(
        batch_size=bs, image_res=config.vit.image_res, q_len=6, a_len=5,
        answers_per_question=3, uint8_images=True,
        vocab_size=config.bert.vocab_size, seed=0)
    state, loss = step(state, shard_batch(mesh, batch))
    state = mplug_train.make_threshold_reset(masker)(state, 0.5)
    gen = mplug_train.make_generate_step(model, cfg, masker=masker,
                                         beam_size=2, max_len=4)
    ids = gen(state, shard_batch(mesh, batch))[0]
    if not np.isfinite(float(loss)):
        raise RuntimeError("dryrun mPLUG: non-finite loss")
    if ids.shape[0] != bs // mesh.data:
        raise RuntimeError(f"dryrun mPLUG: generated rows {ids.shape[0]}")


def _worker(rank: int, n: int, port: int) -> None:
    from .mesh import MeshConfig, initialize_multihost, make_mesh, shutdown

    initialize_multihost(f"127.0.0.1:{port}", n, rank, "cpu",
                         timeout=_TIMEOUT)
    try:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        mesh = make_mesh(MeshConfig(data=n // model, model=model),
                         torch.device("cpu"))
        _stage2(mesh)
        _mplug(mesh)
    finally:
        shutdown()


def dryrun_multichip(n_devices: int) -> None:
    """One stage-2 step and one mPLUG mask step over `n_devices` gloo ranks
    (spawned CPU processes); raises if any rank fails."""
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(n_devices, free_port()), nprocs=n_devices,
             join=True)
