"""ZeRO-style optimizer-state sharding over the data group (counterpart of
`crvqa_tpu/parallel/zero.py`; the analogue of DeepSpeed ZeRO-2,
`mPLUG/configs/ds_config.json:5-8`).

The JAX package shards slices of the moment arrays and lets XLA insert the
reduce-scatter / all-gather. Here whole leaves are owned: the trainable
leaves are dealt over the data ranks, greedily by bytes (largest first,
ties by name) onto the rank with the fewest bytes so far, so every rank
derives the same partition. A rank keeps the optimizer state of its own
leaves only and updates only them; each owner then broadcasts its updated
leaves over the data group in flat buckets per dtype.

The gradients are all-reduced in full before the update (ZeRO-1/2
semantics), and each leaf's update is the optimizer's own arithmetic on
that leaf, so the result equals the unsharded update for every `--opt` of
the factory: LAMB's trust ratio, novograd's norms, Adafactor's factored
statistics and the channel view of adamp / sgdp are per leaf, and
AdaHessian's global-norm clip is taken over every gradient before the
owned ones go to it. Slice-level sharding would need a collective inside
each of those. `gather_state` assembles the full state on every rank (the
checkpoints' counterpart of `crvqa_tpu/core/checkpoint.py:24-28`);
`shard_state` drops the leaves a rank does not own (after a resume, which
loads the full state first).
"""
from __future__ import annotations

import dataclasses
import torch
import torch.distributed as dist

from .mesh import Mesh


def partition(sizes: dict[str, int], n: int) -> dict[str, int]:
    """name -> owning data index: greedy by bytes, largest first, ties by
    name, each onto the least-loaded owner (the lowest index among
    equals)."""
    load = [0] * n
    owner = {}
    for name in sorted(sizes, key=lambda k: (-sizes[k], k)):
        d = min(range(n), key=lambda i: (load[i], i))
        owner[name] = d
        load[d] += sizes[name]
    return owner


def _param_dicts(opt_state) -> list[tuple[tuple[str, ...], dict]]:
    """Every dict of tensors keyed by parameter name inside an optimizer
    state (a field, or a slot of a field holding slots), with its path."""
    out = []
    for f in dataclasses.fields(opt_state):
        value = getattr(opt_state, f.name)
        if not isinstance(value, dict):
            continue
        if value and all(isinstance(v, dict) for v in value.values()):
            out.extend(((f.name, slot), d) for slot, d in value.items())
        else:  # a rank that owns no leaf holds an empty dict
            out.append(((f.name,), value))
    return out


class ZeroPartition:
    """Whole-leaf ownership of the trainable leaves `params` (name ->
    tensor, in the optimizer's order) over `mesh`'s data group."""

    def __init__(self, params: dict[str, torch.Tensor], mesh: Mesh):
        self.mesh = mesh
        self.order = list(params)
        self.owner = partition(
            {k: t.numel() * t.element_size() for k, t in params.items()},
            mesh.data)

    def owned_by(self, data_index: int) -> list[str]:
        return [k for k in self.order if self.owner[k] == data_index]

    def mine(self, tree: dict) -> dict:
        """The entries of a name-keyed dict this rank owns."""
        d = self.mesh.data_index
        return {k: v for k, v in tree.items() if self.owner.get(k, d) == d}

    # ---------------------------------------------------------- the state
    def shard_state(self, opt_state):
        """Drop the leaves this rank does not own from a full state (in
        place; returns it)."""
        for _, d in _param_dicts(opt_state):
            for k in [k for k in d if self.owner[k] != self.mesh.data_index]:
                del d[k]
        return opt_state

    @torch.no_grad()
    def gather_state(self, opt_state):
        """The full state on every rank, each dict in the parameters'
        order, as a new object (the rank's own state is left sharded). A
        collective over the data group; the state itself at data 1."""
        if self.mesh.data == 1:
            return opt_state
        mine = _param_dicts(opt_state)
        meta = {path: {k: (tuple(t.shape), t.dtype) for k, t in d.items()}
                for path, d in mine}
        every: list = [None] * self.mesh.world_size
        dist.all_gather_object(every, meta, group=self.mesh.control_group)
        full: dict[tuple, dict[str, torch.Tensor]] = {
            path: {} for path, _ in mine}
        for d_idx in range(self.mesh.data):
            theirs = every[self.mesh.data_rank(d_idx)]
            entries = [(path, k) for path, _ in mine
                       for k in self.owned_by(d_idx) if k in theirs[path]]
            if d_idx == self.mesh.data_index:
                tensors = [dict(mine)[path][k] for path, k in entries]
            else:
                tensors = [torch.empty(theirs[path][k][0],
                                       dtype=theirs[path][k][1],
                                       device=self.mesh.device)
                           for path, k in entries]
            self._broadcast(tensors, d_idx, copy_back=True)
            for (path, k), t in zip(entries, tensors):
                full[path][k] = t
        out = dataclasses.replace(opt_state)
        for f in dataclasses.fields(out):
            value = getattr(out, f.name)
            if (f.name,) in full:
                setattr(out, f.name, self._ordered(full[(f.name,)]))
            elif isinstance(value, dict) and value and all(
                    isinstance(v, dict) for v in value.values()):
                setattr(out, f.name, {
                    slot: self._ordered(full[(f.name, slot)])
                    for slot in value})
        return out

    def _ordered(self, d: dict) -> dict:
        return {k: d[k] for k in self.order if k in d}

    # ----------------------------------------------------------- broadcast
    def _broadcast(self, tensors: list[torch.Tensor], data_index: int,
                   copy_back: bool) -> None:
        """Broadcast `tensors` (owner: its values; others: buffers of the
        same shapes and dtypes) from the rank at `data_index` over the
        data group, in flat buckets per dtype."""
        from ..train.common import _buckets

        src = self.mesh.data_rank(data_index)
        is_src = data_index == self.mesh.data_index
        for bucket in _buckets(tensors):
            flat = (torch.cat([t.reshape(-1) for t in bucket]) if is_src
                    else torch.empty(sum(t.numel() for t in bucket),
                                     dtype=bucket[0].dtype,
                                     device=bucket[0].device))
            dist.broadcast(flat, src=src, group=self.mesh.data_group)
            if is_src and not copy_back:
                continue
            for t, f in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(f.view_as(t))

    @torch.no_grad()
    def broadcast_params_(self, params: dict[str, torch.Tensor]) -> None:
        """Every owner's updated leaves to the whole data group, in place
        (owners keep their own bits). A no-op without a process group."""
        if not self.mesh.distributed:
            return
        for d_idx in range(self.mesh.data):
            self._broadcast([params[k] for k in self.owned_by(d_idx)],
                            d_idx, copy_back=False)


class ZeroOptimizer:
    """`inner` (any optimizer of the port: init / step over a name-keyed
    dict) with its state sharded by `ZeroPartition`: `step` takes the full
    all-reduced gradients, updates this rank's leaves and broadcasts every
    owner's. A (grads, hess) pair (AdaHessian) is clipped by the global
    norm over all gradients first, with the optimizer's own formula."""

    def __init__(self, inner, zero: ZeroPartition):
        self.inner, self.zero = inner, zero

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads, state) -> None:
        owned = self.zero.mine(params)
        if isinstance(grads, tuple):
            g, hess = grads
            g = self.inner.clip_grads({k: g[k] for k in params})
            self.inner.step(owned, ({k: g[k] for k in owned},
                                    {k: hess[k] for k in owned}), state,
                            clipped=True)
        else:
            self.inner.step(owned, {k: grads[k] for k in owned}, state)
        self.zero.broadcast_params_(params)


def zero_optimizer(inner, params: dict[str, torch.Tensor], mesh: Mesh
                   ) -> tuple[ZeroOptimizer, ZeroPartition]:
    """(`inner` wrapped for ZeRO over `mesh`, its partition of `params`,
    the trainable leaves). The state `inner.init` built stays whole until
    `ZeroPartition.shard_state`, so a resume can fill it first."""
    zero = ZeroPartition(params, mesh)
    return ZeroOptimizer(inner, zero), zero
