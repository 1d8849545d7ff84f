"""Tensor parallelism over the model group (counterpart of
`crvqa_tpu/parallel/tp.py`), Megatron-style, for LXMERT stage 2.

The JAX package places each leaf with a `PartitionSpec` and lets XLA's
SPMD partitioner insert the all-reduces. Here each rank of a model group
holds its slice of the split leaves and the model runs `H / model` local
heads and `I / model` local FFN units, with Megatron's two operators:

- f (`copy_to_model`): identity forward, all-reduce backward, at the
  input of a column-parallel block (query / key / value, the FFN's up
  projection);
- g (`reduce_from_model`): all-reduce forward, identity backward, after a
  row-parallel product (the attention's and the FFN's output dense),
  whose bias is added once, after the reduce.

(`torch.distributed.nn.functional.all_reduce` is not g: its backward
all-reduces again, which would multiply the replicated gradients by
`model`.) The rules are the JAX package's (`param_partition_spec`),
restated for the port's [out, in] weights: column-parallel modules split
dim 0 of their weight and their bias, row-parallel ones dim 1 of their
weight. Mask scores split like the weights they gate; thresholds stay
replicated and are reset from the gathered scores, so every rank gets
the threshold of the whole matrix. Unlike the JAX package, a split leaf
whose dim does not divide by `model` raises: a block of local heads needs
every one of its leaves split.

Structured gates (`--structured_masking`: a (H,) head gate or a ()
layer gate) stay whole on every rank, as the JAX rule replicates every
1-D score leaf that is not a bias (crvqa_tpu/parallel/tp.py:33-41). A
rank applies this rank's part of each gate (`local_gates`: the gate's
entries of its heads over a column-split weight, the whole gate
otherwise), the gates' gradients are summed over the model group
before the clip (`sum_gate_grads_`), and their clip, moments and
exports are those of replicated leaves.

The scan layout's stacked [L, ...] leaves are 3-D and replicate under
the JAX rule. With nothing left to split, `tensor_parallel` returns None:
every model rank runs the whole model, as each device of the JAX mesh
does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

# column-parallel: the output dim ([out, in] dim 0) and the bias split
_COL_MODULES = ("query", "key", "value", "intermediate", "lang_inter",
                "visn_inter", "mlp_c_fc")
# row-parallel: the input dim ([out, in] dim 1) split, the bias replicated
_ROW_PARENTS = ("output", "lang_output", "visn_output", "mlp_c_proj")


def param_partition_spec(name: str, shape) -> Optional[int]:
    """The dim of the parameter `name` (a state_dict name, [out, in]
    weights) that the model group splits, or None when it replicates."""
    parts = name.split(".")
    if len(shape) == 1:
        if parts[-1] == "bias" and any(p in _COL_MODULES for p in parts[:-1]):
            return 0
        return None
    if len(shape) != 2 or parts[-1] != "weight":
        return None  # embeddings are 'weight' too, but in no listed module
    if any(p in _COL_MODULES for p in parts[:-1]):
        return 0
    if len(parts) >= 3 and parts[-2] == "dense" and parts[-3] in _ROW_PARENTS:
        return 1
    if parts[-2] in _ROW_PARENTS:
        return 1
    return None


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce (sum) backward over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce (sum) forward over the group, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass
class TensorParallel:
    """A model group's split: `dims` maps every key the run's dicts use
    (parameter names, score keys, the optimizer's 'scores/<key>') to the
    dim it splits."""

    mesh: Mesh
    dims: dict[str, int]
    # structured gate key -> the split dim of the weight it gates
    gates: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return self.mesh.model

    @property
    def index(self) -> int:
        return self.mesh.model_index

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.mesh.model_group)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.mesh.model_group)

    # ------------------------------------------------------------- leaves
    def shard(self, tree: dict) -> dict:
        """This rank's slices of the split leaves of a name-keyed dict (the
        rest as they are); a leaf that required grad is a new leaf that
        does too."""
        out = {}
        for k, t in tree.items():
            dim = self.dims.get(k)
            if dim is None:
                out[k] = t
                continue
            piece = t.detach().chunk(self.size, dim)[self.index].clone()
            out[k] = piece.requires_grad_(t.requires_grad)
        return out

    @torch.no_grad()
    def gather(self, tree: dict) -> dict:
        """The whole leaves of a sharded name-keyed dict on every rank (a
        collective over the model group); the rest as they are."""
        out = {}
        for k, t in tree.items():
            dim = self.dims.get(k)
            if dim is None:
                out[k] = t
                continue
            t = t.detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.mesh.model_group)
            out[k] = torch.cat(parts, dim)
        return out

    def is_split(self, key: str) -> bool:
        return key in self.dims

    def whole_shapes(self, tree: dict) -> dict[str, torch.Size]:
        """The whole leaves' shapes of a sharded name-keyed dict."""
        out = {}
        for k, t in tree.items():
            shape = list(t.shape)
            if k in self.dims:
                shape[self.dims[k]] *= self.size
            out[k] = torch.Size(shape)
        return out

    # -------------------------------------------------- structured gates
    def local_gates(self, scores: dict) -> dict:
        """`scores` with each head gate of a column-split weight cut to
        this rank's heads (differentiably: the gradient reaches the whole
        gate, zero outside them); every other leaf as it is."""
        out = dict(scores)
        for k, dim in self.gates.items():
            g = scores[k]
            if dim == 0 and g.dim() == 1:
                out[k] = g.chunk(self.size)[self.index]
        return out

    @torch.no_grad()
    def sum_gate_grads_(self, grads: dict) -> None:
        """Each gate's gradient := its sum over the model group (every
        rank saw its own part of the weight), in place, in one fixed-order
        flat all-reduce."""
        keys = [f"scores/{k}" for k in self.gates]
        if not keys:
            return
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, group=self.mesh.model_group)
        for k, f in zip(keys, flat.split([grads[k].numel() for k in keys])):
            grads[k].copy_(f.view_as(grads[k]))


def tensor_parallel(mesh: Mesh, params: dict[str, torch.Tensor], specs=(),
                    num_heads: int = 0, scores: Optional[dict] = None
                    ) -> Optional[TensorParallel]:
    """The split of a stage-2 run over `mesh`'s model group (None at model
    1, or when no leaf splits): parameter names of `params`, the masker
    `specs`' score keys (and their bias keys), and the optimizer's
    'scores/<key>'. A score of another shape than its weight (in
    `scores`, the state's) is a structured gate: whole, listed in
    `gates`. Raises when a split dim, or the head count, does not divide
    by `model`."""
    if mesh.model == 1:
        return None
    from ..masking.masker import bias_key, bias_name, weight_name

    dims = {}
    for name, t in params.items():
        dim = param_partition_spec(name, t.shape)
        if dim is None:
            continue
        if t.shape[dim] % mesh.model:
            raise ValueError(f"--mesh_model {mesh.model}: {name} "
                             f"{tuple(t.shape)} does not split on dim {dim}")
        dims[name] = dim
    if not dims:
        return None
    if num_heads % mesh.model:
        raise ValueError(f"--mesh_model {mesh.model} does not divide "
                         f"{num_heads} heads")
    gates = {}
    for spec in specs:
        for key, name in ((spec.key, weight_name(spec)),
                          (bias_key(spec), bias_name(spec))):
            if name not in dims:
                continue
            if (scores is not None and key in scores
                    and scores[key].shape != params[name].shape):
                gates[key] = dims[name]
            else:
                dims[key] = dims[f"scores/{key}"] = dims[name]
    return TensorParallel(mesh, dims, gates)


def enable_tp(model: torch.nn.Module, tp: TensorParallel) -> None:
    """Make `model`'s transformer blocks run their local part: every
    attention `H / model` heads starting at head `model_index * H /
    model` (the kernels' `head0`), f at the column-parallel inputs, g
    after the row-parallel products (`models/layers.py`)."""
    from ..models.layers import (AttentionOutput, FFNOutput, Intermediate,
                                 MultiHeadAttention)

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.num_heads //= tp.size
            m.head0 = tp.index * m.num_heads
            m.tp = tp
        elif isinstance(m, (AttentionOutput, FFNOutput, Intermediate)):
            m.tp = tp
