"""The process mesh and its collectives (counterpart of
`crvqa_tpu/parallel/mesh.py`).

The JAX package drives a `Mesh(devices.reshape(data, model))` from one
process and lets XLA place the collectives. The port follows PyTorch's
model of one process per device instead: a run of `world_size = data x
model` processes (ranks), each holding one device. A rank's place on the
mesh is process-major, as `make_mesh` lays devices out there:
`data_index = rank // model`, `model_index = rank % model`.

Three kinds of process group:

- the data group of a rank: the ranks that share its `model_index`
  (gradients, gathered eval outputs, ZeRO's broadcasts travel here);
- its model group: the ranks that share its `data_index` (its tensor-
  parallel partners, which see the same rows);
- the control group: every rank, always on gloo, for host-side agreement
  (the preemption flag, the gathers of question ids / labels / valid
  flags, the barrier after rank-0 writes) without a device sync.

Without a process group everything is world 1 and every collective is the
identity. `--device cuda` runs NCCL on `cuda:{LOCAL_RANK}`, `--device
cpu` gloo: an explicit choice, never a fallback.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

# collectives that do not finish within this raise instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh layout; data * model must equal the world size."""

    data: int = -1  # -1 = every rank the model axis leaves
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices")
        return data, model


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: its coordinates, its groups (None
    without a process group) and its device."""

    rank: int
    world_size: int
    data: int
    model: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    control_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        """True under a process group (collectives run, at world 1 too)."""
        return self.control_group is not None

    def data_rank(self, data_index: int) -> int:
        """The global rank at (data_index, this rank's model_index)."""
        return data_index * self.model + self.model_index


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that owns artifact writes (exports, checkpoints,
    logs): the reference's rank gating (`prune_debias_VQA.py:714-719`,
    `mPLUG/utils.py:217-229`)."""
    return process_index() == 0


_GROUPS: dict[tuple[int, int], tuple] = {}


def _groups(data: int, model: int) -> tuple:
    """(data groups by model_index, model groups by data_index, control
    group), built once per layout. Every rank creates every group in the
    same order, as `new_group` requires."""
    key = (data, model)
    if key not in _GROUPS:
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        control = dist.new_group(backend="gloo")
        _GROUPS[key] = (data_groups, model_groups, control)
    return _GROUPS[key]


def make_mesh(config: MeshConfig = MeshConfig(),
              device: Optional[torch.device] = None) -> Mesh:
    """This rank's `Mesh` over the live process group (world 1 without
    one); raises when `config` does not cover the world."""
    device = torch.device(device if device is not None else "cpu")
    world = process_count()
    data, model = config.resolve(world)
    if not dist.is_initialized():
        return Mesh(0, 1, data, model, device)
    rank = dist.get_rank()
    data_groups, model_groups, control = _groups(data, model)
    return Mesh(rank, world, data, model, device,
                data_group=data_groups[rank % model],
                model_group=model_groups[rank // model],
                control_group=control)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def process_local_slice(batch: Any, mesh: Optional[Mesh]) -> Any:
    """Slice a GLOBAL host batch to this rank's contiguous row block — the
    loader-side half of the multi-process contract. Batch sizes always
    mean the GLOBAL batch: every rank derives the same global batch and
    keeps rows [d*B/D, (d+1)*B/D) of it, d its `data_index` (not its rank:
    tensor-parallel partners need the same rows). The analogue of the
    reference's per-rank `DistributedSampler`
    (`mask_trainer_Robust_VQA.py:303-307`), in contiguous blocks so that
    gathered outputs stay in global row order. Scalars and non-array
    leaves pass through; at data 1 this is the identity."""
    if mesh is None or mesh.data == 1:
        return batch
    n, d = mesh.data, mesh.data_index

    def _slice(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(
                f"global batch dim {x.shape[0]} not divisible by "
                f"process_count {n}")
        local = x.shape[0] // n
        return x[d * local:(d + 1) * local]

    if isinstance(batch, dict):
        return {k: _slice(v) for k, v in batch.items()}
    return _slice(batch)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's slice of a batch on its device: tensors and numpy arrays
    move (numpy ids stay on the host for `question_id`, `qid`, `valid`)."""
    from ..data.prefetch import to_device

    return to_device(process_local_slice(batch, mesh), mesh.device)


def host_all_gather(x, mesh: Optional[Mesh]) -> np.ndarray:
    """Every data rank's rows of a device (or host) array concatenated in
    `data_index` order, as numpy on every rank: the analogue of the
    reference's `distributed_concat` eval gather
    (`mask_trainer_Robust_VQA.py:1247-1257`). A collective over the data
    group: every rank must call it together. Without a process group this
    is a host fetch."""
    t = torch.as_tensor(x)
    if mesh is None or not mesh.distributed:
        return t.detach().cpu().numpy()
    t = t.detach().to(mesh.device).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t, group=mesh.data_group)
    return torch.cat(parts).cpu().numpy()


def host_all_gather_local(x, mesh: Optional[Mesh]) -> np.ndarray:
    """Concatenate host arrays of equal shape across the data ranks, in
    `data_index` order — the row order of `host_all_gather`, so host-side
    fields (qids, labels, valid) stay row-aligned with gathered device
    outputs. Travels over the gloo control group (no device sync); every
    rank must call it together. Identity without a process group."""
    arr = np.asarray(x)
    if mesh is None or not mesh.distributed:
        return arr
    is_bool = arr.dtype == np.bool_
    t = torch.from_numpy(np.ascontiguousarray(
        arr.astype(np.uint8) if is_bool else arr))
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.control_group)
    # tensor-parallel partners hold the same rows: one block per data index
    out = torch.cat([parts[d * mesh.model + mesh.model_index]
                     for d in range(mesh.data)]).numpy()
    return out.astype(np.bool_) if is_bool else out


def any_process(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank iff `flag` is True on any rank (a collective over
    the control group; the flag itself without a process group)."""
    if mesh is None or not mesh.distributed:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.control_group)
    return bool(t.item())


def control_group():
    """The gloo control group of the live mesh, or None."""
    return next(iter(_GROUPS.values()))[2] if _GROUPS else None


def barrier() -> None:
    """Wait for every rank on the control group (orders rank-0 writes
    before anything that reads them); a no-op without a process group."""
    group = control_group()
    if group is not None:
        dist.barrier(group=group)


def local_rank() -> int:
    """The device index of this process on its host: torchrun's
    LOCAL_RANK, else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return process_index() % max(n, 1)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> None:
    """Bring up the process group (the analogue of the reference's
    `utils.init_distributed_mode`, `mPLUG/utils.py:238`): from the three
    flags when `coordinator_address` is given (`tcp://<address>`, world
    `num_processes`, rank `process_id`), else from torchrun's RANK /
    WORLD_SIZE / MASTER_ADDR / MASTER_PORT. NCCL on `cuda:{LOCAL_RANK}`
    for a CUDA device, gloo for the CPU. Every failure raises: an explicit
    request never degrades to a rank that trains alone. A no-op when the
    group is already up."""
    if dist.is_initialized():
        return
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR", "MASTER_PORT")}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif all(v is not None for v in env.values()):
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        raise ValueError(
            "--multihost true: give --coordinator_address host:port, "
            "--num_processes and --process_id, or launch under torchrun "
            "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside a world of {world}")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu to run on the CPU on purpose")
        backend = "nccl"
        if "LOCAL_RANK" not in os.environ:
            os.environ["LOCAL_RANK"] = str(
                rank % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)


def shutdown() -> None:
    """Tear the process group down (every rank at its end)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
