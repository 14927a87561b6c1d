"""Data-parallel training over processes (counterpart of the 1-D mesh of
``layout2img_tpu/parallel/mesh.py``).

In JAX one jitted step runs over a ``(data,)`` mesh and XLA makes every batch
reduction cross-replica. Here each process (a rank) holds one device and its
shard of the global batch, and every reduction over the batch is made global
by hand, so that W ranks at per-rank batch b train the model one process
trains at batch W*b:

- gradients: ``all_reduce_grads``, one coalesced f32 buffer per network,
  summed and divided by W before Adam (``train/step.py::_apply_grads``);
- BN batch statistics: ``nn/norms.py::batch_stats`` and
  ``models/layout2im.py::MaskedBatchNorm`` sum (x, x^2, count) over the ranks
  with ``sum`` (differentiable: its backward sums the gradients too, so the
  ISLA backward kernel's per-rank dmean and dvar reach every rank);
- masked means: ``losses/gan.py::masked_mean`` divides by the global count;
- the batch: each rank's loader holds its shard
  (``HostDataLoader(process_id=rank, process_count=W)``) and
  ``data/prefetch.py::device_prefetch`` moves it to the rank's device, JAX's
  ``shard_host_local_batch``;
- latents and dropout: drawn for the global batch from generators seeded
  alike on every rank, each rank keeping its ``rows``;
- metrics, the NaN guard's verdict and the SIGTERM flags: ``mean_metrics``
  and ``any``.

Parameters, buffers, optimizer state and the EMA are replicated: rank 0's are
broadcast at the start (``replicate``), and since every rank then applies
the same global gradients they stay bit-equal (``check_replicated`` checks it).

The mesh of a run is ``make_mesh()``: under a launcher (``torchrun``, which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) it forms the process group, NCCL for CUDA and gloo for the
CPU; without one it is ``world()``, one process. A group that fails to form
raises. ``current()`` is the mesh the layers above read; ``use(mesh)`` sets
it for a block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import os
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from layout2img_tpu_torch.device import resolve_device

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel run: its rank, the world
    size W, its device, the process group (None in one process) and the
    number of nodes the ranks span."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    nodes: int = 1

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor drawn for the global batch."""
        if self.world == 1:
            return t
        n = t.shape[0] // self.world
        return t[self.rank * n:(self.rank + 1) * n]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks, differentiable (the backward sums
        the gradients over the ranks)."""
        if self.world == 1:
            return t
        return dist_nn.all_reduce(t, group=self.group)

    @torch.no_grad()
    def sum_detached(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks, outside autograd."""
        t = t.detach().clone()
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def mean_metrics(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Scalar metrics averaged over the ranks, in one all-reduce."""
        if self.group is None or not metrics:
            return metrics
        keys = sorted(metrics)
        flat = self.sum_detached(torch.stack([metrics[k].detach().to(torch.float32)
                                              for k in keys])) / self.world
        return dict(zip(keys, flat.unbind()))

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank gets the answer)."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.sum_detached(t).item() > 0)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    @torch.no_grad()
    def all_reduce_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The gradients averaged over the ranks: one f32 buffer, summed,
        divided by W, split back into each gradient's shape and dtype."""
        if self.group is None or not grads:
            return grads
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world)
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
            i += g.numel()
        return out

    def gather_rows(self, a: np.ndarray) -> np.ndarray:
        """Every rank's (n, ...) array, concatenated in rank order (n equal
        on every rank)."""
        if self.group is None:
            return a
        # gloo gathers CPU tensors only
        dev = self.device if dist.get_backend(self.group) == "nccl" else torch.device("cpu")
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts).cpu().numpy()


_current: list[DataMesh] = [DataMesh()]


def current() -> DataMesh:
    """The mesh the layers and steps read (one process unless set)."""
    return _current[0]


@contextlib.contextmanager
def use(mesh: DataMesh) -> Iterator[DataMesh]:
    """Make ``mesh`` the current one for the block."""
    prev, _current[0] = _current[0], mesh
    try:
        yield mesh
    finally:
        _current[0] = prev


def world(device: str | torch.device | None = None) -> DataMesh:
    """The one-process mesh on ``device`` (default cuda)."""
    return DataMesh(device=resolve_device(device))


def initialize(device: str | torch.device | None = None, backend: str | None = None,
               timeout_s: float = 1800.0) -> DataMesh:
    """Form the process group from the launcher's variables, make its mesh
    the current one and return it. ``device`` None means cuda, and cuda
    means ``cuda:{LOCAL_RANK % device_count}``; ``backend`` defaults to NCCL
    for CUDA and gloo for the CPU. Missing variables or a group that does
    not form raise."""
    missing = [k for k in LAUNCH_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(f"a data-parallel rank needs {', '.join(missing)} set (torchrun "
                           "sets them)")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        extra = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout_s), **extra)
    mesh = DataMesh(rank=rank, world=size, device=dev, group=dist.group.WORLD,
                    nodes=-(-size // max(local_size, 1)))
    _current[0] = mesh
    return mesh


def make_mesh(device: str | torch.device | None = None, backend: str | None = None) -> DataMesh:
    """The run's mesh, made current: ``initialize`` under a launcher (one
    that sets ``WORLD_SIZE``), else ``world(device)``."""
    mesh = initialize(device, backend) if "WORLD_SIZE" in os.environ else world(device)
    _current[0] = mesh
    return mesh


def shutdown() -> None:
    """Destroy the process group, if any, and return to one process."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _current[0] = DataMesh()


def flat_tensors(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensors of nested dicts and lists, by dotted path, dict keys in
    sorted order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree, key=str)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(flat_tensors(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def state_tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor of a train state (``train/checkpoint.py``'s content:
    parameters, buffers, Adam moments and counts, the EMA), by name."""
    from layout2img_tpu_torch.train.checkpoint import state_dict

    return flat_tensors(state_dict(state))


@torch.no_grad()
def replicate(mesh: DataMesh, state) -> None:
    """Broadcast rank 0's train state to every rank, in place, and check
    that every rank then holds the same bits."""
    if mesh.group is None:
        return
    for t in state_tensors(state).values():
        buf = t.to(mesh.device)  # gloo reduces and broadcasts CUDA tensors too
        dist.broadcast(buf, src=0, group=mesh.group)
        if buf is not t:
            t.copy_(buf)
    check_replicated(mesh, state)


def digests(tensors: dict[str, torch.Tensor]) -> list[tuple[str, str]]:
    """(name, SHA-256 of the bytes) of each tensor."""
    return [(name, hashlib.sha256(t.detach().reshape(-1).cpu().contiguous().view(torch.uint8)
                                  .numpy().tobytes()).hexdigest())
            for name, t in tensors.items()]


def check_replicated(mesh: DataMesh, state) -> None:
    """Raise unless every rank's train state has the same bits."""
    if mesh.group is None:
        return
    mine = digests(state_tensors(state))
    everyone: list = [None] * mesh.world
    dist.all_gather_object(everyone, mine, group=mesh.group)
    for r, theirs in enumerate(everyone):
        if theirs != mine:
            bad = next((a[0] for a, b in zip(mine, theirs) if a != b), "the tensor list")
            raise RuntimeError(f"rank {r}'s train state differs from rank {mesh.rank}'s at {bad}")


def dropout(x: torch.Tensor, p: float, training: bool = True, feature: bool = False) -> torch.Tensor:
    """Dropout (``feature``: whole channels of NCHW x, as ``dropout2d``)
    whose mask is drawn for the global batch from torch's generator and cut
    to this rank's rows, so W ranks drop what one process drops at W*b. The
    noise is ``bernoulli_(1 - p) / (1 - p)`` times x, as torch's own."""
    if not training or p == 0.0:
        return x
    mesh = current()
    shape = (x.shape[0] * mesh.world, *(x.shape[1:2] + (1,) * (x.ndim - 2) if feature
                                        else x.shape[1:]))
    noise = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(1.0 - p).div_(1.0 - p)
    return x * mesh.rows(noise)
