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

The 2-D ``(data, model)`` mesh (``make_mesh_2d``, JAX's ``make_mesh_2d``,
``jit_train_step_2d`` and their shardings): M adjacent ranks form a model
group, which works on one shard of the global batch (``rows`` and the loader
cut by data group, not by rank); the W / M groups are data-parallel. Two
modes, as in JAX:

- ``tensor``: every conv, dense and embedding weight whose output features
  divide by M holds only this rank's 1/M of them (``shard_parameters``; the
  layers of ``nn/layers.py``, ``nn/spectral.py`` and ``nn/gcn.py``), and so
  do its Adam moments and its EMA. A sharded layer's input enters through
  ``copy_to_model`` (identity; its backward sums the ranks' input gradients)
  and its output leaves through ``gather_model`` (the ranks' channels side by
  side; the backward keeps this rank's), Megatron's column-parallel pair: so
  every rank of a group holds every other tensor whole, with its whole
  gradient. BN statistics, masked means and the shards' gradients are
  summed over the data axis (the ranks of one model index); the whole
  parameters' gradients over every rank (``all_reduce_grads``).
- ``spatial``: parameters are replicated and, inside the train step
  (``row_shards``), the image and every activation of G's and D's trunks
  are cut into M shards of rows: ``split_rows`` and ``join_rows`` cross
  between whole and sharded tensors, ``conv2d`` exchanges halo rows with the
  neighbours, and ``model_sum`` adds the shards' parts of a spatial sum.
  Every rank holds a part of each gradient of a whole tensor (the parts sum
  to W times the gradient of the mean loss, as in the 1-D mesh): so
  ``split_rows`` backward pads with zeros, ``join_rows`` backward sums, and
  the gradient all-reduce sums over every rank. BN statistics on row shards
  are summed over every rank; on whole tensors over the data axis.

Every collective is an all-reduce in f32 (an all-gather is the all-reduce of
a zero-padded buffer), so one code path runs under NCCL and under gloo,
whose all-gather takes CPU tensors only. Each is the span
``mesh.all_reduce`` (``utils/tracing.py``), its ``kind`` named by the
caller (grads, bn_sum, metrics, other).
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
import torch.nn.functional as F

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.utils import tracing

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
MODES = ("tensor", "spatial")  # of the 2-D mesh


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the run: its rank, the world size W, its
    device, the process group (None in one process) and the number of nodes
    the ranks span; on a 2-D mesh also M (``model``, ranks per model group),
    the mode, and the groups of its data axis (the ranks of its model index)
    and of its model axis (its model group)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    nodes: int = 1
    model: int = 1
    mode: str = "data"
    data_group: Any = None
    model_group: Any = None

    @property
    def data_size(self) -> int:
        """The data groups: shards of the global batch (W on the 1-D mesh)."""
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def data_axis(self) -> Any:
        """The group of the ranks that share this rank's model index."""
        return self.group if self.model == 1 else self.data_group

    def data_view(self) -> "DataMesh":
        """This rank as a rank of the data axis alone: the mesh of work that
        every rank of a model group does whole (the eval hook's pools)."""
        if self.model == 1:
            return self
        return DataMesh(rank=self.data_index, world=self.data_size, device=self.device,
                        group=self.data_group if self.data_size > 1 else None, nodes=self.nodes)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor drawn for the global batch: its data
        group's."""
        if self.data_size == 1:
            return t
        n = t.shape[0] // self.data_size
        return t[self.data_index * n:(self.data_index + 1) * n]

    def padded(self, b: int) -> int:
        """b rounded up to a multiple of the data groups: the global batch a
        sharded sampler runs (JAX pads its batch up to the device count)."""
        return -(-b // self.data_size) * self.data_size

    def padded_rows(self, batch: dict, n: int) -> tuple[dict, int, int]:
        """This rank's rows of ``batch``, a global batch of arrays or
        tensors padded up to a multiple of the data groups whose first n
        rows are real: (its rows, the index of its first row in the
        batch, the count of real rows among them)."""
        size = len(next(iter(batch.values())))
        if size % self.data_size:
            raise ValueError(f"a batch of {size} rows does not split into {self.data_size} shards")
        first = self.data_index * (size // self.data_size)
        real = min(max(n - first, 0), size // self.data_size)
        return {k: self.rows(v) for k, v in batch.items()}, first, real

    def stats_axis(self) -> tuple[Any, int]:
        """(group, ranks) over which a batch statistic sums: every rank for
        row shards, else the data axis."""
        if rows_sharded():
            return self.group, self.world
        return self.data_axis, self.data_size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of a batch statistic over ``stats_axis``, differentiable
        (the backward sums the gradients over the same ranks)."""
        group, n = self.stats_axis()
        return t if n == 1 else _Sum.apply(t, group, "bn_sum")

    @torch.no_grad()
    def sum_detached(self, t: torch.Tensor, kind: str = "other") -> torch.Tensor:
        """The sum of t over every rank, outside autograd (``kind`` names the
        span)."""
        t = t.detach().clone()
        if self.group is not None:
            _all_reduce(t, self.group, kind)
        return t

    @torch.no_grad()
    def data_sum_detached(self, t: torch.Tensor, kind: str = "other") -> torch.Tensor:
        """The sum of t over the data axis, outside autograd."""
        t = t.detach().clone()
        if self.data_size > 1:
            _all_reduce(t, self.data_axis, kind)
        return t

    def mean_metrics(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Scalar metrics averaged over the data groups, in one all-reduce
        (the ranks of a model group hold the same metrics)."""
        if self.data_size == 1 or not metrics:
            return metrics
        keys = sorted(metrics)
        flat = self.data_sum_detached(torch.stack([metrics[k].detach().to(torch.float32)
                                                   for k in keys]), "metrics") / self.data_size
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
    def all_reduce_grads(self, grads: list[torch.Tensor],
                         params: list[torch.Tensor]) -> list[torch.Tensor]:
        """The gradients of ``params`` averaged over the data groups, each set
        in one f32 buffer, summed, divided, split back into each gradient's
        shape and dtype. On the 1-D mesh and in spatial mode every rank holds
        a part of each gradient (the parts sum to W times the mean's), so the
        sum runs over every rank and is divided by W. In tensor mode a
        shard's gradient (a parameter with ``tp_dim``) is summed over the
        data axis and divided by W / M; a whole parameter's, which every rank
        of a group computes alike, is averaged over every rank, so that
        round-off of kernels that are not deterministic cannot move the
        ranks' copies apart."""
        if self.mode != "tensor":
            return _mean_over(grads, self.group, self.world)
        sharded = [getattr(p, "tp_dim", None) is not None for p in params]
        out = list(grads)
        for flag, group, n in ((False, self.group, self.world),
                               (True, self.data_axis, self.data_size)):
            idx = [i for i, s in enumerate(sharded) if s == flag]
            for i, g in zip(idx, _mean_over([grads[i] for i in idx], group, n)):
                out[i] = g
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


def _all_reduce(t: torch.Tensor, group, kind: str) -> None:
    """Sum t over ``group`` in place: the span ``mesh.all_reduce`` of
    ``kind``."""
    with tracing.span("mesh.all_reduce", kind=kind):
        dist.all_reduce(t, group=group)


def _mean_over(grads: list[torch.Tensor], group, n: int) -> list[torch.Tensor]:
    """The tensors summed over ``group`` and divided by n, in one f32 buffer."""
    if n == 1 or not grads:
        return grads
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    _all_reduce(flat, group, "grads")
    flat.div_(n)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return out


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


@contextlib.contextmanager
def launched(device: str | torch.device | None = None,
             backend: str | None = None) -> Iterator[DataMesh]:
    """``make_mesh`` for the block (a CLI's run): a process group it forms
    is destroyed after the block; one formed before it (a program that runs
    several CLI calls in one launch) is kept, and its mesh is current again."""
    prev, formed = _current[0], not dist.is_initialized()
    try:
        yield make_mesh(device, backend)
    finally:
        if formed:
            shutdown()
        else:
            _current[0] = prev


def make_mesh_2d(mesh: DataMesh, model_parallel: int, mode: str = "tensor") -> DataMesh:
    """The (data, model) mesh over ``mesh``'s ranks, made current: model
    groups of ``model_parallel`` adjacent ranks (JAX's ``make_mesh_2d``), the
    W / M groups data-parallel. Every rank calls it (it forms the groups);
    ``model_parallel`` 1 returns ``mesh``. Raises ``ValueError`` when W does
    not divide by M or the mode is unknown."""
    if mode not in MODES:
        raise ValueError(f"unknown 2-D mode {mode!r}; modes are {MODES}")
    if mesh.world % model_parallel:
        raise ValueError(f"{mesh.world} ranks not divisible by --model_parallel {model_parallel}")
    if model_parallel == 1:
        return mesh
    m, n_data = model_parallel, mesh.world // model_parallel
    groups = {}
    for i in range(m):  # every rank forms every group, in one order
        groups["data", i] = dist.new_group([d * m + i for d in range(n_data)])
    for d in range(n_data):
        groups["model", d] = dist.new_group(list(range(d * m, (d + 1) * m)))
    out = dataclasses.replace(mesh, model=m, mode=mode, data_group=groups["data", mesh.rank % m],
                              model_group=groups["model", mesh.rank // m])
    _current[0] = out
    return out


def shutdown() -> None:
    """Destroy the process group, if any, and return to one process."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _current[0] = DataMesh()
    _rows[0] = False


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
    that every rank then holds the same bits (before ``shard_parameters``:
    the tensors are whole)."""
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
    """Raise unless every rank's train state has the same bits: on a 2-D
    mesh the whole tensors on every rank, the shards on the ranks of one
    model index."""
    from layout2img_tpu_torch.train.checkpoint import sharded_leaves

    if mesh.group is None:
        return
    mine = digests(state_tensors(state))
    sharded = sharded_leaves(state)
    everyone: list = [None] * mesh.world
    dist.all_gather_object(everyone, mine, group=mesh.group)
    for r, theirs in enumerate(everyone):
        same_shards = r % mesh.model == mesh.model_index
        if len(theirs) != len(mine):
            raise RuntimeError(f"rank {r}'s train state holds other tensors than rank "
                               f"{mesh.rank}'s")
        bad = next((a[0] for a, b in zip(mine, theirs)
                    if a != b and (same_shards or a[0] not in sharded)), None)
        if bad is not None:
            raise RuntimeError(f"rank {r}'s train state differs from rank {mesh.rank}'s at {bad}")


def dropout(x: torch.Tensor, p: float, training: bool = True, feature: bool = False) -> torch.Tensor:
    """Dropout (``feature``: whole channels of NCHW x, as ``dropout2d``)
    whose mask is drawn for the global batch from torch's generator and cut
    to this rank's rows (its data group's), so W ranks drop what one process
    drops at W*b. On row shards only ``feature`` dropout is defined. The
    noise is ``bernoulli_(1 - p) / (1 - p)`` times x, as torch's own."""
    if not training or p == 0.0:
        return x
    if rows_sharded() and not feature:
        raise NotImplementedError("element dropout on row shards")
    mesh = current()
    shape = (x.shape[0] * mesh.data_size, *(x.shape[1:2] + (1,) * (x.ndim - 2) if feature
                                            else x.shape[1:]))
    noise = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(1.0 - p).div_(1.0 - p)
    return x * mesh.rows(noise)


# ---- the 2-D mesh's crossings between whole and sharded tensors ----

def _f32_all_reduce(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum of t over ``group``, in a fresh f32 buffer."""
    buf = t.detach().to(torch.float32, copy=True)
    _all_reduce(buf, group, kind)
    return buf


def _all_gather(t: torch.Tensor, dim: int, group, n: int, index: int) -> torch.Tensor:
    """The ``n`` ranks' t side by side along ``dim`` (this rank's at
    ``index``): the all-reduce of a zero-padded f32 buffer, exact."""
    shape = list(t.shape)
    k = shape[dim]
    shape[dim] = k * n
    buf = torch.zeros(shape, dtype=torch.float32, device=t.device)
    buf.narrow(dim, index * k, k).copy_(t)
    _all_reduce(buf, group, "other")
    return buf.to(t.dtype)


class _Sum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it (both
    spans of ``kind``)."""

    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.group, ctx.kind = group, kind
        return _f32_all_reduce(t, group, kind).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return _f32_all_reduce(g, ctx.group, ctx.kind).to(g.dtype), None, None


class _CopyToModel(torch.autograd.Function):
    """Tensor mode: a whole input of a sharded layer (identity); each rank's
    gradient is its shard's part, so the backward sums them."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _f32_all_reduce(g, ctx.mesh.model_group, "other").to(g.dtype), None


class _GatherModel(torch.autograd.Function):
    """Tensor mode: the ranks' output shards side by side along ``dim``; the
    backward keeps this rank's slice of the whole gradient."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.k, ctx.mesh = dim, x.shape[dim], mesh
        return _all_gather(x, dim, mesh.model_group, mesh.model, mesh.model_index)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.model_index * ctx.k, ctx.k).contiguous(), None, None


class _SplitRows(torch.autograd.Function):
    """Spatial mode: this rank's rows of a whole tensor; the backward pads
    its rows' gradient with zeros (a part of the whole tensor's)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.shape = mesh, x.shape
        h, rem = divmod(x.shape[-2], mesh.model)
        if rem:
            raise ValueError(f"{x.shape[-2]} rows do not split into {mesh.model} shards")
        return x.narrow(-2, mesh.model_index * h, h).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(-2, ctx.mesh.model_index * g.shape[-2], g.shape[-2]).copy_(g)
        return out, None


class _JoinRows(torch.autograd.Function):
    """Spatial mode: the whole tensor from the ranks' rows; the backward sums
    the ranks' parts of its gradient and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.h = mesh, x.shape[-2]
        return _all_gather(x, x.ndim - 2, mesh.model_group, mesh.model, mesh.model_index)

    @staticmethod
    def backward(ctx, g):
        whole = _f32_all_reduce(g, ctx.mesh.model_group, "other").to(g.dtype)
        return whole.narrow(-2, ctx.mesh.model_index * ctx.h, ctx.h).contiguous(), None


class _Halo(torch.autograd.Function):
    """Spatial mode: x's rows with ``p`` rows of each neighbour shard above
    and below (zeros at the image's top and bottom), from one all-reduce of
    every rank's edge rows; the backward adds the halo rows' gradients back
    to the rows they came from."""

    @staticmethod
    def forward(ctx, x, p, mesh):
        ctx.p, ctx.mesh = p, mesh
        m, k = mesh.model, mesh.model_index
        edges = torch.zeros((m, 2, *x.shape[:-2], p, x.shape[-1]), dtype=torch.float32,
                            device=x.device)
        edges[k, 0] = x[..., :p, :]
        edges[k, 1] = x[..., -p:, :]
        _all_reduce(edges, mesh.model_group, "other")
        above = edges[k - 1, 1] if k > 0 else torch.zeros_like(edges[k, 0])
        below = edges[k + 1, 0] if k < m - 1 else torch.zeros_like(edges[k, 0])
        return torch.cat([above.to(x.dtype), x, below.to(x.dtype)], dim=-2)

    @staticmethod
    def backward(ctx, g):
        p, mesh = ctx.p, ctx.mesh
        m, k = mesh.model, mesh.model_index
        edges = torch.zeros((m, 2, *g.shape[:-2], p, g.shape[-1]), dtype=torch.float32,
                            device=g.device)
        if k > 0:
            edges[k - 1, 1] = g[..., :p, :]
        if k < m - 1:
            edges[k + 1, 0] = g[..., -p:, :]
        _all_reduce(edges, mesh.model_group, "other")
        dx = g[..., p:-p, :].to(torch.float32, copy=True)
        dx[..., :p, :] += edges[k, 0]
        dx[..., -p:, :] += edges[k, 1]
        return dx.to(g.dtype), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The whole input of a tensor-mode sharded layer (``_CopyToModel``)."""
    return _CopyToModel.apply(x, current())


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A tensor-mode sharded layer's output, whole (``_GatherModel``)."""
    return _GatherModel.apply(x, dim % x.ndim, current())


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's parts of a spatial sum (each rank's over
    its rows), on every rank; the backward sums the gradients likewise."""
    mesh = current()
    return t if mesh.model == 1 else _Sum.apply(t, mesh.model_group, "other")


def row_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of t over every element of the whole image: ``t.mean()``, or
    on row shards the model-summed sum over the whole count."""
    if not rows_sharded():
        return t.mean()
    return model_sum(t.sum()) / (t.numel() * current().model)


# ---- row shards (spatial mode) ----

_rows = [False]


def rows_sharded() -> bool:
    """Whether the image tensors of this region are row shards: inside the
    spatial mode's train step, where G's and D's trunks run on them."""
    return _rows[0] and current().mode == "spatial"


@contextlib.contextmanager
def row_shards(on: bool) -> Iterator[None]:
    """Set for the block whether image tensors are row shards (``rows_sharded``)."""
    prev, _rows[0] = _rows[0], bool(on)
    try:
        yield
    finally:
        _rows[0] = prev


def splits_rows(h: int) -> bool:
    """Whether an image h rows high is cut into row shards in spatial mode:
    into M shards of an even count of rows (2x2 pooling stays local), at
    least 2. Layers on smaller images run on whole rows."""
    return current().mode == "spatial" and h % (2 * current().model) == 0


def split_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole image tensor (``_SplitRows``)."""
    return _SplitRows.apply(x, current())


def join_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole image tensor from the ranks' row shards (``_JoinRows``)."""
    return _JoinRows.apply(x, current())


def reshard_rows(x: torch.Tensor, have: bool, want: bool) -> torch.Tensor:
    """x, which is a row shard when ``have``, as one when ``want``."""
    if want and not have:
        return split_rows(x)
    if have and not want:
        return join_rows(x)
    return x


def row_window(h: int, sharded: bool | None = None) -> tuple[int, int]:
    """(first image row, image height) of a tensor h rows high: its shard's
    window when it is a row shard (``sharded``, default ``rows_sharded()``),
    else (0, h)."""
    if not (rows_sharded() if sharded is None else sharded):
        return 0, h
    mesh = current()
    return mesh.model_index * h, h * mesh.model


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           padding: int) -> torch.Tensor:
    """``F.conv2d`` at stride 1 with ``padding`` zeros around; on a row
    shard the ``padding`` rows above and below are the neighbours' (``_Halo``)
    and only the image's top and bottom get zeros."""
    if not (padding and rows_sharded()):
        return F.conv2d(x, weight, bias, padding=padding)
    if x.shape[-2] < padding:
        raise ValueError(f"a row shard of {x.shape[-2]} rows cannot lend a halo of {padding}")
    return F.conv2d(_Halo.apply(x, padding, current()), weight, bias, padding=(0, padding))


# ---- tensor mode's parameter shards ----

def shard_dims(module: torch.nn.Module) -> dict[str, int]:
    """{parameter name: the dim it is sharded on} of a module's tensor-mode
    shards (each layer's ``tp_dim``, set by ``shard_parameters``)."""
    return {f"{prefix}.{m.TP_PARAM}" if prefix else m.TP_PARAM: m.tp_dim
            for prefix, m in module.named_modules(remove_duplicate=False)
            if getattr(m, "tp_dim", None) is not None}


@torch.no_grad()
def shard_parameters(module: torch.nn.Module, mesh: DataMesh) -> dict[str, int]:
    """Tensor mode: cut every shardable layer's weight (a layer with
    ``TP_PARAM`` and ``TP_DIM``: the weight and its output-feature dim) whose
    output features divide by M to this rank's 1/M, in place, and set the
    layer's ``tp_dim``; the others stay whole (JAX's
    ``tensor_parallel_shardings``: the trailing output-feature axis of every
    leaf of rank >= 2 that divides). Call it before the optimizer is built.
    Returns ``shard_dims(module)``."""
    for m in module.modules():
        name = getattr(m, "TP_PARAM", None)
        if name is None or m.tp_dim is not None:
            continue
        w = getattr(m, name)
        k, rem = divmod(w.shape[m.TP_DIM], mesh.model)
        if rem == 0 and mesh.model > 1:
            shard = torch.nn.Parameter(w.narrow(m.TP_DIM, mesh.model_index * k, k).clone(),
                                       requires_grad=w.requires_grad)
            shard.tp_dim = m.tp_dim = m.TP_DIM  # the gradient all-reduce reads it
            setattr(m, name, shard)
    return shard_dims(module)


def gather_shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor of a tensor-mode shard, on every rank (outside
    autograd)."""
    mesh = current()
    with torch.no_grad():
        return _all_gather(t, dim, mesh.model_group, mesh.model, mesh.model_index)


def own_shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's shard of a whole tensor (a copy)."""
    mesh = current()
    k = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * k, k).clone()
