"""The reference run as ranks: each rank holds one shard of the global
batch, and every reduction over the batch is made global by hand, in plain
``torch.distributed``:

- BN batch statistics: the sums of x and x^2 over every rank, through an
  all-reduce whose backward all-reduces the gradients too;
- masked means: the rank's sum over the global count; plain means: the
  rank's mean over the number of ranks (the shares sum to the global mean);
- dropout masks and latents: drawn for the global batch from generators
  seeded alike on every rank, each rank keeping its rows;
- gradients: summed over the ranks before Adam.

One process is ``Shard()``, world 1, for which every operation above is the
plain one. ``current()`` is the shard the reference's layers read; ``use``
sets it for a block.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class Shard:
    rank: int = 0
    world: int = 1
    group: Any = None

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor drawn for the global batch."""
        if self.world == 1:
            return t
        n = t.shape[0] // self.world
        return t[self.rank * n:(self.rank + 1) * n]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, differentiable."""
        return t if self.world == 1 else _Sum.apply(t, self.group)

    @torch.no_grad()
    def sum_detached(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        if self.world > 1:
            torch.distributed.all_reduce(t, group=self.group)
        return t

    @torch.no_grad()
    def sum_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each gradient summed over the ranks, in one f32 buffer."""
        if self.world == 1 or not grads:
            return grads
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        torch.distributed.all_reduce(flat, group=self.group)
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
            i += g.numel()
        return out


class _Sum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: each rank's
    input reaches every rank's output."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


_current: list[Shard] = [Shard()]


def current() -> Shard:
    return _current[0]


@contextlib.contextmanager
def use(shard: Shard) -> Iterator[Shard]:
    prev, _current[0] = _current[0], shard
    try:
        yield shard
    finally:
        _current[0] = prev
