"""Rematerialization whose recompute replays the state updates of its forward.

``torch.utils.checkpoint`` runs a region's forward a second time in the
backward. The port's layers update state in training: a spectral norm
advances ``weight_u`` by one power iteration, a batch-statistics BN folds
the batch into its running statistics. Run twice, u would advance twice,
the recomputed sigma would not be the one the forward used (so the
gradients would change silently), and the running statistics would be
folded twice. ``jax.checkpoint`` is pure, so the JAX package's remat step
equals its plain step; ``checkpoint`` here gives the port the same property:

- the forward records, per layer and call, the state values it used
  (``layer_state``);
- the recompute takes those values back in the same order and writes no
  state (``replaying`` is then true);
- the RNG state is replayed (``preserve_rng_state=True``, on the CPU and on
  CUDA), so the PSP head's dropout draws the same mask.

Regions may nest (``remat="d"`` around a discriminator whose first trunk
blocks are checkpointed too): a value recorded or replayed in an inner
region is recorded for every enclosing region as well.

Under a data-parallel mesh (``parallel/mesh.py``) a recompute sums its BN
statistics over the ranks again, as the forward did: its backward has to
sum their gradients over the ranks too, which replayed constants could not.
Every rank runs the same graph, so every rank recomputes the same regions in
the same order and the collectives meet (``tests/test_torch_port_parallel.py``
runs ``remat="gd"`` on 2 ranks).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch import nn

_local = threading.local()


def _frames() -> list[tuple[str, "_Stash"]]:
    """The regions entered on this thread, outermost first: (mode, stash)."""
    if not hasattr(_local, "frames"):
        _local.frames = []
    return _local.frames


class _Stash:
    """The state values one checkpointed call's forward used, per layer."""

    def __init__(self):
        self.saved: dict[int, collections.deque] = collections.defaultdict(collections.deque)

    @contextlib.contextmanager
    def _enter(self, mode: str):
        frames = _frames()
        frames.append((mode, self))
        try:
            yield
        finally:
            frames.pop()

    def contexts(self):
        return self._enter("record"), self._enter("replay")


def replaying() -> bool:
    """True inside the recompute of a checkpointed region: write no state."""
    return any(mode == "replay" for mode, _ in _frames())


def layer_state(layer: nn.Module, advance: Callable[[], Any]) -> Any:
    """The state values ``layer`` uses in this call. ``advance()`` computes
    them and writes the layer's state; in a recompute the values of the
    matching forward call are returned instead and nothing is written."""
    frames = _frames()
    source = next((stash for mode, stash in reversed(frames) if mode == "replay"), None)
    value = advance() if source is None else source.saved[id(layer)].popleft()
    for mode, stash in frames:
        if mode == "record":
            stash.saved[id(layer)].append(value)
    return value


def checkpoint(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` under non-reentrant ``torch.utils.checkpoint``,
    with this module's replay of layer state. Pass the tensors ``fn`` reads
    as arguments: their devices are the ones whose RNG state is replayed."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=True,
        context_fn=lambda: _Stash().contexts(), **kwargs)


def checkpoint_module(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` under ``checkpoint``. The recompute runs
    with the parameters this call sees (the bf16 casts of an enclosing
    ``torch.func.functional_call`` included), not the module's own at that
    later time."""
    params = dict(module.named_parameters())
    return checkpoint(lambda *a, **k: torch.func.functional_call(module, params, a, k),
                      *args, **kwargs)
