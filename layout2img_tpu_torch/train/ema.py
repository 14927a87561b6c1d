"""Exponential moving average of the generator's parameters (counterpart of
``layout2img_tpu/train/ema.py``).

Opt-in (``TrainConfig.ema_decay > 0``); it does not change the training
math. The average is a ``{name: tensor}`` dict of f32 copies of the masters,
updated after G's Adam step; under a data-parallel mesh the masters are
stepped with the all-reduced gradients, so every rank's EMA is the same.
Sampling prefers it: ``cli/train.py`` writes it
with the live generator's buffers as ``G_ema.pth``.
"""

from __future__ import annotations

import torch
from torch import nn


def ema_init(module: nn.Module) -> dict[str, torch.Tensor]:
    """Real copies of the parameters: the average never aliases them."""
    return {name: p.detach().clone() for name, p in module.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], module: nn.Module, decay: float = 0.999) -> None:
    """``e = decay * e + (1 - decay) * p`` for each parameter, in place."""
    for name, p in module.named_parameters():
        e = ema[name]
        e.copy_(decay * e + (1.0 - decay) * p.to(e.dtype))
