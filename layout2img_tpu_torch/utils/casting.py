"""Dtype casting for the train step, the sampler and the bench (counterpart of
``layout2img_tpu/utils/casting.py``).

Only floating parameters are cast. Buffers never are: BN running statistics
and the SN vectors ``weight_u``/``weight_v`` stay f32, as the JAX package's
``{"params": cast_floating(params), **state}`` leaves its state collections.
"""

from __future__ import annotations

import torch
from torch import nn


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating parameters of ``module`` to ``dtype``, in place (the
    sampler's serving weights)."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


def cast_params(module: nn.Module, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """``{name: parameter cast to dtype}`` for every floating parameter, for
    ``torch.func.functional_call``. The module is not changed: the casts are
    autograd ops, so gradients reach the f32 masters through them."""
    return {name: p.to(dtype) for name, p in module.named_parameters() if p.is_floating_point()}
