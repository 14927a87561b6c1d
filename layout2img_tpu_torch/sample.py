"""Generator sampling (counterpart of ``layout2img_tpu/train/step.py::make_sample_fn``).

Truncated-normal latents from an explicit ``torch.Generator``, eval-mode
generator, optional object-budget compaction. ``dtype=torch.bfloat16``
serves with bf16 weights and latents (``utils.casting.cast_floating``);
boxes stay f32 for coordinate precision either way.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from layout2img_tpu_torch.models.generators import obj_budget_error
from layout2img_tpu_torch.utils.casting import cast_floating  # noqa: F401  (re-exported)


def truncated_normal(shape: tuple[int, ...], truncation: float, generator: torch.Generator,
                     device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Standard normal truncated to [-truncation, truncation], drawn on the
    generator's device in f32."""
    z = torch.empty(shape, device=generator.device)
    nn.init.trunc_normal_(z, a=-truncation, b=truncation, generator=generator)
    return z.to(device=device, dtype=dtype)


def make_sample_fn(generator: nn.Module, z_dim: int = 128, truncation: float = 2.0,
                   dtype: torch.dtype = torch.float32, obj_budget: int = 0) -> Callable:
    """``sample(boxes, labels, rng) -> (b, 3, h, w)`` images in [-1, 1].

    ``generator`` already holds its weights in ``dtype`` on its device.
    ``obj_budget > 0`` moves the valid object slots to the front (stable
    argsort) and runs G on the first K only: the same images when K covers
    every valid object, since z keeps its full-width per-slot draws."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sampling dtype must be float32 or bfloat16, got {dtype}")
    why = obj_budget_error(generator) if obj_budget else None
    if why is not None:
        raise ValueError(f"obj_budget is not exact for this generator: {why}")
    generator.eval()
    device = next(generator.parameters()).device

    @torch.inference_mode()
    def sample(boxes: torch.Tensor, labels: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
        b, o = labels.shape
        boxes = boxes.to(device=device, dtype=torch.float32)
        labels = labels.to(device=device, dtype=torch.long)
        z = truncated_normal((b, o, z_dim), truncation, rng, device, dtype)
        z_im = truncated_normal((b, z_dim), truncation, rng, device, dtype)
        if 0 < obj_budget < o:
            order = torch.argsort((labels == 0).to(torch.int32), dim=1, stable=True)[:, :obj_budget]
            labels = labels.gather(1, order)
            boxes = boxes.gather(1, order[:, :, None].expand(-1, -1, 4))
            z = z.gather(1, order[:, :, None].expand(-1, -1, z_dim))
        return generator(z, boxes, labels, z_im)

    return sample
