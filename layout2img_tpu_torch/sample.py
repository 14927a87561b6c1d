"""Generator sampling (counterpart of ``layout2img_tpu/train/step.py::make_sample_fn``).

Truncated-normal latents from an explicit ``torch.Generator``, eval-mode
generator, optional object-budget compaction; ``latents_from_seed`` draws
the latents of an exported artifact from a seed tensor instead. ``dtype=torch.bfloat16``
serves with bf16 weights and latents (``utils.casting.cast_floating``);
boxes stay f32 for coordinate precision either way.
"""

from __future__ import annotations

import math
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


_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64, in two 16-bit
    halves of c so that no product leaves int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer."""
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _truncated_normal_from_seed(seed: torch.Tensor, shape: tuple[int, ...], stream: int,
                                truncation: float) -> torch.Tensor:
    """Standard normal truncated to [-t, t] in f64: 32 hashed bits of
    (seed, stream, index) per element, made uniform, then the normal's
    inverse CDF between Phi(-t) and Phi(t)."""
    salt = (0x9E3779B9 * (stream + 1)) & _M32
    key = _mix32((seed.reshape(()).to(torch.int64) & _M32) ^ salt)
    idx = torch.arange(math.prod(shape), device=seed.device, dtype=torch.int64)
    bits = _mix32(_mix32(idx ^ key) ^ salt)
    u = (bits.to(torch.float64) + 0.5) * 2.0 ** -32
    lo = 0.5 * math.erfc(truncation / math.sqrt(2.0))  # Phi(-t)
    z = torch.special.ndtri(lo + u * (1.0 - 2.0 * lo))
    return z.clamp(-truncation, truncation).reshape(shape)


def latents_from_seed(seed: torch.Tensor, b: int, o: int, z_dim: int = 128,
                      truncation: float = 2.0, dtype: torch.dtype = torch.float32
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z (b, o, z_dim), z_im (b, z_dim)): truncated-normal latents drawn
    from ``seed`` (an integer tensor of one element; its low 32 bits count)
    by a counter-based hash, in traceable tensor ops only, so that an
    exported program draws them inside, as the JAX package's serving
    artifact does (``cli/export.py::serve``). Deterministic per seed, equal
    on the CPU and the card to f64 round-off, returned in ``dtype``. Not
    ``jax.random``'s bits, nor ``make_sample_fn``'s ``torch.Generator``
    draws."""
    z = _truncated_normal_from_seed(seed, (b, o, z_dim), 0, truncation)
    z_im = _truncated_normal_from_seed(seed, (b, z_dim), 1, truncation)
    return z.to(dtype), z_im.to(dtype)


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
