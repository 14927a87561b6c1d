"""Hinge GAN losses with validity masking (counterpart of
``layout2img_tpu/losses/gan.py``): relu(1 -/+ d).mean() for D on real and
fake, -d.mean() for G. Per-object scores are fixed-shape (b, o) and the
mean runs over the valid objects only, which equals the reference's
filtering of ``label != 0``. Always accumulated in f32."""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    x = x.to(torch.float32)
    if mask is None:
        return x.mean()
    x = x.reshape(mask.shape)
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def hinge_d_real(scores: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return masked_mean(torch.relu(1.0 - scores), mask)


def hinge_d_fake(scores: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return masked_mean(torch.relu(1.0 + scores), mask)


def g_adv(scores: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return -masked_mean(scores, mask)
