"""Hinge GAN losses with validity masking (counterpart of
``layout2img_tpu/losses/gan.py``): relu(1 -/+ d).mean() for D on real and
fake, -d.mean() for G. Per-object scores are fixed-shape (b, o) and the
mean runs over the valid objects only, which equals the reference's
filtering of ``label != 0``. Always accumulated in f32.

Under a data-parallel mesh (``parallel/mesh.py``) a masked mean divides by
the global count of valid objects (summed over the ranks, without gradient)
and is scaled by W, so that the ranks' mean of it, which the gradient
all-reduce takes, is the global masked mean. An unmasked mean is the rank's;
the ranks' batches are the same size, so their mean is the global one."""

from __future__ import annotations

import torch

from layout2img_tpu_torch.parallel import mesh as data_mesh


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    x = x.to(torch.float32)
    if mask is None:
        return x.mean()
    x = x.reshape(mask.shape)
    mesh = data_mesh.current()
    if mesh.world == 1:
        return (x * mask).sum() / mask.sum().clamp_min(1.0)
    count = mesh.sum_detached(mask.sum().to(torch.float32)).clamp_min(1.0)
    return (x * mask).sum() * mesh.world / count


def hinge_d_real(scores: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return masked_mean(torch.relu(1.0 - scores), mask)


def hinge_d_fake(scores: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return masked_mean(torch.relu(1.0 + scores), mask)


def g_adv(scores: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return -masked_mean(scores, mask)
