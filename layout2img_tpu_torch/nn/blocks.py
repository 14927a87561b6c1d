"""Generator residual block and the PSP context head (counterpart of
``layout2img_tpu/nn/blocks.py``), NCHW.

``GenResBlock``: (ISLA norm with its ReLU -> nearest 2x -> SNConv) x2 with a
learnable 1x1 shortcut, and an optional per-stage semantic-mask head (a
plain conv stack, or the PSP module). Submodule names are the reference's
(``b1``, ``b2``, ``conv1``, ``conv2``, ``c_sc``, ``conv_mask.*``).
The discriminator blocks wait for the training path.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.nn.norms import SpatialAdaptiveNorm, SyncBatchNorm
from layout2img_tpu_torch.nn.spectral import SNConv
from layout2img_tpu_torch.ops.interp import adaptive_avg_pool2d, resize_bilinear


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NCHW (== F.interpolate(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class AdaptiveAvgPool(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool2d(x, (self.size, self.size))


class PSPModule(nn.Module):
    """Pyramid scene parsing head (reference ``resnet_generator_app_v2.py:724-752``).

    Dropout2d is inactive in eval, as in the sampler.
    """

    def __init__(self, in_features: int, out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6), dropout_rate: float = 0.1):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(
                AdaptiveAvgPool(s),
                nn.Conv2d(in_features, out_features, 1, bias=False),
                SyncBatchNorm(out_features),
                nn.ReLU(),
            )
            for s in sizes
        )
        self.bottleneck = nn.Sequential(
            nn.Conv2d(in_features + len(sizes) * out_features, out_features, 3, padding=1, bias=False),
            SyncBatchNorm(out_features),
            nn.ReLU(),
            nn.Dropout2d(dropout_rate),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[-2:])
        priors = [resize_bilinear(stage(x), hw, align_corners=True) for stage in self.stages]
        return self.bottleneck(torch.cat([*priors, x], dim=1))


class GenResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_w: int, hidden_ch: int | None = None,
                 upsample: bool = True, predict_mask: bool = True, psp_module: bool = False,
                 num_mask_classes: int = 184):
        super().__init__()
        h_ch = hidden_ch or out_ch
        self.upsample = upsample
        self.b1 = SpatialAdaptiveNorm(in_ch, num_w)
        self.conv1 = SNConv(in_ch, h_ch, 3)
        self.b2 = SpatialAdaptiveNorm(h_ch, num_w)
        self.conv2 = SNConv(h_ch, out_ch, 3)
        self.c_sc = SNConv(in_ch, out_ch, 1) if (in_ch != out_ch or upsample) else None
        if not predict_mask:
            self.conv_mask = None
        elif psp_module:
            self.conv_mask = nn.Sequential(
                PSPModule(out_ch, 100), nn.Conv2d(100, num_mask_classes, 1))
        else:
            self.conv_mask = nn.Sequential(
                nn.Conv2d(out_ch, 100, 3, padding=1),
                SyncBatchNorm(100),
                nn.ReLU(),
                nn.Conv2d(100, num_mask_classes, 1),
            )

    def forward(self, x: torch.Tensor, vectors: torch.Tensor,
                mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """x (b, in_ch, h, w); vectors (b, o, num_w); mask (b, o, mh, mw).

        Returns the block output and, with a mask head, the per-class stage
        mask logits (b, num_mask_classes, h', w')."""
        y = self.b1(x, vectors, mask, relu=True)
        if self.upsample:
            y = upsample2x_nearest(y)
        y = self.conv1(y)
        y = self.b2(y, vectors, mask, relu=True)
        y = self.conv2(y)

        sc = x
        if self.c_sc is not None:
            if self.upsample:
                sc = upsample2x_nearest(sc)
            sc = self.c_sc(sc)
        out = y + sc
        stage_mask = None if self.conv_mask is None else self.conv_mask(out)
        return out, stage_mask
