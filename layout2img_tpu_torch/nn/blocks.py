"""Generator and discriminator residual blocks and the PSP context head
(counterpart of ``layout2img_tpu/nn/blocks.py``), NCHW.

``GenResBlock``: (ISLA norm with its ReLU -> nearest 2x -> SNConv) x2 with a
learnable 1x1 shortcut, and an optional per-stage semantic-mask head (a
plain conv stack, or the PSP module). Submodule names are the reference's
(``b1``, ``b2``, ``conv1``, ``conv2``, ``c_sc``, ``conv_mask.*``).
``DiscOptimizedBlock`` and ``DiscResBlock``: the discriminator's SN ResBlocks
with 2x2 average-pool downsampling.

As in the JAX package, the PSP head's Dropout2d is switched by the
``deterministic`` argument (default True, dropout off), not by train/eval.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.nn.norms import SpatialAdaptiveNorm, SyncBatchNorm
from layout2img_tpu_torch.nn.spectral import SNConv
from layout2img_tpu_torch.ops.interp import adaptive_avg_pool2d, resize_bilinear
from layout2img_tpu_torch.parallel import mesh as data_mesh


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

    Its Dropout2d (whole channels, p=0.1) runs when ``deterministic`` is False.
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
        )
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        hw = tuple(x.shape[-2:])
        priors = [resize_bilinear(stage(x), hw, align_corners=True) for stage in self.stages]
        y = self.bottleneck(torch.cat([*priors, x], dim=1))
        return data_mesh.dropout(y, self.dropout_rate, training=not deterministic, feature=True)


class GenResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_w: int, hidden_ch: int | None = None,
                 upsample: bool = True, predict_mask: bool = True, psp_module: bool = False,
                 num_mask_classes: int = 184, parts: int = 1):
        super().__init__()
        h_ch = hidden_ch or out_ch
        self.upsample = upsample
        self.b1 = SpatialAdaptiveNorm(in_ch, num_w, parts)
        self.conv1 = SNConv(in_ch, h_ch, 3)
        self.b2 = SpatialAdaptiveNorm(h_ch, num_w, parts)
        self.conv2 = SNConv(h_ch, out_ch, 3)
        self.c_sc = SNConv(in_ch, out_ch, 1) if (in_ch != out_ch or upsample) else None
        if not predict_mask:
            self.conv_mask = None
        elif psp_module:
            self.conv_mask = nn.ModuleList([PSPModule(out_ch, 100), nn.Conv2d(100, num_mask_classes, 1)])
        else:
            self.conv_mask = nn.Sequential(
                nn.Conv2d(out_ch, 100, 3, padding=1),
                SyncBatchNorm(100),
                nn.ReLU(),
                nn.Conv2d(100, num_mask_classes, 1),
            )

    def forward(self, x: torch.Tensor, vectors: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
        """x (b, in_ch, h, w); vectors (b, o, num_w); mask (b, o, mh, mw), or
        (b, o, P, mh, mw) with P parts.

        Returns the block output and, with a mask head, the per-class stage
        mask logits (b, num_mask_classes, h', w'). ``deterministic=False``
        turns on the PSP head's dropout."""
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
        if self.conv_mask is None:
            return out, None
        if isinstance(self.conv_mask, nn.ModuleList):  # PSP head
            psp, conv = self.conv_mask
            return out, conv(psp(out, deterministic))
        return out, self.conv_mask(out)


class DiscOptimizedBlock(nn.Module):
    """First D block (reference ``rcnn_discriminator_app.py:294-314``)."""

    def __init__(self, in_ch: int, out_ch: int, downsample: bool = True):
        super().__init__()
        self.downsample = downsample
        self.conv1 = SNConv(in_ch, out_ch, 3)
        self.conv2 = SNConv(out_ch, out_ch, 3)
        self.c_sc = SNConv(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(x)))
        sc = x
        if self.downsample:
            y, sc = F.avg_pool2d(y, 2), F.avg_pool2d(x, 2)
        return y + self.c_sc(sc)


class DiscResBlock(nn.Module):
    """Pre-activation D ResBlock (reference ``rcnn_discriminator_app.py:317-344``)."""

    def __init__(self, in_ch: int, out_ch: int, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.conv1 = SNConv(in_ch, out_ch, 3)
        self.conv2 = SNConv(out_ch, out_ch, 3)
        self.c_sc = SNConv(in_ch, out_ch, 1) if (in_ch != out_ch or downsample) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample:
            y = F.avg_pool2d(y, 2)
        sc = x
        if self.c_sc is not None:
            sc = self.c_sc(sc)
            if self.downsample:
                sc = F.avg_pool2d(sc, 2)
        return y + sc
