"""Mask regression: style vector -> 16x16 soft mask -> splat into its box
(counterpart of ``layout2img_tpu/nn/mask_regress.py``).

Objects fold into the batch axis for the convs, as in the reference.
Submodule names are the reference's (``fc``, ``conv1.0``, ``conv2.0``,
``conv3.0``, ``conv3.3``; the v1 trunk's BNs ``conv{1,2,3}.1``).

``MaskRegressNetV2`` (256 channels, InstanceNorm) serves the v2 and
context generators. ``MaskRegressNet`` is the v1 trunk (128 channels,
batch-statistics BN): in training its BNs normalize over all b*o object
slots, pad slots included, as the reference's object-folded batch does, so
slots are coupled; in eval they use their running statistics. With
``num_parts`` P > 1 (the part variant) it returns one layout per part.
"""

from __future__ import annotations

import torch
from torch import nn

from layout2img_tpu_torch.nn.norms import InstanceNorm2d, SyncBatchNorm
from layout2img_tpu_torch.nn.spectral import SNConv, SNDense
from layout2img_tpu_torch.ops.interp import masks_to_layout, resize_bilinear


def _conv_in_relu(ch: int) -> list[nn.Module]:
    return [SNConv(ch, ch, 3), InstanceNorm2d(), nn.ReLU()]


def _conv_bn_relu(ch: int) -> list[nn.Module]:
    return [SNConv(ch, ch, 3), SyncBatchNorm(ch), nn.ReLU()]


class MaskRegressNetV2(nn.Module):
    """256-channel InstanceNorm trunk used by every v2/context generator."""

    def __init__(self, num_w: int, channels: int = 256, mask_size: int = 16, map_size: int = 64):
        super().__init__()
        self.channels = channels
        self.mask_size = mask_size
        self.map_size = map_size
        self.fc = SNDense(num_w, channels * 4 * 4)
        self.conv1 = nn.Sequential(*_conv_in_relu(channels))
        self.conv2 = nn.Sequential(*_conv_in_relu(channels))
        self.conv3 = nn.Sequential(*_conv_in_relu(channels), SNConv(channels, 1, 1), nn.Sigmoid())

    def forward(self, vectors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """vectors (b, o, num_w); boxes (b, o, 4) xywh -> (b, o, map, map)."""
        b, o, _ = vectors.shape
        s = self.mask_size
        x = self.fc(vectors).reshape(b * o, self.channels, 4, 4)
        x = resize_bilinear(self.conv1(x), (8, 8))
        x = resize_bilinear(self.conv2(x), (s, s))
        masks = self.conv3(x).reshape(b, o, s, s)
        return masks_to_layout(boxes, masks, self.map_size)


class MaskRegressNet(nn.Module):
    """128-channel batch-statistics BN trunk of the v1 generators."""

    def __init__(self, num_w: int, channels: int = 128, mask_size: int = 16, map_size: int = 64,
                 num_parts: int = 1):
        super().__init__()
        self.channels = channels
        self.mask_size = mask_size
        self.map_size = map_size
        self.num_parts = num_parts
        self.fc = SNDense(num_w, channels * 4 * 4)
        self.conv1 = nn.Sequential(*_conv_bn_relu(channels))
        self.conv2 = nn.Sequential(*_conv_bn_relu(channels))
        self.conv3 = nn.Sequential(*_conv_bn_relu(channels), SNConv(channels, num_parts, 1),
                                   nn.Sigmoid())

    def forward(self, vectors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """vectors (b, o, num_w); boxes (b, o, 4) xywh -> (b, o, map, map), or
        (b, o, P, map, map) with P > 1 parts."""
        b, o, _ = vectors.shape
        s, parts = self.mask_size, self.num_parts
        x = self.fc(vectors).reshape(b * o, self.channels, 4, 4)
        x = resize_bilinear(self.conv1(x), (8, 8))
        x = resize_bilinear(self.conv2(x), (s, s))
        masks = self.conv3(x).reshape(b, o, parts, s, s)
        if parts == 1:
            return masks_to_layout(boxes, masks[:, :, 0], self.map_size)
        return torch.stack([masks_to_layout(boxes, masks[:, :, p], self.map_size)
                            for p in range(parts)], dim=2)
