"""LostGAN-family layout discriminator (counterpart of
``layout2img_tpu/models/discriminators.py``), NCHW, 128 px.

An SN ResBlock image trunk with a linear image score; an object path that
crops per-object features with dual-scale RoIAlign (boxes under 64 px from
the 1/4-scale map, the rest from the 1/8-scale one; ``block_obj4`` runs on
both, so its spectral norms advance twice per call in training) into a
projection head; and the Gram-matrix appearance head (the reference's
``ResnetDiscriminator128_app``).
Scores are fixed-shape (b, o): pad objects get scores that the masked
hinge losses ignore, as the JAX package does in place of the reference's
``label != 0`` filtering. ``remat_blocks=N`` checkpoints the first N blocks
of the image trunk (``nn/remat.py``; the JAX D's ``remat_blocks``): their
activations, the largest of D, are recomputed in the backward. The
parameters and the state dict are the same. Module names are the reference's
(``rcnn_discriminator_app.py``), so ``utils.convert.discriminator_state_dict_from_jax``
and reference-format dicts load with ``strict=True``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.nn import remat
from layout2img_tpu_torch.nn.blocks import DiscOptimizedBlock, DiscResBlock
from layout2img_tpu_torch.nn.spectral import SNDense, SNEmbed
from layout2img_tpu_torch.ops.bbox import xywh_to_xyxy
from layout2img_tpu_torch.ops.roi import dual_scale_roi_align

_ROADMAP_SIZES = "ROADMAP.md §1 'Slices still to port', item 2 (64 and 256px generators and D)"
_ROADMAP_NO_APP = "ROADMAP.md §1 'Slices still to port', item 2 (the app-less D of the remaining presets)"


class LayoutDiscriminator(nn.Module):
    def __init__(self, num_classes: int, image_size: int = 128, ch: int = 64,
                 remat_blocks: int = 0):
        super().__init__()
        if image_size != 128:
            raise NotImplementedError(f"only the 128px discriminator is ported; {image_size}px "
                                      f"waits for {_ROADMAP_SIZES}")
        self.image_size = image_size
        self.ch = ch
        self.remat_blocks = remat_blocks
        self.block1 = DiscOptimizedBlock(3, ch, downsample=True)  # 64
        self.block2 = DiscResBlock(ch, ch * 2, downsample=True)  # 32: the 1/4 map
        self.block3 = DiscResBlock(ch * 2, ch * 4, downsample=True)  # 16: the 1/8 map
        self.block4 = DiscResBlock(ch * 4, ch * 8, downsample=True)  # 8
        self.block5 = DiscResBlock(ch * 8, ch * 16, downsample=True)  # 4
        self.block6 = DiscResBlock(ch * 16, ch * 16, downsample=False)
        self.l7 = SNDense(ch * 16, 1)
        self.block_obj3 = DiscResBlock(ch * 2, ch * 4, downsample=False)
        self.block_obj4 = DiscResBlock(ch * 4, ch * 8, downsample=False)  # shared by both scales
        self.block_obj5 = DiscResBlock(ch * 8, ch * 16, downsample=True)
        self.l_obj = SNDense(ch * 16, 1)
        self.l_y = SNEmbed(num_classes, ch * 16)
        self.app_conv = DiscResBlock(ch * 8, ch * 8, downsample=False)
        self.l_y_app = SNEmbed(num_classes, ch * 8)
        self.app = SNDense(ch * 16, 1)

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                labels: torch.Tensor) -> dict[str, torch.Tensor]:
        """images (b, 3, s, s) in [-1, 1]; boxes (b, o, 4) xywh in [0, 1];
        labels (b, o), 0 = pad -> {"image": (b, 1), "object": (b, o),
        "app": (b, o), "valid": (b, o) f32}."""
        s = self.image_size
        if images.shape[-1] != s:
            raise ValueError(f"images {tuple(images.shape)} are not {s}px")
        b, o = labels.shape
        boxes_px = xywh_to_xyxy(boxes) * s

        def trunk(i: int, x: torch.Tensor) -> torch.Tensor:
            block = getattr(self, f"block{i}")
            return remat.checkpoint_module(block, x) if i <= self.remat_blocks else block(x)

        x = trunk(1, images)
        x1 = trunk(2, x)
        x2 = trunk(3, x1)
        x = self.block6(self.block5(self.block4(x2)))
        out = {"image": self.l7(F.relu(x).sum(dim=(2, 3))),
               "valid": (labels != 0).to(torch.float32)}

        obj_s = self.block_obj4(self.block_obj3(x1))
        obj_l = self.block_obj4(x2)
        crops = dual_scale_roi_align(obj_s, obj_l, boxes_px, 8, 1.0 / 4.0, 1.0 / 8.0, 64.0)
        of = crops.reshape(b * o, *crops.shape[2:])  # objects folded into the batch
        flat_labels = labels.reshape(-1)

        app = F.relu(self.app_conv(of))
        n, c = app.shape[:2]
        appf = app.reshape(n, c, -1)
        gram = appf @ appf.transpose(1, 2) / c  # (n, c, c)
        app_y = self.l_y_app(flat_labels)[:, None, :].expand(n, c, c)
        out_app = self.app(torch.cat([gram, app_y], dim=-1))[..., 0]  # (n, c)
        out["app"] = (out_app.sum(dim=1) / c).reshape(b, o)

        of = F.relu(self.block_obj5(of)).sum(dim=(2, 3))  # (b*o, 16 ch)
        out_obj = self.l_obj(of)[..., 0] + (self.l_y(flat_labels) * of).sum(dim=-1)
        out["object"] = out_obj.reshape(b, o)
        return out


_DISCRIMINATOR_PRESETS: dict[str, dict[str, Any] | str] = {
    "d128_app": dict(image_size=128),
    # not ported yet: the ROADMAP item that brings each
    "d128": _ROADMAP_NO_APP, "d64": _ROADMAP_SIZES, "d256": _ROADMAP_SIZES,
}


def make_discriminator(preset: str, num_classes: int, device: str | torch.device | None = None,
                       **overrides) -> LayoutDiscriminator:
    """Build a discriminator with uninitialized weights on ``device``
    (default cuda), in eval mode: ``.train()`` turns on the spectral-norm
    power iterations. Fill it with ``load_state_dict`` or
    ``utils.convert.init_discriminator``."""
    if preset not in _DISCRIMINATOR_PRESETS:
        raise ValueError(f"unknown discriminator preset {preset!r}")
    cfg = _DISCRIMINATOR_PRESETS[preset]
    if isinstance(cfg, str):
        raise NotImplementedError(f"preset {preset!r} is not ported yet: {cfg}")
    dev = resolve_device(device)
    with torch.device("meta"):
        disc = LayoutDiscriminator(num_classes=num_classes, **{**cfg, **overrides})
    return disc.to_empty(device=dev).eval()
