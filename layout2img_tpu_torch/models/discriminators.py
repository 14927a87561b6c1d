"""LostGAN-family layout discriminator (counterpart of
``layout2img_tpu/models/discriminators.py``), NCHW, 64, 128 or 256 px.

An SN ResBlock image trunk with a linear image score; an object path that
crops per-object features with RoIAlign into a projection head; and,
with ``app_head``, the Gram-matrix appearance head (the reference's
``ResnetDiscriminator*_app``). Per size, as the reference wires it:

- 128 px: trunk ``block1..6``, score ``l7`` on the summed ReLU features;
  dual-scale RoIAlign (boxes under 64 px from the 1/4-scale map through
  ``block_obj3``, the rest from the 1/8-scale one; ``block_obj4`` runs on
  both, so its spectral norms advance twice per call in training), then
  ``block_obj5``.
- 256 px: trunk ``block1..7``, score ``l8``; dual-scale RoIAlign at 1/8
  (through ``block_obj4``) and 1/16 with threshold 128 px, ``block_obj5``
  shared by both scales, then ``block_obj6``.
- 64 px: trunk ``block1..5`` (``block1`` and ``block2`` keep the size),
  score ``l_im`` on the mean ReLU features; single-scale RoIAlign at 1/2
  on the 32x32 map, then ``block_obj4`` (ch*8 out).

Scores are fixed-shape (b, o): pad objects get scores that the masked
hinge losses ignore, as the JAX package does in place of the reference's
``label != 0`` filtering. ``remat_blocks=N`` checkpoints the first N blocks
of the image trunk that JAX may wrap (1-3 at 64 and 128 px, 1-4 at 256 px;
``nn/remat.py``): their activations, the largest of D, are recomputed in
the backward. The parameters and the state dict are the same. Module names
are the reference's (``rcnn_discriminator_app.py``), so
``utils.convert.discriminator_state_dict_from_jax`` and reference-format
dicts load with ``strict=True``.
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
from layout2img_tpu_torch.ops.roi import dual_scale_roi_align, roi_align

# per size: (trunk blocks as (in, out) channel multipliers of ch, 0 = the
# image, and downsample), the blocks that may be rematerialized, the image
# score's name
_TRUNKS = {
    64: ([(0, 1, False), (1, 2, False), (2, 4, True), (4, 8, True), (8, 16, True)], 3, "l_im"),
    128: ([(0, 1, True), (1, 2, True), (2, 4, True), (4, 8, True), (8, 16, True),
           (16, 16, False)], 3, "l7"),
    256: ([(0, 1, True), (1, 2, True), (2, 4, True), (4, 8, True), (8, 8, True), (8, 16, True),
           (16, 16, False)], 4, "l8"),
}


class LayoutDiscriminator(nn.Module):
    def __init__(self, num_classes: int, image_size: int = 128, ch: int = 64,
                 app_head: bool = False, remat_blocks: int = 0):
        super().__init__()
        if image_size not in _TRUNKS:
            raise ValueError(f"unsupported image_size {image_size}")
        trunk, remat_max, score = _TRUNKS[image_size]
        self.image_size = image_size
        self.ch = ch
        self.app_head = app_head
        self.remat_blocks = min(remat_blocks, remat_max)
        self.score_name = score
        for i, (cin, cout, down) in enumerate(trunk):
            block = (DiscOptimizedBlock(3, ch, downsample=down) if i == 0
                     else DiscResBlock(cin * ch, cout * ch, downsample=down))
            self.add_module(f"block{i + 1}", block)
        self.add_module(score, SNDense(ch * 16, 1))
        if image_size == 128:
            self.block_obj3 = DiscResBlock(ch * 2, ch * 4, downsample=False)
            self.block_obj4 = DiscResBlock(ch * 4, ch * 8, downsample=False)  # both scales
            self.block_obj5 = DiscResBlock(ch * 8, ch * 16, downsample=True)
            crop_ch, obj_ch = ch * 8, ch * 16
        elif image_size == 256:
            self.block_obj4 = DiscResBlock(ch * 4, ch * 8, downsample=False)
            self.block_obj5 = DiscResBlock(ch * 8, ch * 8, downsample=False)  # both scales
            self.block_obj6 = DiscResBlock(ch * 8, ch * 16, downsample=True)
            crop_ch, obj_ch = ch * 8, ch * 16
        else:
            self.block_obj4 = DiscResBlock(ch * 4, ch * 8, downsample=True)
            crop_ch, obj_ch = ch * 4, ch * 8
        self.l_obj = SNDense(obj_ch, 1)
        self.l_y = SNEmbed(num_classes, obj_ch)
        if app_head:
            # its input is the crops, whose width depends on the size
            self.app_conv = DiscResBlock(crop_ch, ch * 8, downsample=False)
            self.l_y_app = SNEmbed(num_classes, ch * 8)
            self.app = SNDense(ch * 16, 1)

    def _trunk(self, images: torch.Tensor) -> list[torch.Tensor]:
        """Every trunk block's output, in order."""
        outs, x = [], images
        i = 1
        while hasattr(self, f"block{i}"):
            block = getattr(self, f"block{i}")
            x = remat.checkpoint_module(block, x) if i <= self.remat_blocks else block(x)
            outs.append(x)
            i += 1
        return outs

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                labels: torch.Tensor) -> dict[str, torch.Tensor]:
        """images (b, 3, s, s) in [-1, 1]; boxes (b, o, 4) xywh in [0, 1];
        labels (b, o), 0 = pad -> {"image": (b, 1), "object": (b, o),
        "valid": (b, o) f32, and with the app head "app": (b, o)}."""
        s = self.image_size
        if images.shape[-1] != s:
            raise ValueError(f"images {tuple(images.shape)} are not {s}px")
        b, o = labels.shape
        boxes_px = xywh_to_xyxy(boxes) * s
        feats = self._trunk(images)
        top = F.relu(feats[-1])
        pooled = top.mean(dim=(2, 3)) if s == 64 else top.sum(dim=(2, 3))
        out = {"image": getattr(self, self.score_name)(pooled),
               "valid": (labels != 0).to(torch.float32)}

        if s == 128:
            obj_s = self.block_obj4(self.block_obj3(feats[1]))  # 32x32, scale 1/4
            obj_l = self.block_obj4(feats[2])  # 16x16, scale 1/8
            crops = dual_scale_roi_align(obj_s, obj_l, boxes_px, 8, 1.0 / 4.0, 1.0 / 8.0, 64.0)
            obj_block = self.block_obj5
        elif s == 256:
            obj_s = self.block_obj5(self.block_obj4(feats[2]))  # 32x32, scale 1/8
            obj_l = self.block_obj5(feats[3])  # 16x16, scale 1/16
            crops = dual_scale_roi_align(obj_s, obj_l, boxes_px, 8, 1.0 / 8.0, 1.0 / 16.0, 128.0)
            obj_block = self.block_obj6
        else:
            crops = roi_align(feats[2], boxes_px, 8, 1.0 / 2.0)  # 32x32, scale 1/2
            obj_block = self.block_obj4
        of = crops.reshape(b * o, *crops.shape[2:])  # objects folded into the batch
        flat_labels = labels.reshape(-1)

        if self.app_head:
            app = F.relu(self.app_conv(of))
            n, c = app.shape[:2]
            appf = app.reshape(n, c, -1)
            gram = appf @ appf.transpose(1, 2) / c  # (n, c, c)
            app_y = self.l_y_app(flat_labels)[:, None, :].expand(n, c, c)
            out_app = self.app(torch.cat([gram, app_y], dim=-1))[..., 0]  # (n, c)
            out["app"] = (out_app.sum(dim=1) / c).reshape(b, o)

        of = F.relu(obj_block(of)).sum(dim=(2, 3))  # (b*o, obj_ch)
        out_obj = self.l_obj(of)[..., 0] + (self.l_y(flat_labels) * of).sum(dim=-1)
        out["object"] = out_obj.reshape(b, o)
        return out


_DISCRIMINATOR_PRESETS: dict[str, dict[str, Any]] = {
    "d64": dict(image_size=64),
    "d128": dict(image_size=128),
    "d128_app": dict(image_size=128, app_head=True),
    "d256": dict(image_size=256),
}
# the layout2im family's discriminators (cli/presets.py): built by their own constructors
_SPECIAL_PRESETS = {"layout2im": "models.layout2im.Layout2ImImageDiscriminator and "
                                 "Layout2ImObjectDiscriminator"}


def make_discriminator(preset: str, num_classes: int, device: str | torch.device | None = None,
                       **overrides) -> LayoutDiscriminator:
    """Build a discriminator with uninitialized weights on ``device``
    (default cuda), in eval mode: ``.train()`` turns on the spectral-norm
    power iterations. Fill it with ``load_state_dict`` or
    ``utils.convert.init_discriminator``."""
    if preset in _SPECIAL_PRESETS:
        raise ValueError(f"preset {preset!r} is a special family's discriminator pair, not a "
                         f"preset of this factory: build it with {_SPECIAL_PRESETS[preset]}")
    if preset not in _DISCRIMINATOR_PRESETS:
        raise ValueError(f"unknown discriminator preset {preset!r}")
    dev = resolve_device(device)
    with torch.device("meta"):
        disc = LayoutDiscriminator(num_classes=num_classes,
                                   **{**_DISCRIMINATOR_PRESETS[preset], **overrides})
    return disc.to_empty(device=dev).eval()
