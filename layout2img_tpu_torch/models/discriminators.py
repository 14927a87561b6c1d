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

In the 2-D mesh's spatial mode (``parallel/mesh.py``), called on row shards
of the images (inside the train step), each trunk block whose input splits
(``splits_rows``) runs on this rank's rows, and so do the object blocks
before the crops; the image score's spatial sum is model-summed and RoIAlign
sums the ranks' partial crops. The crops and everything after them are whole
on every rank.

The object path, from its first block through RoIAlign and the object and
app scores, is the span ``d.objects`` (``utils/tracing.py``).
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
from layout2img_tpu_torch.parallel import mesh as data_mesh
from layout2img_tpu_torch.utils import tracing

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

    @property
    def pool_sites(self) -> int:
        """2x2 pool calls (``ops/pool.py::pool2x2_add``, kernel launches on the
        card) per forward: two in a downsampling first block, one in each other
        downsampling block (each runs once a forward)."""
        return sum(getattr(m, "pool_sites", 0) for m in self.children())

    def _trunk(self, images: torch.Tensor, rows: bool) -> tuple[list[torch.Tensor], list[bool]]:
        """Every trunk block's output, in order, and whether each is a row
        shard (``rows``: the images are)."""
        outs, sharded, x, x_rows, h = [], [], images, rows, self.image_size
        i = 1
        while hasattr(self, f"block{i}"):
            block = getattr(self, f"block{i}")
            split = rows and data_mesh.splits_rows(h)
            x, x_rows = data_mesh.reshard_rows(x, x_rows, split), split
            with data_mesh.row_shards(split):
                x = remat.checkpoint_module(block, x) if i <= self.remat_blocks else block(x)
            outs.append(x)
            sharded.append(split)
            h = h // 2 if block.downsample else h
            i += 1
        return outs, sharded

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
        feats, sharded = self._trunk(images, data_mesh.rows_sharded())

        def on_rows(i: int, *blocks: nn.Module) -> torch.Tensor:
            """``blocks`` in turn on trunk output i, on its rows if it is a shard."""
            x = feats[i]
            with data_mesh.row_shards(sharded[i]):
                for block in blocks:
                    x = block(x)
            return x

        with data_mesh.row_shards(False):
            top = F.relu(feats[-1])
            if sharded[-1]:
                pooled = data_mesh.model_sum(top.sum(dim=(2, 3)))
                if s == 64:
                    pooled = pooled / (top.shape[-2] * data_mesh.current().model * top.shape[-1])
            else:
                pooled = top.mean(dim=(2, 3)) if s == 64 else top.sum(dim=(2, 3))
            out = {"image": getattr(self, self.score_name)(pooled),
                   "valid": (labels != 0).to(torch.float32)}

        with data_mesh.row_shards(False), tracing.span("d.objects"):
            if s == 128:
                obj_s = on_rows(1, self.block_obj3, self.block_obj4)  # 32x32, scale 1/4
                obj_l = on_rows(2, self.block_obj4)  # 16x16, scale 1/8
                crops = dual_scale_roi_align(obj_s, obj_l, boxes_px, 8, 1.0 / 4.0, 1.0 / 8.0, 64.0,
                                             (sharded[1], sharded[2]))
                obj_block = self.block_obj5
            elif s == 256:
                obj_s = on_rows(2, self.block_obj4, self.block_obj5)  # 32x32, scale 1/8
                obj_l = on_rows(3, self.block_obj5)  # 16x16, scale 1/16
                crops = dual_scale_roi_align(obj_s, obj_l, boxes_px, 8, 1.0 / 8.0, 1.0 / 16.0,
                                             128.0, (sharded[2], sharded[3]))
                obj_block = self.block_obj6
            else:
                crops = roi_align(feats[2], boxes_px, 8, 1.0 / 2.0, sharded[2])  # 32x32, 1/2
                obj_block = self.block_obj4
            return self._objects(crops, labels, obj_block, out)

    def _objects(self, crops: torch.Tensor, labels: torch.Tensor, obj_block: nn.Module,
                 out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The object and app scores of the crops (b, o, c, 8, 8), into ``out``."""
        b, o = labels.shape
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
