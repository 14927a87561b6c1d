"""LostGAN-family generator (counterpart of ``layout2img_tpu/models/generators.py``).

One configurable module covers the family's nine presets
(``_GENERATOR_PRESETS``, the JAX package's): the label embedding; a context
over the per-object style vectors (none, box-geometric attention with or
without its geometry term, or the GCN); mask regression (the v2
InstanceNorm trunk, or the v1 BN trunk, optionally with 3 part masks)
splatted into the boxes; then upsampling ``GenResBlock``s whose ISLA norms
modulate with either alpha-gated per-stage masks (``stage_masks``: each
block but the last predicts per-class masks for the next, with a PSP head
on the penultimate block at 128 px) or the one regressed layout in every
block; and a BN-relu-SNConv-tanh RGB head.

Images are NCHW, (b, 3, h, w); masks (b, o, h, w), or (b, o, P, h, w)
with parts; vectors (b, o, d). The JAX call's ``train`` flag is the
module's mode here: ``.train()`` runs the batch-statistics BNs and the
spectral-norm power iterations, ``.eval()`` the running statistics. Its
``deterministic`` flag is the forward's argument of that name (False turns
on the PSP head's and the GCN's dropout). Module names are the reference
state-dict names, so a dict written by ``layout2img_tpu.cli.export_torch``
loads with ``strict=True``; the 64px generator names its blocks
``res2..res5`` as the reference does (the exporter's ``res_start=2``).
``rgb_head=False`` is the feature-only variant: the last block's features,
without the RGB head.

``BgFgGenerator`` is the Ours-ED two-stream generator: two feature-only 64px
v1 generators, one over the foreground classes and one over the background
classes, their features concatenated ``[bg, fg]``, a ``CombineResBlock`` and
the BN-relu-SNConv-tanh head (reference ``resnet_generator_v1.py:358-380``,
``background_foreground_generator``; its state dict is the one
``layout2img_tpu.utils.torch_export.export_bgfg_generator`` writes).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.nn.attention import BoxMultiHeadedAttention
from layout2img_tpu_torch.nn.blocks import GenResBlock
from layout2img_tpu_torch.nn.gcn import GraphFunc
from layout2img_tpu_torch.nn.mask_regress import MaskRegressNet, MaskRegressNetV2
from layout2img_tpu_torch.nn.norms import SyncBatchNorm
from layout2img_tpu_torch.nn.spectral import SNConv, SNDense
from layout2img_tpu_torch.ops.bbox import bbox_mask
from layout2img_tpu_torch.ops.interp import resize_bilinear, resize_nearest


def _channel_schedule(image_size: int) -> tuple[list[int], list[int]]:
    """(in_mults, out_mults) of the upsampling ResBlock stack."""
    mult = {64: [16, 8, 4, 2, 1], 128: [16, 16, 8, 4, 2, 1],
            256: [16, 16, 8, 8, 4, 2, 1]}.get(image_size)
    if mult is None:
        raise ValueError(f"unsupported image_size {image_size}")
    return mult[:-1], mult[1:]


class LostGANGenerator(nn.Module):
    def __init__(self, num_classes: int, image_size: int = 128, ch: int = 64, z_dim: int = 128,
                 emb_dim: int = 180, output_dim: int = 3, context: str = "none",
                 use_geometry: bool = True, stage_masks: bool = False, mask_trunk: str = "v2",
                 num_mask_classes: int = 184, map_size: int = 64, hard_mask_size: int = 0,
                 rgb_head: bool = True, parts: int = 1, legacy_attention: bool = False):
        super().__init__()
        if context not in ("none", "attention", "graph"):
            raise ValueError(f"unknown context {context!r}")
        if mask_trunk not in ("v1", "v2"):
            raise ValueError(f"unknown mask_trunk {mask_trunk!r}")
        if parts != 1 and (mask_trunk != "v1" or stage_masks):
            raise ValueError("part masks use the v1 trunk without stage masks")
        if stage_masks and num_classes > num_mask_classes:
            raise ValueError(f"num_classes {num_classes} exceeds num_mask_classes "
                             f"{num_mask_classes}: stage masks are picked by label")
        self.image_size = image_size
        self.ch = ch
        self.z_dim = z_dim
        self.stage_masks = stage_masks
        self.mask_trunk = mask_trunk
        self.parts = parts
        self.num_mask_classes = num_mask_classes
        self.hard_mask_size = hard_mask_size or map_size
        self.legacy_attention = legacy_attention
        num_w = z_dim + emb_dim

        self.label_embedding = nn.Embedding(num_classes, emb_dim)
        if context == "attention":
            self.context = BoxMultiHeadedAttention(1, num_w, use_geometry=use_geometry,
                                                   legacy_view=legacy_attention)
        elif context == "graph":
            self.context = GraphFunc(num_w)
        else:
            self.context = None
        if mask_trunk == "v2":
            self.mask_regress = MaskRegressNetV2(num_w, map_size=map_size)
        else:
            self.mask_regress = MaskRegressNet(num_w, map_size=map_size, num_parts=parts)
        self.fc = SNDense(z_dim, 4 * 4 * 16 * ch)

        in_mults, out_mults = _channel_schedule(image_size)
        self.n_blocks = len(out_mults)
        # the reference's 64px generator numbers its blocks from 2
        self.res_start = 2 if image_size == 64 else 1
        for i, (in_mult, out_mult) in enumerate(zip(in_mults, out_mults)):
            predict = stage_masks and i < self.n_blocks - 1
            # PSP head on the penultimate block at 128 px (reference
            # resnet_generator_app_v2.py:414); plain conv heads otherwise
            psp = image_size == 128 and i == self.n_blocks - 2
            self.add_module(self._block(i), GenResBlock(
                in_mult * ch, out_mult * ch, num_w, upsample=True, predict_mask=predict,
                psp_module=psp, num_mask_classes=num_mask_classes, parts=parts))
            if predict:
                self.register_parameter(f"alpha{i + 1}",
                                        nn.Parameter(torch.zeros(1, num_mask_classes, 1)))
        self.final = (nn.Sequential(SyncBatchNorm(ch), nn.ReLU(), SNConv(ch, output_dim, 3), nn.Tanh())
                      if rgb_head else None)

    def _block(self, i: int) -> str:
        return f"res{self.res_start + i}"

    @property
    def isla_calls(self) -> int:
        """ISLA norm calls (kernel launches on the card) per forward: two per
        block, one per part each."""
        return 2 * self.n_blocks * self.parts

    def forward(self, z: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
                z_im: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """z (b, o, z_dim); boxes (b, o, 4) xywh in [0, 1]; labels (b, o), 0 = pad;
        z_im (b, z_dim) -> images (b, 3, h, w) in [-1, 1], or without the RGB
        head the features (b, ch, h, w)."""
        b = z.shape[0]
        w = torch.cat([z, self.label_embedding(labels).to(z.dtype)], dim=-1)  # (b, o, num_w)
        if isinstance(self.context, GraphFunc):
            w = self.context(w, labels, deterministic)
        elif self.context is not None:
            w = self.context(w, w, w, boxes, labels)
        bmask = self.mask_regress(w, boxes)  # (b, o, map, map) or (b, o, P, map, map)

        x = self.fc(z_im).reshape(b, 16 * self.ch, 4, 4)
        if not self.stage_masks:
            layout = bmask.to(x.dtype)
            for i in range(self.n_blocks):
                x, _ = getattr(self, self._block(i))(x, w, layout, deterministic)
            return x if self.final is None else self.final(x)

        hs = self.hard_mask_size
        # masks in the compute dtype: f32 boxes would otherwise promote the
        # whole modulation path under bf16
        hard = bbox_mask(boxes, hs, hs).to(x.dtype)
        stage_bbox = bmask.to(x.dtype)
        for i in range(self.n_blocks):
            x, smask = getattr(self, self._block(i))(x, w, stage_bbox, deterministic)
            if smask is None:
                continue
            hh, ww = x.shape[-2:]
            o = labels.shape[1]
            # each object's predicted mask at its own class
            idx = labels[:, :, None, None].expand(b, o, hh, ww)
            seman = torch.sigmoid(smask.gather(1, idx)) * resize_nearest(hard, (hh, ww))
            alpha_full = getattr(self, f"alpha{i + 1}").reshape(-1)
            alpha = torch.sigmoid(alpha_full)[labels].to(x.dtype)[:, :, None, None]
            stage_bbox = resize_bilinear(bmask, (hh, ww)).to(x.dtype) * (1 - alpha) + seman * alpha
        return x if self.final is None else self.final(x)


class CombineResBlock(nn.Module):
    """The fg/bg fusion block (reference ``ResBlock_1``,
    ``resnet_generator_v1.py:324-347``): BN-relu-conv twice, plus a
    BN-relu-conv3x3 shortcut, with plain convs that have biases. As in the
    reference, ``conv1`` and ``conv2`` are also ``model.2`` and ``model.5``,
    so the state dict holds each of them under both names."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.model = nn.Sequential(SyncBatchNorm(in_ch), nn.ReLU(), self.conv1,
                                   SyncBatchNorm(out_ch), nn.ReLU(), self.conv2)
        self.bn = SyncBatchNorm(in_ch)
        self.conv3 = nn.Conv2d(in_ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x) + self.conv3(torch.relu(self.bn(x)))


class BgFgGenerator(nn.Module):
    """Ours-ED, the two-stream foreground/background generator (64 px)."""

    def __init__(self, num_fg_classes: int, num_bg_classes: int, image_size: int = 64,
                 ch: int = 64, z_dim: int = 128, output_dim: int = 3, context: str = "none"):
        super().__init__()
        self.z_dim = z_dim
        self.image_size = image_size
        stream = dict(image_size=image_size, ch=ch, z_dim=z_dim, emb_dim=128, mask_trunk="v1",
                      context=context, rgb_head=False)
        self.background_g = LostGANGenerator(num_bg_classes, **stream)
        self.foreground_g = LostGANGenerator(num_fg_classes, **stream)
        self.combination = CombineResBlock(2 * ch, ch)
        self.final = nn.Sequential(SyncBatchNorm(ch), nn.ReLU(), SNConv(ch, output_dim, 3), nn.Tanh())

    @property
    def isla_calls(self) -> int:
        """ISLA norm calls per forward, both streams."""
        return self.background_g.isla_calls + self.foreground_g.isla_calls

    def forward(self, z_fg: torch.Tensor, boxes_fg: torch.Tensor, labels_fg: torch.Tensor,
                z_bg: torch.Tensor, boxes_bg: torch.Tensor, labels_bg: torch.Tensor,
                z_im_fg: torch.Tensor, z_im_bg: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        """Each stream's z (b, o, z_dim), boxes (b, o, 4), labels (b, o) and
        z_im (b, z_dim), the labels in the stream's own classes (0 = pad) ->
        images (b, 3, h, w) in [-1, 1]."""
        fg = self.foreground_g(z_fg, boxes_fg, labels_fg, z_im_fg, deterministic)
        bg = self.background_g(z_bg, boxes_bg, labels_bg, z_im_bg, deterministic)
        return self.final(self.combination(torch.cat([bg, fg], dim=1)))


_GENERATOR_PRESETS: dict[str, dict[str, Any]] = {
    # train_lostGan.py (resnet_generator_v1_orig.py baseline)
    "lostgan128": dict(image_size=128, mask_trunk="v1"),
    "lostgan64": dict(image_size=64, emb_dim=128, mask_trunk="v1"),
    # train_ours_d.py / train_app.py ("apponly": v2 + stage masks)
    "ours_d_base128": dict(image_size=128, stage_masks=True),
    # train_context_app_v2.py (Ours-D final: context + stage masks)
    "ours_d_context128": dict(image_size=128, stage_masks=True, context="attention"),
    # train_context_app.py (context, no stage masks)
    "context128": dict(image_size=128, context="attention", mask_trunk="v1"),
    # train_context_nogeo.py / train_context_app_nogeo.py
    "context128_nogeo": dict(image_size=128, context="attention", use_geometry=False,
                             mask_trunk="v1"),
    # train_graph_context_app.py
    "graph128": dict(image_size=128, context="graph", mask_trunk="v1"),
    # train_context_part.py (3-part masks, resnet_generator_part.py:722-809)
    "context128_part": dict(image_size=128, context="attention", mask_trunk="v1", parts=3),
    # 256px (resnet_generator_app_v2.py:509): regress canvas 64, occupancy canvas 128
    "ours_d_base256": dict(image_size=256, stage_masks=True, hard_mask_size=128),
}
# the special families' generators (cli/presets.py): built by their own constructors
_SPECIAL_PRESETS = {"bgfg64": "models.generators.BgFgGenerator",
                    "layout2im64": "models.layout2im.Layout2ImGenerator"}


def obj_budget_error(gen: LostGANGenerator) -> str | None:
    """Why compacting the object axis would NOT give the same image, or None.

    The v2 trunk keeps slots independent; the v1 trunk's BN couples them
    through its (b*o) batch statistics; the legacy attention scramble mixes
    the slot/channel layout."""
    if gen.mask_trunk != "v2":
        return ("the v1 mask trunk couples object slots through its (b*o) "
                "BatchNorm statistics — compaction would change the image")
    if gen.legacy_attention:
        return ("legacy_attention's concat scramble mixes the slot/channel "
                "layout — compaction would change the image")
    return None


def make_generator(preset: str, num_classes: int, device: str | torch.device | None = None,
                   **overrides) -> LostGANGenerator:
    """Build a generator with uninitialized weights on ``device`` (default
    cuda). Fill it with ``load_state_dict`` or ``utils.convert.init_generator``."""
    if preset in _SPECIAL_PRESETS:
        raise ValueError(f"preset {preset!r} is a special family's generator, not a preset of "
                         f"this factory: build it with {_SPECIAL_PRESETS[preset]}")
    if preset not in _GENERATOR_PRESETS:
        raise ValueError(f"unknown generator preset {preset!r}")
    dev = resolve_device(device)
    with torch.device("meta"):
        gen = LostGANGenerator(num_classes=num_classes, **{**_GENERATOR_PRESETS[preset], **overrides})
    return gen.to_empty(device=dev).eval()
