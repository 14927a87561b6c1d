"""LostGAN-family generator (counterpart of ``layout2img_tpu/models/generators.py``).

This slice ports the Ours-D path (``stage_masks=True, context="attention",
mask_trunk="v2"``): label embedding, box-geometric context attention, v2
mask regression splatted into the boxes, then upsampling ``GenResBlock``s
whose ISLA norms modulate with alpha-gated stage masks (a PSP mask head on
the penultimate block at 128 px), and a BN-relu-SNConv-tanh RGB head.

Images are NCHW, (b, 3, h, w); masks (b, o, h, w); vectors (b, o, d).
The JAX call's ``train`` flag is the module's mode here: ``.train()`` runs
the batch-statistics BNs and the spectral-norm power iterations, ``.eval()``
the running statistics. Its ``deterministic`` flag is the forward's
argument of that name (False turns on the PSP head's dropout).
Module names are the reference state-dict names, so a dict written by
``layout2img_tpu.cli.export_torch`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.nn.attention import BoxMultiHeadedAttention
from layout2img_tpu_torch.nn.blocks import GenResBlock
from layout2img_tpu_torch.nn.mask_regress import MaskRegressNetV2
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


_ROADMAP_PRESETS = "ROADMAP.md §1 'Slices still to port', item 2 (remaining LostGAN presets)"


class LostGANGenerator(nn.Module):
    def __init__(self, num_classes: int, image_size: int = 128, ch: int = 64, z_dim: int = 128,
                 emb_dim: int = 180, output_dim: int = 3, context: str = "attention",
                 use_geometry: bool = True, stage_masks: bool = True, mask_trunk: str = "v2",
                 num_mask_classes: int = 184, map_size: int = 64, hard_mask_size: int = 0,
                 rgb_head: bool = True, parts: int = 1, legacy_attention: bool = False):
        super().__init__()
        if not (context == "attention" and stage_masks and mask_trunk == "v2"
                and rgb_head and parts == 1):
            raise NotImplementedError(
                "only the Ours-D path (context='attention', stage_masks=True, mask_trunk='v2', "
                f"rgb_head=True, parts=1) is ported; the others wait for {_ROADMAP_PRESETS}")
        if num_classes > num_mask_classes:
            raise ValueError(f"num_classes {num_classes} exceeds num_mask_classes "
                             f"{num_mask_classes}: stage masks are picked by label")
        self.image_size = image_size
        self.ch = ch
        self.z_dim = z_dim
        self.num_mask_classes = num_mask_classes
        self.hard_mask_size = hard_mask_size or map_size
        self.legacy_attention = legacy_attention
        num_w = z_dim + emb_dim

        self.label_embedding = nn.Embedding(num_classes, emb_dim)
        self.context = BoxMultiHeadedAttention(1, num_w, use_geometry=use_geometry,
                                               legacy_view=legacy_attention)
        self.mask_regress = MaskRegressNetV2(num_w, map_size=map_size)
        self.fc = SNDense(z_dim, 4 * 4 * 16 * ch)

        in_mults, out_mults = _channel_schedule(image_size)
        n_blocks = len(out_mults)
        self.n_blocks = n_blocks
        for i, (in_mult, out_mult) in enumerate(zip(in_mults, out_mults)):
            is_last = i == n_blocks - 1
            # PSP head on the penultimate block at 128 px (reference
            # resnet_generator_app_v2.py:414); plain conv heads otherwise
            psp = image_size == 128 and i == n_blocks - 2
            self.add_module(f"res{i + 1}", GenResBlock(
                in_mult * ch, out_mult * ch, num_w, upsample=True, predict_mask=not is_last,
                psp_module=psp, num_mask_classes=num_mask_classes))
            if not is_last:
                self.register_parameter(f"alpha{i + 1}",
                                        nn.Parameter(torch.zeros(1, num_mask_classes, 1)))
        self.final = nn.Sequential(SyncBatchNorm(ch), nn.ReLU(), SNConv(ch, output_dim, 3), nn.Tanh())

    def forward(self, z: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
                z_im: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """z (b, o, z_dim); boxes (b, o, 4) xywh in [0, 1]; labels (b, o), 0 = pad;
        z_im (b, z_dim) -> images (b, 3, h, w) in [-1, 1]."""
        b = z.shape[0]
        w = torch.cat([z, self.label_embedding(labels).to(z.dtype)], dim=-1)  # (b, o, num_w)
        w = self.context(w, w, w, boxes, labels)
        bmask = self.mask_regress(w, boxes)  # (b, o, map, map)

        x = self.fc(z_im).reshape(b, 16 * self.ch, 4, 4)
        hs = self.hard_mask_size
        # masks in the compute dtype: f32 boxes would otherwise promote the
        # whole modulation path under bf16
        hard = bbox_mask(boxes, hs, hs).to(x.dtype)
        stage_bbox = bmask.to(x.dtype)
        for i in range(self.n_blocks):
            x, smask = getattr(self, f"res{i + 1}")(x, w, stage_bbox, deterministic)
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
        return self.final(x)


_GENERATOR_PRESETS: dict[str, dict[str, Any] | None] = {
    "ours_d_context128": dict(image_size=128, stage_masks=True, context="attention"),
    # not ported yet (see _ROADMAP_PRESETS)
    "lostgan128": None, "lostgan64": None, "ours_d_base128": None, "context128": None,
    "context128_nogeo": None, "graph128": None, "context128_part": None, "ours_d_base256": None,
}


def obj_budget_error(gen: LostGANGenerator) -> str | None:
    """Why compacting the object axis would NOT give the same image, or None.

    The v2 trunk keeps slots independent; the legacy attention scramble
    mixes the slot/channel layout."""
    if gen.legacy_attention:
        return ("legacy_attention's concat scramble mixes the slot/channel "
                "layout — compaction would change the image")
    return None


def make_generator(preset: str, num_classes: int, device: str | torch.device | None = None,
                   **overrides) -> LostGANGenerator:
    """Build a generator with uninitialized weights on ``device`` (default
    cuda). Fill it with ``load_state_dict`` or ``utils.convert.init_generator``."""
    if preset not in _GENERATOR_PRESETS:
        raise ValueError(f"unknown generator preset {preset!r}")
    cfg = _GENERATOR_PRESETS[preset]
    if cfg is None:
        raise NotImplementedError(f"preset {preset!r} is not ported yet: {_ROADMAP_PRESETS}")
    dev = resolve_device(device)
    with torch.device("meta"):
        gen = LostGANGenerator(num_classes=num_classes, **{**cfg, **overrides})
    return gen.to_empty(device=dev).eval()
