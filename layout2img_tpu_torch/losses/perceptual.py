"""VGG19 perceptual loss (counterpart of ``layout2img_tpu/losses/perceptual.py``).

torchvision's VGG19 ``features`` up to relu5_1, tapped after relu1_1,
relu2_1, relu3_1, relu4_1 and relu5_1; L1 distance per tap with weights
(1/32, 1/16, 1/8, 1/4, 1). As in the reference, images in [-1, 1] go in
with no ImageNet normalization, and the real image's taps are detached.

The module's names are torchvision's (``features.{i}``), so a torchvision
``vgg19`` features dict cut at index 29 loads into it. No weights are
downloaded: ``utils.convert.init_vgg`` gives seeded random filters (the
JAX package's fallback too), and ``utils.convert.vgg19_state_dict_from_jax``
converts the JAX package's parameters.

``dtype=torch.bfloat16`` runs the conv stack in bf16 (the train step passes
it under mixed precision): the VGG weights and both images are cast, and
each tap's L1 mean still accumulates in f32.

On the 2-D mesh's row shards (spatial mode, ``parallel/mesh.py``) the convs
take halo rows, the 2x2 max pools stay local and each L1 mean is the
model-summed sum over the whole image's count.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from layout2img_tpu_torch.nn.layers import Conv2d
from layout2img_tpu_torch.parallel import mesh as data_mesh
from layout2img_tpu_torch.utils.casting import cast_params

# torchvision vgg19 'features' up to relu5_1 (conv channels; 'M' = 2x2 max pool)
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512]
TAPS = (1, 6, 11, 20, 29)  # indices of relu1_1 .. relu5_1 in ``features``


class VGG19Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        in_ch = 3
        for item in VGG19_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(in_ch, item, 3, padding=1), nn.ReLU()]
                in_ch = item
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (b, 3, h, w) -> the five tapped activations."""
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in TAPS:
                taps.append(x)
        return taps


class VGGLoss(nn.Module):
    """Frozen VGG19 features; ``loss(fake, real)`` is an f32 scalar."""

    WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

    def __init__(self, features: VGG19Features):
        super().__init__()
        self.vgg = features.requires_grad_(False).eval()

    def forward(self, fake: torch.Tensor, real: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """fake, real (b, 3, h, w) in [-1, 1] -> f32 scalar. ``dtype`` casts
        the VGG weights and both images first (None: as they are)."""
        vgg = self.vgg
        if dtype is not None:
            fake, real = fake.to(dtype), real.to(dtype)
            vgg = functools.partial(torch.func.functional_call, self.vgg, cast_params(self.vgg, dtype))
        f_taps = vgg(fake)
        with torch.no_grad():
            r_taps = vgg(real)
        loss = torch.zeros((), dtype=torch.float32, device=fake.device)
        for w, f, r in zip(self.WEIGHTS, f_taps, r_taps):
            loss = loss + w * data_mesh.row_mean((f - r).to(torch.float32).abs())
        return loss
