"""LPIPS perceptual diversity (counterpart of ``layout2img_tpu/eval/lpips.py``).

The reference measures sample diversity with the ``lpips`` package
(AlexNet backbone, ``test_lpips.py:22-41``); this is the same computation
on NCHW tensors: AlexNet features at relu1-5, unit-normalized over the
channels, squared difference, learned per-channel linear weights, spatial
mean, sum over the five layers.

``AlexNetFeatures.features`` has torchvision ``alexnet``'s layers and
indices, so its convs are ``features.{0,3,6,8,10}``; the five linear heads
are the buffers ``lin0..lin4`` (c,). ``load_torch_lpips`` reads the three
checkpoint layouts the JAX loader reads. Without weights the fallback is
fixed-seed random filters (lecun-normal conv kernels, zero biases) with
uniform heads ``1/c``: a relative diversity measure only, and, drawn from a
``torch.Generator``, not the JAX package's random bits.
"""

from __future__ import annotations

import torch
from torch import nn

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.eval.inception import empty_module, lecun_normal_

_SHIFT = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
_SCALE = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)
ALEX_CHANNELS = (64, 192, 384, 256, 256)
ALEX_CONV_INDEX = (0, 3, 6, 8, 10)  # the convs' positions in torchvision alexnet.features


class AlexNetFeatures(nn.Module):
    """(b, 3, h, w) -> the five relu taps."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())

    def forward(self, x):
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i - 1 in ALEX_CONV_INDEX:  # the ReLU after each conv
                taps.append(x)
        return taps


class LPIPS(nn.Module):
    """``lpips(a, b)`` -> (b,) distances of (b, 3, h, w) images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, c in enumerate(ALEX_CHANNELS):
            self.register_buffer(f"lin{i}", torch.full((c,), 1.0 / c))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        shift, scale = _SHIFT.to(a.device, a.dtype), _SCALE.to(a.device, a.dtype)
        fa, fb = self.net((a - shift) / scale), self.net((b - shift) / scale)
        total = 0.0
        for i, (f1, f2) in enumerate(zip(fa, fb)):
            n1 = f1 * torch.rsqrt((f1 ** 2).sum(1, keepdim=True) + 1e-10)
            n2 = f2 * torch.rsqrt((f2 ** 2).sum(1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{i}").view(1, -1, 1, 1)
            total = total + ((n1 - n2) ** 2 * lin).sum(1).mean((1, 2))
        return total


@torch.no_grad()
def random_lpips_state_dict(seed: int = 0) -> dict[str, torch.Tensor]:
    """The fallback without weights: lecun-normal conv kernels and zero
    biases drawn from ``torch.Generator().manual_seed(seed)``, heads 1/c."""
    g = torch.Generator().manual_seed(seed)
    lp = empty_module(LPIPS)
    for i, c in zip(ALEX_CONV_INDEX, ALEX_CHANNELS):
        conv = lp.net.features[i]
        lecun_normal_(conv.weight, conv.weight[0].numel(), g)
        conv.bias.zero_()
    for i, c in enumerate(ALEX_CHANNELS):
        getattr(lp, f"lin{i}").fill_(1.0 / c)
    return lp.state_dict()


def load_torch_lpips(path: str, backbone_path: str | None = None) -> dict[str, torch.Tensor]:
    """An LPIPS state dict from lpips or torchvision files, as the JAX
    loader reads them:

    - a full ``lpips.LPIPS(net='alex').state_dict()``: backbone keys
      ``net.sliceK.N.weight`` (N is the global ``alexnet.features`` index)
      and heads ``linN.model.1.weight`` (1, c, 1, 1);
    - the lpips package's per-net ``.pth``, heads only: the backbone comes
      from a torchvision ``alexnet`` state dict at ``backbone_path``;
    - a torchvision ``alexnet`` state dict (``features.N.weight``), with or
      without head keys (uniform 1/c heads without).
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if backbone_path:
        sd = {**torch.load(backbone_path, map_location="cpu", weights_only=True), **sd}
    out: dict[str, torch.Tensor] = {}
    lins: list[torch.Tensor | None] = [None] * 5
    for k, v in sd.items():
        parts = k.split(".")
        if ".model." in k and parts[-1] == "weight" and parts[0].startswith("lin"):
            lins[int(parts[0].removeprefix("lin"))] = v[0, :, 0, 0]
            continue
        if parts[-1] not in ("weight", "bias"):
            continue
        idx = None
        if parts[0] == "features" and parts[1].isdigit():
            idx = int(parts[1])
        elif len(parts) >= 3 and parts[-3].startswith("slice") and parts[-2].isdigit():
            idx = int(parts[-2])
        if idx in ALEX_CONV_INDEX:
            out[f"net.features.{idx}.{parts[-1]}"] = v
    missing = [f"conv{n}" for n, i in enumerate(ALEX_CONV_INDEX)
               if f"net.features.{i}.weight" not in out]
    if missing:
        raise ValueError(
            f"{path} carries no AlexNet backbone weights for {missing} (the "
            "official lpips .pth ships only the lin heads). Pass a torchvision "
            "alexnet state_dict via backbone_path / --lpips_backbone.")
    if any(lin is None for lin in lins):
        lins = [torch.full((c,), 1.0 / c) for c in ALEX_CHANNELS]
    for i, lin in enumerate(lins):
        out[f"lin{i}"] = lin.float()
    return out


def load_lpips(weights: str | dict = "", backbone_path: str | None = None,
               device: str | torch.device | None = None) -> LPIPS:
    """LPIPS on ``device`` (default cuda) from a state dict, an
    lpips/torchvision ``.pth`` path (``load_torch_lpips``), or (empty) the
    seed-0 random filters."""
    if isinstance(weights, str):
        weights = (load_torch_lpips(weights, backbone_path) if weights
                   else random_lpips_state_dict(0))
    lp = empty_module(LPIPS)
    lp.load_state_dict(weights)
    return lp.to(resolve_device(device)).eval()
