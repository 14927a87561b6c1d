"""InceptionV3 for IS and FID (counterpart of ``layout2img_tpu/eval/inception.py``).

The standard InceptionV3 (torchvision's topology: pool3 = 2048-d features
and 1000 logits) as an NCHW ``nn.Module`` whose parameter and buffer names
are torchvision's ``inception_v3`` names without ``AuxLogits``, so a
torchvision or pytorch-fid state dict loads with ``strict=True`` once its
``AuxLogits.*`` keys are dropped (``load_torch_inception_v3``). Its convs go
to cuDNN. Input (b, 3, h, w) in [-1, 1] is resized to 299x299 by the
port's constant-matrix ``ops.interp.resize_bilinear``, as the JAX module
resizes with ``resize_bilinear_nhwc``.

No weights are downloaded. Without a state dict the fallback is fixed-seed
random filters (``random_inception_state_dict``): the JAX package's
``random_inception_variables`` recipe (lecun-normal conv kernels scaled by
sqrt(2), a lecun-normal ``fc``, zero biases, identity BN), drawn here from a
``torch.Generator``. Those bits cannot equal JAX's PRNG draws, so a
random-filter rel-FID from the port is not comparable with one from the JAX
package; to compare the two, carry the JAX variables across
(``utils.convert.inception_state_dict_from_jax``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.ops.interp import resize_bilinear

# flax's truncated normal keeps [-2, 2] standard deviations; dividing by this
# constant (the std of a unit normal truncated there) restores the variance
TRUNC_STD = 0.87962566103423978


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool3x3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1)  # count_include_pad, as the JAX module


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_pool3x3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_pool3x3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_pool3x3(x))], 1)


class InceptionV3(nn.Module):
    """(b, 3, h, w) in [-1, 1] -> (pool3 features (b, 2048), logits (b, 1000)).

    Eval-mode BN (running statistics) is the only mode the metrics use:
    ``load_inception`` returns the module in eval mode."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = resize_bilinear(x, (299, 299))
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        feats = x.mean((2, 3))  # pool3, 2048-d
        return feats, self.fc(feats)


def lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator, gain: float = 1.0) -> None:
    """Flax's ``lecun_normal`` (a normal truncated at two standard
    deviations, variance 1/fan_in) times ``gain``, drawn from ``g``."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
    w.mul_(gain)


def empty_module(cls: type[nn.Module]) -> nn.Module:
    """``cls()`` with uninitialized CPU storage: building it on the meta
    device spares the default init, which would draw from (and move) torch's
    global generator, and with it a training run's dropout."""
    with torch.device("meta"):
        net = cls()
    return net.to_empty(device="cpu")


@torch.no_grad()
def random_inception_state_dict(seed: int = 0) -> dict[str, torch.Tensor]:
    """Fixed-seed random filters, the fallback without weights: every conv
    kernel lecun-normal times sqrt(2) (plain lecun-normal halves the
    activation variance at each ReLU, and across ~90 convs the pool3
    features would collapse), the ``fc`` kernel lecun-normal, zero biases,
    BN scale 1, bias 0, mean 0, var 1; drawn in module order from
    ``torch.Generator().manual_seed(seed)``."""
    g = torch.Generator().manual_seed(seed)
    net = empty_module(InceptionV3)
    for mod in net.modules():
        if isinstance(mod, nn.Conv2d):
            lecun_normal_(mod.weight, mod.weight[0].numel(), g, gain=math.sqrt(2.0))
        elif isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, mod.in_features, g)
            mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
    return net.state_dict()


def load_torch_inception_v3(path: str) -> dict[str, torch.Tensor]:
    """A torchvision ``inception_v3`` (or pytorch-fid) state dict, without
    its ``AuxLogits.*`` keys."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")}


def load_inception(weights: str | dict = "",
                   device: str | torch.device | None = None) -> InceptionV3:
    """InceptionV3 in eval mode on ``device`` (default cuda): from a state
    dict, a torchvision ``.pth`` path, or (empty) the seed-0 random filters."""
    if isinstance(weights, str):
        weights = load_torch_inception_v3(weights) if weights else random_inception_state_dict(0)
    net = empty_module(InceptionV3)
    net.load_state_dict(weights)
    return net.to(resolve_device(device)).eval()
