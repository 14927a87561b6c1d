"""String-spec CNN and MLP builders (counterpart of ``layout2img_tpu/nn/builders.py``;
reference ``model_layout2img/layers.py:127-230``, ``build_cnn``/``build_mlp``).

The spec language, as the JAX package's (a comma-separated string or a list):

- ``IX``     X input channels (first token only; default 3)
- ``CK-X``   KxK conv to X channels, stride 1; ``CK-X-S`` stride S
- ``R``      residual block keeping the channel count
- ``UX``     nearest upsample by X
- ``PX``     pooling by X (max or avg)
- ``FC-D-E`` flatten (once), then a D -> E linear layer

Every conv but the first is preceded by normalization and activation; an
``FC`` is followed by the activation unless it is the last token. With the
JAX package's deltas from the reference: ``FC`` flattens features in (h, w,
c) order (the JAX package's NHWC order, so a JAX ``Dense`` kernel converts
by a plain transpose), ``instance`` is a per-sample instance norm in both
modes, only 'same' padding, and ``relu`` is ReLU. ``batch`` normalization
follows flax's ``BatchNorm(momentum=0.9)``: batch statistics in training,
the running variance biased. Submodule names are the JAX modules' names
(``conv_{i}``, ``norm_{i}.BatchNorm_0``, ``res_{i}``, ``fc_{i}``,
``dense_{i}``, ``BatchNorm_{k}``), so ``utils.convert.layout2im_state_dict_from_jax``
maps their variables. Only the tests use these builders, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    low = name.lower()
    if low.startswith("leakyrelu"):
        slope = float(name.split("-")[1]) if "-" in name else 0.01
        return lambda x: F.leaky_relu(x, slope)
    if low == "relu":
        return F.relu
    raise ValueError(f'invalid activation "{name}"')


class _FlaxBatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over every axis but the
    channels (dim 1): the variance ``max(E[x^2] - E[x]^2, 0)``, the running
    statistics updated with the biased batch variance."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dim=dims)
            var = (x.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + 1e-5)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


class _Norm2D(nn.Module):
    """'batch' | 'instance' | 'none'."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.BatchNorm_0 = _FlaxBatchNorm(channels)
        elif kind == "instance":
            self.GroupNorm_0 = nn.GroupNorm(channels, channels, eps=1e-5)
        elif kind != "none":
            raise ValueError(f'unrecognized normalization "{kind}"')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "batch":
            return self.BatchNorm_0(x)
        if self.kind == "instance":
            return self.GroupNorm_0(x)
        return x


class BuiltResidualBlock(nn.Module):
    """norm - act - conv - norm - act - conv, plus the identity."""

    def __init__(self, channels: int, normalization: str = "batch", activation: str = "relu",
                 kernel_size: int = 3):
        super().__init__()
        self.act = _activation(activation)
        self.norm1 = _Norm2D(normalization, channels)
        self.conv1 = nn.Conv2d(channels, channels, kernel_size, padding=kernel_size // 2)
        self.norm2 = _Norm2D(normalization, channels)
        self.conv2 = nn.Conv2d(channels, channels, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.act(self.norm1(x)))
        return x + self.conv2(self.act(self.norm2(y)))


def _parse_arch(arch) -> list[str]:
    if isinstance(arch, str):
        arch = arch.split(",")
    return [s.strip() for s in arch if s.strip()]


class BuiltCNN(nn.Module):
    """The CNN of a spec; NCHW in, NCHW out (or (b, features) after ``FC``)."""

    def __init__(self, arch, normalization: str = "batch", activation: str = "relu",
                 pooling: str = "max"):
        super().__init__()
        tokens = _parse_arch(arch)
        cur = 3
        if tokens and tokens[0][0] == "I":
            cur = int(tokens[0][1:])
            tokens = tokens[1:]
        self.tokens, self.pooling = tokens, pooling
        self.act = _activation(activation)
        first_conv = True
        for i, s in enumerate(tokens):
            if s[:2] == "FC":
                _, d_in, d_out = s.split("-")
                self.add_module(f"fc_{i}", nn.Linear(int(d_in), int(d_out)))
            elif s[0] == "C":
                if not first_conv:
                    self.add_module(f"norm_{i}", _Norm2D(normalization, cur))
                first_conv = False
                vals = [int(v) for v in s[1:].split("-")]
                k, out = vals[0], vals[1]
                self.add_module(f"conv_{i}", nn.Conv2d(cur, out, k, stride=vals[2] if len(vals) == 3
                                                       else 1, padding=(k - 1) // 2))
                cur = out
            elif s[0] == "R":
                self.add_module(f"res_{i}", BuiltResidualBlock(
                    cur, "none" if first_conv else normalization, activation))
                first_conv = False
            elif s[0] not in "UP":
                raise ValueError(f'invalid layer "{s}"')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = False
        for i, s in enumerate(self.tokens):
            if s[:2] == "FC":
                if not flat:
                    x = x.permute(0, 2, 3, 1).flatten(1) if x.ndim == 4 else x.flatten(1)
                    flat = True
                x = getattr(self, f"fc_{i}")(x)
                if i + 1 < len(self.tokens):
                    x = self.act(x)
            elif s[0] == "C":
                if hasattr(self, f"norm_{i}"):
                    x = self.act(getattr(self, f"norm_{i}")(x))
                x = getattr(self, f"conv_{i}")(x)
            elif s[0] == "R":
                x = getattr(self, f"res_{i}")(x)
            elif s[0] == "U":
                x = F.interpolate(x, scale_factor=int(s[1:]), mode="nearest")
            else:
                pool = F.max_pool2d if self.pooling == "max" else F.avg_pool2d
                x = pool(x, int(s[1:]))
        return x


def cnn_out_channels(arch, in_channels: int = 3) -> int:
    """The channels (or features) a spec ends with."""
    cur = in_channels
    tokens = _parse_arch(arch)
    if tokens and tokens[0][0] == "I":
        cur = int(tokens[0][1:])
        tokens = tokens[1:]
    for s in tokens:
        if s[:2] == "FC":
            cur = int(s.split("-")[2])
        elif s[0] == "C":
            cur = int(s[1:].split("-")[1])
    return cur


class BuiltMLP(nn.Module):
    """An MLP over a list of widths (reference ``layers.py:214-230``)."""

    def __init__(self, dims: Sequence[int], activation: str = "relu", batch_norm: str = "none",
                 dropout: float = 0.0, final_nonlinearity: bool = True):
        super().__init__()
        self.act = _activation(activation)
        self.dropout, self.final_nonlinearity = dropout, final_nonlinearity
        self.n = len(dims) - 1
        k = 0
        for i in range(self.n):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
            if batch_norm == "batch" and (i < self.n - 1 or final_nonlinearity):
                self.add_module(f"BatchNorm_{k}", _FlaxBatchNorm(dims[i + 1]))
                k += 1
        self.batch_norm = batch_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = 0
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1 or self.final_nonlinearity:
                if self.batch_norm == "batch":
                    x = getattr(self, f"BatchNorm_{k}")(x)
                    k += 1
                x = self.act(x)
            if self.dropout > 0:
                x = F.dropout(x, self.dropout, training=self.training)
        return x


def build_cnn(arch, normalization: str = "batch", activation: str = "relu",
              pooling: str = "max") -> tuple[BuiltCNN, int]:
    """The reference-shaped constructor: (module, out_channels)."""
    return BuiltCNN(arch, normalization, activation, pooling), cnn_out_channels(arch)


def build_mlp(dim_list: Sequence[int], activation: str = "relu", batch_norm: str = "none",
              dropout: float = 0.0, final_nonlinearity: bool = True) -> BuiltMLP:
    return BuiltMLP(tuple(dim_list), activation, batch_norm, dropout, final_nonlinearity)
