"""Normalization layers (counterpart of ``layout2img_tpu/nn/norms.py``), NCHW.

``SyncBatchNorm`` normalizes in f32 and casts back to the input's dtype. In
eval it uses the running statistics. In training it uses the batch mean and
the biased batch variance, ``max(E[x^2] - mean^2, 0)`` in f32 as the JAX
package computes them, and updates the running statistics without gradient:
momentum 0.1, the running variance unbiased by n / (n - 1), n = b*h*w. Under
a data-parallel mesh (``parallel/mesh.py``) the batch is the global one: the
sums of x and x^2 are summed over the ranks (differentiably, so the gradient
of the statistics reaches every rank's x) and n counts every rank's pixels.
The recompute of a checkpointed region (``nn/remat.py``) folds nothing: the
forward it repeats already did; every rank recomputes in the same order, so
its sums over the ranks meet. On a 2-D mesh the sums run over the data axis,
or over every rank where x is a row shard (spatial mode), and n counts the
pixels those ranks hold.

``SpatialAdaptiveNorm`` is the ISLA norm: BN without affine, then the
mask-weighted per-object affine, and optionally the ReLU that follows it in
``GenResBlock``, as one call of ``ops.isla.isla_norm`` (one kernel launch on
the card, two more for its gradient). In training it hands the batch
statistics to that call, and autograd carries their gradients back into x.
With P > 1 parts (the part-mask generator) it makes P such calls, one per
part, without the ReLU, sums them and applies the ReLU once: JAX's
``y * sum_p (G_p + 1) + sum_p B_p`` is ``sum_p [y (G_p + 1) + B_p]``
exactly, and autograd sums the P backward calls. On a row shard the ISLA
calls take the shard's row window (``parallel/mesh.py::row_window``): the
kernels read the whole stage mask at the shard's rows.
"""

from __future__ import annotations

import torch
from torch import nn

from layout2img_tpu_torch.nn import remat
from layout2img_tpu_torch.nn.spectral import SNDense
from layout2img_tpu_torch.ops.isla import isla_norm
from layout2img_tpu_torch.parallel import mesh as data_mesh

MOMENTUM = 0.1  # of the running statistics, as the JAX package's


def batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of NCHW x over the global batch,
    in f32."""
    xf = x.to(torch.float32)
    mesh = data_mesh.current()
    if mesh.stats_axis()[1] == 1:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
    sums = mesh.sum(torch.stack([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3))]))
    n = stat_count(x)
    mean = sums[0] / n
    return mean, (sums[1] / n - mean.square()).clamp_min(0.0)


def stat_count(x: torch.Tensor) -> int:
    """The values per channel ``batch_stats`` averages: b*h*w on each rank
    it sums over."""
    return x.numel() // x.shape[1] * data_mesh.current().stats_axis()[1]


class SyncBatchNorm(nn.Module):
    """BatchNorm over NCHW with the reference's state-dict names."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The (mean, var) to normalize x with: the running statistics in
        eval; in training the batch statistics, after folding them into the
        running ones."""
        if not self.training:
            return self.running_mean, self.running_var
        mean, var = batch_stats(x)
        if remat.replaying():
            return mean, var
        n = stat_count(x)
        m = MOMENTUM
        with torch.no_grad():
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * (var * (n / max(n - 1, 1))))
            self.num_batches_tracked.add_(1)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def chan(t: torch.Tensor) -> torch.Tensor:
            return t.to(torch.float32)[:, None, None]

        mean, var = self.stats(x)
        y = (x.to(torch.float32) - chan(mean)) * torch.rsqrt(chan(var) + self.eps)
        if self.weight is not None:
            y = y * chan(self.weight) + chan(self.bias)
        return y.to(x.dtype)


class InstanceNorm2d(nn.Module):
    """torch nn.InstanceNorm2d defaults (per-sample, per-channel spatial stats,
    no affine), computed in f32."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(-2, -1), keepdim=True)
        var = (xf - mean).square().mean(dim=(-2, -1), keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class SpatialAdaptiveNorm(nn.Module):
    """ISLA norm: BN(affine=False) + mask-weighted per-object affine.

    gamma(p) = sum_o m_o(p) g_o / (sum_o m_o(p) + 1e-6) + 1, beta likewise
    without the +1, where (g_o, b_o) are SN projections of each object's
    style vector. Pad objects carry all-zero masks and so add nothing.
    With ``parts`` P the projections give P (g, b) pairs per object, parts
    major (output index p * c + channel), one per mask part.
    """

    def __init__(self, num_features: int, num_w: int, parts: int = 1):
        super().__init__()
        self.parts = parts
        self.weight_proj = SNDense(num_w, num_features * parts)
        self.bias_proj = SNDense(num_w, num_features * parts)
        self.batch_norm2d = SyncBatchNorm(num_features, affine=False)

    def forward(self, x: torch.Tensor, vectors: torch.Tensor, mask: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
        """x (b, c, h, w); vectors (b, o, num_w); mask (b, o, mh, mw), or
        (b, o, P, mh, mw) with parts, at its own size (resized to x's
        inside); ``relu`` applies the ReLU in the same pass."""
        x = x.contiguous()
        mean, var = self.batch_norm2d.stats(x)
        gamma = self.weight_proj(vectors).to(x.dtype)
        beta = self.bias_proj(vectors).to(x.dtype)
        mask = mask.to(x.dtype)
        eps = self.batch_norm2d.eps
        row0, full_h = data_mesh.row_window(x.shape[-2])
        if self.parts == 1:
            return isla_norm(x, mean, var, eps, mask.contiguous(), gamma.contiguous(),
                             beta.contiguous(), relu=relu, row0=row0, full_h=full_h)
        b, o = vectors.shape[:2]
        c = x.shape[1]
        gamma = gamma.reshape(b, o, self.parts, c)
        beta = beta.reshape(b, o, self.parts, c)
        out = sum(isla_norm(x, mean, var, eps, mask[:, :, p].contiguous(),
                            gamma[:, :, p].contiguous(), beta[:, :, p].contiguous(),
                            row0=row0, full_h=full_h)
                  for p in range(self.parts))
        return torch.relu(out) if relu else out
