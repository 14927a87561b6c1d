"""Normalization layers (counterpart of ``layout2img_tpu/nn/norms.py``), NCHW.

``SyncBatchNorm`` is eval-only in this slice: it normalizes with the running
statistics, in f32, and casts back to the input's dtype. Batch statistics
(and their cross-GPU sync) arrive with the training path.

``SpatialAdaptiveNorm`` is the ISLA norm: BN without affine, then the
mask-weighted per-object affine, and optionally the ReLU that follows it in
``GenResBlock``, as one call of ``ops.isla.isla_norm`` (one kernel launch on
the card).
"""

from __future__ import annotations

import torch
from torch import nn

from layout2img_tpu_torch.nn.spectral import SNDense
from layout2img_tpu_torch.ops.isla import isla_norm


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

    def require_eval(self) -> None:
        if self.training:
            raise NotImplementedError(
                "batch-statistics BatchNorm arrives with the training path; call .eval()")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.require_eval()

        def chan(t: torch.Tensor) -> torch.Tensor:
            return t.to(torch.float32)[:, None, None]

        y = (x.to(torch.float32) - chan(self.running_mean)) * torch.rsqrt(
            chan(self.running_var) + self.eps)
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
    """ISLA norm, parts=1: BN(affine=False) + mask-weighted per-object affine.

    gamma(p) = sum_o m_o(p) g_o / (sum_o m_o(p) + 1e-6) + 1, beta likewise
    without the +1, where (g_o, b_o) are SN projections of each object's
    style vector. Pad objects carry all-zero masks and so add nothing.
    """

    def __init__(self, num_features: int, num_w: int):
        super().__init__()
        self.weight_proj = SNDense(num_w, num_features)
        self.bias_proj = SNDense(num_w, num_features)
        self.batch_norm2d = SyncBatchNorm(num_features, affine=False)

    def forward(self, x: torch.Tensor, vectors: torch.Tensor, mask: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
        """x (b, c, h, w); vectors (b, o, num_w); mask (b, o, mh, mw) at its own
        size (resized to x's inside); ``relu`` applies the ReLU in the same pass."""
        bn = self.batch_norm2d
        bn.require_eval()
        gamma = self.weight_proj(vectors).to(x.dtype).contiguous()
        beta = self.bias_proj(vectors).to(x.dtype).contiguous()
        return isla_norm(x.contiguous(), bn.running_mean, bn.running_var, bn.eps,
                         mask.to(x.dtype).contiguous(), gamma, beta, relu=relu)
