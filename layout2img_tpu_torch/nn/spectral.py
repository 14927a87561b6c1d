"""Spectrally normalized layers (counterpart of ``layout2img_tpu/nn/spectral.py``).

Parameter names are the reference's ``torch.nn.utils.spectral_norm`` names
(``weight_orig``, ``weight_u``, ``weight_v``), so reference-format state
dicts load with ``strict=True``. As in the JAX package, sigma is recomputed
from the stored ``u`` on every call, even in eval: ``v = normalize(W^T u)``,
``sigma = u . W v``, in f32, and the weight is cast back to its own dtype.
``weight_v`` is kept only so that such dicts load; it is never read.

In training (``module.train()``) each call first runs one power iteration,
``v = normalize(W^T u)``, ``u = normalize(W v)``, stores the new ``u`` in
place, and takes ``sigma = u . W v`` with u and v detached, as the JAX
package's ``update_stats=True`` does: so a layer called twice in one forward
advances u twice. In eval sigma is differentiated through v. Inside the
recompute of a checkpointed region (``nn/remat.py``) the layer reuses the
(u, v) of the forward call it repeats and leaves ``weight_u`` alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.nn import remat


def spectral_sigma(w_mat: torch.Tensor, u: torch.Tensor, eps: float) -> torch.Tensor:
    """sigma of a (rows, cols) matrix from the stored left vector u (f32)."""
    w_mat = w_mat.to(torch.float32)
    v = F.normalize(w_mat.T @ u, dim=0, eps=eps)
    return u @ (w_mat @ v)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One power iteration from u, in f32 and without gradient: (new u, v)."""
    with torch.no_grad():
        w_mat = w_mat.to(torch.float32)
        v = F.normalize(w_mat.T @ u, dim=0, eps=eps)
        return F.normalize(w_mat @ v, dim=0, eps=eps), v


class _SNWeight(nn.Module):
    def __init__(self, shape: tuple[int, ...], bias: bool, eps: float):
        super().__init__()
        self.eps = eps
        self.weight_orig = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None
        rest = 1
        for s in shape[1:]:
            rest *= s
        self.register_buffer("weight_u", torch.empty(shape[0]))
        self.register_buffer("weight_v", torch.empty(rest))

    def normalized_weight(self) -> torch.Tensor:
        w = self.weight_orig
        w_mat = w.reshape(w.shape[0], -1)
        if self.training:
            def advance():
                u, v = power_iteration(w_mat, self.weight_u.to(torch.float32), self.eps)
                self.weight_u.copy_(u)
                return u, v

            # u is a fresh tensor: later in-place updates of weight_u leave
            # this call's graph intact
            u, v = remat.layer_state(self, advance)
            sigma = u @ (w_mat.to(torch.float32) @ v)
        else:
            sigma = spectral_sigma(w_mat, self.weight_u.to(torch.float32), self.eps)
        return (w.to(torch.float32) / sigma).to(w.dtype)


class SNDense(_SNWeight):
    """spectral_norm(nn.Linear); eps 1e-12 as in torch's default."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, eps: float = 1e-12):
        super().__init__((out_features, in_features), bias, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight().to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, w, b)


class SNConv(_SNWeight):
    """spectral_norm(nn.Conv2d) on NCHW, stride 1, 'SAME' padding; eps 1e-4
    as in the reference's generator and discriminator convs."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, bias: bool = True,
                 eps: float = 1e-4):
        super().__init__((out_ch, in_ch, kernel_size, kernel_size), bias, eps)
        self.padding = kernel_size // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight().to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, padding=self.padding)


class SNEmbed(_SNWeight):
    """spectral_norm(nn.Embedding): the (num_embeddings, dim) table divided by
    its sigma, then indexed; eps 1e-12 as in torch's default."""

    def __init__(self, num_embeddings: int, dim: int, eps: float = 1e-12):
        super().__init__((num_embeddings, dim), False, eps)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.normalized_weight()[idx]
