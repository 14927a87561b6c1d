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

On the 2-D mesh's tensor mode (``parallel/mesh.py::shard_parameters``) a
layer holds only its rank's share of the output features: rows of the
(out, in) matrix of a conv or dense weight, columns of the (num, dim) table
of an embedding. The power iteration runs on the shard: the products that
span the sharded axis (``W^T u`` of row shards, ``W v`` and ``||W^T u||``
of column shards) are summed over the model group, ``W v`` of row shards is
gathered, and sigma is the model-summed ``u . W v`` (its backward sums too),
so the whole weight is never built. ``weight_u`` stays whole. Convs and
dense layers take their input through ``copy_to_model`` and gather their
output; convs on row shards take halo rows (``parallel/mesh.py::conv2d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.nn import remat
from layout2img_tpu_torch.parallel import mesh as data_mesh


def _right(w_mat: torch.Tensor, u: torch.Tensor, eps: float, tp_dim: int | None) -> torch.Tensor:
    """v = normalize(W^T u) of a whole matrix, of row shards (whole v) or of
    column shards (this rank's part of v)."""
    if tp_dim is None:
        return F.normalize(w_mat.T @ u, dim=0, eps=eps)
    if tp_dim == 0:
        return F.normalize(data_mesh.model_sum(w_mat.T @ data_mesh.own_shard(u, 0)), dim=0, eps=eps)
    t = w_mat.T @ u
    return t / data_mesh.model_sum(t.square().sum()).sqrt().clamp_min(eps)


def _sigma(w_mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor, tp_dim: int | None) -> torch.Tensor:
    """u . W v (model-summed on shards)."""
    if tp_dim is None:
        return u @ (w_mat @ v)
    if tp_dim == 0:
        return data_mesh.model_sum(data_mesh.own_shard(u, 0) @ (w_mat @ v))
    return u @ data_mesh.model_sum(w_mat @ v)


def spectral_sigma(w_mat: torch.Tensor, u: torch.Tensor, eps: float,
                   tp_dim: int | None = None) -> torch.Tensor:
    """sigma of a (rows, cols) matrix from the stored left vector u (f32);
    ``tp_dim``: w_mat is the rank's row (0) or column (1) shard."""
    w_mat = w_mat.to(torch.float32)
    return _sigma(w_mat, u, _right(w_mat, u, eps, tp_dim), tp_dim)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, eps: float,
                    tp_dim: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One power iteration from u, in f32 and without gradient: (new u, v);
    ``tp_dim`` as in ``spectral_sigma`` (u whole, v the rank's part for
    column shards)."""
    with torch.no_grad():
        w_mat = w_mat.to(torch.float32)
        v = _right(w_mat, u, eps, tp_dim)
        wv = w_mat @ v
        if tp_dim == 0:
            wv = data_mesh.gather_shard(wv, 0)
        elif tp_dim == 1:
            wv = data_mesh.model_sum(wv)
        return F.normalize(wv, dim=0, eps=eps), v


class _SNWeight(nn.Module):
    TP_PARAM, TP_DIM = "weight_orig", 0  # the weight and its output-feature dim
    tp_dim: int | None = None  # set when the weight is a tensor-mode shard

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
                u, v = power_iteration(w_mat, self.weight_u.to(torch.float32), self.eps,
                                       self.tp_dim)
                self.weight_u.copy_(u)
                return u, v

            # u is a fresh tensor: later in-place updates of weight_u leave
            # this call's graph intact
            u, v = remat.layer_state(self, advance)
            sigma = _sigma(w_mat.to(torch.float32), u, v, self.tp_dim)
        else:
            sigma = spectral_sigma(w_mat, self.weight_u.to(torch.float32), self.eps, self.tp_dim)
        return (w.to(torch.float32) / sigma).to(w.dtype)

    def _bias(self, dtype: torch.dtype) -> torch.Tensor | None:
        return None if self.bias is None else self.bias.to(dtype)


class SNDense(_SNWeight):
    """spectral_norm(nn.Linear); eps 1e-12 as in torch's default."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, eps: float = 1e-12):
        super().__init__((out_features, in_features), bias, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight().to(x.dtype)
        if self.tp_dim is None:
            return F.linear(x, w, self._bias(x.dtype))
        y = data_mesh.gather_model(F.linear(data_mesh.copy_to_model(x), w), -1)
        return y if self.bias is None else y + self._bias(y.dtype)


class SNConv(_SNWeight):
    """spectral_norm(nn.Conv2d) on NCHW, stride 1, 'SAME' padding; eps 1e-4
    as in the reference's generator and discriminator convs."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, bias: bool = True,
                 eps: float = 1e-4):
        super().__init__((out_ch, in_ch, kernel_size, kernel_size), bias, eps)
        self.padding = kernel_size // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight().to(x.dtype)
        if self.tp_dim is None:
            return data_mesh.conv2d(x, w, self._bias(x.dtype), self.padding)
        y = data_mesh.gather_model(
            data_mesh.conv2d(data_mesh.copy_to_model(x), w, None, self.padding), 1)
        return y if self.bias is None else y + self._bias(y.dtype)[:, None, None]


class SNEmbed(_SNWeight):
    """spectral_norm(nn.Embedding): the (num_embeddings, dim) table divided by
    its sigma, then indexed; eps 1e-12 as in torch's default."""

    TP_DIM = 1

    def __init__(self, num_embeddings: int, dim: int, eps: float = 1e-12):
        super().__init__((num_embeddings, dim), False, eps)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        out = self.normalized_weight()[idx]
        return out if self.tp_dim is None else data_mesh.gather_model(out, -1)
