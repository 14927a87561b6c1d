"""Graph-convolution context over per-object style vectors (counterpart of
``layout2img_tpu/nn/gcn.py``).

The adjacency connects objects of one class: ``A[i, j] = 1[y_i == y_j]``
for i != j, plus self-loops, row-normalized, dense over the o slots (the
reference builds it per sample as a scipy sparse matrix; the relation is
the same). Two graph convolutions with a residual:
``x + gc2(dropout(relu(gc1(x, A))), A)``, ``gc(h) = A (h W) + b``.
Parameter names and shapes are the reference's ``GraphConvolution``
(``gc{1,2}.weight`` (in, out), ``gc{1,2}.bias``). Dropout (0.5,
elementwise) runs when the forward's ``deterministic`` is False, as in
JAX; under ``nn/remat.py::checkpoint`` its recompute draws the same mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.parallel import mesh as data_mesh


def same_label_adjacency(labels: torch.Tensor) -> torch.Tensor:
    """(b, o) labels -> (b, o, o) row-normalized adjacency with self-loops, f32."""
    same = (labels[:, :, None] == labels[:, None, :]).to(torch.float32)
    eye = torch.eye(labels.shape[-1], device=labels.device)
    adj = same * (1.0 - eye) + eye
    return adj / adj.sum(dim=-1, keepdim=True)


class GraphConvolution(nn.Module):
    """``A (h W) + b`` with W (in, out), as the reference stores it. In the
    2-D mesh's tensor mode W may hold this rank's columns (``tp_dim`` 1,
    ``parallel/mesh.py::shard_parameters``): the products are gathered."""

    TP_PARAM, TP_DIM = "weight", 1
    tp_dim: int | None = None

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        if self.tp_dim is None:
            return adj @ (h @ self.weight.to(h.dtype)) + self.bias.to(h.dtype)
        y = adj @ (data_mesh.copy_to_model(h) @ self.weight.to(h.dtype))
        return data_mesh.gather_model(y, -1) + self.bias.to(h.dtype)


class GraphFunc(nn.Module):
    def __init__(self, z_dim: int, dropout_rate: float = 0.5):
        super().__init__()
        self.gc1 = GraphConvolution(z_dim, 4 * z_dim)
        self.gc2 = GraphConvolution(4 * z_dim, z_dim)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        """x (b, o, z_dim); labels (b, o). The adjacency is computed in f32
        and cast to x's dtype, so a bf16 x keeps the products in bf16."""
        adj = same_label_adjacency(labels).to(x.dtype)
        h = data_mesh.dropout(F.relu(self.gc1(x, adj)), self.dropout_rate,
                              training=not deterministic)
        return x + self.gc2(h, adj)
