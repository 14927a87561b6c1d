"""``nn.Conv2d``, ``nn.Linear`` and ``nn.Embedding`` for the 2-D mesh
(``parallel/mesh.py``), with torch's state-dict names.

Each behaves exactly as its torch base class until the mesh asks for more:

- tensor mode (``parallel/mesh.py::shard_parameters`` sets ``tp_dim``): the
  weight holds this rank's share of the output features (dim 0 of a conv or
  dense weight, dim 1 of an embedding table: JAX's trailing axis); the input
  enters through ``copy_to_model``, the output is gathered whole and the
  bias, which stays whole, is added after;
- spatial mode, on row shards (``Conv2d`` only, stride 1 with 'same'
  padding as every use in the port): the rows above and below come from the
  neighbour shards (``parallel/mesh.py::conv2d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.parallel import mesh as data_mesh


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None, dim: int) -> torch.Tensor:
    if bias is None:
        return y
    shape = [1] * y.ndim
    shape[dim] = -1
    return y + bias.to(y.dtype).reshape(shape)


class Conv2d(nn.Conv2d):
    TP_PARAM, TP_DIM = "weight", 0
    tp_dim: int | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_dim is None and not data_mesh.rows_sharded():
            return super().forward(x)
        pad = self.padding[0]
        if self.tp_dim is None:
            return data_mesh.conv2d(x, self.weight, self.bias, pad)
        y = data_mesh.conv2d(data_mesh.copy_to_model(x), self.weight, None, pad)
        return _add_bias(data_mesh.gather_model(y, 1), self.bias, 1)


class Linear(nn.Linear):
    TP_PARAM, TP_DIM = "weight", 0
    tp_dim: int | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_dim is None:
            return super().forward(x)
        y = data_mesh.gather_model(F.linear(data_mesh.copy_to_model(x), self.weight), -1)
        return _add_bias(y, self.bias, -1)


class Embedding(nn.Embedding):
    TP_PARAM, TP_DIM = "weight", 1
    tp_dim: int | None = None

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        if self.tp_dim is None:
            return super().forward(idx)
        return data_mesh.gather_model(F.embedding(idx, self.weight), -1)
