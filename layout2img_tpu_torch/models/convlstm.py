"""ConvLSTM layout fusion (counterpart of ``layout2img_tpu/models/convlstm.py``):
the upstream layout2im fusion, kept by the reference as its baseline variants
(``model_layout2img/generator{,1,2}.py``; cell at ``generator_app.py:414-716``).

The object axis is a padded (b, o) axis: the loop runs over all o slots,
and a pad slot carries the state through unchanged (a masked update), which
is the reference's variable-length sequence per image. NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class ConvLSTMCell(nn.Module):
    """ConvLSTM cell: the i, f, o, g gates from one conv over [x, h]."""

    def __init__(self, in_dim: int, hidden_dim: int, kernel_size: int = 5):
        super().__init__()
        self.conv = nn.Conv2d(in_dim + hidden_dim, 4 * hidden_dim, kernel_size,
                              padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        i, f, o, g = self.conv(torch.cat([x, h], dim=1)).chunk(4, dim=1)
        c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_next), c_next


class LayoutConvLSTM(nn.Module):
    """Stacked ConvLSTM over the object axis; returns the last layer's final
    hidden state per image (reference ``LayoutConvLSTM(8, 512, [128, 64,
    64], (5, 5))``, ``generator_app.py:784-789``)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (128, 64, 64),
                 kernel_size: int = 5):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        dims = (in_dim, *self.hidden_dims)
        for i in range(len(self.hidden_dims)):
            self.add_module(f"cell{i}", ConvLSTMCell(dims[i], dims[i + 1], kernel_size))

    def forward(self, feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """feats (b, o, c, s, s); valid (b, o) -> (b, hidden_dims[-1], s, s)."""
        b, o, _, s, _ = feats.shape
        x = feats
        h = None
        for i, hd in enumerate(self.hidden_dims):
            cell = getattr(self, f"cell{i}")
            h = feats.new_zeros(b, hd, s, s)
            c = feats.new_zeros(b, hd, s, s)
            outs = []
            for t in range(o):
                h_next, c_next = cell(x[:, t], h, c)
                keep = (valid[:, t] > 0)[:, None, None, None]
                h = torch.where(keep, h_next, h)
                c = torch.where(keep, c_next, c)
                outs.append(h)
            x = torch.stack(outs, dim=1)
        return h
