"""Attention (counterpart of ``layout2img_tpu/nn/attention.py``).

``BoxMultiHeadedAttention`` is the LostGAN family's context attention over
per-object style vectors, ``MultiHeadAttention`` the layout2im family's
plain one.

Box attention:

``softmax(log(max(relu(W_G g), 1e-6)) + QK^T / sqrt(d_k))`` over the object
tokens, with g the pairwise sinusoidal box embedding; key slots whose label
is 0 (pad) get -1e9 logits. Submodule names are the reference's
(``linears.{0..3}``, ``WGs.{h}``, ``layer_norm0``, ``layer_norm``).

``legacy_view=True`` reproduces the reference's h=1 concat scramble, which
its trained checkpoints depend on; the default is the corrected concat.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from layout2img_tpu_torch.nn.layers import Linear
from layout2img_tpu_torch.ops.relation import box_relational_embedding
from layout2img_tpu_torch.parallel import mesh as data_mesh


class BoxMultiHeadedAttention(nn.Module):
    def __init__(self, heads: int, d_model: int, trignometric: bool = True,
                 use_geometry: bool = True, legacy_view: bool = False):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"d_model {d_model} is not divisible by heads {heads}")
        self.heads = heads
        self.d_model = d_model
        self.trignometric = trignometric
        self.use_geometry = use_geometry
        self.legacy_view = legacy_view
        self.linears = nn.ModuleList(Linear(d_model, d_model) for _ in range(4))
        dim_g = 64 if trignometric else 4
        self.WGs = nn.ModuleList(Linear(dim_g, 1) for _ in range(heads))
        self.layer_norm0 = nn.LayerNorm(d_model, eps=1e-5)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                boxes: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        """query/key/value (b, o, d_model); boxes (b, o, 4); labels (b, o), 0 = pad."""
        b, o, _ = query.shape
        h = self.heads
        d_k = self.d_model // h
        residual = query

        def split(t):
            return t.reshape(b, o, h, d_k).transpose(1, 2)  # (b, h, o, d_k)

        q, k, v = (split(lin(t)) for lin, t in zip(self.linears[:3], (query, key, value)))
        logits = q @ k.transpose(-1, -2) / math.sqrt(d_k)
        if labels is not None:
            key_mask = (labels != 0)[:, None, None, :]  # (b, 1, 1, o)
            logits = logits.masked_fill(~key_mask, -1e9)

        if self.use_geometry:
            geo = box_relational_embedding(boxes, trignometric=self.trignometric).to(query.dtype)
            w_g = torch.cat([wg(geo) for wg in self.WGs], dim=-1)  # (b, o, o, h)
            w_g = torch.relu(w_g).permute(0, 3, 1, 2)  # (b, h, o, o)
            logits = torch.log(torch.clamp_min(w_g, 1e-6)) + logits

        attn = torch.softmax(logits, dim=-1)
        out = attn @ v  # (b, h, o, d_k)
        if self.legacy_view and h == 1:
            # reference scramble: (b, o, d) -> transpose -> row-major reshape
            out = out[:, 0].transpose(1, 2).reshape(b, o, self.d_model)
        else:
            out = out.transpose(1, 2).reshape(b, o, self.d_model)

        out = self.layer_norm0(out + residual)
        inner = out
        out = self.linears[3](out)
        return self.layer_norm(out + inner)


class MultiHeadAttention(nn.Module):
    """Plain multi-head attention with the reference's residual and
    LayerNorm topology (``model_layout2img/transformer.py:42-93``):
    ``ln1(fc(ln0(attn + query)) + ln0(...))``. Key slots whose label is 0
    get -1e9 logits, before the 1/sqrt(d_k) scale. ``heads * d_v`` must
    equal ``d_model`` (the first residual). Dropout (``dropout_rate``, on
    the attention weights and on ``fc``'s output) runs unless the forward
    is ``deterministic``, from torch's global generator, its masks drawn
    for the global batch (``parallel/mesh.py::dropout``)."""

    def __init__(self, heads: int, d_model: int, d_k: int, d_v: int, dropout_rate: float = 0.1):
        super().__init__()
        if heads * d_v != d_model:
            raise ValueError(f"heads * d_v = {heads * d_v} is not d_model {d_model}")
        self.heads, self.d_k, self.d_v = heads, d_k, d_v
        self.dropout_rate = dropout_rate
        self.w_qs = nn.Linear(d_model, heads * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, heads * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, heads * d_v, bias=False)
        self.ln0 = nn.LayerNorm(d_model, eps=1e-5)
        self.fc = nn.Linear(heads * d_v, d_model)
        self.ln1 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                labels: torch.Tensor | None = None, deterministic: bool = True) -> torch.Tensor:
        """query (b, q, d_model); key, value (b, k, d_model); labels (b, k), 0 = pad."""
        b, nq, _ = query.shape
        h = self.heads
        drop = 0.0 if deterministic else self.dropout_rate
        q = self.w_qs(query).reshape(b, nq, h, self.d_k).transpose(1, 2)
        k = self.w_ks(key).reshape(b, -1, h, self.d_k).transpose(1, 2)
        v = self.w_vs(value).reshape(b, -1, h, self.d_v).transpose(1, 2)
        logits = q @ k.transpose(-1, -2)
        if labels is not None:
            logits = logits.masked_fill((labels == 0)[:, None, None, :], -1e9)
        attn = torch.softmax(logits / math.sqrt(self.d_k), dim=-1)
        attn = data_mesh.dropout(attn, drop, training=drop > 0)
        out = (attn @ v).transpose(1, 2).reshape(b, nq, h * self.d_v)
        out = self.ln0(out + query)
        inner = out
        out = data_mesh.dropout(self.fc(out), drop, training=drop > 0)
        return self.ln1(out + inner)
