"""Plain tensor operations of the reference: resizes, box masks and splats,
RoIAlign, the box relation embedding, the ISLA norm pass by pass, and the
precision of the matrix products.

Frozen copies of the published LostGAN operations as the port computes them
(same semantics, same order of the resize taps), written out again with
nothing imported from the program. Everything runs in f32 unless a
``Quantizer`` rounds the operands of a product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
ISLA_EPS = 1e-6


class Quantizer:
    """How the operands of every convolution, linear map and heavy matrix
    product are rounded. ``f32``: not at all (the reference). ``fp8``: each
    operand scaled per tensor to the e4m3 range, rounded to float8_e4m3fn and
    scaled back, with the gradient passed straight through: the precision
    one step below bf16, used as the control."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return t
        with torch.no_grad():
            amax = t.detach().abs().amax().clamp_min(1e-30)
            scale = amax / E4M3_MAX
            q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (q - t).detach()


F32 = Quantizer("f32")


def linspace01(n: int, like: torch.Tensor) -> torch.Tensor:
    """``iota * (1 / (n - 1))`` with an exact endpoint."""
    out = torch.arange(n, dtype=like.dtype, device=like.device)
    if n > 1:
        out = out * torch.tensor(1.0 / (n - 1), dtype=like.dtype)
        out[-1] = 1.0
    return out


@functools.cache
def _resize_matrix_np(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * (in_size - 1) / (out_size - 1) if out_size > 1 else np.zeros_like(dst)
    else:
        src = np.maximum((dst + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0
    np.add.at(m, (np.arange(out_size), i0), 1.0 - w1)
    np.add.at(m, (np.arange(out_size), i1), w1)
    return m


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of the last two dims with ``F.interpolate``'s taps."""
    (h_in, w_in), (h_out, w_out) = x.shape[-2:], out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    wy = torch.from_numpy(_resize_matrix_np(h_out, h_in, align_corners)).to(x.device, x.dtype)
    wx = torch.from_numpy(_resize_matrix_np(w_out, w_in, align_corners)).to(x.device, x.dtype)
    return wy @ x @ wx.T


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    (h_in, w_in), (h_out, w_out) = x.shape[-2:], out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    iy = torch.clamp(torch.arange(h_out, device=x.device) * h_in // h_out, max=h_in - 1)
    ix = torch.clamp(torch.arange(w_out, device=x.device) * w_in // w_out, max=w_in - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def bbox_mask(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(b, o, 4) xywh -> (b, o, h, w) hard box occupancy."""
    x0, y0, bw, bh = boxes.unbind(-1)
    fx = (linspace01(w, boxes) - x0[..., None]) / bw[..., None]
    fy = (linspace01(h, boxes) - y0[..., None]) / bh[..., None]
    in_x = (fx >= 0.0) & (fx <= 1.0)
    in_y = (fy >= 0.0) & (fy <= 1.0)
    return (in_y[..., :, None] & in_x[..., None, :]).to(boxes.dtype)


def _sample_matrix(src_pos: torch.Tensor, in_size: int) -> torch.Tensor:
    """(..., out, in_size) bilinear taps with zero padding."""
    src_pos = torch.nan_to_num(src_pos, nan=-2.0).clamp(-2.0, in_size + 1.0)
    i0 = torch.floor(src_pos)
    w1 = src_pos - i0
    i0 = i0.to(torch.long)[..., None]
    cols = torch.arange(in_size, device=src_pos.device)
    zero = torch.zeros((), dtype=src_pos.dtype, device=src_pos.device)
    return (torch.where(cols == i0, (1.0 - w1)[..., None], zero)
            + torch.where(cols == i0 + 1, w1[..., None], zero))


def masks_to_layout(boxes: torch.Tensor, masks: torch.Tensor, size: int) -> torch.Tensor:
    """Per-object (b, o, m, m) masks splatted into their boxes on a
    (size, size) canvas (``grid_sample``, align_corners=False, zero pad)."""
    m = masks.shape[-1]
    x0, y0, bw, bh = (t[..., None] for t in boxes.unbind(-1))
    lin = linspace01(size, boxes)
    sx = ((2.0 * (lin - x0) / bw - 1.0 + 1.0) * m - 1.0) / 2.0
    sy = ((2.0 * (lin - y0) / bh - 1.0 + 1.0) * m - 1.0) / 2.0
    wx = _sample_matrix(sx, m).to(masks.dtype)
    wy = _sample_matrix(sy, m).to(masks.dtype)
    return wy @ masks @ wx.transpose(-1, -2)


def _roi_taps(pos: torch.Tensor, size: int) -> torch.Tensor:
    valid = (pos >= -1.0) & (pos <= float(size))
    xx = pos.clamp(0.0, float(size - 1))
    low = torch.floor(xx)
    frac = xx - low
    low = low.to(torch.long)[..., None]
    cols = torch.arange(size, device=pos.device)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    m = torch.where(cols == low, (1.0 - frac)[..., None], zero)
    m = m + torch.where(cols == low + 1, frac[..., None], zero)
    return m * valid[..., None].to(m.dtype)


def _roi_axis(start: torch.Tensor, length: torch.Tensor, bins: int, size: int) -> torch.Tensor:
    """torchvision RoIAlign (sampling_ratio=0, aligned=False) along one axis
    as a (..., bins, size) averaging matrix."""
    bin_sz = length / bins
    t = max(1, -(-size // bins))
    grid = torch.ceil(bin_sz).clamp(1.0, float(t))
    slots = torch.arange(bins * t, device=start.device)
    which = (slots // t).to(start.dtype)
    p = (slots % t).to(start.dtype)
    pos = start[..., None] + (which + (p + 0.5) / grid[..., None]) * bin_sz[..., None]
    live = (p < grid[..., None]).to(start.dtype) / grid[..., None]
    taps = _roi_taps(pos, size) * live[..., None]
    return taps.reshape(*taps.shape[:-2], bins, t, size).sum(dim=-2)


def roi_align(features: torch.Tensor, boxes_xyxy: torch.Tensor, out: int,
              scale: float) -> torch.Tensor:
    """(b, c, h, w), (b, o, 4) image pixels -> (b, o, c, out, out)."""
    h, w = features.shape[-2:]
    x0, y0, x1, y1 = (boxes_xyxy * scale).unbind(-1)
    ax = _roi_axis(x0, (x1 - x0).clamp_min(1.0), out, w)
    ay = _roi_axis(y0, (y1 - y0).clamp_min(1.0), out, h)
    return torch.einsum("boxw,bocyw->bocyx", ax, torch.einsum("boyh,bchw->bocyw", ay, features))


def dual_scale_roi_align(small: torch.Tensor, large: torch.Tensor, boxes_xyxy: torch.Tensor,
                         out: int, scale_small: float, scale_large: float,
                         threshold: float) -> torch.Tensor:
    """Boxes with both sides under ``threshold`` pixels crop ``small``."""
    crops_s = roi_align(small, boxes_xyxy, out, scale_small)
    crops_l = roi_align(large, boxes_xyxy, out, scale_large)
    bw = boxes_xyxy[..., 2] - boxes_xyxy[..., 0]
    bh = boxes_xyxy[..., 3] - boxes_xyxy[..., 1]
    small_box = (bw < threshold) & (bh < threshold)
    return torch.where(small_box[:, :, None, None, None], crops_s, crops_l)


def box_relation(boxes: torch.Tensor, dim_g: int = 64, wave_len: float = 1000.0) -> torch.Tensor:
    """(b, o, 4) -> (b, o, o, dim_g) sinusoidal box-pair geometry (the
    relation network's embedding, applied to the boxes as given)."""
    b0, b1, b2, b3 = (t[..., None] for t in boxes.unbind(-1))
    cx, cy = (b0 + b2) * 0.5, (b1 + b3) * 0.5
    w, h = (b2 - b0) + 1.0, (b3 - b1) + 1.0
    dx = torch.log(torch.clamp_min(torch.abs((cx - cx.transpose(-1, -2)) / w), 1e-3))
    dy = torch.log(torch.clamp_min(torch.abs((cy - cy.transpose(-1, -2)) / h), 1e-3))
    dw = torch.log(w / w.transpose(-1, -2))
    dh = torch.log(h / h.transpose(-1, -2))
    pos = torch.stack([dx, dy, dw, dh], dim=-1)
    n = dim_g // 8
    freq = torch.arange(n, dtype=boxes.dtype, device=boxes.device) / n
    inv = 1.0 / torch.pow(torch.tensor(wave_len, dtype=boxes.dtype, device=boxes.device), freq)
    mul = ((100.0 * pos)[..., None] * inv).reshape(*pos.shape[:-1], 4 * n)
    return torch.cat([torch.sin(mul), torch.cos(mul)], dim=-1)


def isla_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
              mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              relu: bool) -> torch.Tensor:
    """BN with the given statistics, the stage mask resized to x, the
    mask-weighted per-object affine, then the ReLU when asked:
    ``y (sum_o m_o g_o / (sum_o m_o + 1e-6) + 1) + sum_o m_o b_o / (...)``."""
    c, h, w = x.shape[1:]
    y = (x - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + eps)
    m = resize_bilinear(mask_src, (h, w))
    d = m.sum(dim=1, keepdim=True) + ISLA_EPS
    maps = torch.einsum("bohw,boc->bchw", m, torch.cat([gamma, beta], dim=-1)) / d
    out = y * (maps[:, :c] + 1.0) + maps[:, c:]
    return torch.relu(out) if relu else out


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, pad: int,
           q: Quantizer) -> torch.Tensor:
    return F.conv2d(q(x), q(w), b, padding=pad)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, q: Quantizer) -> torch.Tensor:
    return F.linear(q(x), q(w), b)
