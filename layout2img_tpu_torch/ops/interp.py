"""Resizing and mask splatting (counterpart of ``layout2img_tpu/ops/interp.py``).

A bilinear resize is two constant (out, in) matrices, ``W_y @ x @ W_x^T``,
as in the JAX package: on the GPU that is one batched GEMM pair over all
b*o maps. (``F.interpolate`` on a (1, b*o, h, w) view runs PyTorch's NCHW
bilinear kernel, which loops over every map inside each output pixel's
thread; that took most of a full-width forward's device time on an H100.)
Nearest resize gathers constant indices; adaptive pooling is torch's own
``F.adaptive_avg_pool2d``. The box-dependent splat builds two bilinear
sampling matrices from the boxes and applies them as batched matmuls; so
do ``crop_boxes`` (each object's box cut out of its image, the layout2im
family's crops) and its inverse ``paste_boxes``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from layout2img_tpu_torch.ops.bbox import linspace01


def _as_nchw(x: torch.Tensor) -> tuple[torch.Tensor, torch.Size]:
    """View ``(..., H, W)`` as ``(1, N, H, W)`` for torch's 4-D resizers."""
    lead = x.shape[:-2]
    return x.reshape(1, -1, *x.shape[-2:]), lead


@functools.cache
def _resize_matrix_np(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) bilinear resize matrix with ``F.interpolate``'s semantics."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * (in_size - 1) / (out_size - 1) if out_size > 1 else np.zeros_like(dst)
    else:
        # negative source coordinates clamp to 0 (edge replicate)
        src = np.maximum((dst + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0
    np.add.at(m, (np.arange(out_size), i0), 1.0 - w1)
    np.add.at(m, (np.arange(out_size), i1), w1)
    return m


# Device copies of the constant tables above and below, one per (table,
# dtype, device), so that an eager call on the card makes no host-to-device
# copy. Only real tensors are kept. Under a tracing mode (``torch.export``,
# ``torch.compile``, ``make_fx``) the tensor built is a fake or functional
# stand-in that belongs to that trace: kept, it would be handed to every
# later eager call (ROADMAP §3, trap 9). Tables are built outside inference
# mode: an inference tensor kept here would break any later call that
# autograd records.
_DEVICE_TABLES: dict[tuple, torch.Tensor] = {}


def device_table(key: tuple, array: np.ndarray, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``array`` (a cached numpy table named by ``key``) as a tensor of
    ``dtype`` on ``device``, kept per device when it is a real tensor."""
    full_key = (key, dtype, torch.device(device))
    t = _DEVICE_TABLES.get(full_key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.from_numpy(array).to(device, dtype)
        if type(t) is torch.Tensor and not torch.compiler.is_compiling():
            _DEVICE_TABLES[full_key] = t
    return t


def _resize_matrix(out_size: int, in_size: int, align_corners: bool, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    key = ("resize", out_size, in_size, align_corners)
    return device_table(key, _resize_matrix_np(*key[1:]), dtype, device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *, align_corners: bool = False,
                    rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Bilinear resize of the trailing two dims ``(..., H, W)``. ``rows``
    (start, count) keeps only those rows of the resized map: the same values
    as the whole resize's rows (a row shard's window)."""
    (h_in, w_in), (h_out, w_out) = x.shape[-2:], out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x if rows is None else x[..., rows[0]:rows[0] + rows[1], :]
    wy = _resize_matrix(h_out, h_in, align_corners, x.dtype, x.device)
    if rows is not None:
        wy = wy[rows[0]:rows[0] + rows[1]]
    wx = _resize_matrix(w_out, w_in, align_corners, x.dtype, x.device)
    return wy @ x @ wx.T


@functools.cache
def _nearest_index_np(out_size: int, in_size: int) -> np.ndarray:
    """torch 'nearest' source index: ``floor(dst * in / out)``."""
    return np.minimum(np.arange(out_size) * in_size // out_size, in_size - 1).astype(np.int64)


def _nearest_index(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    key = ("nearest", out_size, in_size)
    return device_table(key, _nearest_index_np(out_size, in_size), torch.long, device)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the trailing two dims ``(..., H, W)``."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    iy = _nearest_index(h_out, h_in, x.device)
    ix = _nearest_index(w_out, w_in, x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on the trailing two dims ``(..., H, W)``."""
    x4, lead = _as_nchw(x)
    return F.adaptive_avg_pool2d(x4, tuple(out_hw)).reshape(*lead, *out_hw)


def sample_matrix_1d(src_pos: torch.Tensor, in_size: int) -> torch.Tensor:
    """Bilinear sampling matrix with zero padding (grid_sample semantics).

    src_pos: (..., out) continuous source pixel coordinates; taps outside
    [0, in_size) weigh zero. Returns (..., out, in_size).
    """
    # A degenerate box (w == 0) gives +-inf, or NaN where 0/0. Map NaN out of
    # range and clamp to a band where every tap already weighs zero, so the
    # integer cast below is defined.
    src_pos = torch.nan_to_num(src_pos, nan=-2.0).clamp(-2.0, in_size + 1.0)
    i0 = torch.floor(src_pos)
    w1 = src_pos - i0  # weight of tap i0 + 1
    w0 = 1.0 - w1
    i0 = i0.to(torch.long)[..., None]
    cols = torch.arange(in_size, device=src_pos.device)
    zero = torch.zeros((), dtype=src_pos.dtype, device=src_pos.device)
    m0 = torch.where(cols == i0, w0[..., None], zero)
    m1 = torch.where(cols == i0 + 1, w1[..., None], zero)
    return m0 + m1


def masks_to_layout(boxes: torch.Tensor, masks: torch.Tensor, h: int, w: int | None = None) -> torch.Tensor:
    """Splat per-object masks into their box footprint on an (h, w) canvas.

    The reference's ``grid_sample`` splat: canvas pixel j maps to the in-box
    coordinate ``(linspace(0,1)[j] - x0) / bw``, then to mask pixels with
    align_corners=False, bilinear, zero padding.

    boxes: (b, o, 4) xywh; masks: (b, o, m, m) -> (b, o, h, w).
    """
    if w is None:
        w = h
    m = masks.shape[-1]
    x0, y0, bw, bh = (t[..., None] for t in boxes.unbind(-1))  # each (b, o, 1)
    gx = 2.0 * (linspace01(w, boxes) - x0) / bw - 1.0  # (b, o, w)
    gy = 2.0 * (linspace01(h, boxes) - y0) / bh - 1.0  # (b, o, h)
    sx = ((gx + 1.0) * m - 1.0) / 2.0
    sy = ((gy + 1.0) * m - 1.0) / 2.0
    # positions in the boxes' f32; the finished matrices in the masks' dtype
    wx = sample_matrix_1d(sx, m).to(masks.dtype)  # (b, o, w, m)
    wy = sample_matrix_1d(sy, m).to(masks.dtype)  # (b, o, h, m)
    return wy @ masks @ wx.transpose(-1, -2)


def paste_boxes(crops: torch.Tensor, boxes: torch.Tensor, h: int, w: int | None = None) -> torch.Tensor:
    """The inverse of ``crop_boxes``: splat per-object crops into their box
    footprint on an (h, w) canvas, zero outside (``masks_to_layout`` with
    channels).

    crops (b, o, c, m, m); boxes (b, o, 4) xywh -> (b, o, c, h, w).
    """
    if w is None:
        w = h
    m = crops.shape[-1]
    x0, y0, bw, bh = (t[..., None] for t in boxes.unbind(-1))
    gx = 2.0 * (linspace01(w, boxes) - x0) / bw - 1.0
    gy = 2.0 * (linspace01(h, boxes) - y0) / bh - 1.0
    sx = ((gx + 1.0) * m - 1.0) / 2.0
    sy = ((gy + 1.0) * m - 1.0) / 2.0
    wx = sample_matrix_1d(sx, m).to(crops.dtype)  # (b, o, w, m)
    wy = sample_matrix_1d(sy, m).to(crops.dtype)  # (b, o, h, m)
    return wy[:, :, None] @ crops @ wx.transpose(-1, -2)[:, :, None]


def crop_boxes(images: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Each object's box cut out of its image and resized to (out, out),
    differentiably: the reference's ``crop_bbox_batch`` (``grid_sample`` on a
    grid that spans the box with both ends included, align_corners=False,
    bilinear, zero padding) as two sampling matrices.

    images (b, c, h, w); boxes (b, o, 4) xywh in [0, 1] -> (b, o, c, out, out).
    """
    h, w = images.shape[-2:]
    x0, y0, bw, bh = (t[..., None] for t in boxes.unbind(-1))  # each (b, o, 1)
    lin = linspace01(out_size, boxes)
    gx = 2.0 * (x0 + lin * bw) - 1.0  # (b, o, out)
    gy = 2.0 * (y0 + lin * bh) - 1.0
    sx = ((gx + 1.0) * w - 1.0) / 2.0
    sy = ((gy + 1.0) * h - 1.0) / 2.0
    wx = sample_matrix_1d(sx, w).to(images.dtype)  # (b, o, out, w)
    wy = sample_matrix_1d(sy, h).to(images.dtype)  # (b, o, out, h)
    return wy[:, :, None] @ images[:, None] @ wx.transpose(-1, -2)[:, :, None]
