"""RoIAlign as separable interpolation matmuls (counterpart of
``layout2img_tpu/ops/roi.py``), NCHW.

ROI bins are axis-aligned, so torchvision's bilinear-average pooling
(``RoIAlign((8, 8), scale, sampling_ratio=0)``, aligned=False, the
reference discriminators' setting) factors into per-object 1-D averaging
matrices, and a crop is ``A_y @ fm @ A_x^T``: two batched matmuls. The
adaptive grid (``ceil(bin_size)`` taps per bin) uses a static bound of
``ceil(size / out_bins)`` tap slots, masked and renormalized per object,
exactly as the JAX package does. Border rules are torchvision's: taps at
positions < -1 or > size weigh zero; others clamp to [0, size - 1].

Boxes are in image pixels (xyxy); the caller scales the loader's
normalized xywh boxes first. Pad objects get crops too; the losses mask
them out.

On a row shard of the feature map (the 2-D mesh's spatial mode,
``parallel/mesh.py``) each rank contracts its rows with its columns of the
row tap matrix, and the model group sums the partial crops: the same
separable matmuls, in another order.
"""

from __future__ import annotations

import torch

from layout2img_tpu_torch.parallel import mesh as data_mesh

def _roi_tap_matrix(pos: torch.Tensor, size: int) -> torch.Tensor:
    """(..., S, size) bilinear weights of positions ``pos`` (..., S)."""
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


def _axis_matrix(start: torch.Tensor, length: torch.Tensor, out_bins: int, size: int) -> torch.Tensor:
    """(..., out_bins, size) ROI-average matrix along one axis: ``grid =
    ceil(length / out_bins)`` taps per bin, in ``ceil(size / out_bins)``
    static slots. start, length (...,) in feature-map pixels."""
    bin_sz = length / out_bins
    t = max(1, -(-size // out_bins))
    grid = torch.ceil(bin_sz).clamp(1.0, float(t))
    slots = torch.arange(out_bins * t, device=start.device)
    bins = (slots // t).to(start.dtype)
    p = (slots % t).to(start.dtype)
    # position of tap p in its bin: start + (bin + (p + 0.5) / grid) * bin_sz
    pos = start[..., None] + (bins + (p + 0.5) / grid[..., None]) * bin_sz[..., None]
    live = (p < grid[..., None]).to(start.dtype) / grid[..., None]
    taps = _roi_tap_matrix(pos, size) * live[..., None]
    return taps.reshape(*taps.shape[:-2], out_bins, t, size).sum(dim=-2)


def roi_align(features: torch.Tensor, boxes_xyxy: torch.Tensor, out_size: int,
              spatial_scale: float, rows: bool = False) -> torch.Tensor:
    """features (b, c, h, w); boxes_xyxy (b, o, 4) in image pixels ->
    crops (b, o, c, out_size, out_size). The tap matrices are built in the
    boxes' f32 and cast to the features' dtype. ``rows``: features is this
    rank's row shard, and the crops are summed over the model group."""
    h, w = features.shape[-2:]
    row0, full_h = data_mesh.row_window(h, rows)
    x0, y0, x1, y1 = (boxes_xyxy * spatial_scale).unbind(-1)  # each (b, o)
    roi_w = (x1 - x0).clamp_min(1.0)
    roi_h = (y1 - y0).clamp_min(1.0)
    ax = _axis_matrix(x0, roi_w, out_size, w).to(features.dtype)  # (b, o, out, w)
    ay = _axis_matrix(y0, roi_h, out_size, full_h)[..., row0:row0 + h].to(features.dtype)
    crops = torch.einsum("boxw,bocyw->bocyx", ax, torch.einsum("boyh,bchw->bocyw", ay, features))
    return data_mesh.model_sum(crops) if rows else crops


def dual_scale_roi_align(feat_small: torch.Tensor, feat_large: torch.Tensor,
                         boxes_xyxy: torch.Tensor, out_size: int, scale_small: float,
                         scale_large: float, size_threshold: float,
                         rows: tuple[bool, bool] = (False, False)) -> torch.Tensor:
    """The reference's small/large ROI routing as a select: boxes with both
    sides under ``size_threshold`` pixels crop the high-resolution map
    ``feat_small``, the rest ``feat_large``. Returns (b, o, c, out, out).
    ``rows``: whether each map is a row shard (``roi_align``)."""
    crops_s = roi_align(feat_small, boxes_xyxy, out_size, scale_small, rows[0])
    crops_l = roi_align(feat_large, boxes_xyxy, out_size, scale_large, rows[1])
    bw = boxes_xyxy[..., 2] - boxes_xyxy[..., 0]
    bh = boxes_xyxy[..., 3] - boxes_xyxy[..., 1]
    is_small = (bw < size_threshold) & (bh < size_threshold)
    return torch.where(is_small[:, :, None, None, None], crops_s, crops_l)
