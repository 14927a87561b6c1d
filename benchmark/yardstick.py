"""The benchmark's fixed arithmetic: the card's peaks, the kernel classes,
the ISLA norm's byte counts, the reduction of a device trace to busy time,
idle gaps and class sums, and shares of a roofline or a peak.

Frozen copies: ``PROFILE_GROUPS`` and the byte formulas are those of the
port's ``chip_smoke.py`` (``PROFILE_GROUPS``, ``isla_cost``,
``isla_bwd_cost``) at the time the benchmark was written; the program may
change, these do not.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# kernel classes by marks in their names; the first match wins
PROFILE_GROUPS = (
    ("ISLA", ("isla_norm",)),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions (cuDNN)", ("xmma", "cudnn", "conv", "implicit_gemm", "winograd", "fft")),
    ("GEMMs (cuBLAS)", ("gemm", "cutlass", "sm90_", "ampere_", "Kernel2")),
    ("pooling", ("pool", "adaptive_avg", "atomic_adaptive")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "CatArrayBatched")),
)
ISLA_FORWARD = "isla_norm_kernel"
ISLA_BACKWARD = "isla_norm_bwd"


class ShareError(ValueError):
    """A share of a roofline or peak above 100%: the work is counted too
    high or the time leaves part of it out."""


@dataclasses.dataclass(frozen=True)
class Event:
    """One device operation of a trace (seconds on the trace's clock)."""

    name: str
    start: float
    dur: float
    kernel: bool = True  # False: a memcpy or memset

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass(frozen=True)
class HostOp:
    """One host operation of a trace: what the host was doing."""

    name: str
    start: float
    dur: float


def kernel_class(name: str) -> str:
    return next((g for g, marks in PROFILE_GROUPS if any(m in name for m in marks)), "other")


def class_seconds(events: list[Event]) -> dict[str, float]:
    """Device seconds per kernel class, kernels only."""
    out: dict[str, float] = {}
    for e in events:
        if e.kernel:
            k = kernel_class(e.name)
            out[k] = out.get(k, 0.0) + e.dur
    return out


def seconds_where(events: list[Event], pred) -> float:
    return sum(e.dur for e in events if e.kernel and pred(e.name))


def busy_intervals(events: list[Event]) -> list[tuple[float, float]]:
    """The union of the events' intervals, merged and sorted."""
    spans = sorted((e.start, e.end) for e in events)
    merged: list[list[float]] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_seconds(events: list[Event]) -> float:
    return sum(t - s for s, t in busy_intervals(events))


def idle_gaps(events: list[Event], host: list[HostOp], start: float, end: float,
              top: int = 10) -> list[tuple[str, float]]:
    """The ``top`` longest spans of [start, end] with no device operation,
    each named by the innermost host operation running at its middle."""
    gaps, at = [], start
    for s, t in busy_intervals(events):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if end > at:
        gaps.append((at, end))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, t in gaps[:top]:
        mid = 0.5 * (s + t)
        inner = [h for h in host if h.start <= mid <= h.start + h.dur]
        name = min(inner, key=lambda h: h.dur).name if inner else "host: between operators"
        out.append((name, t - s))
    return out


def share_pct(least_seconds: float, seconds: float) -> float:
    """100 x the least time the work needs over the time it took; raises
    ``ShareError`` above 100."""
    if seconds <= 0:
        raise ShareError(f"no time measured for {least_seconds} s of least time")
    pct = 100.0 * least_seconds / seconds
    if pct > 100.0:
        raise ShareError(f"share {pct:.3f}% over 100%: {least_seconds} s least against "
                         f"{seconds} s measured")
    return pct


def isla_forward_bytes(x_shape: tuple[int, ...], mask_shape: tuple[int, ...], itemsize: int) -> int:
    """One ISLA norm call: x read and the output written once; the source
    mask, gamma and beta read once (itemsize each); the two f32 statistics."""
    b, c, h, w = x_shape
    o = mask_shape[1]
    numel = b * c * h * w
    mask = b * o * mask_shape[2] * mask_shape[3]
    return itemsize * (2 * numel + mask + 2 * b * o * c) + 2 * 4 * c


def isla_backward_bytes(x_shape: tuple[int, ...], mask_shape: tuple[int, ...], itemsize: int) -> int:
    """One ISLA backward: x and the output gradient read, dx written; the
    source mask read and its gradient written; gamma and beta read and their
    gradients written; the statistics read and theirs written (f32)."""
    b, c, h, w = x_shape
    o = mask_shape[1]
    numel = b * c * h * w
    mask = b * o * mask_shape[2] * mask_shape[3]
    return itemsize * (3 * numel + 2 * mask + 4 * b * o * c) + 4 * 4 * c
