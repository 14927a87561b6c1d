"""The numbers that decide ``correct``, and the readings behind them.

Train cells compare a side (the program, or a control or fault put in its
place) with the f32 reference over the first ``check_steps`` steps from the
same weights, batches, latents and dropout, per parameter (G and D apart):

- ``grad_gap``: the first step's gradient as each optimizer got it (from
  Adam's second moment after one step): |‖g_side‖ - ‖g_ref‖| / max(‖g_ref‖,
  the network's median ‖g_ref‖), taken at the 90th-percentile parameter: a
  gradient a little off on many parameters, as a lower precision gives.
- ``grad_gap_third``: the same gap at the third-worst parameter: a gradient
  off on three parameters or more, such as the ISLA norms' gamma and beta
  projections that one backward kernel feeds. The two worst are left out
  because they are nearly always the attention's geometry gate
  (``context.WGs.0``, weight and bias), whose gradient passes
  ``d log(relu(x)) = 1/x`` at x near 0 and so multiplies round-off: on an
  H100 it read up to 11.5 in sound bf16 COCO steps.
- ``grad_gap_d``: ``grad_gap`` over D's parameters alone. D's gradients do
  not pass the geometry gate, so at a batch where the gate's round-off
  reaches the 90th percentile of G's parameters (b=256 on an H100: PERF.md
  §6) D's still tell a lower precision from a sound run. Judged only in
  the cells whose limits name it (``OPTIONAL``).
- ``update_gap``: the same of each parameter's change over the steps, at the
  worst parameter, over those whose first reference gradient is at least a
  thousandth of the network's median (the others move by round-off alone
  under Adam). A step that leaves the state unchanged reads 1.

The losses are read but not compared: no control or fault separates them
from sound runs (PERF.md §6 gives the readings).

Sample cells compare the uint8 images of a seeded sample of the window's
batches with the reference's, in grey levels: ``image_rms_mean``, the mean
over images of each image's RMS difference (precision), and
``image_q25_worst``, the largest over images of the 25th percentile of the
absolute pixel differences: a different picture moves three quarters of its
pixels, while an image in which the attention's geometry gate flipped under
round-off differs in a region.
"""

from __future__ import annotations

import math
import statistics

import torch

MOVED = 1e-3  # of the median gradient: below it a parameter moves by round-off
OPTIONAL = ("grad_gap_d",)  # judged only where a cell's limits name them


def grad_norms(sq_sums: dict[str, torch.Tensor], beta2: float) -> dict[str, float]:
    """‖g‖ per parameter from the sums of Adam's second moment after one step."""
    return {k: math.sqrt(max(float(v), 0.0) / (1.0 - beta2)) for k, v in sq_sums.items()}


def delta_norms(now: dict[str, torch.Tensor], before: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float((now[k].detach().float() - before[k].float()).norm()) for k in before}


def _net(key: str) -> str:
    return key.split(".", 1)[0]


def _medians(norms: dict[str, float], keys) -> dict[str, float]:
    by: dict[str, list[float]] = {}
    for k in keys:
        by.setdefault(_net(k), []).append(norms[k])
    return {n: statistics.median(v) for n, v in by.items()}


def _gap(side: float, ref: float, scale: float) -> float:
    g = abs(side - ref) / max(ref, scale) if max(ref, scale) > 0 else abs(side - ref)
    return g if math.isfinite(g) else math.inf


def _quantile(values: list[float], q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


def train_numbers(side: dict, ref: dict) -> dict[str, float]:
    """side, ref: ``{"losses": [[d, g], ...], "grad": {name: ‖g‖}, "delta":
    {name: ‖Δ‖}}`` -> ``{"grad_gap", "grad_gap_d", "grad_gap_third",
    "update_gap"}``."""
    names = ("grad_gap", "grad_gap_d", "grad_gap_third", "update_gap")
    if set(side["grad"]) != set(ref["grad"]) or len(side["losses"]) != len(ref["losses"]):
        return dict.fromkeys(names, math.inf)
    keys = sorted(ref["grad"])
    gmed = _medians(ref["grad"], keys)
    gaps = [_gap(side["grad"][k], ref["grad"][k], gmed[_net(k)]) for k in keys]
    moved = [k for k in keys if ref["grad"][k] >= MOVED * gmed[_net(k)]]
    dmed = _medians(ref["delta"], moved)
    update = max(_gap(side["delta"][k], ref["delta"][k], dmed[_net(k)]) for k in moved)
    if not all(math.isfinite(x) for step in side["losses"] for x in step):
        return dict.fromkeys(names, math.inf)
    d_gaps = [g for k, g in zip(keys, gaps) if _net(k) == "D"]
    return {"grad_gap": _quantile(gaps, 0.9),
            "grad_gap_d": _quantile(d_gaps, 0.9) if d_gaps else math.inf,
            "grad_gap_third": sorted(gaps)[-3], "update_gap": update}


def image_numbers(side: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """Two stacks of uint8 (n, 3, h, w) images -> ``{"image_rms_mean",
    "image_q25_worst"}``."""
    d = side.to(torch.float64) - ref.to(torch.float64)
    rms = d.square().mean(dim=(1, 2, 3)).sqrt()
    q25 = d.abs().flatten(1).float().quantile(0.25, dim=1)
    return {"image_rms_mean": float(rms.mean()), "image_q25_worst": float(q25.max())}


def judged(numbers: dict[str, float], limits: dict[str, float]) -> dict[str, float]:
    """The numbers that ``limits`` judges: all but an ``OPTIONAL`` one it
    does not name."""
    return {k: v for k, v in numbers.items() if k in limits or k not in OPTIONAL}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[str]]:
    """Every judged number at or under its limit (a number without a limit,
    or a limit without a number, fails). Returns (correct, one line per
    number)."""
    numbers = judged(numbers, limits)
    lines, ok = [], bool(numbers)
    for k in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(k, math.inf), limits.get(k)
        good = lim is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        lines.append(f"check {k} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}")
    return ok, lines
