"""The program's own spans over a traced stretch, for the readers of
``metrics/``: the records of ``layout2img_tpu_torch.utils.tracing`` that
overlap the traced window, whose bounds are the first and last device event
or host operation of the trace (seconds on ``torch.profiler``'s clock, the
wall clock the records carry too). Spans record only while the profiler
runs, so they are the traced units'. This module and ``program.py`` are the
harness's only imports of the program.

A span's time here is the device's busy time inside the span's device
interval: from the moment the stream reached the span's start event to the
moment it reached its end event. On one stream that interval holds the
span's device work and nothing else, so its busy time is the span's kernel
time, without the stretches in which the card waited for the host's
dispatch. The CUDA events give each interval's offset from the window's
first start event; that event's own time on the trace's clock is the
latest of the lower bounds the window's records give, since an event
completes no sooner than the host recorded it, after the record's
``start_ns``, and the bound is tight for any span that opened while the
stream was idle. A record without CUDA events (on the CPU) counts its host
interval.

A program without the tracing module, or a trace in which it recorded
nothing, reads as no records: every function here then returns None, so
the readers return None.
"""

from __future__ import annotations

import bisect
import itertools
import statistics
from typing import Callable

from benchmark import yardstick

ROOTS = ("train.step", "sample")  # the spans that open a unit of the trace


def _tracing():
    try:
        from layout2img_tpu_torch.utils import tracing
    except ImportError:  # a program without spans
        return None
    return tracing


def bounds(ctx) -> tuple[float, float] | None:
    """(start, end) of the traced window in seconds, from its events."""
    spans = [(e.start, e.start + e.dur) for e in [*ctx.events, *ctx.host]]
    if not spans:
        return None
    return min(s for s, _ in spans), max(t for _, t in spans)


def records(ctx) -> list:
    """The program's records of the traced window (empty without spans)."""
    tracing, window = _tracing(), bounds(ctx)
    if tracing is None or window is None:
        return []
    return tracing.records(int(window[0] * 1e9), int(window[1] * 1e9))


def _matching(recs: list, name: str, attrs: dict) -> list:
    return [r for r in recs if r.name == name
            and all(r.attrs.get(k) == v for k, v in attrs.items())]


def _units(recs: list) -> int:
    return sum(r.name in ROOTS for r in recs)


def device_intervals(recs: list) -> list[tuple[float, float]]:
    """Each record's device interval, (start, end) in seconds on the trace's
    clock; a record without CUDA events gives its host interval."""
    timed = [r for r in recs if r.events is not None]
    out = {id(r): (r.start_ns * 1e-9, r.end_ns * 1e-9) for r in recs if r.events is None}
    if timed:
        anchor = min(timed, key=lambda r: r.start_ns).events[0]
        offsets = {id(r): (1e-3 * anchor.elapsed_time(r.events[0]),
                           1e-3 * anchor.elapsed_time(r.events[1])) for r in timed}
        at = max(r.start_ns * 1e-9 - offsets[id(r)][0] for r in timed)
        out.update({k: (at + s, at + t) for k, (s, t) in offsets.items()})
    return [out[id(r)] for r in recs]


def _busy_before(events: list) -> Callable[[float], float]:
    """x -> the device's busy seconds before x, over ``events``."""
    merged = yardstick.busy_intervals(events)
    starts = [s for s, _ in merged]
    total = list(itertools.accumulate((t - s for s, t in merged), initial=0.0))

    def before(x: float) -> float:
        i = bisect.bisect_right(starts, x)
        return 0.0 if i == 0 else total[i - 1] + min(x, merged[i - 1][1]) - starts[i - 1]

    return before


def busy_ms(ctx, recs: list) -> list[float]:
    """Each record's busy device ms inside its device interval (its host ms
    without CUDA events)."""
    before = _busy_before(ctx.events)
    return [1e3 * (t - s if r.events is None else before(t) - before(s))
            for r, (s, t) in zip(recs, device_intervals(recs))]


def ms_per_unit(ctx, name: str, **attrs) -> float | None:
    """Busy device ms a traced unit in the spans ``name`` whose attributes
    include ``attrs``; None without units or such spans."""
    recs = records(ctx)
    mine, units = _matching(recs, name, attrs), _units(recs)
    if not mine or not units:
        return None
    busy = dict(zip(map(id, recs), busy_ms(ctx, recs)))  # every record places the window
    return sum(busy[id(r)] for r in mine) / units


def spans_per_unit(ctx, name: str) -> float | None:
    """The number of spans ``name`` a traced unit."""
    recs = records(ctx)
    mine, units = _matching(recs, name, {}), _units(recs)
    return len(mine) / units if mine and units else None


def median_host_ms(ctx, name: str) -> float | None:
    """The median host ms of the spans ``name``."""
    mine = _matching(records(ctx), name, {})
    return statistics.median((r.end_ns - r.start_ns) * 1e-6 for r in mine) if mine else None


def _gaps(ctx) -> list[tuple[float, float]]:
    """Every stretch of the window with no device operation (seconds), as
    ``yardstick.idle_gaps`` finds them."""
    start, end = bounds(ctx)
    gaps, at = [], start
    for s, t in yardstick.busy_intervals(ctx.events):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if end > at:
        gaps.append((at, end))
    return gaps


def idle_in(ctx, name: str) -> float | None:
    """Device idle seconds of the window in the gaps whose midpoint falls
    inside the host interval of a span ``name``."""
    mine = [(r.start_ns * 1e-9, r.end_ns * 1e-9) for r in _matching(records(ctx), name, {})]
    if not mine:
        return None
    return sum(t - s for s, t in _gaps(ctx)
               if any(a <= 0.5 * (s + t) <= b for a, b in mine))
