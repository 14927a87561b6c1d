"""The port's spans, at the layer boundaries of the train step, the sampler,
the collectives and the data feed.

    with tracing.span("train.d_forward", role="real"):
        out = disc(images, boxes, labels)

Spans are off unless a ``torch.profiler`` session is active in the process
(``torch.autograd._profiler_enabled()``) or ``enable(True)`` was called.
``enable(False)`` forces them off even under a profiler, to measure what
they cost there (it is the same flag, no code of its own); ``enable(None)``
restores the automatic mode. Off, ``span`` returns a shared null context
after two flag checks: no ``record_function``, no allocation, no record.
Under ``torch.compile`` or ``torch.export`` tracing they are always off, so
no graph holds a profiler op.

On, a span enters ``torch.profiler.record_function(name)``, so a profiler
trace (``cli.train --profile_dir``) shows it over its kernels, and when it
closes it appends a ``Record`` to an in-memory ring of the newest ``RING``
records, which nothing writes out: ``records`` reads it, ``clear`` empties
it. A record holds the name and attributes; its host start and end in ns on
``time.time_ns``, the wall clock that ``torch.profiler``'s events carry, so
a device trace can be laid against the host spans; and, once the process
has initialised CUDA, two CUDA events recorded on the current stream at
entry and exit, which the record holds until the ring drops it (so the ring
is short: at most ``2 * RING`` events).

``device_ms(record)`` resolves those events after the caller has
synchronised: the time the stream took from finishing the work enqueued
before the span to finishing the span's own, so it includes the device's
idle time waiting for the span's dispatch. Without CUDA it is the host time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

RING = 4096  # records kept, the newest

_NULL = contextlib.nullcontext()
_forced: bool | None = None
_ring: collections.deque = collections.deque(maxlen=RING)


@dataclasses.dataclass(eq=False)
class Record:
    """One closed span. ``start_ns``/``end_ns``: host clock (``time.time_ns``)."""

    name: str
    attrs: dict
    start_ns: int
    end_ns: int = 0
    events: tuple | None = None  # (start, end) CUDA events, or None off CUDA


def enable(on: bool | None) -> None:
    """True: spans on; False: off even under a profiler; None: on exactly
    while a ``torch.profiler`` session is active (the default)."""
    global _forced
    _forced = on


def span(name: str, **attrs):
    """A context that records the span ``name`` with ``attrs`` when tracing
    is on, else a shared null context."""
    if torch.compiler.is_compiling():  # first: dynamo cannot trace the profiler's flag
        return _NULL
    if not (torch.autograd._profiler_enabled() if _forced is None else _forced):
        return _NULL
    return _Span(name, attrs)


def records(t0_ns: int | None = None, t1_ns: int | None = None) -> list[Record]:
    """The ring's records whose host interval overlaps [t0_ns, t1_ns] (either
    end open when None), in the order they closed."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [r for r in list(_ring) if r.end_ns >= lo and r.start_ns <= hi]


def clear() -> None:
    _ring.clear()


def device_ms(record: Record) -> float:
    """The record's device ms (its host ms without CUDA); call after the
    device has finished the span's work."""
    if record.events is None:
        return (record.end_ns - record.start_ns) * 1e-6
    return record.events[0].elapsed_time(record.events[1])


class _Span:
    __slots__ = ("rf", "rec")

    def __init__(self, name: str, attrs: dict):
        self.rec = Record(name, attrs, 0)

    def __enter__(self) -> Record:
        rec = self.rec
        rec.start_ns = time.time_ns()  # before the annotation: its first entry is slow
        if torch.cuda.is_initialized():  # the start event next, a few us after start_ns
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        self.rf = torch.profiler.record_function(rec.name)
        self.rf.__enter__()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time.time_ns()
        _ring.append(rec)
        self.rf.__exit__(*exc)
