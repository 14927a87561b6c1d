"""A traced stretch of a run: ``torch.profiler`` over a fixed number of
units (steps or batches), reduced to the device's operations and the host's.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from benchmark.yardstick import Event, HostOp


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture(unit: Callable[[int], object], units: int, device: torch.device):
    """Run ``unit(0..units-1)`` under the profiler, then wait for the
    device. Returns (device events, host operations, traced seconds on the
    host's clock, from the first dispatch to the end of the wait)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            unit(i)
        _sync(device)
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(Event(name, start, dur, kernel=not name.startswith(("Memcpy", "Memset"))))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(HostOp(name, start, dur))
    return dev, host, window
