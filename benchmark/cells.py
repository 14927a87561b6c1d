"""What every kind of traffic shares: the device's clock and memory, the
seeded weights, and the reduction of a traced stretch to the cell's
per-layer metrics. The kinds themselves are ``kinds/<kind>.py``, found by
the ``kind`` of a traffic file (``spec.kind``): each builds the program
from the cell's configuration, runs its check units and warm-up as set-up,
measures ``--seconds``, optionally traces a fixed number of units at the
window's start, then frees the program and runs the reference for the
check.
"""

from __future__ import annotations

import gc
from types import SimpleNamespace

import torch

from benchmark import spec, traffic, weights, yardstick
from benchmark.reference import step as ref

COMPUTE = {"bf16": torch.bfloat16, "f32": torch.float32}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int | None:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def draw_weights(config: dict, seed: int, device: torch.device, parts=("G", "D", "VGG")) -> dict:
    """The seeded state dicts of the configuration's networks (those of
    ``parts`` it has), drawn on the device."""
    nets = ref.build(config, "meta", parts=parts)
    streams = {"G": traffic.WEIGHTS_G, "D": traffic.WEIGHTS_D, "VGG": traffic.WEIGHTS_VGG}
    return {k: weights.draw(net.state_dict(), traffic.mix(seed, streams[k]), device)
            for k, net in nets.items()}


def max_of(*xs):
    xs = [x for x in xs if x is not None]
    return max(xs) if xs else None


def trace_ctx(kind, tr, mix, n, rest_s, unit_flops, calls, config, peak_window, latencies=(),
              chips=1):
    """What a metric reader reads: the trace of the window's first units, the
    untraced rest of the window (its units, seconds and, when sampling, each
    batch's latency), the work counted from the reference (a unit's, over
    every chip), the chips that share it, the window's peak."""
    events, host, traced_s = tr
    units = int(mix["trace_units"])
    return SimpleNamespace(kind=kind, events=events, host=host, traced_s=traced_s,
                           traced_units=units, rest_units=n - units, rest_s=rest_s,
                           latencies=list(latencies), flops_per_unit=unit_flops,
                           isla_calls=calls, itemsize=COMPUTE[config["precision"]].itemsize,
                           peak_window_bytes=peak_window, chips=chips)


def per_layer(cell: spec.Cell, ctx: SimpleNamespace, tr) -> dict:
    """The cell's per-layer metrics that find something to read in ``ctx``,
    the trace's busy and traced seconds, and its breakdown."""
    metrics = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    events, host, traced_s = tr
    out = {"metrics": metrics, "busy_s": yardstick.busy_seconds(events), "window_s": traced_s}
    if events:
        classes = sorted(yardstick.class_seconds(events).items(), key=lambda kv: -kv[1])[:10]
        start = min(e.start for e in [*events, *host])
        end = max(e.start + e.dur for e in [*events, *host])
        out["breakdown"] = {"device_ops": [[k, v] for k, v in classes],
                            "idle_gaps": [[k, v] for k, v in
                                          yardstick.idle_gaps(events, host, start, end)]}
    return out
