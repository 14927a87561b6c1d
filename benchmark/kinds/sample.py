"""``sample``: a closed loop of sampled batches on one device, one batch in
flight, over a pool of seeded layouts with fresh latents per batch; each
batch's images reach the host as uint8.

Set-up builds the served sampler and runs the warm-up batches. The window
samples until ``--seconds`` have passed, timing each batch from its dispatch
until its images are on the host, and keeps the images of a sample of
batches drawn from the seed. After the window the program is freed and the
reference draws the kept batches again from the same weights, layouts and
latents.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from benchmark import cells, check, log, spec, traffic
from benchmark import program as program_api
from benchmark.reference import step as ref


def kept(seed: int, j: int, every: int) -> bool:
    """Whether the window's ``j``-th batch is one the check compares."""
    return j == 0 or traffic.mix(seed, 7 << 20 | j) % every == 0


def kept_units(seed: int, mix: dict) -> list[int]:
    """The units the check compares when the window runs long enough."""
    k0, ks, j = int(mix["warmup_batches"]), [], 0
    while len(ks) < int(mix["check_batches"]):
        if kept(seed, j, int(mix["check_every"])):
            ks.append(k0 + j)
        j += 1
    return ks


def sampler_unit(cell: spec.Cell, seed: int, device: torch.device,
                 api=program_api) -> Callable[[int], torch.Tensor]:
    """The program's sampler as the window's unit: ``unit(k)`` samples layout
    batch ``k`` of the pool with unit ``k``'s latents and returns its uint8
    images on the host."""
    config = cell.config
    w = cells.draw_weights(config, seed, device, parts=("G",))
    log("weights drawn")
    prog = api.build_sampler(config, w, device)
    del w
    log("program built")
    layouts = traffic.pool(seed, config, cell.traffic, device, images=False)
    rng = torch.Generator(device=device)

    def unit(k: int) -> torch.Tensor:
        traffic.seed_unit(seed, k, rng, device)
        lay = layouts[k % len(layouts)]
        return ref.to_uint8(prog.sample(lay["boxes"], lay["labels"], rng)).cpu()

    return unit


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, api=program_api) -> dict:
    config, mix = cell.config, cell.traffic
    unit = sampler_unit(cell, seed, device, api)
    k0 = int(mix["warmup_batches"])
    for k in range(k0):
        unit(k)
    cells.sync(device)
    setup_s = time.perf_counter() - t0
    log("warm-up done: window starts")
    peak_setup = cells.peak_bytes(device)
    cells.reset_peak(device)

    n, tr, lat, images_kept = 0, None, [], {}
    want, every = int(mix["check_batches"]), int(mix["check_every"])
    start = time.perf_counter()
    if traced:
        from benchmark import trace

        units = int(mix["trace_units"])
        tr = trace.capture(lambda i: unit(k0 + i), units, device)
        n = units
    traced_until = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        images = unit(k0 + n)
        lat.append(time.perf_counter() - t)
        if len(images_kept) < want and kept(seed, n, every):
            images_kept[k0 + n] = images
        n += 1
    end = time.perf_counter()
    peak_window = cells.peak_bytes(device)
    del unit
    cells.free(device)

    numbers, failed = reference_sample_gaps(cell, seed, device, images_kept)
    result = {"attempted": n, "failed": failed, "numbers": numbers,
              "finite": True, "peak": cells.max_of(peak_setup, peak_window)}
    if not traced:
        result["metrics"] = {"sample_img_s": n * config["batch"] / (end - start),
                             "setup_s": setup_s}
        return result
    from benchmark import flops

    batch_flops, calls = flops.sample_work(config)
    ctx = cells.trace_ctx("sample", tr, mix, n, end - traced_until, batch_flops, calls, config,
                          peak_window, latencies=lat)
    return {**result, **cells.per_layer(cell, ctx, tr)}


def reference_images(cell: spec.Cell, seed: int, device: torch.device, ks,
                     precision: str = "f32") -> dict[int, torch.Tensor]:
    """The reference's uint8 images of units ``ks`` (same weights, layouts
    and latents as the program's)."""
    config, mix = cell.config, cell.traffic
    gen = ref.build(config, device, precision, parts=("G",))["G"]
    gen.load_state_dict(cells.draw_weights(config, seed, device, parts=("G",))["G"])
    layouts = traffic.pool(seed, config, mix, device, images=False)
    rng = torch.Generator(device=device)
    out = {}
    for k in ks:
        traffic.seed_unit(seed, k, rng, device)
        z, z_im = ref.truncated_latents(rng, config["batch"], config["slots"], config["z_dim"],
                                        config["truncation"])
        lay = layouts[k % len(layouts)]
        out[k] = ref.to_uint8(ref.sample(gen, lay["boxes"], lay["labels"], z, z_im)).cpu()
    return out


def reference_sample_gaps(cell: spec.Cell, seed: int, device: torch.device,
                          images_kept: dict[int, torch.Tensor]) -> tuple[dict[str, float], int]:
    """(the check's numbers over every kept image, how many kept batches
    alone hold a number over its limit)."""
    if not images_kept:
        return {"image_rms_mean": math.inf, "image_q25_worst": math.inf}, 0
    ks = sorted(images_kept)
    want = reference_images(cell, seed, device, ks)
    numbers = check.image_numbers(torch.cat([images_kept[k] for k in ks]),
                                  torch.cat([want[k] for k in ks]))
    failed = sum(not check.judge(check.image_numbers(images_kept[k], want[k]), cell.limits)[0]
                 for k in ks)
    return numbers, failed


def readings(cell: spec.Cell, seed: int, device: torch.device, control: bool, faults: bool,
             api=program_api):
    """(side, numbers, extra) for the calibration of the limits: the
    program's kept batches (through the window's own unit), with
    ``control`` the fp8 reference's, and with ``faults`` the altered and
    half-produced answers, each against the f32 reference."""
    ks = kept_units(seed, cell.traffic)
    t = time.perf_counter()
    unit = sampler_unit(cell, seed, device, api)
    got = {k: unit(k) for k in ks}
    del unit
    cells.free(device)
    t_prog = time.perf_counter() - t
    t = time.perf_counter()
    want = reference_images(cell, seed, device, ks)

    def worst(images):
        side = torch.cat([images[k] for k in ks])
        ref_images = torch.cat([want[k] for k in ks])
        d = (side.to(torch.float64) - ref_images.to(torch.float64)).abs().flatten(1)
        return {**check.image_numbers(side, ref_images),
                "image_rms_worst": float(d.square().mean(dim=1).sqrt().max()),
                "image_mad_worst": float(d.median(dim=1).values.max())}

    yield "program", worst(got), {"program_s": t_prog, "reference_s": time.perf_counter() - t}
    if control:
        yield "control", worst(reference_images(cell, seed, device, ks, "fp8")), {}
    if faults:
        altered = {k: torch.cat([v[1:2], v[1:]]) for k, v in want.items()}
        yield "altered", worst(altered), {}
        half = {k: torch.cat([v[: len(v) // 2], torch.zeros_like(v[len(v) // 2:])])
                for k, v in want.items()}
        yield "half_batch", worst(half), {}


def calibrate(cell: spec.Cell, seeds, control, faults, device: torch.device, emit) -> None:
    for seed in seeds:
        for side, numbers, extra in readings(cell, seed, device, seed in control, seed in faults):
            emit(seed, side, numbers, extra)
