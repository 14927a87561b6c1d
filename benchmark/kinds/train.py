"""``train``: a closed loop of train steps on one device over a resident pool
of seeded batches, cycled.

Set-up builds the program's step once, runs the check steps through the
window's own call (their readings are what the check compares), then the
warm-up steps. The window runs steps until ``--seconds`` have passed; with
``--trace 1`` its first ``trace_units`` steps run under the profiler. After
the window the program is freed and the reference runs the check steps from
the same weights, batches, latents and dropout seeds.

The functions here take ``ranks`` (``reference/shard.py``) so that the
data-parallel kind (``kinds/ddp.py``) runs the same set-up, window and
check on each rank's shard of the global batch.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from benchmark import cells, check, log, spec, traffic
from benchmark import program as program_api
from benchmark.reference import shard
from benchmark.reference import step as ref

ONE = shard.Shard()


def batches(seed: int, cell: spec.Cell, device: torch.device, ranks: shard.Shard = ONE):
    """This rank's rows of the pool of global batches (``batch`` rows a rank;
    the other ranks' rows are freed)."""
    config = {**cell.config, "batch": cell.config["batch"] * ranks.world}
    pool = traffic.pool(seed, config, cell.traffic, device, images=True)
    if ranks.world == 1:
        return pool
    return [{k: ranks.rows(v).clone() for k, v in b.items()} for b in pool]


def program_train(cell: spec.Cell, seed: int, device: torch.device, api=program_api,
                  ranks: shard.Shard = ONE):
    """Build the program's step and run the check steps through the window's
    own call. Returns (what the check compares, the step as a unit of the
    window: ``unit(k)``, the program's handle)."""
    config, mix = cell.config, cell.traffic
    w = cells.draw_weights(config, seed, device)
    log("weights drawn")
    prog = api.build_train(config, w, device)
    del w
    log("program built")
    pool = batches(seed, cell, device, ranks)
    rng = torch.Generator(device=device)

    def unit(k: int):
        traffic.seed_unit(seed, k, rng, device)
        return prog.step(pool[k % len(pool)], rng)

    before = {k: p.detach().clone() for k, p in prog.params().items()}
    losses, grads = [], None
    for k in range(int(mix["check_steps"])):
        m = unit(k)
        losses.append((m["d_loss"], m["g_loss"]))
        if k == 0:
            grads = check.grad_norms(prog.grad_sq_sums(), prog.beta2)
    delta = check.delta_norms(prog.params(), before)
    del before
    log(f"{len(losses)} check steps run")
    side = {"losses": [[float(d), float(g)] for d, g in losses], "grad": grads, "delta": delta}
    return side, unit, prog


def reference_train(cell: spec.Cell, seed: int, device: torch.device, precision: str = "f32",
                    fault: str | None = None, ranks: shard.Shard = ONE) -> dict:
    """The reference's check steps from the same weights, batches, latents
    and dropout seeds: the same readings as ``program_train``'s."""
    config, mix = cell.config, cell.traffic
    compute = cells.COMPUTE[config["precision"]]
    with shard.use(ranks):
        nets = ref.build(config, device, precision, dropout_dtype=compute)
        w = cells.draw_weights(config, seed, device)
        for key, net in nets.items():
            net.load_state_dict(w[key])
        del w
        gen, disc = nets["G"], nets["D"]
        step = ref.TrainStep(gen, disc, nets.get("VGG"), hyper=config["train_config"],
                             fault=fault)
        named = {**{f"G.{n}": p for n, p in gen.named_parameters()},
                 **{f"D.{n}": p for n, p in disc.named_parameters()}}
        before = {k: p.detach().clone() for k, p in named.items()}
        pool = batches(seed, cell, device, ranks)
        rng = torch.Generator(device=device)
        b, o = config["batch"], config["slots"]
        losses, grads = [], None
        for k in range(int(mix["check_steps"])):
            traffic.seed_unit(seed, k, rng, device)
            z, z_im = ref.train_latents(rng, b, o, config["z_dim"], compute)
            m = step(pool[k % len(pool)], z, z_im)
            losses.append([float(m["d_loss"]), float(m["g_loss"])])
            if k == 0:
                sq = {f"G.{n}": v.sum() for (n, _), v in zip(gen.named_parameters(), step.g_opt.v)}
                sq.update({f"D.{n}": v.sum()
                           for (n, _), v in zip(disc.named_parameters(), step.d_opt.v)})
                grads = check.grad_norms(sq, step.h["beta2"])
        return {"losses": losses, "grad": grads, "delta": check.delta_norms(named, before)}


def window(unit: Callable[[int], dict], k0: int, seconds: float, traced: bool, mix: dict,
           device: torch.device, go: Callable[[float], bool] | None = None) -> dict:
    """The measured window: steps from unit ``k0`` on while ``go(elapsed)``
    (default: elapsed under ``seconds``), the first ``trace_units`` traced
    when asked. Returns the steps, the trace, the times and the last
    metrics."""
    go = go or (lambda elapsed: elapsed < seconds)
    n, tr, last = 0, None, None
    start = time.perf_counter()
    if traced:
        from benchmark import trace

        units = int(mix["trace_units"])
        tr = trace.capture(lambda i: unit(k0 + i), units, device)
        n = units
    traced_until = time.perf_counter()
    while go(time.perf_counter() - start):
        last = unit(k0 + n)
        n += 1
    cells.sync(device)
    end = time.perf_counter()
    finite = last is None or all(math.isfinite(float(last[k])) for k in ("d_loss", "g_loss"))
    return {"n": n, "trace": tr, "start": start, "traced_until": traced_until, "end": end,
            "finite": finite}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, api=program_api) -> dict:
    config, mix = cell.config, cell.traffic
    side, unit, prog = program_train(cell, seed, device, api)
    k0 = int(mix["check_steps"])
    for k in range(k0, k0 + int(mix["warmup_steps"])):
        unit(k)
    k0 += int(mix["warmup_steps"])
    cells.sync(device)
    setup_s = time.perf_counter() - t0
    log("warm-up done: window starts")
    peak_setup = cells.peak_bytes(device)
    cells.reset_peak(device)

    w = window(unit, k0, seconds, traced, mix, device)
    peak_window = cells.peak_bytes(device)
    del prog, unit
    cells.free(device)
    log(f"window done: {w['n']} steps")
    numbers = check.train_numbers(side, reference_train(cell, seed, device))
    log("reference done")
    n = w["n"]
    result = {"attempted": n, "failed": 0 if w["finite"] else n, "numbers": numbers,
              "finite": w["finite"], "peak": cells.max_of(peak_setup, peak_window)}
    if not traced:
        result["metrics"] = {"train_img_s": n * config["batch"] / (w["end"] - w["start"]),
                             "setup_s": setup_s}
        return result
    from benchmark import flops

    step_flops, calls = flops.train_work(config)
    ctx = cells.trace_ctx("train", w["trace"], mix, n, w["end"] - w["traced_until"], step_flops,
                          calls, config, peak_window)
    return {**result, **cells.per_layer(cell, ctx, w["trace"])}


def readings(cell: spec.Cell, seed: int, device: torch.device, control: bool, faults: bool,
             api=program_api, ranks: shard.Shard = ONE):
    """(side, the check's numbers, extra) for the calibration of the limits:
    the reference's own readings, the program's, and with ``control`` the
    fp8 reference's and with ``faults`` each planted fault's, all against
    the f32 reference."""
    t = time.perf_counter()
    side, unit, prog = program_train(cell, seed, device, api, ranks)
    del unit, prog
    cells.free(device)
    t_prog = time.perf_counter() - t
    t = time.perf_counter()
    want = reference_train(cell, seed, device, ranks=ranks)
    cells.free(device)
    yield "reference", {}, {"detail": want}
    yield "program", check.train_numbers(side, want), {"program_s": t_prog, "detail": side,
                                                       "reference_s": time.perf_counter() - t}
    if control:
        got = reference_train(cell, seed, device, precision="fp8", ranks=ranks)
        yield "control", check.train_numbers(got, want), {"detail": got}
        cells.free(device)
    if faults:
        for fault in ("half_batch",) + (("no_exchange",) if ranks.world > 1 else ()):
            got = reference_train(cell, seed, device, fault=fault, ranks=ranks)
            yield fault, check.train_numbers(got, want), {"detail": got}
            cells.free(device)


def calibrate(cell: spec.Cell, seeds, control, faults, device: torch.device, emit) -> None:
    for seed in seeds:
        for side, numbers, extra in readings(cell, seed, device, seed in control, seed in faults):
            emit(seed, side, numbers, extra)
