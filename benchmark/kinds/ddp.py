"""``ddp``: the ``train`` loop as data-parallel ranks, one process per chip
of the cell, under the program's ``parallel/mesh.py`` (NCCL on CUDA, gloo on
the CPU): each rank steps on its ``batch`` rows of a global batch of
``batch`` x chips, with global BN statistics and one gradient all-reduce a
network, as ``cli.train`` runs under ``torchrun``.

Its rate is ``train_img_s.ddp``: every rank's images over rank 0's window,
bounded apart from one chip's ``train_img_s``, whose runs spread less.

This process launches the ranks (``torch.multiprocessing``, spawned, a
``tcp://localhost`` rendezvous on a free port) and waits for each; it
touches no device. Every rank runs ``kinds/train.py``'s set-up on its shard;
rank 0's clock opens and closes the window, and every step it tells the
other ranks over a gloo group whether to run another, so that all run the
same steps. After the window the reference runs as the same ranks
(``reference/shard.py``) and rank 0 compares. Rank 0 reports the rate, the
set-up and the traced metrics; every rank reports its memory peak, its
traced busy seconds and the JAX modules it holds, which this process
merges: the fullest chip's peak, the mean busy seconds, every module.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import time
import traceback

import torch

from benchmark import cells, check, log, spec
from benchmark import program as program_api
from benchmark.kinds import train
from benchmark.reference import shard

RANK_TIMEOUT_S = 600.0  # a collective that waits longer than this fails the run


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(cell: spec.Cell, job: str, args: tuple, device_type: str, on_row=None) -> dict:
    """Run ``job`` on ``cell.chips`` ranks; returns each rank's final piece.
    Rows that a rank sends on the way go to ``on_row``. A rank that fails
    ends every rank and raises here."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    messages = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, cell.chips, port, device_type, job, cell, args,
                                             messages), daemon=False)
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    pieces: dict[int, dict] = {}
    error = None
    try:
        while len(pieces) < len(procs) and error is None:
            try:
                msg = messages.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                continue
            if msg[0] == "row" and on_row is not None:
                on_row(*msg[1:])
            elif msg[0] == "done":
                pieces[msg[1]] = msg[2]
            elif msg[0] == "error":
                error = f"rank {msg[1]} failed:\n{msg[2]}"
    finally:
        if error is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
        messages.close()
        messages.join_thread()
    if error is not None:
        raise RuntimeError(error)
    return pieces


def _rank(rank: int, world: int, port: int, device_type: str, job: str, cell: spec.Cell,
          args: tuple, messages) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cpu":
        torch.set_num_threads(max(1, min(4, torch.get_num_threads() // world)))
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    api = args[-1] or program_api  # None: the program itself (a module does not pickle)
    try:
        import torch.distributed as dist

        api.init_ranks(device, RANK_TIMEOUT_S)
        control = dist.new_group(backend="gloo") if device_type == "cuda" else dist.group.WORLD
        ranks = shard.Shard(rank, world, dist.group.WORLD)
        try:
            piece = JOBS[job](cell, *args[:-1], device=device, api=api, ranks=ranks,
                              control=control, messages=messages)
        finally:
            api.shutdown_ranks()
        from benchmark.run import forbidden_modules

        piece["forbidden"] = forbidden_modules()
        if device_type == "cuda":
            piece["kind"] = torch.cuda.get_device_name(device)
        messages.put(("done", rank, piece))
    except BaseException:
        messages.put(("error", rank, traceback.format_exc()))
        raise


def _run_rank(cell: spec.Cell, seed: int, seconds: float, traced: bool, t0: float, *,
              device, api, ranks: shard.Shard, control, messages) -> dict:
    import torch.distributed as dist

    config, mix = cell.config, cell.traffic
    side, unit, prog = train.program_train(cell, seed, device, api, ranks)
    k0 = int(mix["check_steps"])
    for k in range(k0, k0 + int(mix["warmup_steps"])):
        unit(k)
    k0 += int(mix["warmup_steps"])
    cells.sync(device)
    dist.barrier(group=control)
    setup_s = time.perf_counter() - t0
    if ranks.rank == 0:
        log("warm-up done on every rank: window starts")
    peak_setup = cells.peak_bytes(device)
    cells.reset_peak(device)
    flag = torch.zeros(1)

    def go(elapsed: float) -> bool:  # rank 0's clock decides for every rank
        flag[0] = 1.0 if elapsed < seconds else 0.0
        dist.broadcast(flag, 0, group=control)
        return bool(flag[0] > 0)

    w = train.window(unit, k0, seconds, traced, mix, device, go)
    peak_window = cells.peak_bytes(device)
    del prog, unit
    cells.free(device)
    want = train.reference_train(cell, seed, device, ranks=ranks)
    piece = {"peak": cells.max_of(peak_setup, peak_window)}
    if w["trace"] is not None:
        from benchmark import yardstick

        piece["busy_s"] = yardstick.busy_seconds(w["trace"][0])
    if ranks.rank != 0:
        return piece
    log(f"window done: {w['n']} steps; reference done")
    n, batch = w["n"], config["batch"] * ranks.world
    result = {"attempted": n, "failed": 0 if w["finite"] else n,
              "numbers": check.train_numbers(side, want), "finite": w["finite"]}
    if not traced:
        result["metrics"] = {"train_img_s.ddp": n * batch / (w["end"] - w["start"]),
                             "setup_s": setup_s}
    else:
        from benchmark import flops

        step_flops, calls = flops.train_work(config)
        ctx = cells.trace_ctx("train", w["trace"], mix, n, w["end"] - w["traced_until"],
                              step_flops * ranks.world, calls, config, peak_window,
                              chips=ranks.world)
        result.update(cells.per_layer(cell, ctx, w["trace"]))
    return {**piece, "result": result}


def _calibrate_rank(cell: spec.Cell, seeds, control_seeds, fault_seeds, *, device, api,
                    ranks: shard.Shard, control, messages) -> dict:
    for seed in seeds:
        for side, numbers, extra in train.readings(cell, seed, device, seed in control_seeds,
                                                   seed in fault_seeds, api, ranks):
            if ranks.rank == 0:
                messages.put(("row", seed, side, numbers, extra))
    return {}


JOBS = {"run": _run_rank, "calibrate": _calibrate_rank}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, api=program_api) -> dict:
    pieces = _launch(cell, "run", (seed, seconds, traced, t0, None if api is program_api else api),
                     device.type)
    out = pieces[0]["result"]
    out["peak"] = cells.max_of(*(p["peak"] for p in pieces.values()))
    out["forbidden"] = sorted({m for p in pieces.values() for m in p["forbidden"]})
    if "kind" in pieces[0]:
        out["kind"] = pieces[0]["kind"]
    if traced:
        out["busy_s"] = sum(p["busy_s"] for p in pieces.values()) / len(pieces)
    return out


def calibrate(cell: spec.Cell, seeds, control, faults, device: torch.device, emit) -> None:
    _launch(cell, "calibrate", (list(seeds), set(control), set(faults), None),
            device.type, on_row=emit)
