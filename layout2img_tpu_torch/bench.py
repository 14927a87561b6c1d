"""Benchmark of the port's train step (counterpart of the JAX package's
``bench.py``): the full GAN train step (G + D, hinge + pixel + VGG
perceptual) of one generator preset (default the flagship Ours-D context
configuration at 128x128) on the GPU. The image size follows the preset,
and D is ``LayoutDiscriminator(image_size=size, app_head=True)``, as the
JAX bench builds it.

    python -m layout2img_tpu_torch.bench
    BENCH_OBJ=31 BENCH_CLASSES=179 BENCH_VALID_MAX=10 BENCH_D_OBJ_BUDGET=12 \\
        BENCH_G_OBJ_BUDGET=12 python -m layout2img_tpu_torch.bench  # VG shape

Prints ONE JSON line, with the JAX bench's metric name and keys:
  {"metric": "gan_train_step_images_per_sec_<size>px", "value": N,
   "unit": "img/s/chip", "vs_baseline": N, "baseline": "..."}
and logs to stderr the card (``nvidia-smi``'s name and power limit), the
step's median and quartile ms and the peak memory.

The environment knobs are the JAX bench's, with its defaults:
``BENCH_BATCH`` (128), ``BENCH_MODEL`` (ours_d_context128; any of the
nine generator presets of ``models/generators.py``), ``BENCH_CLASSES``
(184), ``BENCH_OBJ`` (8 slots), ``BENCH_VALID_MAX`` (0: all; else the real
objects per layout, the rest pad slots, as VG's o=31 with 6-10 objects),
``BENCH_MIXED`` (1: bf16 compute over f32 masters; 0: f32 with TF32 off),
``BENCH_FUSED_D`` (0), ``BENCH_REMAT`` (none), ``BENCH_REMAT_D_BLOCKS`` (0),
``BENCH_D_OBJ_BUDGET`` and ``BENCH_G_OBJ_BUDGET`` (0). ``BENCH_SCAN`` x
``BENCH_SCANS`` (10 x 3) is the number of timed steps: each is timed by CUDA
events after ``BENCH_SCAN`` warm-up steps, and the value is the batch over
the median step. Weights are seeded and random (the JAX bench's too); the
batch is one synthetic batch, drawn once.

It runs on the card. ``--device cpu`` (timed by the host's clock),
``--ch`` and ``--no_vgg`` are for tests at a small width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

TORCH_GPU_BASELINE_IMG_S = 25.0  # the JAX bench's divisor, an estimate
BASELINE = "estimated 25 img/s torch-GPU (reference publishes no throughput)"
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    batch: int = 128
    scan: int = 10
    scans: int = 3
    model: str = "ours_d_context128"
    classes: int = 184
    obj: int = 8
    valid_max: int = 0
    mixed: bool = True
    fused_d: bool = False
    remat: str = "none"
    remat_d_blocks: int = 0
    d_obj_budget: int = 0
    g_obj_budget: int = 0
    ch: int = 64
    vgg: bool = True


def config_from_env(env=None) -> BenchConfig:
    """The ``BENCH_*`` knobs of ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env
    return BenchConfig(
        batch=int(env.get("BENCH_BATCH", "128")), scan=int(env.get("BENCH_SCAN", "10")),
        scans=int(env.get("BENCH_SCANS", "3")),
        model=env.get("BENCH_MODEL", "ours_d_context128"),
        classes=int(env.get("BENCH_CLASSES", "184")), obj=int(env.get("BENCH_OBJ", "8")),
        valid_max=int(env.get("BENCH_VALID_MAX", "0")), mixed=env.get("BENCH_MIXED", "1") == "1",
        fused_d=env.get("BENCH_FUSED_D", "0") == "1", remat=env.get("BENCH_REMAT", "none"),
        remat_d_blocks=int(env.get("BENCH_REMAT_D_BLOCKS", "0")),
        d_obj_budget=int(env.get("BENCH_D_OBJ_BUDGET", "0")),
        g_obj_budget=int(env.get("BENCH_G_OBJ_BUDGET", "0")))


def card_line() -> str:
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build(cfg: BenchConfig, device: torch.device) -> SimpleNamespace:
    """The models (seeded), the train state and step, the synthetic batch
    and the latent generator of ``cfg`` on ``device``."""
    from layout2img_tpu_torch.data.synthetic import PAD_BOX, synthetic_batch
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.models.generators import obj_budget_error
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator, init_vgg

    log(f"building models (model={cfg.model}, batch={cfg.batch}, steps={cfg.scan}x{cfg.scans}, "
        f"mixed={cfg.mixed}, remat={cfg.remat}, fused_d={cfg.fused_d}, obj={cfg.obj}, "
        f"valid_max={cfg.valid_max}, budgets g={cfg.g_obj_budget} d={cfg.d_obj_budget})")
    gen = init_generator(0, cfg.classes, preset=cfg.model, device=device, ch=cfg.ch)
    size = gen.image_size
    disc = init_discriminator(1, cfg.classes, preset="d128_app", device=device, ch=cfg.ch,
                              image_size=size, remat_blocks=cfg.remat_d_blocks)
    if cfg.g_obj_budget:
        why = obj_budget_error(gen)
        if why is not None:
            raise SystemExit(f"BENCH_G_OBJ_BUDGET is not exact for {cfg.model}: {why}")
    batch = synthetic_batch(np.random.default_rng(0), cfg.batch, size, cfg.obj, cfg.classes)
    if cfg.valid_max:
        batch["labels"][:, cfg.valid_max:] = 0
        batch["boxes"][:, cfg.valid_max:] = np.asarray(PAD_BOX, np.float32)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    batch["labels"] = batch["labels"].long()
    train_cfg = TrainConfig(mixed_precision=cfg.mixed, fused_d=cfg.fused_d, remat=cfg.remat,
                            d_obj_budget=cfg.d_obj_budget, g_obj_budget=cfg.g_obj_budget)
    vgg = VGGLoss(init_vgg(2, device=device)) if cfg.vgg else None
    state = create_train_state(gen, disc, train_cfg)
    return SimpleNamespace(state=state, step=make_train_step(state, train_cfg, vgg_loss=vgg),
                           batch=batch, rng=torch.Generator(device=device).manual_seed(1),
                           size=size)


def time_steps(built: SimpleNamespace, cfg: BenchConfig, device: torch.device) -> dict:
    """Warm up and time the built step. Returns the JSON line's dict
    (``"line"``), the step times in ms (``"step_ms"``, sorted), their median
    and quartiles, img/s, the peak memory in GiB over the timed steps (None
    on the CPU) and the last step's d_loss."""
    step, batch, rng = built.step, built.batch, built.rng
    log(f"warm-up: {cfg.scan} steps")
    for _ in range(cfg.scan):
        metrics = step(batch, rng)
    log(f"warm-up done (d_loss {float(metrics['d_loss']):.3f}); timing {cfg.scan * cfg.scans} steps")
    n = cfg.scan * cfg.scans
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(n)]
        for start, end in events:
            start.record()
            metrics = step(batch, rng)
            end.record()
        torch.cuda.synchronize(device)
        times = sorted(s.elapsed_time(e) for s, e in events)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
    else:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            metrics = step(batch, rng)
            times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        peak = None
    median, p25, p75 = times[n // 2], times[n // 4], times[(3 * n) // 4]
    img_s = 1e3 * cfg.batch / median
    final = float(metrics["d_loss"])
    log(f"final d_loss {final:.3f}; step {median:.3f} ms median [{p25:.3f}, {p75:.3f}] over {n} "
        f"steps, {img_s:.1f} img/s, peak "
        + ("not measured (CPU)" if peak is None else f"{peak:.2f} GiB allocated"))
    line = {"metric": f"gan_train_step_images_per_sec_{built.size}px", "value": round(img_s, 3),
            "unit": "img/s/chip", "vs_baseline": round(img_s / TORCH_GPU_BASELINE_IMG_S, 3),
            "baseline": BASELINE}
    return {"line": line, "step_ms": times, "median_ms": median, "p25_ms": p25, "p75_ms": p75,
            "img_s": img_s, "peak_gib": peak, "d_loss": final}


def run(cfg: BenchConfig, device: torch.device) -> dict:
    """``time_steps(build(cfg, device), ...)``."""
    return time_steps(build(cfg, device), cfg, device)


def main(argv=None) -> None:
    from layout2img_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    ap.add_argument("--ch", type=int, default=64, help="channel width (64: the model's own)")
    ap.add_argument("--no_vgg", action="store_true", help="leave the VGG perceptual loss out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(config_from_env(), ch=args.ch, vgg=not args.no_vgg)
    if device.type == "cuda":
        log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    else:
        log(f"device {device}")
    # the f32 step is the JAX package's f32: no TF32 (bf16 ops do not read these)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run(cfg, device)["line"]), flush=True)


if __name__ == "__main__":
    main()
