"""Benchmark of the port's evaluation throughput (counterpart of the JAX
package's ``scripts/bench_eval.py``): InceptionV3 feature and probability
extraction, the rate that bounds ``cli.evaluate is|fid|kid`` and each
``--eval_every`` call (image decoding excluded).

    python -m layout2img_tpu_torch.bench_eval
    BENCH_BATCH=64 BENCH_SIZE=256 python -m layout2img_tpu_torch.bench_eval

Prints ONE JSON line with the JAX bench's metric name and keys:
  {"metric": "inception_eval_images_per_sec", "value": N, "unit": "img/s/chip",
   "batch_size": B, "input_px": S}
and logs to stderr the card (``nvidia-smi``'s name and power limit), the
median and quartile ms per batch and the peak memory.

The environment knobs are the JAX bench's, with its defaults: ``BENCH_BATCH``
(256 images per call), ``BENCH_SIZE`` (128: the input side, resized to 299
inside the net), ``BENCH_SCAN`` x ``BENCH_SCANS`` (20 x 3) timed calls, each
timed by CUDA events after ``BENCH_SCAN`` warm-up calls; the value is the
batch over the median call. A call is the forward and the softmax, f32 with
TF32 off in cuDNN and matmul (as ``eval/metrics.py`` runs it), on seeded
random filters and one seeded batch in [-1, 1].

It runs on the card; ``--device cpu`` (timed by the host's clock) is for
tests at a small batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[bench_eval +{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class EvalBenchConfig:
    batch: int = 256
    scan: int = 20
    scans: int = 3
    size: int = 128


def config_from_env(env=None) -> EvalBenchConfig:
    """The ``BENCH_*`` knobs of ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env
    return EvalBenchConfig(batch=int(env.get("BENCH_BATCH", "256")),
                           scan=int(env.get("BENCH_SCAN", "20")),
                           scans=int(env.get("BENCH_SCANS", "3")),
                           size=int(env.get("BENCH_SIZE", "128")))


def build(cfg: EvalBenchConfig, device: torch.device):
    """(InceptionV3 with the seed-0 random filters, one seeded batch) on ``device``."""
    from layout2img_tpu_torch.eval.inception import load_inception

    log(f"building InceptionV3 (batch={cfg.batch}, {cfg.size}px input, "
        f"calls={cfg.scan}x{cfg.scans})")
    net = load_inception("", device)
    g = torch.Generator().manual_seed(0)
    images = (torch.rand(cfg.batch, 3, cfg.size, cfg.size, generator=g) * 2 - 1).to(device)
    return net, images


def time_calls(net, images: torch.Tensor, cfg: EvalBenchConfig, tf32: bool = False) -> dict:
    """Warm up and time the forward and softmax of the built batch, TF32 in
    cuDNN and matmul as ``tf32`` says (restored after). Returns the JSON
    line's dict (``"line"``), the call times in ms (sorted), their median
    and quartiles, img/s and the peak memory in GiB (None on the CPU)."""
    device = images.device
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32

    def call():
        f, logits = net(images)
        return f, torch.softmax(logits, dim=-1)

    n = cfg.scan * cfg.scans
    try:
        with torch.inference_mode():
            for _ in range(cfg.scan):
                call()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                events = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
                for start, end in events:
                    start.record()
                    call()
                    end.record()
                torch.cuda.synchronize(device)
                times = sorted(s.elapsed_time(e) for s, e in events)
                peak = torch.cuda.max_memory_allocated(device) / 2**30
            else:
                times = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    call()
                    times.append(1e3 * (time.perf_counter() - t0))
                times.sort()
                peak = None
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    median, p25, p75 = times[n // 2], times[n // 4], times[(3 * n) // 4]
    img_s = 1e3 * cfg.batch / median
    log(f"{'TF32' if tf32 else 'f32, TF32 off'}: {median:.3f} ms per batch of {cfg.batch} median "
        f"[{p25:.3f}, {p75:.3f}] over {n} calls, {img_s:.1f} img/s, peak "
        + ("not measured (CPU)" if peak is None else f"{peak:.2f} GiB allocated"))
    line = {"metric": "inception_eval_images_per_sec", "value": round(img_s, 3),
            "unit": "img/s/chip", "batch_size": cfg.batch, "input_px": cfg.size}
    return {"line": line, "call_ms": times, "median_ms": median, "p25_ms": p25, "p75_ms": p75,
            "img_s": img_s, "peak_gib": peak}


def main(argv=None) -> None:
    from layout2img_tpu_torch.bench import card_line
    from layout2img_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_env()
    if device.type == "cuda":
        log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    else:
        log(f"device {device}")
    print(json.dumps(time_calls(*build(cfg, device), cfg)["line"]), flush=True)


if __name__ == "__main__":
    main()
