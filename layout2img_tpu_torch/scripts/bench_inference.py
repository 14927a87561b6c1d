"""Generator-only inference benchmarks (the port's counterpart of the JAX
repo's ``scripts/bench_inference.py``; BASELINE.md tracked configs 1-2):

1. COCO 64x64 Ours-ED (fg/bg two-stream ``BgFgGenerator``, 184 classes
   split 91 fg / 93 bg) generator inference, b=8, o=8.
2. VG 128x128 Ours-D (``ours_d_context128``: context + stage masks, 179
   classes) generator inference, b=8, o=31.

    python -m layout2img_tpu_torch.scripts.bench_inference
    BENCH_BF16=1 python -m layout2img_tpu_torch.scripts.bench_inference
    BENCH_VALID_MAX=10 BENCH_OBJ_BUDGET=12 python -m layout2img_tpu_torch.scripts.bench_inference

The knobs are the JAX script's, with its defaults: ``BENCH_K`` (500) timed
batches a configuration; ``BENCH_BF16`` (0; 1 casts the weights and latents
to bfloat16, boxes stay f32: the serving precision); ``BENCH_VALID_MAX`` (0:
all 31 slots real; N pads all but the first N slots of config 2, as real VG
layouts carry about 6-10 objects in 31 slots) and ``BENCH_OBJ_BUDGET`` (0; K
serves only the first K slots of config 2, the valid ones being in front: z
is drawn at full width and then sliced, as ``cli.sample --obj_budget`` keeps
its per-slot draws). Layouts come from ``numpy.random.default_rng(0)`` in
the JAX script's order (boxes ``rng.random * 0.4 + 0.1``); the weights are
the port's seeded init (``utils/convert.py``), not trained ones.

Each timed batch draws fresh truncated-normal latents in [-2, 2] from a
``torch.Generator`` and runs the generator in eval mode; the K batches are
timed by CUDA events after a warm-up (the JAX script's readback-latency
floor corrects for its TPU transport and has no counterpart here). It
prints the card (``nvidia-smi``'s name and power limit), then per
configuration its ms per batch and img/s per card. It runs on the card;
``--device cpu`` (timed by the host's clock) and ``--ch`` are for tests at a
small width.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from layout2img_tpu_torch.bench import card_line
from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.sample import truncated_normal
from layout2img_tpu_torch.utils.casting import cast_floating

WARMUP = 3  # untimed batches before the timed ones
Z = 128


@dataclasses.dataclass(frozen=True)
class Knobs:
    k: int = 500
    bf16: bool = False
    valid_max: int = 0
    obj_budget: int = 0


def knobs_from_env(env=None) -> Knobs:
    """The ``BENCH_*`` knobs of ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env
    return Knobs(k=int(env.get("BENCH_K", "500")), bf16=env.get("BENCH_BF16", "0") == "1",
                 valid_max=int(env.get("BENCH_VALID_MAX", "0")),
                 obj_budget=int(env.get("BENCH_OBJ_BUDGET", "0")))


@dataclasses.dataclass
class Config:
    """One timed function: ``forward(*draw(rng))`` -> (batch, 3, s, s)."""

    name: str
    batch: int
    draw: Callable[[torch.Generator], tuple]
    forward: Callable[..., torch.Tensor]


def layouts(valid_max: int = 0) -> dict[str, np.ndarray]:
    """Both configurations' layouts, drawn from ``default_rng(0)`` in the
    JAX script's order: config 1's boxes and fg and bg labels (b=o=8), then
    config 2's boxes and labels (b=8, o=31; past ``valid_max`` slots pads at
    ``PAD_BOX``)."""
    from layout2img_tpu_torch.data.synthetic import PAD_BOX

    rng = np.random.default_rng(0)
    out = {"ed_boxes": (rng.random((8, 8, 4)) * 0.4 + 0.1).astype(np.float32),
           "ed_labels_fg": rng.integers(1, 91, (8, 8)).astype(np.int64),
           "ed_labels_bg": rng.integers(1, 93, (8, 8)).astype(np.int64),
           "vg_boxes": (rng.random((8, 31, 4)) * 0.4 + 0.1).astype(np.float32),
           "vg_labels": rng.integers(1, 179, (8, 31)).astype(np.int64)}
    if valid_max:
        out["vg_labels"][:, valid_max:] = 0
        out["vg_boxes"][:, valid_max:] = np.asarray(PAD_BOX, np.float32)
    return out


def _latents(rng: torch.Generator, device: torch.device, dtype: torch.dtype, *shapes) -> tuple:
    return tuple(truncated_normal(s, 2.0, rng, device, dtype) for s in shapes)


def ours_ed(device: torch.device, knobs: Knobs, gen: torch.nn.Module | None = None,
            ch: int = 64) -> Config:
    """Config 1 on ``gen`` (default: the port's seeded ``BgFgGenerator``)."""
    from layout2img_tpu_torch.utils.convert import init_bgfg_generator

    dtype = torch.bfloat16 if knobs.bf16 else torch.float32
    gen = gen if gen is not None else init_bgfg_generator(0, 91, 93, device=device, ch=ch)
    cast_floating(gen.to(device).eval(), dtype)
    lay = layouts()
    boxes = torch.from_numpy(lay["ed_boxes"]).to(device)
    fg, bg = (torch.from_numpy(lay[k]).to(device) for k in ("ed_labels_fg", "ed_labels_bg"))
    b, o = fg.shape

    @torch.inference_mode()
    def forward(z_fg, z_bg, z_im_fg, z_im_bg):
        return gen(z_fg.to(dtype), boxes, fg, z_bg.to(dtype), boxes, bg, z_im_fg.to(dtype),
                   z_im_bg.to(dtype))

    return Config("Ours-ED 64px infer b8 ", b,
                  lambda rng: _latents(rng, device, dtype, (b, o, Z), (b, o, Z), (b, Z), (b, Z)),
                  forward)


def ours_d_vg(device: torch.device, knobs: Knobs, gen: torch.nn.Module | None = None,
              ch: int = 64) -> Config:
    """Config 2 on ``gen`` (default: the port's seeded ``ours_d_context128``)."""
    from layout2img_tpu_torch.utils.convert import init_generator

    dtype = torch.bfloat16 if knobs.bf16 else torch.float32
    gen = gen if gen is not None else init_generator(0, 179, preset="ours_d_context128",
                                                     device=device, ch=ch)
    cast_floating(gen.to(device).eval(), dtype)
    lay = layouts(knobs.valid_max)
    b, o = lay["vg_labels"].shape
    k = knobs.obj_budget if 0 < knobs.obj_budget < o else o
    boxes = torch.from_numpy(lay["vg_boxes"][:, :k]).to(device)
    labels = torch.from_numpy(lay["vg_labels"][:, :k]).to(device)

    @torch.inference_mode()
    def forward(z, z_im):
        # the full-width draw sliced to the budget (the valid slots are in front)
        return gen(z[:, :k].to(dtype), boxes, labels, z_im.to(dtype))

    tag = (f" (valid {knobs.valid_max or o}, budget {k})"
           if (knobs.valid_max or knobs.obj_budget) else "")
    return Config(f"Ours-D 128px VG infer b8{tag}", b,
                  lambda rng: _latents(rng, device, dtype, (b, o, Z), (b, Z)), forward)


def ms_per_call(call: Callable[[], object], k: int, device: torch.device) -> float:
    """Mean ms of k calls of ``call()`` in a row: CUDA events around them on
    the card, the host's clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(k):
            call()
        return (time.perf_counter() - t0) * 1000.0 / k
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(k):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / k


def bench(cfg: Config, k: int, device: torch.device) -> dict:
    """``WARMUP`` batches, then k timed ones (fresh latents each); prints
    and returns ms per batch, img/s and the forward calls made."""
    rng = torch.Generator(device=device).manual_seed(0)
    for _ in range(WARMUP):
        cfg.forward(*cfg.draw(rng))
    rng.manual_seed(1)
    out = [None]

    def call():
        out[0] = cfg.forward(*cfg.draw(rng))

    ms = ms_per_call(call, k, device)
    if not bool(torch.isfinite(out[0].float()).all()):
        raise RuntimeError(f"{cfg.name}: non-finite images")
    img_s = cfg.batch / (ms / 1000.0)
    print(f"{cfg.name}: {ms:7.2f} ms/batch  ({img_s:8.1f} img/s/card)", flush=True)
    return {"name": cfg.name.strip(), "ms": ms, "img_s": img_s, "calls": WARMUP + k}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    p.add_argument("--ch", type=int, default=64, help="channel width (64: the configs' own)")
    return p.parse_args(argv)


def main(argv=None, env=None) -> list[dict]:
    """Both configurations with the knobs of ``env`` (default the
    environment); returns each one's ``bench`` result."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    knobs = knobs_from_env(env)
    if device.type == "cuda":
        print(f"card: {card_line()} | bf16={int(knobs.bf16)} K={knobs.k}", flush=True)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return [bench(make(device, knobs, ch=args.ch), knobs.k, device)
            for make in (ours_ed, ours_d_vg)]


if __name__ == "__main__":
    main()
