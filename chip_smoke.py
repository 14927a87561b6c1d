#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``layout2img_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases build,kernel_bwd] [--reps N]

Run it from the root of a checkout. It builds the port's CUDA kernels from
the checkout's sources (``nvcc`` into ``build/kernels/``) and runs these
phases in order, each printing its own lines; any failure exits non-zero.
With no arguments it runs every phase with 50 timed launches per kernel
and shape; ``--phases`` picks some (``rate`` needs ``slice``,
``train_rate`` needs ``train``) and ``--reps`` sets the timed launches
(a fifth of them, at least 5, for the b=128 calls of ``train_mixed``):

1. device  -- requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build   -- one ``nvcc`` per ``layout2img_tpu_torch/csrc/*.cu``, all
              started together; prints each kernel's registers and spills.
3. kernel  -- the fused ISLA norm kernel against its plain PyTorch version
              on the card, at the ten (h, c) shapes of one Ours-D 128px
              forward (b=8) with their real source-mask sizes, for o=31 and
              o=8, in f32 and bf16, with sparse (box) and dense masks; per
              shape the error, the kernel's and the plain version's time (L2
              flushed before each launch), the time of ``x.clone()`` (the
              floor a streaming pass over x reaches) and the least time the
              card could take for this data.
4. kernel_bwd -- the same for the ISLA backward, two kernels per call, with
              batch statistics that need a gradient: every gradient (x
              through the statistics, the source mask, gamma, beta) against
              autograd of the plain version, the finishing kernel against
              its plain version on the main kernel's partial buffers, two
              calls compared bit for bit, the kernels per call counted by
              the profiler, and per shape the function's time, the main
              launch's and the finishing launch's alone, against the plain
              backward's and the bounds.
5. bwd_vg  -- the ISLA backward on masks drawn as Visual Genome layouts
              give them (o=31: 3 to 30 objects, the ``__image__`` slot, pads),
              through the port's public entry points alone, so that it also
              times an earlier tree: every gradient against the plain
              version, the function's time and the main kernel's (profiler),
              and the live objects per tile.
6. slice   -- full-width ``ours_d_context128`` (ch=64, 179 classes, o=31 with
              6 valid objects, b=8) from seeded weights, saved and reloaded
              strictly, sampled 3x in f32 and 3x in bf16 through the
              sampler; checks shape, range, 10 kernel launches per forward,
              ``obj_budget``, and one f32 batch of 2 against the CPU path.
7. train   -- the same generator with ``d128_app`` (ch=64) and the VGG loss,
              seeded, saved and reloaded strictly, 5 f32 train steps at b=8:
              finite losses, parameters, BN statistics and SN vectors moved,
              10 forward ISLA launches and 10 of each backward kernel per
              step; then one
              step on the card against the same step on the CPU at b=2 and
              b=8, with the per-layer bars of ``tests/test_torch_port_train.py``.
8. rate    -- sampler img/s at b=8 and b=128 and the profiler's breakdown of
              one sampler forward.
9. train_rate -- train-step ms and img/s at b=8 and b=32 (CUDA events, after
              warm-up) with peak memory, in f32 as ``cli/train.py`` runs it
              and, for comparison, with TF32 in cuDNN and matmul; the
              profiler's breakdown of one f32 train step.
10. train_mixed -- the mixed-precision step (bf16 compute over f32 masters)
              at full width: 5 steps at b=8 (finite losses; f32 masters that
              moved; BN statistics and SN vectors moved; 10 launches of each
              ISLA kernel per step, bf16 by the profiler); one f32 step at b=2
              for each knob (remat=gd, remat_d_blocks=2, g_obj_budget=12,
              d_obj_budget=12, fused_d, EMA) against the plain step at the CPU
              tests' bars, 20 forward launches under remat; the ten bf16 ISLA
              calls of one mixed step at the bench's shapes (b=128: o=8, and
              o=31 cut to 12 by both budgets) against the plain versions, with
              their times; the port's bench (``layout2img_tpu_torch/bench.py``)
              in both configurations (10 warm-up and 20 timed steps each)
              and the f32 step at b=32; the profiler's
              breakdown of one mixed b=128 step.
11. presets -- every other LostGAN experiment of ``cli/presets.py``
              (``ours_d``, ``context_app``, ``context_nogeo``,
              ``context_app_nogeo``, ``graph_context_app``, ``lostgan``,
              ``context_part``, ``ours_d_256``) and ``lostgan64`` + ``d64``,
              at full width (ch=64, 184 classes, o=8): G and D seeded, saved
              and reloaded strictly; 3 f32 train steps at b=8 (finite losses,
              parameters, BN statistics and SN vectors moved, the ISLA
              launches per step the preset implies: 8 at 64 px, 10 at 128,
              12 at 256, 30 with 3 part masks, by the counts and the
              profiler); the ISLA calls of one f32 and one mixed step
              (h=256 and the part calls among them) against the plain
              versions, timed (a twentieth of ``--reps``, at least 5); one
              f32 eval forward at b=2 against the CPU at 2e-3; the f32 and
              mixed step ms at b=8; then the bench with
              ``BENCH_MODEL=ours_d_base256`` (mixed, b=32).
12. data   -- the CLIs' main path on fixture datasets on disk, at full
              width (``context_app_v2``: ch=64, 128 px, b=8, f32, VGG on):
              prints whether PIL, h5py and the native decoder are there;
              writes a COCO-Stuff fixture (64 JPEGs at 640x480, 6-8 objects
              with stuff; ``--dataset synthetic`` without PIL); trains 2
              epochs through ``cli.train.main`` (a checkpoint each, metrics
              and grids every 2 steps), resumes for a third with
              ``--async_ckpt`` (the step count continues; the resumed-from
              and the async-written checkpoints, restored on the card, equal
              their files bit for bit); 10 launches of each ISLA kernel
              per step and 10 forward launches per grid; a NaN drill (exit 3,
              the last checkpoint's bytes kept); ``cli.sample --ckpt_dir``
              on the fixture (20 launches) and ``cli.export_torch`` (its G
              loads strictly); then, on a second fixture of 1024 JPEGs (16
              batches of 128 with the flips), per decoder the ms per item on
              one thread and ``HostDataLoader`` img/s at b=128 with 8 threads
              and prefetch 4 (the CLI's default: 4 batches decoded at once)
              and 8 (8 at once), the mixed b=128 step fed by the loader and
              the prefetch with both loads against the same step on a
              device-resident batch, and the card's idle share over two
              traced loader-fed steps;
              then train and resume on a Visual Genome fixture (o=31, 179
              classes) when h5py is there.
13. eval   -- the evaluation path at full width: InceptionV3 (4 images at
              128 px, 2 at 64, 2 at 256) and LPIPS with the port's seeded
              random weights on the card against the CPU at the CPU tests'
              bars, and the pool3 variance; ``cli.train --eval_every 2
              --eval_n 16`` (``context_app_v2``, ch=64, b=8, f32, VGG on, 2
              steps): rel_fid at step 2, 10 forward ISLA launches per
              step, per image grid and per eval batch; one ``PeriodicEval``
              call on a full-width train state, which equals itself bit for
              bit before and after, timed as G sampling, Inception and the
              host's Frechet distance; ``cli.sample`` (64 images, 40
              launches) then ``cli.evaluate`` is, fid (``--ref_dir`` and
              ``--save_stats`` then ``--ref_stats``: the same number, about
              0), kid and lpips (0, a ragged tail) on that directory; the
              eval bench (``bench_eval.py``: b=256, 128-px input) in f32 and
              with TF32, its operation count and bound, and the profiler's
              breakdown of one batch.
14. special -- the special families at full width. Ours-ED (``BgFgGenerator``,
              ch=64, 184 classes split 91/93, o=8, with d64 and the VGG loss):
              G and D seeded, saved and reloaded strictly; 3 f32 b=8 steps
              (finite losses; parameters, BN statistics and SN vectors
              moved; 16 launches of each ISLA kernel per step by the counts
              and the profiler); the 16 ISLA calls of one step against the
              plain versions, timed; one f32 eval forward at b=2 against the
              CPU at 2e-3; step ms, img/s and a traced step's breakdown at
              b=8 and b=16. layout2im
              (conv_dim 64, D ch=64, b=8) in each of its four fusions: 2 f32
              steps (finite, moved) and one deterministic training-mode G
              forward at b=2 against the CPU at 2e-3; the step ms and a
              traced step at b=16 for ``transformer``. Then the CLIs on a 16-JPEG COCO fixture:
              ``cli.train --model ours_ed`` 2 epochs and ``--resume`` one
              with ``--eval_every`` (16 launches per step and per eval
              batch), ``cli.train --model layout2im``, ``cli.sample
              --ckpt_dir`` for both, ``cli.evaluate is`` on the Ours-ED
              samples, ``cli.export_torch --model ours_ed`` (loads strictly).
15. export -- the serving artifact at the CLI's defaults (``context_app_v2``:
              ch=64, 128 px, 184 classes, o=8): a checkpoint with an EMA
              written through the train state; ``cli.export`` in f32 and
              with ``--bf16`` at b=8, and with ``--bf16`` at b=128; an eager forward after the
              exports is a real tensor equal bit for bit to one before them;
              the sidecar; ``--run`` (f32) in a fresh process that imports no
              module of ``models/``; each artifact holds 10 ISLA operator
              nodes and no plain-twin einsum; the b=8 artifacts for seeds 0
              and 1 against the eager EMA generator on ``latents_from_seed``
              (f32 1e-5, bf16 1e-2; the seeds differ; the raw weights' images
              differ), 10 forward launches a call by the counts and the
              profiler; artifact and eager sampler ms per batch and img/s for
              each artifact (10 batches at b=8, 5 at b=128).
16. conditioning -- ``scripts/train_conditioning_check.py`` for the flagship
              at its defaults (12 classes, o=4, b=32, 64 px, ch=24, mixed
              precision, 16 chunks of 50 steps): the score before, every 200
              steps and after, the wall time, 8 bf16 launches of each ISLA
              kernel per step (two norms a block, 4 blocks at 64 px); the
              script's own gate decides the phase.
17. ddp    -- data parallelism (``parallel/mesh.py``) at the flagship's full
              width (``context_app_v2``: ch=64, 128 px, seeded VGG19 filters).
              ``torchrun --nproc_per_node=1`` of ``cli.train`` over NCCL, 5
              steps at b=8 on synthetic data: its losses, parameters and Adam
              state equal the one-process run's bit for bit (both with
              deterministic cuDNN), and its ISLA counters read 10 forward, 10
              backward and 10 finishing launches a step (and 10 forward for
              the one image grid). Then 2 ranks on the one card over gloo, b=4
              each, one f32 step from the saved train weights against the
              one-process step at b=8 on the same images and latents, with the
              ``train`` phase's card bars; ms per step of each run.
18. the ``{"kernels": [...]}`` line, the card's line, then the result line.

fp32 comparisons run with TF32 off in cuDNN and matmul: cuDNN's TF32
default keeps about three decimal digits.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]

# (h, c, hs) of the ISLA norms b1, b2 of res1..res5 at 128 px, ch=64: x is
# (b, c, h, h), its stage mask arrives at (hs, hs) and is resized to h inside
ISLA_SHAPES = [(4, 1024, 64), (8, 1024, 64), (8, 1024, 8), (16, 512, 8), (16, 512, 16),
               (32, 256, 16), (32, 256, 32), (64, 128, 32), (64, 128, 64), (128, 64, 64)]
ISLA_SOURCE = "layout2img_tpu_torch/csrc/isla_norm.cu"
ISLA_REPLACES = "layout2img_tpu/ops/pallas/isla.py:85 (tree of d0260d0^, _isla_kernel_batched)"
ISLA_BWD_SOURCE = "layout2img_tpu_torch/csrc/isla_norm_bwd.cu"
ISLA_BWD_REPLACES = ("layout2img_tpu/ops/pallas/isla.py:103 (tree of d0260d0^, _bwd of the "
                     "isla_modulate custom_vjp)")
PHASES = ("build", "kernel", "kernel_bwd", "bwd_vg", "slice", "train", "rate", "train_rate",
          "train_mixed", "presets", "data", "eval", "special", "export", "conditioning", "ddp")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32; bf16 tensor cores
B, O, N_VALID, NUM_CLASSES, CH = 8, 31, 6, 179, 64
# kernel kinds of a profiled step, by marks in their names (first match wins)
PROFILE_GROUPS = (("ISLA", ("isla_norm",)), ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
                  ("convolutions (cuDNN)", ("xmma", "cudnn", "conv", "implicit_gemm", "winograd",
                                            "fft")),
                  ("GEMMs (cuBLAS)", ("gemm", "cutlass", "sm90_", "ampere_", "Kernel2")),
                  ("pooling", ("pool", "adaptive_avg", "atomic_adaptive")),
                  ("reductions", ("reduce_kernel",)),
                  ("elementwise and copies", ("elementwise", "copy", "fill", "CatArrayBatched")))
TRAIN_STEPS = 5
AFTER_PSP = ("res5.", "final.")  # G's layers after the PSP head
PSP_STAGE_CONV = "res4.conv_mask.0.stages.0.1.weight"  # the conv before its 1x1 stage's BN


class SmokeFailure(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, flush=None) -> tuple[float, float, float]:
    """Device time of ``fn`` per launch by CUDA events: (median, 25th, 75th
    percentile) over ``reps`` launches. ``flush``, a buffer larger than L2,
    is overwritten before each launch so the inputs come from device
    memory."""
    import torch

    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[reps // 2], times[reps // 4], times[(3 * reps) // 4]


def stage_masks(b: int, o: int, hs: int, pattern: str, g, dtype):
    """Source stage masks (b, o, hs, hs). ``sparse`` is the main path's
    pattern: N_VALID objects each non-zero inside one box, pad objects all
    zero. ``dense``: every object non-zero everywhere, the most work. ``vg``:
    as ``data/vg.py`` fills o=31 slots, n ~ U[3, 30] objects (the counts
    ``cli/preprocess_vg.py`` keeps; the dataset's own distribution is not in
    the repository), each non-zero inside a box whose sides are U(0.1, 0.9)
    of the canvas, then the ``__image__`` slot non-zero over the whole
    canvas, then pad slots, all zero."""
    import torch

    dev = g.device
    if pattern == "dense":
        return (torch.rand(b, o, hs, hs, device=dev, generator=g) + 0.01).to(dtype)
    pos = (torch.arange(hs, device=dev) + 0.5) / hs
    if pattern == "vg":
        n = torch.randint(3, 31, (b, 1), device=dev, generator=g)
        side = 0.1 + 0.8 * torch.rand(b, o, 2, 1, device=dev, generator=g)
        lo = (1.0 - side) * torch.rand(b, o, 2, 1, device=dev, generator=g)
        inside = (pos >= lo) & (pos < lo + side)  # (b, o, 2, hs)
        slot = torch.arange(o, device=dev)[None, :]
        box = ((inside[:, :, 0, :, None] & inside[:, :, 1, None, :] & (slot < n)[..., None, None])
               | (slot == n)[..., None, None])
        return ((0.01 + 0.99 * torch.rand(b, o, hs, hs, device=dev, generator=g)) * box).to(dtype)
    lo = 0.6 * torch.rand(b, N_VALID, 2, 1, device=dev, generator=g)  # box corner (y, x)
    size = 0.1 + 0.4 * torch.rand(b, N_VALID, 2, 1, device=dev, generator=g)
    inside = (pos >= lo) & (pos < lo + size)  # (b, N_VALID, 2, hs)
    box = inside[:, :, 0, :, None] & inside[:, :, 1, None, :]
    mask = torch.zeros(b, o, hs, hs, device=dev)
    mask[:, :N_VALID] = torch.rand(b, N_VALID, hs, hs, device=dev, generator=g) * box
    return mask.to(dtype)


def isla_cost(x, mask_src, live: int, dtype_name: str):
    """(bound_ms, bytes-bound ms, ops-bound ms) of one fused ISLA norm call on
    this data. Bytes: x read and out written once; the source mask, gamma,
    beta and the two f32 statistics read once. Operations: 4 per output
    element for each object whose resized mask is non-zero at its pixel
    (``live`` counts those (b, o, p); a zero mask needs no work), 5 per
    output element for the BN, the affine and the ReLU, and 8 per resized
    mask value for its 2x2 taps, the sum over objects and the fold."""
    b, c, h, w = x.shape
    o = mask_src.shape[1]
    nbytes = x.element_size() * (2 * x.numel() + mask_src.numel() + 2 * b * o * c) + 2 * 4 * c
    ops = 4 * c * live + 5 * x.numel() + 8 * b * o * h * w
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops), t_bytes, t_ops


def isla_bwd_cost(x, mask_src, live: int, dtype_name: str):
    """(bound_ms, bytes-bound ms, ops-bound ms) of one ISLA backward call on
    this data. Bytes: x and the output gradient read once, dx and the mask
    gradient written once, the source mask, gamma and beta read and their
    gradients written once, the statistics read and theirs written.
    Operations: for each (b, o, p) whose resized mask is non-zero, 4 per
    channel for G and B and 4 for dgamma and dbeta; for every (b, o, p),
    4 per channel for U (a pad object's mask gradient is not zero) and 11 for
    the resize, the denominator and dm; 10 per element of x."""
    b, c, h, w = x.shape
    o = mask_src.shape[1]
    nbytes = (x.element_size() * (3 * x.numel() + 2 * mask_src.numel() + 4 * b * o * c)
              + 4 * 4 * c)
    ops = 8 * c * live + (4 * c + 11) * b * o * h * w + 10 * x.numel()
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops), t_bytes, t_ops


def build_phase() -> None:
    from layout2img_tpu_torch.ops import _build

    seconds = _build.build_all()
    for name, s in seconds.items():
        log = _build.library_path(name).with_suffix(".log").read_text().splitlines()
        usage = [ln.split(":", 1)[1].strip() for ln in log if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in log if "spill stores" in ln]
        phase("build", f"csrc/{name}.cu: built in {s:.1f}s; per kernel: {usage}; {spills}")


def kernel_phase(reps: int = 50) -> dict:
    import torch

    from layout2img_tpu_torch.ops.interp import resize_bilinear
    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_plain

    dev = torch.device("cuda")
    # 1 GiB: far past the 50 MB L2, and its ~0.3 ms overwrite outlasts the
    # host's launch latency, so each timed launch starts on a busy queue
    flush = torch.empty(2**28, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1234)
    worst_abs, worst_rel, n_checks = 0.0, 0.0, 0
    # (dtype, o, pattern) -> [kernel, plain, bound, bytes-bound, ops-bound, x.clone() ms]
    per_forward = {}
    for dtype, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        dname = str(dtype).removeprefix("torch.")
        for o in (O, 8):
            for pattern in ("sparse", "dense"):
                for i, (h, c, hs) in enumerate(ISLA_SHAPES):
                    relu = i % 2 == 1  # alternate, as both kinds of call are on the path
                    x = torch.randn(B, c, h, h, device=dev, generator=g).to(dtype)
                    mean = 0.5 * torch.randn(c, device=dev, generator=g)
                    var = 0.5 + torch.rand(c, device=dev, generator=g)
                    mask = stage_masks(B, o, hs, pattern, g, dtype)
                    gamma = torch.randn(B, o, c, device=dev, generator=g).to(dtype)
                    beta = torch.randn(B, o, c, device=dev, generator=g).to(dtype)
                    args = (x, mean, var, 1e-5, mask, gamma, beta, relu)
                    got = isla_norm(*args)
                    torch.cuda.synchronize()
                    ref = isla_norm_plain(*args).float()
                    err = (got.float() - ref).abs().max().item()
                    scale = ref.abs().max().item()
                    where = f"b={B} o={o} h={h} c={c} hs={hs} {dname} {pattern}"
                    need(torch.isfinite(got.float()).all().item(), f"ISLA kernel non-finite at {where}")
                    need(err <= rel_tol * scale, f"ISLA kernel off at {where}: {err} > {rel_tol} * {scale}")
                    worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
                    n_checks += 1
                    live = int((resize_bilinear(mask.float(), (h, h)) != 0).sum().item())
                    k_ms, k_lo, k_hi = time_ms(lambda: isla_norm(*args), reps, flush)
                    p_ms, _, _ = time_ms(lambda: isla_norm_plain(*args), reps, flush)
                    # the floor a streaming pass over x reaches here: read x, write a copy
                    c_ms, _, _ = time_ms(lambda: x.clone(), reps, flush)
                    bound_ms, t_b, t_o = isla_cost(x, mask, live, dname)
                    phase("kernel", f"isla_norm {where} relu={int(relu)}: max_abs_err={err:.3e} "
                          f"(bar {rel_tol:g}*{scale:.3g}) kernel_ms={k_ms:.5f} [{k_lo:.5f}, {k_hi:.5f}] "
                          f"plain_ms={p_ms:.5f} copy_ms={c_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
                          f"({'bytes' if t_b >= t_o else 'operations'}) "
                          f"share={bound_ms / k_ms:.3f} live_per_pixel={live / (B * h * h):.2f}")
                    acc = per_forward.setdefault((dname, o, pattern), [0.0] * 6)
                    for j, v in enumerate((k_ms, p_ms, bound_ms, t_b, t_o, c_ms)):
                        acc[j] += v
    for (dname, o, pattern), (k_ms, p_ms, bound_ms, _, _, c_ms) in per_forward.items():
        phase("kernel", f"isla_norm {dname} o={o} {pattern} per forward (b={B}, ten calls): "
              f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} copy_ms={c_ms:.5f} bound_ms={bound_ms:.5f} "
              f"share_of_bound={bound_ms / k_ms:.3f}")
    k_ms, p_ms, bound_ms, t_b, t_o, c_ms = per_forward[("float32", O, "sparse")]
    bf = per_forward[("bfloat16", O, "sparse")]
    return {"name": "isla_norm", "route": "cuda", "source": ISLA_SOURCE,
            "replaces": ISLA_REPLACES, "launches": None, "max_abs_err": worst_abs,
            "max_rel_err": worst_rel, "checks": n_checks,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_b >= t_o else "operations", "library_ms": None,
            "ms_bf16": bf[0], "plain_ms_bf16": bf[1], "bound_ms_bf16": bf[2],
            "copy_ms": c_ms, "copy_ms_bf16": bf[5],
            "timed_as": f"sum of the ten calls of one forward, b={B}, o={O}, sparse masks, "
                        "L2 flushed; plain = BN, resize, modulation and ReLU as separate torch ops"}


def _isla_grads(norm, x, mask, gamma, beta, grad, relu):
    """Gradients of x (through the batch statistics), mask, gamma and beta."""
    import torch

    from layout2img_tpu_torch.nn.norms import batch_stats

    leaves = [t.detach().clone().requires_grad_(True) for t in (x, mask, gamma, beta)]
    mean, var = batch_stats(leaves[0])
    out = norm(leaves[0], mean, var, 1e-5, *leaves[1:], relu=relu)
    return torch.autograd.grad(out, leaves, grad)


def _off_gate_ties(x, mask, gamma, beta, grad):
    """The output gradient, zeroed where the pre-ReLU output is within 1e-5
    of its max|.| of zero: there the kernel's recomputed output and the
    oracle's may fall on opposite sides of the ReLU's gate."""
    from layout2img_tpu_torch.nn.norms import batch_stats
    from layout2img_tpu_torch.ops.isla import isla_norm_plain

    pre = isla_norm_plain(x.float(), *batch_stats(x), 1e-5, mask.float(), gamma.float(),
                          beta.float())
    ties = pre.abs() <= 1e-5 * pre.abs().max()
    return grad.masked_fill(ties, 0), int(ties.sum())


def finish_cost(parts, outs):
    """(bound_ms, bytes-bound ms, ops-bound ms) of one finishing launch: the
    three f32 partial buffers and the variances read once, the five
    gradients written once; one add per element of the buffers, and per
    (b, o) plane 4 operations per tap of the two gather passes (at most 2 per
    destination pixel per pass)."""
    part_stats, part_gb, part_dm = parts
    nbytes = sum(t.numel() * t.element_size() for t in (*parts, *outs)) + 4 * outs[0].numel()
    ops = part_stats.numel() + part_gb.numel() + part_dm.numel() + 4 * 2 * 2 * part_dm[0].numel()
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops), t_bytes, t_ops


def device_kernels(calls: list) -> list[str]:
    """Names of the kernels that ``calls`` run on the card, in the order they
    ran, from one profiler session (the calls run one at a time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
            torch.cuda.synchronize()
    return [name for _, name in sorted((e.time_range.start, e.name) for e in prof.events()
                                       if e.device_type == torch.autograd.DeviceType.CUDA)]


def kernel_bwd_phase(reps: int = 50) -> tuple[dict, dict]:
    """The ISLA backward (two kernels per call) against autograd of the plain
    version, at the ten shapes of one forward; bars against max|plain| of
    each gradient: 1e-4 in f32 (sums over up to 131k pixels in another
    order, 1/d up to 1e6 where no object covers a pixel), 2e-2 in bf16
    (inputs, dx and the outputs rounded to bf16; the plain oracle runs in
    f32). With the ReLU, the output gradient is zeroed at the gate's ties
    (``_off_gate_ties``). The finishing kernel alone against
    ``finish_backward_plain`` on the main kernel's partial buffers: 1e-5 of
    max|plain| (sums of up to 688 partials per channel in another order),
    plus 2^-8 of each value in bf16 (one rounding). The
    function's time is the wrapper's (both launches); the plain version is
    autograd of ``isla_norm_plain`` from the same inputs. Returns the rows
    of the backward function and of its finishing kernel."""
    import torch

    from layout2img_tpu_torch.nn.norms import batch_stats
    from layout2img_tpu_torch.ops.interp import resize_bilinear
    from layout2img_tpu_torch.ops.isla import (_launch_backward, _launch_finish, _plain_backward,
                                               backward_config, finish_backward_plain, isla_norm,
                                               blocks_per_sm, isla_norm_backward, isla_norm_plain)

    dev = torch.device("cuda")
    flush = torch.empty(2**28, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(4321)
    worst_abs, worst_rel, n_checks, fin_abs, fin_rel = 0.0, 0.0, 0, 0.0, 0.0
    # (dtype, o, pattern) -> [function, main launch, finishing launch, plain, bound, bytes-bound,
    # ops-bound, plain finish, finish bound, finish bytes-bound, finish ops-bound]
    per_forward, finish_by_shape = {}, {}
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        dname = str(dtype).removeprefix("torch.")
        for o in (O, 8):
            for pattern in ("sparse", "dense"):
                for i, (h, c, hs) in enumerate(ISLA_SHAPES):
                    relu = i % 2 == 1
                    x = torch.randn(B, c, h, h, device=dev, generator=g).to(dtype)
                    mask = stage_masks(B, o, hs, pattern, g, dtype)
                    gamma = torch.randn(B, o, c, device=dev, generator=g).to(dtype)
                    beta = torch.randn(B, o, c, device=dev, generator=g).to(dtype)
                    grad = torch.randn(B, c, h, h, device=dev, generator=g).to(dtype)
                    where = f"b={B} o={o} h={h} c={c} hs={hs} {dname} {pattern} relu={int(relu)}"
                    grad, ties = _off_gate_ties(x, mask, gamma, beta, grad) if relu else (grad, 0)
                    got = _isla_grads(isla_norm, x, mask, gamma, beta, grad, relu)
                    torch.cuda.synchronize()
                    want = _isla_grads(isla_norm_plain,
                                       *(t.float() for t in (x, mask, gamma, beta, grad)), relu)
                    errs = [f"{ties} gate ties"]
                    for name, a, w in zip(("x", "mask_src", "gamma", "beta"), got, want):
                        need(a.dtype == dtype and torch.isfinite(a.float()).all().item(),
                             f"ISLA backward: non-finite or mistyped d{name} at {where}")
                        err, scale = (a.float() - w).abs().max().item(), w.abs().max().item()
                        need(err <= rel_tol * scale,
                             f"ISLA backward off in d{name} at {where}: {err} > {rel_tol} * {scale}")
                        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
                        errs.append(f"d{name} {err / scale:.1e}")
                    n_checks += 1
                    # the kernels alone, at the statistics the training path gives them
                    mean, var = batch_stats(x)
                    args = (x, mean, var, 1e-5, mask, gamma, beta, grad, relu)
                    first = isla_norm_backward(*args)
                    second = isla_norm_backward(*args)
                    need(all(torch.equal(a, b) for a, b in zip(first, second)),
                         f"ISLA backward not bit-identical run to run at {where}")
                    cfg = backward_config(B, c, h, h, o)
                    _, *parts = _launch_backward(*args, cfg)
                    fin = _launch_finish(*parts, var, 1e-5, mask, gamma)
                    plain_fin = finish_backward_plain(*parts, var, 1e-5, (hs, hs), (torch.float32,) * 3)
                    for name, a, w in zip(("dmean", "dvar", "dmask", "dgamma", "dbeta"), fin, plain_fin):
                        bf = 0.0 if a.dtype == torch.float32 else 2 ** -8
                        scale = w.abs().max().item()
                        off = ((a.float() - w).abs() - bf * w.abs()).max().item()
                        need(off <= 1e-5 * scale, f"ISLA finishing kernel off in {name} at {where}: "
                                                  f"{off} > 1e-5 * {scale}")
                        err = (a.float() - w).abs().max().item()
                        fin_abs, fin_rel = max(fin_abs, err), max(fin_rel, err / max(scale, 1e-30))
                    w_ms, w_lo, w_hi = time_ms(lambda: isla_norm_backward(*args), reps, flush)
                    k_ms, _, _ = time_ms(lambda: _launch_backward(*args, cfg), reps, flush)
                    f_ms, _, _ = time_ms(lambda: _launch_finish(*parts, var, 1e-5, mask, gamma),
                                         reps, flush)
                    p_ms, _, _ = time_ms(lambda: _plain_backward(*args), reps, flush)
                    pf_ms, _, _ = time_ms(lambda: finish_backward_plain(
                        *parts, var, 1e-5, (hs, hs), (dtype,) * 3), reps, flush)
                    live = int((resize_bilinear(mask.float(), (h, h)) != 0).sum().item())
                    bound_ms, t_b, t_o = isla_bwd_cost(x, mask, live, dname)
                    f_bound, f_b, f_o = finish_cost(parts, fin)
                    phase("kernel", f"isla_norm_bwd {where}: rel_err {', '.join(errs)} (bar {rel_tol:g}) "
                          f"ms={w_ms:.5f} [{w_lo:.5f}, {w_hi:.5f}] launch_ms={k_ms:.5f} "
                          f"finish_ms={f_ms:.5f} "
                          f"plain_ms={p_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
                          f"({'bytes' if t_b >= t_o else 'operations'}) share={bound_ms / w_ms:.3f} "
                          f"finish_bound_us={1e3 * f_bound:.3f} threads={cfg.threads} "
                          f"warps_per_sm="
                          f"{blocks_per_sm(cfg.threads, cfg.smem_bytes) * cfg.threads // 32} "
                          f"spans={cfg.n_spans} groups={cfg.n_groups} smem={cfg.smem_bytes}")
                    if o == O and pattern == "sparse":
                        finish_by_shape[(dname, h, c, hs)] = f_ms
                    acc = per_forward.setdefault((dname, o, pattern), [0.0] * 11)
                    for j, v in enumerate((w_ms, k_ms, f_ms, p_ms, bound_ms, t_b, t_o, pf_ms, f_bound,
                                           f_b, f_o)):
                        acc[j] += v
    for (dname, o, pattern), (w_ms, k_ms, f_ms, p_ms, bound_ms, *_, f_bound, _, _) in per_forward.items():
        phase("kernel", f"isla_norm_bwd {dname} o={o} {pattern} per forward (b={B}, ten calls): "
              f"ms={w_ms:.5f} launch_ms={k_ms:.5f} finish_ms={f_ms:.5f} plain_ms={p_ms:.5f} "
              f"bound_ms={bound_ms:.5f} share_of_bound={bound_ms / w_ms:.3f} "
              f"finish_bound_ms={f_bound:.5f}")
    # the kernels one call runs, from the profiler, at each shape in f32 and bf16 (o=31, sparse)
    calls, labels = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for h, c, hs in ISLA_SHAPES:
            x = torch.randn(B, c, h, h, device=dev, generator=g).to(dtype)
            mask = stage_masks(B, O, hs, "sparse", g, dtype)
            gamma, beta, grad = (torch.randn(*shape, device=dev, generator=g).to(dtype)
                                 for shape in ((B, O, c), (B, O, c), (B, c, h, h)))
            args = (x, *batch_stats(x), 1e-5, mask, gamma, beta, grad, True)
            isla_norm_backward(*args)  # warm
            calls.append(functools.partial(isla_norm_backward, *args))
            labels.append((dtype, h, c, hs))
    names = device_kernels(calls)
    kinds = ["finish" if "isla_norm_bwd_finish_kernel" in n else
             "main" if "isla_norm_bwd_kernel" in n else n for n in names]
    need(kinds == ["main", "finish"] * len(calls),
         f"{len(calls)} ISLA backward calls ran {len(names)} kernels, not the main and the "
         f"finishing one each: {names[:6]}")
    for dtype, h, c, hs in labels:
        dname = str(dtype).removeprefix("torch.")
        phase("kernel", f"isla_norm_bwd kernels per call (profiler) b={B} o={O} h={h} c={c} hs={hs} "
              f"{dname} sparse: 2 (main, finishing) finish_ms={finish_by_shape[(dname, h, c, hs)]:.5f}")
    w_ms, k_ms, f_ms, p_ms, bound_ms, t_b, t_o, pf_ms, f_bound, f_b, f_o = per_forward[
        ("float32", O, "sparse")]
    bf = per_forward[("bfloat16", O, "sparse")]
    timed_as = f"sum of the ten calls of one forward's backward, b={B}, o={O}, sparse masks, L2 flushed"
    bwd = {"name": "isla_norm_bwd", "route": "cuda", "source": ISLA_BWD_SOURCE,
           "replaces": ISLA_BWD_REPLACES, "launches": None, "max_abs_err": worst_abs,
           "max_rel_err": worst_rel, "checks": n_checks,
           "ms": w_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if t_b >= t_o else "operations", "library_ms": None,
           "launch_ms": k_ms, "finish_ms": f_ms, "ms_bf16": bf[0], "launch_ms_bf16": bf[1],
           "finish_ms_bf16": bf[2], "plain_ms_bf16": bf[3], "bound_ms_bf16": bf[4],
           "timed_as": f"{timed_as}; ms = isla_norm_backward (two launches: the main kernel and "
                       "the finishing kernel), launch_ms = the main launch alone, finish_ms = the "
                       "finishing launch alone; plain = autograd of isla_norm_plain from the same "
                       "inputs"}
    fin = {"name": "isla_norm_bwd_finish", "route": "cuda", "source": ISLA_BWD_SOURCE,
           "replaces": ISLA_BWD_REPLACES, "launches": None, "max_abs_err": fin_abs,
           "max_rel_err": fin_rel, "checks": n_checks,
           "ms": f_ms, "plain_ms": pf_ms, "bound_ms": f_bound,
           "bound_by": "bytes" if f_b >= f_o else "operations", "library_ms": None,
           "ms_bf16": bf[2], "plain_ms_bf16": bf[7], "bound_ms_bf16": bf[8],
           "timed_as": f"{timed_as}; the finishing launch alone on the main kernel's partial "
                       "buffers; plain = finish_backward_plain (torch sums, the gather as "
                       "index_select passes)"}
    return bwd, fin


def bwd_vg_phase(reps: int = 50) -> dict:
    """The ISLA backward on Visual Genome traffic (``stage_masks`` pattern
    ``vg``) through the port's public entry points alone (``isla_norm``,
    ``isla_norm_backward``, ``isla_norm_plain``, ``batch_stats``), so that the
    phase also times an earlier tree of the port. At the ten shapes of one
    forward (b=8, o=31), in f32 and bf16: every gradient against autograd of
    the plain version at kernel_bwd's bars, the function's time (L2 flushed),
    the main kernel's device time from the profiler (the median of the
    kernels it saw in reps // 10 calls, L2 flushed before each), the bound, and the live objects per
    64-pixel tile. Returns {dtype name: [function ms, main kernel ms, bound
    ms]}, each summed over the ten calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from layout2img_tpu_torch.nn.norms import batch_stats
    from layout2img_tpu_torch.ops.interp import resize_bilinear
    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward, isla_norm_plain

    dev = torch.device("cuda")
    flush = torch.empty(2**28, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(2468)
    per_forward = {}
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        dname = str(dtype).removeprefix("torch.")
        for i, (h, c, hs) in enumerate(ISLA_SHAPES):
            relu = i % 2 == 1
            x = torch.randn(B, c, h, h, device=dev, generator=g).to(dtype)
            mask = stage_masks(B, O, hs, "vg", g, dtype)
            gamma, beta = (torch.randn(B, O, c, device=dev, generator=g).to(dtype) for _ in range(2))
            grad = torch.randn(B, c, h, h, device=dev, generator=g).to(dtype)
            where = f"b={B} o={O} h={h} c={c} hs={hs} {dname} vg relu={int(relu)}"
            grad, _ = _off_gate_ties(x, mask, gamma, beta, grad) if relu else (grad, 0)
            got = _isla_grads(isla_norm, x, mask, gamma, beta, grad, relu)
            torch.cuda.synchronize()
            want = _isla_grads(isla_norm_plain, *(t.float() for t in (x, mask, gamma, beta, grad)),
                               relu)
            errs = []
            for name, a, w in zip(("x", "mask_src", "gamma", "beta"), got, want):
                err, scale = (a.float() - w).abs().max().item(), w.abs().max().item()
                need(a.dtype == dtype and torch.isfinite(a.float()).all().item()
                     and err <= rel_tol * scale,
                     f"ISLA backward off in d{name} at {where}: {err} > {rel_tol} * {scale}")
                errs.append(f"d{name} {err / scale:.1e}")
            args = (x, *batch_stats(x), 1e-5, mask, gamma, beta, grad, relu)
            w_ms, w_lo, w_hi = time_ms(lambda: isla_norm_backward(*args), reps, flush)
            n_prof = max(5, reps // 10)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n_prof):
                    flush.zero_()
                    isla_norm_backward(*args)
                torch.cuda.synchronize()
            main_us = sorted(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and "isla_norm_bwd_kernel" in e.name)
            # the profiler has dropped some kernels of a run of calls on the card: the median
            # of those it saw, and a failure only when it saw none
            need(len(main_us) > 0, f"the profiler saw no main ISLA backward kernel in {n_prof} "
                                   f"calls at {where}")
            k_ms = main_us[len(main_us) // 2] / 1e3
            resized = resize_bilinear(mask.float(), (h, h)).flatten(2)  # (b, o, p)
            tp = min(64, h * h)
            tiles = torch.nn.functional.pad(resized, (0, -resized.shape[-1] % tp)).view(B, O, -1, tp)
            live_tile = (tiles != 0).any(-1).sum(1).float()  # (b, tiles)
            bound_ms, _, _ = isla_bwd_cost(x, mask, int((resized != 0).sum().item()), dname)
            phase("bwd_vg", f"isla_norm_bwd {where}: rel_err {', '.join(errs)} (bar {rel_tol:g}) "
                  f"ms={w_ms:.5f} [{w_lo:.5f}, {w_hi:.5f}] main_kernel_ms={k_ms:.5f} "
                  f"(profiled {len(main_us)}/{n_prof}) bound_us={1e3 * bound_ms:.3f} "
                  f"live_per_tile mean={live_tile.mean().item():.2f} "
                  f"max={int(live_tile.max().item())}")
            acc = per_forward.setdefault(dname, [0.0, 0.0, 0.0])
            for j, v in enumerate((w_ms, k_ms, bound_ms)):
                acc[j] += v
    for dname, (w_ms, k_ms, bound_ms) in per_forward.items():
        phase("bwd_vg", f"isla_norm_bwd {dname} o={O} vg per forward (b={B}, ten calls): "
              f"ms={w_ms:.5f} main_kernel_ms={k_ms:.5f} bound_ms={bound_ms:.5f} "
              f"share_of_bound={bound_ms / w_ms:.3f}")
    return per_forward


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def slice_phase(seed: int, tmp_dir: str, dev) -> tuple[int, dict]:
    """Drive the sampler at full width; returns the ISLA launches of its six
    forwards and the f32 and bf16 generators."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.cli.sample import load_generator
    from layout2img_tpu_torch.data.synthetic import synthetic_layouts
    from layout2img_tpu_torch.ops.isla import isla_norm
    from layout2img_tpu_torch.sample import make_sample_fn
    from layout2img_tpu_torch.utils.casting import cast_floating
    from layout2img_tpu_torch.utils.convert import init_generator

    t0 = time.perf_counter()
    gen = init_generator(seed, NUM_CLASSES, device="cpu", ch=CH)
    n_params = sum(p.numel() for p in gen.parameters())
    path = os.path.join(tmp_dir, "G.pth")
    torch.save(gen.state_dict(), path)
    del gen
    gens = {torch.float32: load_generator(path, dev),
            torch.bfloat16: cast_floating(load_generator(path, dev), torch.bfloat16)}
    phase("slice", f"ours_d_context128 ch={CH} classes={NUM_CLASSES}: {n_params} parameters, "
          f"seeded, saved and reloaded strict in {time.perf_counter() - t0:.1f}s")
    layout = synthetic_layouts(np.random.default_rng(seed), B, O, NUM_CLASSES,
                               min_objects=N_VALID, max_objects=N_VALID)
    boxes, labels = torch.from_numpy(layout["boxes"]), torch.from_numpy(layout["labels"])

    samplers = {dt: make_sample_fn(g, dtype=dt) for dt, g in gens.items()}
    rng = torch.Generator(device=dev).manual_seed(seed)
    isla_norm.launches = 0
    outs = {}
    for dt, sample in samplers.items():
        for _ in range(3):
            before = isla_norm.launches
            img = sample(boxes, labels, rng)
            sync(dev)
            need(isla_norm.launches == before + 10,
                 f"{isla_norm.launches - before} ISLA launches in one forward, not 10")
            outs[dt] = img
    launches = isla_norm.launches
    for dt, img in outs.items():
        need(img.shape == (B, 3, 128, 128) and img.dtype == dt, f"bad output {img.shape} {img.dtype}")
        f = img.float()
        need(torch.isfinite(f).all().item(), f"non-finite {dt} images")
        need(f.abs().max().item() <= 1.0, f"{dt} images outside [-1, 1]")
        phase("slice", f"{str(dt).removeprefix('torch.')} 3 batches: shape {tuple(img.shape)}, "
              f"finite, range [{f.min().item():.4f}, {f.max().item():.4f}], std {f.std().item():.4f}")
    phase("slice", f"main path ran the ISLA kernel {launches} times (10 per forward, 6 forwards)")

    # the object budget compacts the 6 valid slots into 8: same images
    budget = make_sample_fn(gens[torch.float32], obj_budget=8)
    a = samplers[torch.float32](boxes, labels, torch.Generator(device=dev).manual_seed(5))
    b = budget(boxes, labels, torch.Generator(device=dev).manual_seed(5))
    diff = (a - b).abs().max().item()
    need(diff <= 1e-4, f"obj_budget=8 changed the images by {diff}")
    phase("slice", f"obj_budget=8 vs none: max_abs_diff={diff:.3e} (bar 1e-4)")

    # one f32 batch of 2 against the plain CPU path, same weights and inputs
    g_cpu = torch.Generator().manual_seed(seed + 1)
    z = torch.randn(2, O, 128, generator=g_cpu)
    z_im = torch.randn(2, 128, generator=g_cpu)
    cpu_gen = load_generator(path, torch.device("cpu"))
    args = (z, boxes[:2], labels[:2].long(), z_im)
    with torch.inference_mode():
        want = cpu_gen(*args)
        got = gens[torch.float32](*(t.to(dev) for t in args)).cpu()
    diff = (got - want).abs().max().item()
    need(diff <= 2e-3, f"GPU vs CPU f32 forward differ by {diff} > 2e-3")
    phase("slice", f"f32 b=2 GPU kernel path vs CPU plain path: max_abs_diff={diff:.3e} (bar 2e-3)")
    return launches, gens


def rate_phase(seed: int, card: str, gens: dict) -> float | None:
    """Sampler rates, then a profiled f32 b=8 forward; returns the ISLA
    kernel's device ms in that forward (None if the profiler saw none)."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.data.synthetic import synthetic_layouts
    from layout2img_tpu_torch.sample import make_sample_fn

    dev = torch.device("cuda")
    gen, gen_bf16 = gens[torch.float32], gens[torch.bfloat16]
    runs = [("float32", gen, torch.float32, False), ("float32+tf32", gen, torch.float32, True),
            ("bfloat16", gen_bf16, torch.bfloat16, False)]
    for b, reps in ((8, 20), (128, 8)):
        layout = synthetic_layouts(np.random.default_rng(seed), b, O, NUM_CLASSES,
                                   min_objects=N_VALID, max_objects=N_VALID)
        boxes = torch.from_numpy(layout["boxes"]).to(dev)
        labels = torch.from_numpy(layout["labels"]).to(dev)
        for tag, g, dt, tf32 in runs:
            torch.backends.cudnn.allow_tf32 = tf32
            sample = make_sample_fn(g, dtype=dt)
            rng = torch.Generator(device=dev).manual_seed(seed)
            for _ in range(3):
                sample(boxes, labels, rng)
            ms, lo, hi = time_ms(lambda: sample(boxes, labels, rng), reps)
            phase("rate", f"sampler {tag} b={b} o={O}: {ms:.3f} ms/batch [{lo:.3f}, {hi:.3f}] "
                  f"over {reps} batches, {1e3 * b / ms:.1f} img/s on {card}")
    torch.backends.cudnn.allow_tf32 = False

    # where one f32 b=8 forward spends its device time
    from torch.profiler import ProfilerActivity, profile

    layout = synthetic_layouts(np.random.default_rng(seed), B, O, NUM_CLASSES,
                               min_objects=N_VALID, max_objects=N_VALID)
    boxes, labels = torch.from_numpy(layout["boxes"]), torch.from_numpy(layout["labels"])
    sample = make_sample_fn(gen)
    rng = torch.Generator(device=dev).manual_seed(seed)
    sample(boxes, labels, rng)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            sample(boxes, labels, rng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3e-3
    rows = [(e.key, e.device_time_total / 3e3, e.count // 3) for e in prof.key_averages()
            if e.device_time_total > 0 and not getattr(e, "is_user_annotation", False)
            and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total = sum(ms for _, ms, _ in rows)
    if total <= 0:
        phase("rate", "profile: the profiler saw no device time; breakdown not measured")
        return None
    rows.sort(key=lambda r: -r[1])
    isla = sum(ms for k, ms, _ in rows if "isla" in k)
    isla_n = sum(n for k, _, n in rows if "isla" in k)
    triton_n = sum(n for k, _, n in rows if "triton" in k.lower())
    need(isla_n == 10, f"the profile shows {isla_n} ISLA kernels per forward, not 10")
    need(triton_n == 0, f"the profile shows {triton_n} Triton kernels per forward")
    phase("rate", f"profile f32 b={B}: device kernel time {total:.3f} ms of {wall_ms:.3f} ms wall "
          f"per forward (traced), {sum(n for _, _, n in rows)} kernels per forward, "
          f"ISLA kernel x{isla_n} {isla:.4f} ms ({100 * isla / total:.1f}%), Triton kernels 0")
    for key, ms, n in rows[:12]:
        phase("rate", f"  {ms:8.4f} ms  {100 * ms / total:5.1f}%  x{n:<4d} {key[:90]}")
    return isla


def _train_batch(rng, b: int, dev) -> dict:
    """VG-shaped synthetic training batch: uniform images in [-1, 1], o=31
    slots with N_VALID objects, on ``dev``."""
    import torch

    from layout2img_tpu_torch.data.synthetic import synthetic_layouts

    images = rng.uniform(-1, 1, (b, 3, 128, 128)).astype("float32")
    layout = synthetic_layouts(rng, b, O, NUM_CLASSES, min_objects=N_VALID, max_objects=N_VALID)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {"images": images, **layout}.items()}
    batch["labels"] = batch["labels"].long()
    return batch


def _trainer(paths: dict, dev, seed: int, deterministic: bool = False, config=None,
             remat_blocks: int = 0):
    """(state, train_step) from the saved G and D, with the seeded VGG loss;
    ``config`` is a ``TrainConfig`` (default: the f32 step)."""
    import torch

    from layout2img_tpu_torch.cli.sample import load_generator
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.convert import init_vgg

    config = config or TrainConfig()
    gen = load_generator(paths["G"], dev)
    disc = make_discriminator("d128_app", NUM_CLASSES, device=dev, ch=CH, remat_blocks=remat_blocks)
    disc.load_state_dict(torch.load(paths["D"], map_location="cpu", weights_only=True), strict=True)
    state = create_train_state(gen, disc, config)
    vgg = VGGLoss(init_vgg(seed + 2, device=dev))
    return state, make_train_step(state, config, vgg_loss=vgg, deterministic=deterministic)


def save_train_weights(seed: int, tmp_dir: str) -> dict:
    """Seeded full-width G and D saved as reference-format state dicts;
    returns their paths."""
    import torch

    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator

    paths = {"G": os.path.join(tmp_dir, "train_G.pth"), "D": os.path.join(tmp_dir, "train_D.pth")}
    torch.save(init_generator(seed, NUM_CLASSES, device="cpu", ch=CH).state_dict(), paths["G"])
    torch.save(init_discriminator(seed + 1, NUM_CLASSES, device="cpu", ch=CH).state_dict(), paths["D"])
    return paths


def _grad_report(name: str, got, want, b: int) -> str:
    """Each gradient tensor of ``got`` (card) against ``want`` (CPU), with the
    bars of ``tests/test_torch_port_train.py``: the error norm within 1e-3 of
    the CPU norm for D and for G's res5 and final, within 1e-2 for G's layers
    before the PSP head, and within 5e-2 at b=2 for the conv feeding the BN
    of the head's 1x1 stage (that BN sees two values per channel and its
    backward is mostly what f32 leaves of 1 - y^2; that file's
    ``test_step_gradient_gap_is_the_f32_spread`` pins both); any other tensor
    under 1e-5 of the net's largest norm is round-off of an exact zero and is
    held to an absolute 1e-6 of that norm. Returns the worst tensor per bar."""
    largest = max(w.norm().item() for w in want.values())
    worst, off = {}, []
    for k, w in want.items():
        err, norm = (got[k] - w).norm().item(), w.norm().item()
        if k == PSP_STAGE_CONV and b == 2:
            kind = "5e-2"
        elif norm < 1e-5 * largest:
            kind = "abs 1e-6"
        else:
            kind = "1e-3" if name == "D" or k.startswith(AFTER_PSP) else "1e-2"
        bar = 1e-6 * largest if kind == "abs 1e-6" else float(kind) * norm
        row = (err / bar, k, err / max(norm, 1e-30))
        worst[kind] = max(worst.get(kind, row), row)
        if err > bar:
            off.append(row)
    need(not off, f"train step card vs CPU, b={b}: {name} gradients off their bars (ratio, name, "
                  f"relative error): {sorted(off, reverse=True)[:6]}")
    return f"b={b} {name} grads within their bars; " + "; ".join(
        f"bar {kind}: worst {k} at {ratio:.3f} of it (relative error {rel:.3e})"
        for kind, (ratio, k, rel) in sorted(worst.items()))


def _step_grads(paths: dict, dev, seed: int, batch: dict, z, z_im, shown=None):
    """One step without dropout on ``dev`` from the saved weights: its losses,
    the gradients of G and D, the images G made and the gradient of the G
    loss at the images D saw. With ``shown``, D sees those images in place
    of G's (G's gradient still flows through them)."""
    state, step = _trainer(paths, dev, seed, deterministic=True)
    seen = {}

    def swap(module, args, out):
        seen["images"] = out.detach().cpu()
        if shown is not None:
            out = shown.to(dev) + (out - out.detach())
        out.register_hook(lambda grad: seen.__setitem__("at_images", grad.detach().cpu()))
        return out

    state.generator.register_forward_hook(swap)
    m = step.with_latents({k: v.to(dev) for k, v in batch.items()}, z.to(dev), z_im.to(dev))
    grads = {n: {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
             for n, net in (("G", state.generator), ("D", state.discriminator))}
    return {k: v.item() for k, v in m.items()}, grads, seen


def card_vs_cpu(seed: int, paths: dict, dev, b: int) -> None:
    """One step on the card against the same step on the CPU (same weights,
    batch and latents, dropout off: the two devices draw it apart). D's
    gradient with respect to its input image moves by about 1e-3 where
    round-off moves the image by about 1e-6, so the CPU's D is shown the
    card's images; the run prints both moves."""
    import numpy as np
    import torch

    batch = _train_batch(np.random.default_rng(seed + 7), b, "cpu")
    g = torch.Generator().manual_seed(seed + 7)
    z, z_im = torch.randn(b, O, 128, generator=g), torch.randn(b, 128, generator=g)
    cpu = torch.device("cpu")
    m_card, g_card, card = _step_grads(paths, dev, seed, batch, z, z_im)
    _, _, own = _step_grads(paths, cpu, seed, batch, z, z_im)
    m_cpu, g_cpu, shown = _step_grads(paths, cpu, seed, batch, z, z_im, shown=card["images"])

    def rel(a, w):
        return ((a - w).norm() / w.norm()).item()

    phase("train", f"f32 b={b} step card vs CPU: images {rel(card['images'], own['images']):.3e} "
          f"apart; D's gradient at them {rel(card['at_images'], own['at_images']):.3e} apart, and "
          f"{rel(shown['at_images'], own['at_images']):.3e} between the CPU's D at its own images and "
          f"at the card's; {rel(card['at_images'], shown['at_images']):.3e} with the CPU's D shown the "
          "card's images, as below")
    worst = max(abs(m_card[k] - m_cpu[k]) for k in m_cpu)
    need(worst <= 2e-3, f"train step card vs CPU, b={b}: losses differ by {worst} > 2e-3: {m_card} {m_cpu}")
    phase("train", f"f32 b={b} step card vs CPU: losses within {worst:.3e} (bar 2e-3)")
    phase("train", _grad_report("D", g_card["D"], g_cpu["D"], b))
    phase("train", _grad_report("G", g_card["G"], g_cpu["G"], b))


def drive_steps(name: str, tag: str, state, step, batches: list, rng, dev,
                per_step: int = 10) -> tuple[int, int, int]:
    """The main path of a train phase: the given steps, with the kernels'
    counts set to 0 just before and read just after. Checks finite losses,
    ``per_step`` launches of each ISLA kernel per step (the generator's norm
    calls), f32 masters, and that the parameters, the BN running statistics
    and the SN u vectors moved. Returns the launches of the forward kernel
    and of the backward's main and finishing kernels."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward

    gen, disc = state.generator, state.discriminator
    before = {f"G.{k}": v.clone() for k, v in gen.state_dict().items()}
    before |= {f"D.{k}": v.clone() for k, v in disc.state_dict().items()}
    isla_norm.launches = isla_norm_backward.launches = isla_norm_backward.finish_launches = 0
    for i, batch in enumerate(batches):
        f0, b0, n0 = isla_norm.launches, isla_norm_backward.launches, isla_norm_backward.finish_launches
        metrics = step(batch, rng)
        sync(dev)
        fwd, bwd = isla_norm.launches - f0, isla_norm_backward.launches - b0
        fin = isla_norm_backward.finish_launches - n0
        need((fwd, bwd, fin) == (per_step,) * 3,
             f"{tag} train step {i + 1}: {fwd} ISLA forward, {bwd} backward and {fin} finishing "
             f"launches, not {per_step} each")
        values = {k: v.item() for k, v in metrics.items()}
        need(all(np.isfinite(v) for v in values.values()), f"{tag} train step {i + 1}: non-finite {values}")
        phase(name, f"{tag} b={len(batch['labels'])} step {i + 1}: "
              + " ".join(f"{k}={v:.5f}" for k, v in values.items()))
    launches = (isla_norm.launches, isla_norm_backward.launches, isla_norm_backward.finish_launches)
    phase(name, f"main path ran the ISLA forward kernel {launches[0]} times, the backward's "
          f"main kernel {launches[1]} times and its finishing kernel {launches[2]} times "
          f"({len(batches)} steps, {per_step} each per step)")

    after = {f"G.{k}": v for k, v in gen.state_dict().items()}
    after |= {f"D.{k}": v for k, v in disc.state_dict().items()}
    params = {f"G.{k}": p for k, p in gen.named_parameters()}
    params |= {f"D.{k}": p for k, p in disc.named_parameters()}
    masters = [k for k, p in params.items() if p.dtype != torch.float32 or p.grad.dtype != torch.float32]
    need(not masters, f"{tag}: parameters or gradients not f32: {masters[:5]}")
    # a parameter whose gradient is exactly zero stays put (D's score biases:
    # while every hinge term is active, the real and fake terms cancel)
    zero_grad = sorted(k for k, p in params.items() if not p.grad.any())
    for what, keys in (("parameters", sorted(set(params) - set(zero_grad))),
                       ("BN running statistics", [k for k in after if k.endswith("running_mean")]),
                       ("SN u vectors", [k for k in after if k.endswith("weight_u")])):
        still = [k for k in keys if torch.equal(before[k], after[k])]
        need(keys and not still, f"{tag}: {len(still)} of {len(keys)} {what} did not move: {still[:5]}")
        phase(name, f"all {len(keys)} {what} moved (parameters and gradients f32)")
    phase(name, f"{len(zero_grad)} parameters had an exactly zero gradient in the last step: "
          f"{zero_grad[:6]}")
    return launches


def train_phase(seed: int, tmp_dir: str, dev) -> tuple[tuple[int, int, int], dict]:
    """Drive the train step at full width; returns the launches of the ISLA
    forward kernel and of the backward's main and finishing kernels in its
    TRAIN_STEPS steps, and the saved weights' paths."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    paths = save_train_weights(seed, tmp_dir)
    state, step = _trainer(paths, dev, seed)
    gen, disc = state.generator, state.discriminator
    phase("train", f"ours_d_context128 + d128_app ch={CH} classes={NUM_CLASSES}: "
          f"{sum(p.numel() for p in gen.parameters())} + {sum(p.numel() for p in disc.parameters())} "
          f"parameters, seeded, saved and reloaded strict in {time.perf_counter() - t0:.1f}s")
    data_rng = np.random.default_rng(seed)
    batches = [_train_batch(data_rng, B, dev) for _ in range(TRAIN_STEPS)]
    launches = drive_steps("train", "f32", state, step, batches,
                           torch.Generator(device=dev).manual_seed(seed), dev)

    # b=2 as the CPU tests run it, where the PSP head's 1x1 stage sees two
    # values per channel; b=8, where it sees eight
    for b in (2, 8):
        card_vs_cpu(seed, paths, dev, b)
    return launches, paths


def train_rate_phase(seed: int, card: str, paths: dict) -> tuple[float | None, ...]:
    """Train-step rates at b=8 and b=32, in f32 (as ``cli/train.py`` runs
    it) and with TF32 in cuDNN and matmul, then a profiled f32 b=8 step;
    returns the device ms of the ISLA forward kernel and of the backward's
    main and finishing kernels in that step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    for b, reps in ((8, 10), (32, 5)):
        for tag, tf32 in (("f32", False), ("f32+tf32", True)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            state, step = _trainer(paths, dev, seed)
            batch = _train_batch(np.random.default_rng(seed), b, dev)
            rng = torch.Generator(device=dev).manual_seed(seed)
            for _ in range(3):
                step(batch, rng)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, lo, hi = time_ms(lambda: step(batch, rng), reps)
            peak = torch.cuda.max_memory_allocated() / 2**30
            phase("rate", f"train step {tag} b={b} o={O}: {ms:.3f} ms/step [{lo:.3f}, {hi:.3f}] over "
                  f"{reps} steps, {1e3 * b / ms:.1f} img/s, peak {peak:.2f} GiB allocated on {card}")
            del state, step
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    state, step = _trainer(paths, dev, seed)
    batch = _train_batch(np.random.default_rng(seed), B, dev)
    rng = torch.Generator(device=dev).manual_seed(seed)
    step(batch, rng)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch, rng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 2e-3
    rows = [(e.key, e.device_time_total / 2e3, e.count // 2) for e in prof.key_averages()
            if e.device_time_total > 0 and not getattr(e, "is_user_annotation", False)
            and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total = sum(ms for _, ms, _ in rows)
    if total <= 0:
        phase("rate", "train profile: the profiler saw no device time; breakdown not measured")
        return None, None, None
    rows.sort(key=lambda r: -r[1])
    fwd = [(ms, n) for k, ms, n in rows if "isla_norm_kernel" in k]
    bwd = [(ms, n) for k, ms, n in rows if "isla_norm_bwd_kernel" in k]
    fin = [(ms, n) for k, ms, n in rows if "isla_norm_bwd_finish_kernel" in k]
    f_ms, f_n = sum(ms for ms, _ in fwd), sum(n for _, n in fwd)
    b_ms, b_n = sum(ms for ms, _ in bwd), sum(n for _, n in bwd)
    n_ms, n_n = sum(ms for ms, _ in fin), sum(n for _, n in fin)
    need((f_n, b_n, n_n) == (10, 10, 10),
         f"the train profile shows {f_n} ISLA forward, {b_n} backward and {n_n} finishing kernels "
         "per step, not 10 each")
    phase("rate", f"train profile f32 b={B}: device kernel time {total:.3f} ms of {wall_ms:.3f} ms "
          f"wall per step (traced), {sum(n for _, _, n in rows)} kernels per step, ISLA forward x{f_n} "
          f"{f_ms:.4f} ms ({100 * f_ms / total:.1f}%), ISLA backward x{b_n} {b_ms:.4f} ms "
          f"({100 * b_ms / total:.1f}%) and its finishing kernel x{n_n} {n_ms:.4f} ms "
          f"({100 * n_ms / total:.1f}%) on {card}")
    for key, ms, n in rows[:15]:
        phase("rate", f"  {ms:8.4f} ms  {100 * ms / total:5.1f}%  x{n:<4d} {key[:90]}")
    return f_ms, b_ms, n_ms


def _profile_steps(step, batch, rng, n: int = 2):
    """One profiler session over ``n`` steps after one unprofiled step:
    (device ms per step, traced wall ms per step, kernels per step, rows of
    (name, device ms per step, launches per step) by time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(batch, rng)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch, rng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.key, e.device_time_total / (1e3 * n), e.count // n) for e in prof.key_averages()
            if e.device_time_total > 0 and not getattr(e, "is_user_annotation", False)
            and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms, _ in rows), wall_ms, sum(k for _, _, k in rows), rows


def by_kind(rows, dev_ms: float) -> str:
    """Profiler rows of (name, device ms, launches) summed by the kinds of
    ``PROFILE_GROUPS``, largest first."""
    groups = {}
    for key, ms, n in rows:
        group = next((g for g, marks in PROFILE_GROUPS if any(m in key for m in marks)), "other")
        t_ms, t_n = groups.get(group, (0.0, 0))
        groups[group] = (t_ms + ms, t_n + n)
    return "; ".join(f"{g} {ms:.3f} ms ({100 * ms / dev_ms:.1f}%, x{n})"
                     for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]))


def _one_step(paths: dict, dev, seed: int, inputs, config, remat_blocks: int = 0):
    """One step without dropout from the saved weights: the state, its
    metrics, the ISLA launches (forward, backward main, finishing) and G's
    parameters before it."""
    from types import SimpleNamespace

    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward

    state, step = _trainer(paths, dev, seed, deterministic=True, config=config,
                           remat_blocks=remat_blocks)
    init = {k: p.detach().clone() for k, p in state.generator.named_parameters()}
    isla_norm.launches = isla_norm_backward.launches = isla_norm_backward.finish_launches = 0
    metrics = step.with_latents(*inputs)
    sync(dev)
    launches = (isla_norm.launches, isla_norm_backward.launches, isla_norm_backward.finish_launches)
    return SimpleNamespace(state=state, metrics={k: v.item() for k, v in metrics.items()},
                           launches=launches, init=init)


def _same_step(tag: str, got, want, rtol: float, atol: float, param_atol: float,
               state_atol: float | None = None, grads: bool = True) -> str:
    """``got``'s step against ``want``'s: every metric of ``want`` within
    atol + rtol |want|, every parameter within param_atol, with
    ``state_atol`` every SN vector and BN running statistic, and with
    ``grads`` every gradient at the step tests' per-layer bars."""
    missing = sorted(set(want.metrics) - set(got.metrics))
    need(not missing, f"{tag}: metrics missing: {missing}")
    worst_m = max(abs(got.metrics[k] - v) / (atol + rtol * abs(v)) for k, v in want.metrics.items())
    need(worst_m <= 1.0, f"{tag}: metrics off: {got.metrics} against {want.metrics}")
    worst_p = worst_s = 0.0
    grads_seen = {}
    for net in ("generator", "discriminator"):
        ga, gb = getattr(got.state, net), getattr(want.state, net)
        pb, sb = dict(gb.named_parameters()), gb.state_dict()
        for name, p in ga.named_parameters():
            off = (p - pb[name]).abs().max().item()
            need(off <= param_atol, f"{tag}: {net} parameter {name} off by {off} > {param_atol}")
            worst_p = max(worst_p, off)
        for name, t in ga.state_dict().items():
            if state_atol is not None and name.endswith(("weight_u", "weight_v", "running_mean",
                                                         "running_var")):
                off = (t - sb[name]).abs().max().item()
                need(off <= state_atol, f"{tag}: {net} {name} off by {off} > {state_atol}")
                worst_s = max(worst_s, off)
        grads_seen[net] = ({k: p.grad.detach().cpu() for k, p in ga.named_parameters()},
                           {k: p.grad.detach().cpu() for k, p in pb.items()})
    line = (f"{tag}: metrics within {worst_m:.3f} of their bar (rtol {rtol:g}, atol {atol:g}), "
            f"parameters within {worst_p:.3e} (bar {param_atol:g})")
    if state_atol is not None:
        line += f", SN vectors and BN statistics within {worst_s:.3e} (bar {state_atol:g})"
    if grads:
        line += "; " + "; ".join(_grad_report(n[0].upper(), *grads_seen[n], 2)
                                 for n in ("discriminator", "generator"))
    return line


def knob_checks(seed: int, paths: dict, dev) -> None:
    """One f32 step at b=2 for each knob against the plain step from the same
    weights, batch and latents, with cuDNN's deterministic algorithms, at
    the CPU tests' bars: remat and remat_d_blocks as the plain step (losses
    rtol 1e-4 + atol 1e-5, parameters 2.1e-4, SN vectors and BN statistics
    1e-6, gradients at the step tests' per-layer bars); the object budgets
    of 12 (6 valid objects in 31 slots) the same, the state at 1e-4 (fewer
    slots reorder sums; the JAX parity tests' bar for the PSP bottleneck's
    BN), with their overflow metrics at 0; fused_d at the JAX package's fused bars (losses rtol 5e-3
    + atol 5e-4, parameters 1e-4 + 1e-2 |p|: two power iterations, not
    three); EMA as the plain step, with e = 0.999 init + 0.001 new."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.train.state import TrainConfig

    batch = _train_batch(np.random.default_rng(seed + 9), 2, dev)
    g = torch.Generator().manual_seed(seed + 9)
    inputs = (batch, torch.randn(2, O, 128, generator=g).to(dev), torch.randn(2, 128, generator=g).to(dev))
    torch.backends.cudnn.deterministic = True
    try:
        plain = _one_step(paths, dev, seed, inputs, TrainConfig())
        need(plain.launches == (10, 10, 10), f"plain step: ISLA launches {plain.launches}")
        same = dict(rtol=1e-4, atol=1e-5, param_atol=2.1e-4)
        for tag, cfg, blocks, want_launches, state_atol in (
                ("remat=gd", TrainConfig(remat="gd"), 0, (20, 10, 10), 1e-6),
                ("remat_d_blocks=2", TrainConfig(), 2, (10, 10, 10), 1e-6),
                ("g_obj_budget=12", TrainConfig(g_obj_budget=12), 0, (10, 10, 10), 1e-4),
                ("d_obj_budget=12", TrainConfig(d_obj_budget=12), 0, (10, 10, 10), 1e-4)):
            got = _one_step(paths, dev, seed, inputs, cfg, remat_blocks=blocks)
            need(got.launches == want_launches,
                 f"{tag}: ISLA launches (forward, backward, finishing) {got.launches}, not {want_launches}")
            overflow = {k: v for k, v in got.metrics.items() if k.endswith("_budget_overflow")}
            need(all(v == 0.0 for v in overflow.values()) and len(overflow) == ("budget" in tag),
                 f"{tag}: overflow metrics {overflow}")
            phase("train_mixed", _same_step(tag, got, plain, state_atol=state_atol, **same)
                  + f"; ISLA launches {got.launches}" + (f"; {overflow}" if overflow else ""))
        got = _one_step(paths, dev, seed, inputs, TrainConfig(fused_d=True))
        phase("train_mixed", _same_step("fused_d", got, plain, rtol=5e-3, atol=5e-4, param_atol=2.1e-4,
                                        grads=False))
        got = _one_step(paths, dev, seed, inputs, TrainConfig(ema_decay=0.999))
        line = _same_step("ema_decay=0.999", got, plain, state_atol=1e-6, **same)
        live = dict(got.state.generator.named_parameters())
        off = max((e - (0.999 * got.init[k] + (1.0 - 0.999) * live[k].detach())).abs().max().item()
                  for k, e in got.state.ema.items())
        need(off <= 1e-6, f"ema_decay=0.999: the average is off by {off}")
        need(all(e.data_ptr() != live[k].data_ptr() for k, e in got.state.ema.items()),
             "ema_decay=0.999: the average aliases the live parameters")
        phase("train_mixed", f"{line}; EMA = 0.999 init + 0.001 new within {off:.3e} (bar 1e-6)")
    finally:
        torch.backends.cudnn.deterministic = False


def capture_isla_calls(built) -> list[dict]:
    """One step of a built bench state, keeping each ISLA norm call's inputs
    and the gradient its output received."""
    from layout2img_tpu_torch.nn import norms

    real, calls = norms.isla_norm, []

    def keep(x, mean, var, eps, mask, gamma, beta, relu=False):
        out = real(x, mean, var, eps, mask, gamma, beta, relu=relu)
        rec = {"args": tuple(t.detach() for t in (x, mean, var)) + (eps,)
               + tuple(t.detach() for t in (mask, gamma, beta)), "relu": relu}
        if out.requires_grad:
            out.register_hook(lambda grad: rec.__setitem__("grad", grad.detach()))
        calls.append(rec)
        return out

    norms.isla_norm = keep
    try:
        built.step(built.batch, built.rng)
        sync(built.batch["labels"].device)
    finally:
        norms.isla_norm = real
    return calls


def check_captured(tag: str, calls: list, want_o: int, reps: int, want_calls: int = 10,
                   dtype=None, name: str = "train_mixed") -> tuple[float, ...]:
    """Each captured call's forward and every gradient of its backward (the
    direct dx, dmean, dvar, the source mask, gamma, beta; the output
    gradient zeroed at the ReLU gate's ties) against the plain versions, as
    the kernel phases hold them: bf16 (the default) forward 1e-2 and
    backward 2e-2 of max|plain|, f32 1e-5 and 1e-4; then the kernels' and
    the plain versions' times (L2 flushed). Returns (forward ms, plain ms,
    bound ms, backward ms, plain ms, bound ms), each summed over the
    calls."""
    import torch

    from layout2img_tpu_torch.ops.interp import resize_bilinear
    from layout2img_tpu_torch.ops.isla import (_plain_backward, isla_norm, isla_norm_backward,
                                               isla_norm_plain)

    dtype = dtype or torch.bfloat16
    dname = str(dtype).removeprefix("torch.")
    f_tol, b_tol = (1e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    need(len(calls) == want_calls and all("grad" in c for c in calls),
         f"{tag}: captured {len(calls)} ISLA calls, {sum('grad' in c for c in calls)} with "
         f"gradients, not {want_calls}")
    flush = torch.empty(2**28, dtype=torch.float32, device="cuda")
    sums = [0.0] * 6
    for i, rec in enumerate(calls):
        x, mean, var, eps, mask, gamma, beta = rec["args"]
        relu, grad = rec["relu"], rec["grad"]
        b, c, h, w = x.shape
        o, hs = mask.shape[1], mask.shape[2]
        where = f"{tag} call {i + 1}: b={b} o={o} h={h} c={c} hs={hs} relu={int(relu)}"
        need(x.dtype == mask.dtype == gamma.dtype == grad.dtype == dtype and o == want_o,
             f"{where}: not {dname} with o={want_o}: {x.dtype} {mask.dtype} {grad.dtype}")
        args = (x, mean, var, eps, mask, gamma, beta)
        with torch.no_grad():
            got = isla_norm(*args, relu=relu).float()
            ref = isla_norm_plain(*args, relu=relu).float()
        f_err, f_scale = (got - ref).abs().max().item(), ref.abs().max().item()
        need(torch.isfinite(got).all().item() and f_err <= f_tol * f_scale,
             f"{where}: forward off by {f_err} > {f_tol} * {f_scale}")
        pre = isla_norm_plain(x.float(), mean, var, eps, mask.float(), gamma.float(), beta.float())
        ties = pre.abs() <= 1e-5 * pre.abs().max() if relu else torch.zeros_like(pre, dtype=torch.bool)
        grad = grad.masked_fill(ties, 0)
        got_b = isla_norm_backward(*args, grad, relu)
        want_b = _plain_backward(x.float(), mean, var, eps, mask.float(), gamma.float(), beta.float(),
                                 grad.float(), relu)
        errs = []
        for gname, a, wt in zip(("x", "mean", "var", "mask_src", "gamma", "beta"), got_b, want_b):
            err, scale = (a.float() - wt).abs().max().item(), wt.abs().max().item()
            need(torch.isfinite(a.float()).all().item() and err <= b_tol * scale,
                 f"{where}: backward off in d{gname}: {err} > {b_tol} * {scale}")
            errs.append(f"d{gname} {err / max(scale, 1e-30):.1e}")
        live = int((resize_bilinear(mask.float(), (h, w)) != 0).sum().item())
        bound_f, bound_b = isla_cost(x, mask, live, dname)[0], isla_bwd_cost(x, mask, live, dname)[0]
        with torch.no_grad():
            f_ms = time_ms(lambda: isla_norm(*args, relu=relu), reps, flush)[0]
            pf_ms = time_ms(lambda: isla_norm_plain(*args, relu=relu), max(3, reps // 4), flush)[0]
        b_ms = time_ms(lambda: isla_norm_backward(*args, grad, relu), reps, flush)[0]
        pb_ms = time_ms(lambda: _plain_backward(*args, grad, relu), max(3, reps // 4), flush)[0]
        phase(name, f"{where} {dname}: forward rel_err {f_err / f_scale:.1e} (bar {f_tol:g}), "
              f"backward rel_err {', '.join(errs)} (bar {b_tol:g}, {int(ties.sum())} gate ties); forward "
              f"{f_ms:.5f} ms (plain {pf_ms:.5f}, bound {bound_f:.5f}), backward {b_ms:.5f} ms "
              f"(plain {pb_ms:.5f}, bound {bound_b:.5f})")
        for j, v in enumerate((f_ms, pf_ms, bound_f, b_ms, pb_ms, bound_b)):
            sums[j] += v
    phase(name, f"{tag}: the {len(calls)} {dname} calls of one step: forward {sums[0]:.5f} ms (plain "
          f"{sums[1]:.5f}, bound {sums[2]:.5f}), backward {sums[3]:.5f} ms (plain {sums[4]:.5f}, "
          f"bound {sums[5]:.5f})")
    return tuple(sums)


def train_mixed_phase(seed: int, tmp_dir: str, dev, card: str, paths: dict | None,
                      reps: int) -> dict:
    """The mixed-precision step at full width, the knobs against the plain
    step, the kernels at the bench's shapes and the bench's rates. Returns
    the kernel rows' additions."""
    import numpy as np
    import torch

    from layout2img_tpu_torch import bench
    from layout2img_tpu_torch.train.state import TrainConfig

    t0 = time.perf_counter()
    paths = paths or save_train_weights(seed, tmp_dir)

    # ---- the main path: 5 mixed steps at b=8 ----
    state, step = _trainer(paths, dev, seed, config=TrainConfig(mixed_precision=True))
    data_rng = np.random.default_rng(seed + 3)
    batches = [_train_batch(data_rng, B, dev) for _ in range(TRAIN_STEPS)]
    rng = torch.Generator(device=dev).manual_seed(seed)
    launches = drive_steps("train_mixed", "bf16 mixed", state, step, batches, rng, dev)
    names = device_kernels([lambda: step(batches[0], rng)])
    kinds = {k: [n for n in names if k in n] for k in ("isla_norm_kernel", "isla_norm_bwd_kernel",
                                                       "isla_norm_bwd_finish_kernel")}
    need(all(len(v) == 10 and all("bfloat16" in n for n in v) for v in kinds.values()),
         f"the profiler saw {[(k, len(v)) for k, v in kinds.items()]} ISLA kernels in one mixed "
         f"step, not 10 bf16 each: {[v[:1] for v in kinds.values()]}")
    phase("train_mixed", f"profiler: one mixed step ran 10 bf16 launches of each ISLA kernel "
          f"({kinds['isla_norm_kernel'][0][:60]}...) among {len(names)} kernels")
    del state, step, batches
    torch.cuda.empty_cache()

    # ---- every knob against the plain step, f32 at b=2 ----
    knob_checks(seed, paths, dev)

    # ---- the kernels at the bench's shapes, the bench's rates, the profile ----
    out = {"launches": launches}
    configs = (("bench default", bench.BenchConfig(scans=2), 8),
               ("bench VG budgeted", bench.BenchConfig(scans=2, obj=31, classes=179, valid_max=10,
                                                       d_obj_budget=12, g_obj_budget=12), 12))
    for tag, cfg, want_o in configs:
        built = bench.build(cfg, dev)
        sums = check_captured(f"{tag} b={cfg.batch}", capture_isla_calls(built), want_o, reps)
        out[tag] = sums
        rate = bench.time_steps(built, cfg, dev)
        phase("train_mixed", f"{tag} (b={cfg.batch}, o={cfg.obj}, valid_max={cfg.valid_max}, "
              f"budgets g={cfg.g_obj_budget} d={cfg.d_obj_budget}, {cfg.classes} classes, mixed): "
              f"{rate['img_s']:.1f} img/s, step {rate['median_ms']:.3f} ms median "
              f"[{rate['p25_ms']:.3f}, {rate['p75_ms']:.3f}] over {len(rate['step_ms'])} steps, "
              f"peak {rate['peak_gib']:.2f} GiB allocated on {card}; bench line "
              + json.dumps(rate["line"]))
        if tag == "bench default":
            dev_ms, wall_ms, kernels, rows = _profile_steps(built.step, built.batch, built.rng)
            need(dev_ms > 0, "the profiler saw no device time in the mixed b=128 step")
            isla = [(k, ms, n) for k, ms, n in rows if "isla_norm" in k]
            isla_ms = sum(ms for _, ms, _ in isla)
            phase("train_mixed", f"profile mixed b={cfg.batch} o={cfg.obj}: device kernel time "
                  f"{dev_ms:.3f} ms of {wall_ms:.3f} ms traced per step ({100 * dev_ms / wall_ms:.1f}% "
                  f"busy), {kernels} kernels per step, ISLA kernels x{sum(n for _, _, n in isla)} "
                  f"{isla_ms:.4f} ms ({100 * isla_ms / dev_ms:.1f}%) on {card}")
            phase("train_mixed", "profile by kind: " + by_kind(rows, dev_ms))
            for key, ms, n in rows[:15]:
                phase("train_mixed", f"  {ms:8.4f} ms  {100 * ms / dev_ms:5.1f}%  x{n:<4d} {key[:90]}")
        del built
        torch.cuda.empty_cache()
    f32 = bench.BenchConfig(batch=32, mixed=False, scan=3, scans=2)
    rate = bench.run(f32, dev)
    phase("train_mixed", f"f32 step for comparison (b=32, o=8, 184 classes, TF32 off): "
          f"{rate['img_s']:.1f} img/s, step {rate['median_ms']:.3f} ms median "
          f"[{rate['p25_ms']:.3f}, {rate['p75_ms']:.3f}] over {len(rate['step_ms'])} steps, peak "
          f"{rate['peak_gib']:.2f} GiB allocated on {card}")
    torch.cuda.empty_cache()
    phase("train_mixed", f"{time.perf_counter() - t0:.1f}s")
    return out


PRESET_TIMED_STEPS = 3  # timed steps per experiment and precision in the presets phase
# the presets phase: (experiment, generator preset, D preset), the slice's
# LostGAN experiments (cli/presets.py) and the 64px pair
PRESET_RUNS = (("ours_d", "ours_d_base128", "d128_app"), ("context_app", "context128", "d128_app"),
               ("context_nogeo", "context128_nogeo", "d128"),
               ("context_app_nogeo", "context128_nogeo", "d128_app"),
               ("graph_context_app", "graph128", "d128_app"), ("lostgan", "lostgan128", "d128"),
               ("context_part", "context128_part", "d128"), ("ours_d_256", "ours_d_base256", "d256"),
               ("lostgan64", "lostgan64", "d64"))
COCO_CLASSES, COCO_OBJ = 184, 8


def presets_phase(seed: int, tmp_dir: str, dev, card: str, reps: int) -> dict:
    """Every LostGAN experiment of the slice and the 64px pair at full width
    (ch=64, 184 classes, COCO-shaped batches: o=8 with 3-8 objects): G and D
    seeded, saved and reloaded strictly on the card; 3 f32 train steps at
    b=8 (finite losses; parameters, BN statistics and SN vectors moved; the
    ISLA launches per step that the preset implies, by the counts and by
    the profiler); the ISLA calls of one f32 step and of one mixed step
    captured and held against the plain versions; one f32 eval forward at
    b=2 against the CPU at 2e-3; the f32 and mixed step ms at b=8. Then the
    bench with ``BENCH_MODEL=ours_d_base256`` (mixed, b=32). Returns the
    launches of the three kernels over the phase's steps and the captured
    calls' sums per experiment."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from layout2img_tpu_torch import bench
    from layout2img_tpu_torch.data.synthetic import synthetic_batch
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.models.generators import make_generator
    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator, init_vgg

    t0 = time.perf_counter()
    vgg = VGGLoss(init_vgg(seed + 2, device=dev))
    paths = {}

    def saved(kind: str, preset: str) -> str:
        """The seeded full-width net's state dict, written once per preset."""
        if (kind, preset) not in paths:
            init = init_generator if kind == "G" else init_discriminator
            path = os.path.join(tmp_dir, f"presets_{kind}_{preset}.pth")
            torch.save(init(seed + (kind == "D"), COCO_CLASSES, preset=preset, device="cpu",
                            ch=CH).state_dict(), path)
            paths[(kind, preset)] = path
        return paths[(kind, preset)]

    def load(kind: str, preset: str, device):
        make = make_generator if kind == "G" else make_discriminator
        net = make(preset, COCO_CLASSES, device=device, ch=CH)
        net.load_state_dict(torch.load(saved(kind, preset), map_location="cpu", weights_only=True),
                            strict=True)
        return net

    def trainer(gen_preset: str, disc_preset: str, config):
        state = create_train_state(load("G", gen_preset, dev), load("D", disc_preset, dev), config)
        return state, make_train_step(state, config, vgg_loss=vgg)

    totals, out = [0, 0, 0], {}
    for exp_name, gen_preset, disc_preset in PRESET_RUNS:
        t1 = time.perf_counter()
        state, step = trainer(gen_preset, disc_preset, TrainConfig())
        gen = state.generator
        size, calls = gen.image_size, gen.isla_calls
        tag = f"{exp_name} ({gen_preset} + {disc_preset}, {size}px)"
        phase("presets", f"{tag}: {sum(p.numel() for p in gen.parameters())} + "
              f"{sum(p.numel() for p in state.discriminator.parameters())} parameters, seeded, "
              f"saved and reloaded strict; {calls} ISLA calls per forward")
        data_rng = np.random.default_rng(seed + 11)
        batches = []
        for _ in range(3):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
                data_rng, B, size, COCO_OBJ, COCO_CLASSES).items()}
            batch["labels"] = batch["labels"].long()
            batches.append(batch)
        rng = torch.Generator(device=dev).manual_seed(seed)
        launches = drive_steps("presets", f"{exp_name} f32", state, step, batches, rng, dev,
                               per_step=calls)
        totals = [a + b for a, b in zip(totals, launches)]
        names = device_kernels([lambda: step(batches[0], rng)])
        seen = [sum(k in n for n in names) for k in ("isla_norm_kernel", "isla_norm_bwd_kernel",
                                                     "isla_norm_bwd_finish_kernel")]
        need(seen == [calls] * 3, f"{tag}: the profiler saw {seen} ISLA forward, backward and "
                                  f"finishing kernels in one f32 step, not {calls} each")
        f32_ms = time_ms(lambda: step(batches[0], rng), PRESET_TIMED_STEPS)
        built = SimpleNamespace(step=step, batch=batches[0], rng=rng)
        f32_sums = check_captured(f"{exp_name} f32 b={B}", capture_isla_calls(built), COCO_OBJ,
                                  reps, calls, torch.float32, "presets")
        del state, step, built

        state, step = trainer(gen_preset, disc_preset, TrainConfig(mixed_precision=True))
        built = SimpleNamespace(step=step, batch=batches[0], rng=rng)
        bf_sums = check_captured(f"{exp_name} mixed b={B}", capture_isla_calls(built), COCO_OBJ,
                                 reps, calls, torch.bfloat16, "presets")
        mixed_ms = time_ms(lambda: step(batches[0], rng), PRESET_TIMED_STEPS)
        del state, step, built, batches

        # one f32 eval forward at b=2, card against CPU
        layout = synthetic_layouts_np(seed + 13, 2, size)
        g_cpu = torch.Generator().manual_seed(seed + 13)
        args = (torch.randn(2, COCO_OBJ, 128, generator=g_cpu), layout["boxes"], layout["labels"],
                torch.randn(2, 128, generator=g_cpu))
        with torch.inference_mode():
            want = load("G", gen_preset, torch.device("cpu"))(*args)
            got = load("G", gen_preset, dev)(*(t.to(dev) for t in args)).cpu()
        diff = (got - want).abs().max().item()
        need(got.shape == (2, 3, size, size) and torch.isfinite(got).all().item() and diff <= 2e-3,
             f"{tag}: card vs CPU f32 eval forward differ by {diff} > 2e-3")
        phase("presets", f"{tag}: f32 b=2 eval forward card vs CPU max_abs_diff={diff:.3e} "
              f"(bar 2e-3); step b={B}: f32 {f32_ms[0]:.3f} ms [{f32_ms[1]:.3f}, {f32_ms[2]:.3f}], "
              f"mixed {mixed_ms[0]:.3f} ms [{mixed_ms[1]:.3f}, {mixed_ms[2]:.3f}] on {card}; "
              f"{time.perf_counter() - t1:.1f}s")
        out[exp_name] = {"f32": f32_sums, "bf16": bf_sums, "f32_ms": f32_ms[0],
                         "mixed_ms": mixed_ms[0], "calls": calls}
        torch.cuda.empty_cache()

    cfg = bench.BenchConfig(batch=32, scan=3, scans=2, model="ours_d_base256")
    rate = bench.run(cfg, dev)
    phase("presets", f"bench BENCH_MODEL=ours_d_base256 (b={cfg.batch}, o={cfg.obj}, "
          f"{cfg.classes} classes, mixed, D = d256 with the app head): {rate['img_s']:.1f} img/s, "
          f"step {rate['median_ms']:.3f} ms median [{rate['p25_ms']:.3f}, {rate['p75_ms']:.3f}] "
          f"over {len(rate['step_ms'])} steps, peak {rate['peak_gib']:.2f} GiB allocated on {card}; "
          "bench line " + json.dumps(rate["line"]))
    torch.cuda.empty_cache()
    phase("presets", f"main path ran the ISLA forward kernel {totals[0]} times, the backward's "
          f"main kernel {totals[1]} and its finishing kernel {totals[2]} times "
          f"({len(PRESET_RUNS)} experiments x 3 f32 steps); {time.perf_counter() - t0:.1f}s")
    return {"launches": tuple(totals), "runs": out, "bench": rate}


# the data phase: the CLI's main path on fixture datasets written to disk
DATA_IMAGES, DATA_B, DATA_VG_IMAGES = 64, 8, 32
# the host path's timing: 1024 JPEGs and their flips, 16 batches of the bench's b=128
DATA_RATE_IMAGES, DATA_RATE_B = 1024, 128


def _machine_report() -> dict:
    """What the card's machine has for the host data path; each missing
    package or library is a line of its own."""
    import importlib.util

    from layout2img_tpu_torch.data import native

    have = {}
    for mod in ("PIL", "h5py"):
        spec = importlib.util.find_spec(mod)
        have[mod] = spec is not None
        if spec is None:
            phase("data", f"{mod}: MISSING on this machine")
        else:
            version = getattr(__import__(mod), "__version__", "?")
            phase("data", f"{mod}: {version}")
    have["native"] = native.native_available()
    if have["native"]:
        phase("data", f"native decoder (native/dataplane.cc, libjpeg): built, "
              f"{native.library_path().name}")
    else:
        err = (native.build_error() or "").strip().splitlines()
        phase("data", f"native decoder (native/dataplane.cc, libjpeg): NOT BUILT, the loaders "
              f"decode with PIL: {err[-1] if err else '?'}")
    return have


def _isla_counts() -> tuple[int, int, int]:
    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward

    return isla_norm.launches, isla_norm_backward.launches, isla_norm_backward.finish_launches


def _reset_isla_counts() -> None:
    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward

    isla_norm.launches = isla_norm_backward.launches = isla_norm_backward.finish_launches = 0


def _logged(run: str) -> list[dict]:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _cli_train(tag: str, argv: list[str], expect_exit: int = 0,
               name: str = "data") -> tuple[int, int, int]:
    """One in-process ``cli.train.main`` call; returns the ISLA launches it
    made (counts set to 0 just before, read just after)."""
    from layout2img_tpu_torch.cli import train as train_cli

    _reset_isla_counts()
    t0 = time.perf_counter()
    code = 0
    try:
        train_cli.main(argv)
    except SystemExit as e:  # the NaN guard's exit: checked against expect_exit below
        code = e.code
    sync_all()
    counts = _isla_counts()
    need(code == expect_exit, f"{tag}: cli.train exited {code}, expected {expect_exit}")
    phase(name, f"{tag}: cli.train exit {code} in {time.perf_counter() - t0:.1f}s; ISLA forward "
          f"x{counts[0]}, backward x{counts[1]}, finishing x{counts[2]}")
    return counts


def sync_all() -> None:
    import torch

    torch.cuda.synchronize()


def _check_train_run(tag: str, run: str, counts, steps: list[int], log_every: int) -> None:
    """The run's metrics lines, checkpoints and ISLA launches: 10 of each
    per step, and 10 forward launches per image grid (one per log point)."""
    lines = _logged(run)
    got = [ln["step"] for ln in lines]
    want = [s for s in steps if s % log_every == 0]
    need(got[len(got) - len(want):] == want, f"{tag}: logged steps {got} do not end with {want}")
    bad = [ln for ln in lines if not all(math.isfinite(v) for v in ln.values())]
    need(not bad, f"{tag}: non-finite metrics {bad[:1]}")
    n, grids = len(steps), len(want)
    need(counts == (10 * (n + grids), 10 * n, 10 * n),
         f"{tag}: ISLA launches {counts}, not {(10 * (n + grids), 10 * n, 10 * n)} for {n} steps "
         f"and {grids} image grids")
    last = lines[-1]
    phase("data", f"{tag}: steps {steps[0]}..{steps[-1]}, last logged step {last['step']}: "
          + " ".join(f"{k}={last[k]:.5f}" for k in ("d_loss", "g_loss", "pixel_loss", "feat_loss")))


def _restored_equals_saved(ckpt_dir: str, steps: list[int], dev, model_args) -> None:
    """Restore each checkpoint of ``steps`` into a freshly seeded full-width
    state on the card and hold every tensor of it against the file, bit for
    bit."""
    import torch

    from layout2img_tpu_torch.cli import train as train_cli
    from layout2img_tpu_torch.cli.presets import experiment
    from layout2img_tpu_torch.train.checkpoint import CheckpointManager
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state

    args = train_cli.parse_args(model_args + ["--seed", "99"])
    exp = experiment(args.model)
    train_cli.check_img_size(args, exp)
    gen, disc = train_cli.build_networks(args, exp, dev)
    state = create_train_state(gen, disc, TrainConfig())
    mgr = CheckpointManager(ckpt_dir)
    for step in steps:
        mgr.restore(state, step)
        ck = mgr.read(step)
        n = 0
        for part, sd in (("generator", gen.state_dict()), ("discriminator", disc.state_dict())):
            for k, v in ck[part].items():
                need(torch.equal(sd[k].cpu(), v), f"restored {part}.{k} differs from checkpoint {step}")
                n += 1
        for part, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
            for i, st in opt.state_dict()["state"].items():
                for k, v in st.items():
                    need(torch.equal(v.cpu(), ck[part]["state"][i][k]),
                         f"restored {part} state {i}.{k} differs from checkpoint {step}")
                    n += 1
        need(state.step == step, f"restored step {state.step}, not {step}")
        phase("data", f"checkpoint {step} restored on the card into a fresh state: all {n} tensors "
              "(parameters, SN vectors, BN statistics, Adam moments and steps) equal the file bit "
              "for bit")
    del gen, disc, state
    torch.cuda.empty_cache()


def _per_item_ms(ds, n: int = 64) -> float:
    """Host ms per dataset item (decode, resize, flip, normalize) on one
    thread, over the first ``n`` items."""
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    return (time.perf_counter() - t0) * 1e3 / n


def _loader_rate(ds, card: str, decoder: str, threads: int, prefetch: int) -> float:
    """HostDataLoader img/s at 128 px over one epoch of b=128 batches. Each
    batch is built on one pool thread, so ``min(prefetch, threads)`` batches
    are decoded at once."""
    from layout2img_tpu_torch.data.coco import HostDataLoader

    loader = HostDataLoader(ds, DATA_RATE_B, seed=0, num_threads=threads, prefetch=prefetch)
    t0 = time.perf_counter()
    n = sum(len(b["labels"]) for b in loader)
    rate = n / (time.perf_counter() - t0)
    phase("data", f"HostDataLoader, decoder {decoder}: {rate:.1f} img/s at 128 px from 640x480 "
          f"JPEGs, b={DATA_RATE_B}, {threads} threads, prefetch {prefetch}: "
          f"{min(threads, prefetch)} batches decoded at once, {n} images in {len(loader)} "
          f"batches (host clock; the machine of {card})")
    return rate


def _fed_vs_resident(ds, decoder: str, dev, card: str,
                     loads: tuple[tuple[int, int], ...] = ((8, 4), (8, 8))) -> None:
    """The mixed b=128 step (the bench's default cell) fed by HostDataLoader
    through the prefetch, for each (threads, prefetch) of ``loads``, against
    the same step on one device-resident batch before and after: ms per step
    by the host clock. A fed run takes one epoch of the fixture: its first
    ``warm`` steps fill the pipeline and are not timed. Then the card's idle
    share over two traced loader-fed steps with the last load."""
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from layout2img_tpu_torch import bench
    from layout2img_tpu_torch.data.coco import HostDataLoader
    from layout2img_tpu_torch.data.prefetch import device_prefetch

    cfg = bench.BenchConfig()
    need(cfg.batch == DATA_RATE_B, f"the bench's batch is {cfg.batch}, not {DATA_RATE_B}")
    built = bench.build(cfg, dev)
    warm, n = 4, 10
    need(len(ds) // cfg.batch >= warm + n,
         f"the fixture has {len(ds)} items, fewer than {warm + n} batches of {cfg.batch}")

    def fed(threads: int, prefetch: int):
        loader = HostDataLoader(ds, cfg.batch, seed=0, num_threads=threads, prefetch=prefetch)
        for batch in device_prefetch(loader, dev, size=2):
            batch["labels"] = batch["labels"].long()
            yield batch

    def timed(batches, n: int) -> float:
        sync_all()
        t0 = time.perf_counter()
        for batch in itertools.islice(batches, n):
            built.step(batch, built.rng)
        sync_all()
        return (time.perf_counter() - t0) * 1e3 / n

    def fed_ms(threads: int, prefetch: int) -> float:
        batches = fed(threads, prefetch)
        for batch in itertools.islice(batches, warm):
            built.step(batch, built.rng)
        ms = timed(batches, n)
        batches.close()
        return ms

    for _ in range(3):
        built.step(built.batch, built.rng)
    resident = [timed(itertools.repeat(built.batch), n)]
    fed_at = {load: fed_ms(*load) for load in loads}
    resident.append(timed(itertools.repeat(built.batch), n))
    phase("data", f"mixed b={cfg.batch} step (bench default cell), {n} steps each after {warm} "
          f"untimed, by the host clock, decoder {decoder}: loader-fed "
          + ", ".join(f"{ms:.3f} ms/step with {t} threads, prefetch {p} ({min(t, p)} batches "
                      "decoded at once)" for (t, p), ms in fed_at.items())
          + f"; device-resident {resident[0]:.3f} / {resident[1]:.3f} ms/step (before / after) "
          f"on {card}")

    threads, prefetch = loads[-1]
    batches = fed(threads, prefetch)
    for batch in itertools.islice(batches, warm):
        built.step(batch, built.rng)
    sync_all()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in itertools.islice(batches, 2):
            built.step(batch, built.rng)
        sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    batches.close()
    dev_ms = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_time_total > 0 and not getattr(e, "is_user_annotation", False)
                 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 2e3
    need(dev_ms > 0, "the profiler saw no device time in the loader-fed step")
    phase("data", f"loader-fed mixed b={cfg.batch} step traced ({threads} threads, prefetch "
          f"{prefetch}): {dev_ms:.3f} ms of device time in {wall_ms:.3f} ms per step, idle share "
          f"{100 * (1 - dev_ms / wall_ms):.1f}% on {card}")
    del built
    torch.cuda.empty_cache()


def data_phase(seed: int, tmp_dir: str, dev, card: str) -> tuple[int, int, int]:
    """Train from on-disk fixture datasets through the CLIs at full width;
    returns the ISLA launches of the main path (the train, resume and
    sampling calls)."""
    import hashlib
    import shutil

    import torch

    from layout2img_tpu_torch.cli import export_torch
    from layout2img_tpu_torch.cli import sample as sample_cli
    from layout2img_tpu_torch.data import synthetic
    from layout2img_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    have = _machine_report()
    root = os.path.join(tmp_dir, "data")
    shutil.rmtree(root, ignore_errors=True)
    out = os.path.join(root, "out")
    common = ["--model", "context_app_v2", "--batch_size", str(DATA_B), "--seed", str(seed),
              "--out_path", out]
    if have["PIL"]:
        t0 = time.perf_counter()
        _, inst = synthetic.write_synthetic_coco(os.path.join(root, "coco"), DATA_IMAGES, seed=seed)
        stuff = synthetic.write_synthetic_stuff(os.path.join(root, "coco"), inst, seed=seed)
        paths = ["--coco_image_dir", os.path.join(root, "coco"), "--coco_instances", inst,
                 "--coco_stuff", stuff]
        data = ["--dataset", "coco", *paths]
        per_epoch = 2 * DATA_IMAGES // DATA_B
        phase("data", f"fixture COCO-Stuff: {DATA_IMAGES} JPEGs at 640x480, 5 things and 1-3 stuff "
              f"boxes each, written in {time.perf_counter() - t0:.1f}s")
    else:
        phase("data", "PIL missing: the train, resume and drill calls run on --dataset synthetic; no "
              "JPEG is decoded in this run")
        data, per_epoch = ["--dataset", "synthetic", "--steps_per_epoch", "16"], 16
    run = os.path.join(out, data[1], "128", "context_app_v2")
    ckpt_dir = os.path.join(run, "ckpt")
    totals = [0, 0, 0]

    def add(counts):
        for i, c in enumerate(counts):
            totals[i] += c

    # train 2 epochs, then resume for one more
    base = [*common, *data, "--save_every_epochs", "1", "--log_every", "2"]
    counts = _cli_train("train", base + ["--total_epoch", "2"])
    _check_train_run("train", run, counts, list(range(1, 2 * per_epoch + 1)), 2)
    add(counts)
    saved = CheckpointManager(ckpt_dir).all_steps()
    need(saved == [per_epoch, 2 * per_epoch], f"checkpoints {saved}")
    counts = _cli_train("resume", base + ["--total_epoch", "1", "--resume", "--async_ckpt"])
    _check_train_run("resume", run, counts, list(range(2 * per_epoch + 1, 3 * per_epoch + 1)), 2)
    add(counts)
    last = 3 * per_epoch
    saved = CheckpointManager(ckpt_dir).all_steps()
    need(saved == [per_epoch, 2 * per_epoch, last], f"checkpoints after resume {saved}")
    with open(os.path.join(run, "log.txt")) as f:
        need(f"resumed from step {2 * per_epoch}" in f.read(), "the resume did not say its step")
    _restored_equals_saved(ckpt_dir, [2 * per_epoch, last], dev, [*common, *data])

    # NaN drill: metrics poisoned from 2 steps after the last save
    path = os.path.join(ckpt_dir, str(last), "state.pt")
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    _cli_train("NaN drill", base + ["--total_epoch", "3", "--resume", "--save_every_epochs", "100",
                                    "--fault_inject_nan_at", str(last + 2)], expect_exit=3)
    need(CheckpointManager(ckpt_dir).all_steps() == saved, "the NaN drill changed the checkpoints")
    need(hashlib.sha256(open(path, "rb").read()).hexdigest() == digest,
         f"the NaN drill changed checkpoint {last}")
    phase("data", f"NaN drill: exit 3 at step {last + 2}, checkpoints {saved} kept, step {last}'s "
          "file unchanged")

    # sample from the checkpoint through the kernels, export, load the export strictly
    sample_dir = os.path.join(root, "samples")
    _reset_isla_counts()
    sample_cli.main(["--model", "context_app_v2", "--ckpt_dir", ckpt_dir,
                     *(data if have["PIL"] else ["--dataset", "synthetic"]),
                     "--batch_size", str(DATA_B), "--num_img", "1", "--max_layouts", "16",
                     "--sample_path", sample_dir, "--device", "cuda"])
    sync_all()
    counts = _isla_counts()
    written = sorted(os.listdir(sample_dir))
    need(len(written) == 16 and counts[0] == 20,
         f"cli.sample wrote {len(written)} images with {counts[0]} ISLA launches, not 16 and 20")
    add(counts)
    g_pth, d_pth = os.path.join(root, "G_export.pth"), os.path.join(root, "D_export.pth")
    export_torch.main(["--ckpt_dir", ckpt_dir, "--out_g", g_pth, "--out_d", d_pth])
    gen = sample_cli.load_generator(g_pth, dev)
    phase("data", f"cli.sample --ckpt_dir: {len(written)} images, ISLA x{counts[0]}; "
          f"cli.export_torch G loads strictly ({sum(p.numel() for p in gen.parameters())} "
          "parameters)")
    del gen
    torch.cuda.empty_cache()

    # the host data path on this machine's cores, on a fixture of many b=128 batches
    if have["PIL"]:
        from layout2img_tpu_torch.data.coco import CocoLayoutDataset

        t0 = time.perf_counter()
        rate_root = os.path.join(root, "coco_rate")
        _, rate_inst = synthetic.write_synthetic_coco(rate_root, DATA_RATE_IMAGES, seed=seed)
        rate_stuff = synthetic.write_synthetic_stuff(rate_root, rate_inst, seed=seed)
        phase("data", f"fixture COCO-Stuff for the host path: {DATA_RATE_IMAGES} JPEGs at 640x480 "
              f"written in {time.perf_counter() - t0:.1f}s")
        decoded = []
        for use_native in ([True, False] if have["native"] else [False]):
            decoder = "native (libjpeg)" if use_native else "PIL"
            ds = CocoLayoutDataset(rate_root, rate_inst, rate_stuff, image_size=128,
                                   left_right_flip=True, use_native=use_native)
            phase("data", f"decoder {decoder}: {_per_item_ms(ds):.3f} ms per item on one thread "
                  "(decode, resize, flip, normalize; host clock)")
            for threads, prefetch in ((8, 4), (8, 8)):
                _loader_rate(ds, card, decoder, threads, prefetch)
            decoded.append((ds, decoder))
        _fed_vs_resident(*decoded[0], dev=dev, card=card)  # the decoder the CLI takes
        del decoded, ds
        shutil.rmtree(rate_root)
    else:
        phase("data", "PIL missing: the loader rate and the loader-fed step are not measured")

    # Visual Genome: the same train and resume on a fixture VG (o=31, 179 classes)
    if have["PIL"] and have["h5py"]:
        vocab, h5, vg_root = synthetic.write_synthetic_vg(
            os.path.join(root, "vg"), DATA_VG_IMAGES, objects_per_image=10, num_classes=179,
            seed=seed)
        vg = [*common, "--dataset", "vg", "--vg_vocab", vocab, "--vg_h5", h5, "--vg_image_dir",
              vg_root, "--save_every_epochs", "1", "--log_every", "2"]
        vg_run = os.path.join(out, "vg", "128", "context_app_v2")
        per = 2 * DATA_VG_IMAGES // DATA_B
        counts = _cli_train("vg train", vg + ["--total_epoch", "1"])
        _check_train_run("vg train", vg_run, counts, list(range(1, per + 1)), 2)
        add(counts)
        counts = _cli_train("vg resume", vg + ["--total_epoch", "1", "--resume"])
        _check_train_run("vg resume", vg_run, counts, list(range(per + 1, 2 * per + 1)), 2)
        add(counts)
        saved = CheckpointManager(os.path.join(vg_run, "ckpt")).all_steps()
        need(saved == [per, 2 * per], f"vg checkpoints {saved}")
    else:
        missing = " and ".join(m for m in ("PIL", "h5py") if not have[m])
        phase("data", f"{missing} missing: the Visual Genome fixture run is skipped")
    phase("data", f"main path ran the ISLA forward kernel {totals[0]} times, the backward's main "
          f"kernel {totals[1]} and its finishing kernel {totals[2]} times; "
          f"{time.perf_counter() - t_phase:.1f}s")
    return tuple(totals)


# the eval phase: (images, side) of the Inception card-vs-CPU checks, the
# periodic eval's pool, and the images cli.sample writes for cli.evaluate
EVAL_INCEPTION_INPUTS = ((4, 128), (2, 64), (2, 256))
EVAL_B, EVAL_N, EVAL_SAMPLES = 8, 16, 64


def _eval_nets_card_vs_cpu(dev) -> None:
    """InceptionV3 and LPIPS with the port's seed-0 random weights on the
    card against the CPU, TF32 off, at the CPU tests' bars: Inception
    features and logits 1e-5 of their largest magnitude, probabilities 1e-6
    (``tests/test_torch_port_eval_inception.py``); LPIPS 1e-6
    (``tests/test_torch_port_eval_lpips.py``), and d(a, a) = 0 within 1e-6."""
    import torch

    from layout2img_tpu_torch.eval.inception import load_inception, random_inception_state_dict
    from layout2img_tpu_torch.eval.lpips import load_lpips, random_lpips_state_dict
    from layout2img_tpu_torch.eval.metrics import tf32_off

    sd = random_inception_state_dict(0)
    nets = [load_inception(sd, d) for d in (dev, "cpu")]  # the card's, the CPU's
    g = torch.Generator().manual_seed(7)
    for n, side in EVAL_INCEPTION_INPUTS:
        x = torch.rand(n, 3, side, side, generator=g) * 2 - 1
        outs = []
        with torch.inference_mode(), tf32_off():
            for net in nets:
                f, logits = net(x.to(next(net.parameters()).device))
                outs.append((f.cpu(), logits.cpu(), torch.softmax(logits, -1).cpu()))
        errs = []
        for kind, got, want in zip(("features", "logits", "probabilities"), *outs):
            err = (got - want).abs().max().item()
            bar = 1e-6 if kind == "probabilities" else 1e-5 * want.abs().max().item()
            need(err <= bar,
                 f"Inception {kind} card vs CPU at b={n}, {side}px: {err:.3e} > {bar:.3e}")
            errs.append(f"{kind} {err:.3e} (bar {bar:.3e})")
        f = outs[0][0]
        var, spread = f.var().item(), f.std(0).mean().item()
        need(var > 1e-2 and spread > 1e-4, f"degenerate pool3 features: variance {var:.3e}, "
             f"spread across images {spread:.3e}")
        phase("eval", f"InceptionV3 card vs CPU, b={n} at {side}px: " + ", ".join(errs)
              + f"; pool3 variance {var:.4f}, mean std across images {spread:.3e}")
    del nets

    sd = random_lpips_state_dict(0)
    card_lp, cpu_lp = (load_lpips(sd, device=d) for d in (dev, "cpu"))
    a, b = (torch.rand(4, 3, 128, 128, generator=g) * 2 - 1 for _ in range(2))
    with torch.inference_mode(), tf32_off():
        got = card_lp(a.to(dev), b.to(dev)).cpu()
        want = cpu_lp(a, b)
        same = card_lp(a.to(dev), a.to(dev)).abs().max().item()
    err = (got - want).abs().max().item()
    need(err <= 1e-6, f"LPIPS card vs CPU: {err:.3e} > 1e-6")
    need(same <= 1e-6, f"LPIPS d(a, a) = {same:.3e} on the card, not 0 within 1e-6")
    phase("eval", f"LPIPS card vs CPU, b=4 at 128px: distances {got.numpy().round(5).tolist()}, "
          f"max error {err:.3e} (bar 1e-6); d(a, a) max {same:.3e} (bar 1e-6)")


def _train_state_snapshot(state, z_rng) -> list:
    """Copies of every G and D tensor (parameters and buffers), both
    optimizers' state, the EMA, the latent generator's and the card's
    default generator's state."""
    import torch

    tensors = [*state.generator.state_dict().values(), *state.discriminator.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        for st in opt.state_dict()["state"].values():
            tensors += [v for v in st.values() if torch.is_tensor(v)]
    tensors += list((state.ema or {}).values())
    return [t.detach().clone() for t in tensors] + [z_rng.get_state(), torch.cuda.get_rng_state()]


def _hook_call(seed: int, dev, card: str) -> tuple[int, int, int]:
    """One ``PeriodicEval`` call at the phase's pool size on a full-width
    train state (one f32 step taken, VGG on): the state before and after it
    equal bit for bit, the call's time split into G sampling, Inception and
    the host's Frechet distance. Returns the ISLA launches of the call."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.cli import train as train_cli
    from layout2img_tpu_torch.cli.presets import experiment
    from layout2img_tpu_torch.data.synthetic import SyntheticLayoutDataset
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.train import eval_hook
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.convert import init_vgg

    args = train_cli.parse_args(["--seed", str(seed), "--batch_size", str(EVAL_B)])
    exp = experiment(args.model)
    train_cli.check_img_size(args, exp)
    gen, disc = train_cli.build_networks(args, exp, dev)
    cfg = TrainConfig(ema_decay=0.999)
    state = create_train_state(gen, disc, cfg)
    step = make_train_step(state, cfg, vgg_loss=VGGLoss(init_vgg(seed + 2, device=dev)))
    loader = SyntheticLayoutDataset(EVAL_B, 128, 8, seed=seed, steps=EVAL_N // EVAL_B)
    pool = list(loader)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pool[0].items()}
    batch["labels"] = batch["labels"].long()
    z_rng = torch.Generator(device=dev).manual_seed(seed)
    step(batch, z_rng)

    spent = {"sampling": 0.0, "fid": 0.0}
    sample = eval_hook.make_train_sample_fn(gen)

    def timed_sample(*a):
        sync_all()
        t0 = time.perf_counter()
        out = sample(*a)
        sync_all()
        spent["sampling"] += time.perf_counter() - t0
        return out

    frechet = eval_hook.frechet_distance

    def timed_frechet(*a):
        t0 = time.perf_counter()
        out = frechet(*a)
        spent["fid"] += time.perf_counter() - t0
        return out

    hook = eval_hook.PeriodicEval(timed_sample, pool, device=dev, seed=seed)
    spent["sampling"] = 0.0
    before = _train_state_snapshot(state, z_rng)
    eval_hook.frechet_distance = timed_frechet
    _reset_isla_counts()
    try:
        sync_all()
        t0 = time.perf_counter()
        out = hook(state)
        sync_all()
        total = time.perf_counter() - t0
    finally:
        eval_hook.frechet_distance = frechet
    counts = _isla_counts()
    after = _train_state_snapshot(state, z_rng)
    need(len(before) == len(after) and all(torch.equal(x, y) for x, y in zip(before, after)),
         "the PeriodicEval call changed the training state")
    need(state.generator.training, "the generator is not back in training mode after the eval")
    need(np.isfinite(out["rel_fid"]) and out["rel_fid"] >= 0 and set(out) == {"rel_fid"},
         f"the hook returned {out}")
    need(counts == (10 * len(pool), 0, 0),
         f"the hook call made ISLA launches {counts}, not {(10 * len(pool), 0, 0)}")
    inception = total - spent["sampling"] - spent["fid"]
    phase("eval", f"PeriodicEval call at the phase's pool ({hook.n_images} images, {len(pool)} "
          f"batches of {EVAL_B}, EMA on): rel_fid {out['rel_fid']:.4f}; the {len(before)} tensors "
          "and generator states of the train state equal before and after bit for bit; ISLA "
          f"x{counts[0]}; {1e3 * total:.1f} ms = G sampling {1e3 * spent['sampling']:.1f} ms + "
          f"Inception {1e3 * inception:.1f} ms + Frechet distance on the host "
          f"{1e3 * spent['fid']:.1f} ms (host clock, synchronized; on {card})")
    del state, step, gen, disc, hook
    torch.cuda.empty_cache()
    return counts


def _evaluate(argv: list[str]) -> str:
    import contextlib
    import io

    from layout2img_tpu_torch.cli import evaluate as evaluate_cli

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        evaluate_cli.main(argv)
    text = out.getvalue()
    last = text.strip().splitlines()[-1]
    phase("eval", f"cli.evaluate {' '.join(argv[:1])}: {last} ({time.perf_counter() - t0:.1f}s)")
    return text


def _number(text: str, mark: str) -> float:
    line = [ln for ln in text.splitlines() if mark in ln][-1]
    return float(line.split(mark, 1)[1].split()[0])


def _bench_eval(dev, card: str) -> None:
    """The eval bench at its defaults (b=256, 128-px input), f32 with TF32
    off, then with TF32 for comparison; the work's bound from its counted
    operations; a profile of one batch by kind."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from layout2img_tpu_torch import bench_eval

    cfg = bench_eval.EvalBenchConfig()
    net, images = bench_eval.build(cfg, dev)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        net(images)
    flops = counter.get_total_flops()
    bound_ms = {k: 1e3 * flops / rate for k, rate in (("f32", 67e12), ("TF32", 495e12))}
    rate = bench_eval.time_calls(net, images, cfg)
    phase("eval", f"bench_eval b={cfg.batch} at {cfg.size}px, f32 TF32 off: "
          f"{rate['img_s']:.1f} img/s, {rate['median_ms']:.3f} ms per batch median "
          f"[{rate['p25_ms']:.3f}, {rate['p75_ms']:.3f}] over {len(rate['call_ms'])} calls, peak "
          f"{rate['peak_gib']:.2f} GiB allocated; {flops / 1e9 / cfg.batch:.2f} GFLOP per image "
          f"(convs and the fc, counted), bound {bound_ms['f32']:.3f} ms at 67 TFLOP/s "
          f"({100 * bound_ms['f32'] / rate['median_ms']:.1f}% of the bound reached) on {card}; "
          "bench line " + json.dumps(rate["line"]))
    tf32 = bench_eval.time_calls(net, images, dataclasses.replace(cfg, scan=5, scans=4), tf32=True)
    phase("eval", f"bench_eval with TF32 for comparison: {tf32['img_s']:.1f} img/s, "
          f"{tf32['median_ms']:.3f} ms per batch median [{tf32['p25_ms']:.3f}, "
          f"{tf32['p75_ms']:.3f}] over {len(tf32['call_ms'])} calls, "
          f"peak {tf32['peak_gib']:.2f} GiB; "
          f"bound {bound_ms['TF32']:.3f} ms at 495 TFLOP/s on {card}")

    with torch.inference_mode():
        net(images)
        sync_all()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            f, logits = net(images)
            torch.softmax(logits, -1)
            sync_all()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and not getattr(e, "is_user_annotation", False)
            and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(ms for _, ms, _ in rows)
    if dev_ms <= 0:
        phase("eval", "Inception profile: the profiler saw no device time; breakdown not measured")
    else:
        rows.sort(key=lambda r: -r[1])
        phase("eval", f"profile of one Inception batch (b={cfg.batch}, f32): {dev_ms:.3f} ms of "
              f"device time in {wall_ms:.3f} ms traced ({100 * dev_ms / wall_ms:.1f}% busy), "
              f"{sum(n for _, _, n in rows)} kernels; by kind: {by_kind(rows, dev_ms)}")
        for key, ms, n in rows[:8]:
            phase("eval", f"  {ms:8.4f} ms  {100 * ms / dev_ms:5.1f}%  x{n:<4d} {key[:90]}")
    del net, images
    torch.cuda.empty_cache()


def eval_phase(seed: int, tmp_dir: str, dev, card: str) -> tuple[int, int, int]:
    """The evaluation path at full width; returns the ISLA launches of its
    main path (``cli.train`` with the periodic eval, the hook call,
    ``cli.sample``)."""
    import shutil

    from layout2img_tpu_torch.cli import sample as sample_cli

    t_phase = time.perf_counter()
    root = os.path.join(tmp_dir, "eval")
    shutil.rmtree(root, ignore_errors=True)
    _eval_nets_card_vs_cpu(dev)

    # cli.train with --eval_every at full width
    out = os.path.join(root, "out")
    steps, every = 2, 2
    counts = _cli_train("cli.train --eval_every", [
        "--model", "context_app_v2", "--dataset", "synthetic", "--batch_size", str(EVAL_B),
        "--steps", str(steps), "--eval_every", str(every), "--eval_n", str(EVAL_N),
        "--log_every", str(every), "--seed", str(seed), "--out_path", out], name="eval")
    run = os.path.join(out, "synthetic", "128", "context_app_v2")
    lines = _logged(run)
    evals = [ln for ln in lines if "rel_fid" in ln]
    need([ln["step"] for ln in evals] == list(range(every, steps + 1, every)),
         f"rel_fid logged at {[ln['step'] for ln in evals]}")
    need(all(math.isfinite(ln["rel_fid"]) and ln["rel_fid"] >= 0 and "is_mean" not in ln
             for ln in evals), f"eval lines {evals}")
    n_evals, pool_batches, grids = len(evals), EVAL_N // EVAL_B, steps // every
    want = (10 * (steps + grids + n_evals * pool_batches), 10 * steps, 10 * steps)
    need(counts == want, f"cli.train --eval_every made ISLA launches {counts}, not {want}: 10 per "
         f"step, per image grid and per eval batch ({n_evals} evals of {pool_batches} batches)")
    phase("eval", "cli.train --eval_every: rel_fid " + ", ".join(
        f"{ln['rel_fid']:.4f} at step {ln['step']}" for ln in evals)
          + f" (no is_mean: random filters); ISLA launches {counts} = 10 per step, per grid and "
          f"per eval batch")
    totals = list(counts)

    counts = _hook_call(seed, dev, card)
    totals[0] += counts[0]

    # cli.sample from the run's G.pth, then cli.evaluate on the directory
    samples = os.path.join(root, "samples")
    _reset_isla_counts()
    sample_cli.main(["--model", "context_app_v2", "--weights", os.path.join(run, "G.pth"),
                     "--dataset", "synthetic", "--batch_size", str(EVAL_SAMPLES // 4),
                     "--num_img", "1", "--sample_path", samples, "--seed", str(seed),
                     "--device", "cuda"])
    sync_all()
    counts = _isla_counts()
    written = os.listdir(samples)
    need(len(written) == EVAL_SAMPLES and counts[0] == 40,
         f"cli.sample wrote {len(written)} images with {counts[0]} ISLA launches, not "
         f"{EVAL_SAMPLES} and 40")
    totals[0] += counts[0]
    phase("eval", f"cli.sample from G.pth: {len(written)} images, ISLA x{counts[0]}")

    common = ["--dir", samples, "--batch_size", "32", "--device", "cuda"]
    is_mean = _number(_evaluate(["is", *common]), "IS: ")
    need(abs(is_mean - 1.0) < 0.01, f"IS {is_mean} with random filters, not about 1")
    stats = os.path.join(root, "samples.npz")
    fid_dir = _number(_evaluate(["fid", *common, "--ref_dir", samples, "--save_stats", stats]),
                      "FID: ")
    fid_stats = _number(_evaluate(["fid", *common, "--ref_stats", stats]), "FID: ")
    need(abs(fid_dir) < 1e-3 and fid_stats == fid_dir,
         f"FID of the samples against themselves: {fid_dir} by --ref_dir, {fid_stats} by "
         "--ref_stats, not the same number about 0")
    kid = _number(_evaluate(["kid", *common, "--ref_dir", samples, "--kid_subsets", "20"]),
                  "KID: ")
    need(abs(kid) < 50.0, f"KID of the samples against themselves {kid} (x10^-3), not about 0")
    lp = _number(_evaluate(["lpips", "--dir", samples, "--ref_dir", samples, "--batch_size", "7",
                            "--device", "cuda"]), "LPIPS: ")
    need(lp == 0.0, f"LPIPS of the samples against themselves {lp}, not 0")

    _bench_eval(dev, card)
    shutil.rmtree(root, ignore_errors=True)
    phase("eval", f"main path ran the ISLA forward kernel {totals[0]} times, the backward's main "
          f"kernel {totals[1]} and its finishing kernel {totals[2]} times; "
          f"{time.perf_counter() - t_phase:.1f}s")
    return tuple(totals)


# the special phase: the Ours-ED and layout2im families at full width
SPECIAL_FUSIONS = ("transformer", "convlstm", "transformer_decoder", "transformer_noctx")
SPECIAL_IMAGES, SPECIAL_B = 16, 8  # the phase's COCO fixture: 16 JPEGs, 4 steps of 8 an epoch


def _special_batches(seed: int, b: int, n: int, dev) -> list:
    """``n`` COCO-shaped 64px batches (o=8, 3-8 objects) with the Ours-ED
    streams, on the card."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.data.coco import split_fg_bg_batch
    from layout2img_tpu_torch.data.synthetic import synthetic_batch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = split_fg_bg_batch(synthetic_batch(rng, b, 64, COCO_OBJ, COCO_CLASSES))
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}
        for k in ("labels", "labels_fg", "labels_bg"):
            batch[k] = batch[k].long()
        out.append(batch)
    return out


def _special_profile(tag: str, step, batch, rng, card: str) -> None:
    """One traced step of a special family: device time against the traced
    wall time, kernels, time by kind and the heaviest kernels."""
    dev_ms, wall_ms, kernels, rows = _profile_steps(step, batch, rng)
    phase("special", f"{tag} profile: {dev_ms:.3f} ms device time of {wall_ms:.3f} ms traced "
          f"({100 * dev_ms / wall_ms:.1f}% busy), {kernels} kernels per step on {card}; by kind: "
          + by_kind(rows, dev_ms))
    for key, ms, n in rows[:6]:
        phase("special", f"  {ms:8.4f} ms  {100 * ms / dev_ms:5.1f}%  x{n:<4d} {key[:90]}")


def _ours_ed_steps(seed: int, tmp_dir: str, dev, card: str, reps: int) -> dict:
    """Ours-ED at full width (ch=64, 184 classes split 91/93, o=8, VGG on):
    G and D seeded, saved and reloaded strictly; 3 f32 b=8 steps through
    ``make_bgfg_train_step`` (finite losses, parameters, BN statistics and
    SN vectors moved, 16 launches of each ISLA kernel per step by the counts
    and by the profiler); the 16 ISLA calls of one step against the plain
    versions, timed; one f32 eval forward at b=2, card against CPU at 2e-3;
    step ms and img/s at b=8 and b=16."""
    from types import SimpleNamespace

    import torch

    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.models.generators import BgFgGenerator
    from layout2img_tpu_torch.train.state import TrainConfig
    from layout2img_tpu_torch.train.step_bgfg import create_bgfg_state, make_bgfg_train_step
    from layout2img_tpu_torch.utils.convert import (init_bgfg_generator, init_discriminator,
                                                    init_vgg)

    t0 = time.perf_counter()
    g_path, d_path = (os.path.join(tmp_dir, f"special_{n}.pth") for n in ("G", "D"))
    torch.save(init_bgfg_generator(seed, 91, COCO_CLASSES - 91, device="cpu", ch=CH).state_dict(),
               g_path)
    torch.save(init_discriminator(seed + 1, COCO_CLASSES, preset="d64", device="cpu",
                                  ch=CH).state_dict(), d_path)

    def load_g(device):
        gen = BgFgGenerator(91, COCO_CLASSES - 91, ch=CH).to(device)
        gen.load_state_dict(torch.load(g_path, map_location="cpu", weights_only=True), strict=True)
        return gen

    disc = init_discriminator(seed + 5, COCO_CLASSES, preset="d64", device=dev, ch=CH)
    disc.load_state_dict(torch.load(d_path, map_location="cpu", weights_only=True), strict=True)
    gen = load_g(dev)
    cfg = TrainConfig()
    state = create_bgfg_state(gen, disc, cfg)
    step = make_bgfg_train_step(state, cfg, vgg_loss=VGGLoss(init_vgg(seed + 2, device=dev)))
    calls = gen.isla_calls
    need(calls == 16, f"BgFgGenerator makes {calls} ISLA calls per forward, not 16")
    phase("special", f"ours_ed (BgFgGenerator 91 + 93 classes + d64, ch={CH}, 64px): "
          f"{sum(p.numel() for p in gen.parameters())} + {sum(p.numel() for p in disc.parameters())}"
          f" parameters, seeded, saved and reloaded strict; {calls} ISLA calls per forward")
    batches = _special_batches(seed + 11, SPECIAL_B, 3, dev)
    live = [int((batches[0][k] != 0).sum(dim=1).max()) for k in ("labels_fg", "labels_bg")]
    phase("special", f"ours_ed streams: at most {live[0]} fg and {live[1]} bg live objects of "
          f"{COCO_OBJ} slots per layout")
    rng = torch.Generator(device=dev).manual_seed(seed)
    launches = drive_steps("special", "ours_ed f32", state, step, batches, rng, dev,
                           per_step=calls)
    names = device_kernels([lambda: step(batches[0], rng)])
    seen = [sum(k in n for n in names) for k in ("isla_norm_kernel", "isla_norm_bwd_kernel",
                                                 "isla_norm_bwd_finish_kernel")]
    need(seen == [calls] * 3, f"ours_ed: the profiler saw {seen} ISLA forward, backward and "
                              f"finishing kernels in one f32 step, not {calls} each")
    phase("special", f"ours_ed: the profiler saw {seen} ISLA forward, backward and finishing "
          "kernels in one f32 step")
    sums = check_captured(f"ours_ed f32 b={SPECIAL_B}", capture_isla_calls(SimpleNamespace(
        step=step, batch=batches[0], rng=rng)), COCO_OBJ, reps, calls, torch.float32, "special")
    rates = {}
    for b in (SPECIAL_B, 16):
        batch = batches[0] if b == SPECIAL_B else _special_batches(seed + 12, b, 1, dev)[0]
        ms = time_ms(lambda: step(batch, rng), 5)
        rates[b] = ms
        phase("special", f"ours_ed f32 step b={b}: {ms[0]:.3f} ms [{ms[1]:.3f}, {ms[2]:.3f}], "
              f"{b / ms[0] * 1e3:.1f} img/s on {card}")
        _special_profile(f"ours_ed f32 b={b}", step, batch, rng, card)
    del state, step, gen, disc
    torch.cuda.empty_cache()

    # one f32 eval forward at b=2, card against CPU
    layout = {k: v[:2].cpu() for k, v in batches[0].items()}
    g_cpu = torch.Generator().manual_seed(seed + 13)
    z = [torch.randn(2, COCO_OBJ, 128, generator=g_cpu) for _ in range(2)]
    z_im = [torch.randn(2, 128, generator=g_cpu) for _ in range(2)]
    args = (z[0], layout["boxes_fg"], layout["labels_fg"], z[1], layout["boxes_bg"],
            layout["labels_bg"], z_im[0], z_im[1])
    with torch.inference_mode():
        want = load_g("cpu").eval()(*args)
        got = load_g(dev).eval()(*(t.to(dev) for t in args)).cpu()
    diff = (got - want).abs().max().item()
    need(got.shape == (2, 3, 64, 64) and torch.isfinite(got).all().item() and diff <= 2e-3,
         f"ours_ed: card vs CPU f32 eval forward differ by {diff} > 2e-3")
    phase("special", f"ours_ed: f32 b=2 eval forward card vs CPU max_abs_diff={diff:.3e} (bar "
          f"2e-3); {time.perf_counter() - t0:.1f}s")
    return {"launches": launches, "sums": sums, "ms_b8": rates[SPECIAL_B][0], "ms_b16": rates[16][0]}


def _layout2im_steps(seed: int, dev, card: str) -> dict:
    """Each fusion of layout2im at full width (conv_dim 64, 184 classes, o=8,
    b=8): 2 f32 steps (finite losses; parameters, BN statistics and SN
    vectors moved; no ISLA launch); one deterministic training-mode G
    forward at b=2, card against CPU at 2e-3; the step ms at b=16 for
    ``transformer``."""
    import torch

    from layout2img_tpu_torch.ops.bbox import bbox_mask
    from layout2img_tpu_torch.train.step_layout2im import (Layout2ImConfig,
                                                           create_layout2im_state,
                                                           make_layout2im_train_step)
    from layout2img_tpu_torch.utils.convert import (init_layout2im_discriminators,
                                                    init_layout2im_generator)

    out = {}
    cfg = Layout2ImConfig()
    for fusion in SPECIAL_FUSIONS:
        t0 = time.perf_counter()
        gen = init_layout2im_generator(seed, COCO_CLASSES, fusion=fusion, device=dev)
        d_img, d_obj = init_layout2im_discriminators(seed + 1, COCO_CLASSES, conv_dim=CH,
                                                     device=dev)
        state = create_layout2im_state(gen, d_img, d_obj, cfg)
        step = make_layout2im_train_step(state, cfg)
        phase("special", f"layout2im {fusion} (conv_dim 64, D ch={CH}): "
              f"{sum(p.numel() for p in gen.parameters())} + "
              f"{sum(p.numel() for p in state.discriminator.parameters())} parameters, seeded")
        batches = _special_batches(seed + 21, SPECIAL_B, 2, dev)
        rng = torch.Generator(device=dev).manual_seed(seed)
        drive_steps("special", f"layout2im {fusion} f32", state, step, batches, rng, dev,
                    per_step=0)
        sd = {k: v.detach().cpu().clone() for k, v in gen.state_dict().items()}
        b = {k: v[:2] for k, v in batches[0].items()}
        g_cpu = torch.Generator().manual_seed(seed + 22)
        noise = [torch.randn(2, COCO_OBJ, cfg.z_dim, generator=g_cpu) for _ in range(3)]
        results = []
        for device in ("cpu", dev):
            net = init_layout2im_generator(seed, COCO_CLASSES, fusion=fusion, device=device)
            net.load_state_dict(sd, strict=True)
            bd = {k: v.to(device) for k, v in b.items()}
            with torch.no_grad():
                res = net.train()(bd["images"], bd["labels"], bd["boxes"],
                                  bbox_mask(bd["boxes"], 64, 64), *(t.to(device) for t in noise),
                                  deterministic=True)
            results.append({k: res[k].cpu() for k in ("img_rec", "img_rand", "mu", "z_rand_rec")})
        diff = max((results[1][k] - results[0][k]).abs().max().item() for k in results[0])
        need(all(torch.isfinite(v).all().item() for v in results[1].values()) and diff <= 2e-3,
             f"layout2im {fusion}: card vs CPU training-mode forward differ by {diff} > 2e-3")
        ms = None
        if fusion == "transformer":
            big = _special_batches(seed + 23, 16, 1, dev)[0]
            ms = time_ms(lambda: step(big, rng), 5)
            _special_profile("layout2im transformer f32 b=16", step, big, rng, card)
        phase("special", f"layout2im {fusion}: b=2 deterministic training-mode G forward card vs "
              f"CPU max_abs_diff={diff:.3e} (bar 2e-3)"
              + (f"; f32 step b=16: {ms[0]:.3f} ms [{ms[1]:.3f}, {ms[2]:.3f}], "
                 f"{16 / ms[0] * 1e3:.1f} img/s on {card}" if ms else "")
              + f"; {time.perf_counter() - t0:.1f}s")
        out[fusion] = {"diff": diff, "ms_b16": ms[0] if ms else None}
        del state, step, gen, d_img, d_obj
        torch.cuda.empty_cache()
    return out


def _special_clis(seed: int, root: str, dev) -> tuple[int, int, int]:
    """The CLIs on a COCO fixture at full width: ``cli.train --model
    ours_ed`` 2 epochs, then ``--resume`` an epoch with ``--eval_every``;
    ``cli.train --model layout2im`` 2 steps; ``cli.sample --ckpt_dir`` for
    both; ``cli.evaluate is`` on the Ours-ED samples; ``cli.export_torch
    --model ours_ed``. Returns the ISLA launches of the Ours-ED runs and
    sampling."""
    import torch

    from layout2img_tpu_torch.cli import export_torch
    from layout2img_tpu_torch.cli import sample as sample_cli
    from layout2img_tpu_torch.data.synthetic import write_synthetic_coco, write_synthetic_stuff
    from layout2img_tpu_torch.models.generators import BgFgGenerator
    from layout2img_tpu_torch.train.checkpoint import CheckpointManager

    fixture = os.path.join(root, "coco")
    _, inst = write_synthetic_coco(fixture, SPECIAL_IMAGES, width=160, height=120, seed=seed)
    stuff = write_synthetic_stuff(fixture, inst, seed=seed + 1)
    data = ["--dataset", "coco", "--coco_image_dir", fixture, "--coco_instances", inst,
            "--coco_stuff", stuff, "--batch_size", str(SPECIAL_B), "--seed", str(seed)]
    out = os.path.join(root, "out")
    common = [*data, "--save_every_epochs", "1", "--log_every", "2", "--out_path", out]
    counts = _cli_train("cli.train --model ours_ed", ["--model", "ours_ed", *common,
                                                      "--total_epoch", "2"], name="special")
    run = os.path.join(out, "coco", "64", "ours_ed")
    ckpt = os.path.join(run, "ckpt")
    steps = CheckpointManager(ckpt).all_steps()
    per_epoch = steps[0]
    need(len(steps) == 2 and steps[1] == 2 * per_epoch and counts == (16 * steps[1],) * 3,
         f"cli.train ours_ed: checkpoints {steps}, ISLA launches {counts}: not 16 of each per step")
    more = _cli_train("cli.train --model ours_ed --resume --eval_every", [
        "--model", "ours_ed", *common, "--total_epoch", "1", "--resume", "--eval_every",
        str(per_epoch), "--eval_n", str(SPECIAL_B)], name="special")
    steps = CheckpointManager(ckpt).all_steps()
    lines = _logged(run)
    evals = [ln for ln in lines if "rel_fid" in ln]
    need(steps[-1] == 3 * per_epoch and [ln["step"] for ln in evals] == [3 * per_epoch]
         and all(math.isfinite(v) for ln in lines for v in ln.values()),
         f"resumed ours_ed: checkpoints {steps}, eval lines {evals}")
    need(more == (16 * per_epoch + 16, 16 * per_epoch, 16 * per_epoch),
         f"resumed ours_ed: ISLA launches {more}, not 16 per step and per eval batch")
    phase("special", f"cli.train ours_ed: steps 1..{2 * per_epoch}, resumed {2 * per_epoch + 1}.."
          f"{3 * per_epoch}, rel_fid {evals[0]['rel_fid']:.4f} at step {3 * per_epoch}; launches "
          f"{counts} + {more} = 16 per step and per eval batch; no .pth: "
          f"{not any(n.endswith('.pth') for n in os.listdir(run))}")
    totals = [a + b for a, b in zip(counts, more)]

    _cli_train("cli.train --model layout2im", ["--model", "layout2im", *common, "--steps", "2",
                                               "--total_epoch", "1"], name="special")
    l2i_ckpt = os.path.join(out, "coco", "64", "layout2im", "ckpt")
    need(CheckpointManager(l2i_ckpt).all_steps() == [2], "cli.train layout2im: no checkpoint 2")

    samples = {}
    for model, ck in (("ours_ed", ckpt), ("layout2im", l2i_ckpt)):
        path = os.path.join(root, f"samples_{model}")
        _reset_isla_counts()
        sample_cli.main(["--model", model, "--ckpt_dir", ck, *data, "--num_img", "1",
                         "--sample_path", path, "--device", "cuda"])
        sync_all()
        got = _isla_counts()
        n = len(os.listdir(path))
        want = 16 * -(-n // SPECIAL_B) if model == "ours_ed" else 0
        need(n > 0 and got[0] == want, f"cli.sample {model}: {n} images, {got[0]} ISLA "
                                       f"launches, not {want}")
        totals[0] += got[0]
        samples[model] = path
        phase("special", f"cli.sample --model {model} --ckpt_dir: {n} images, ISLA x{got[0]}")
    is_mean = _number(_evaluate(["is", "--dir", samples["ours_ed"], "--batch_size", "16",
                                 "--device", "cuda"]), "IS: ")
    need(abs(is_mean - 1.0) < 0.01, f"IS of the ours_ed samples {is_mean} with random filters, "
                                    "not about 1")
    g_path = os.path.join(root, "G_ours_ed.pth")
    export_torch.main(["--model", "ours_ed", "--ckpt_dir", ckpt, "--out_g", g_path])
    BgFgGenerator(91, COCO_CLASSES - 91, ch=CH).load_state_dict(
        torch.load(g_path, weights_only=True), strict=True)
    phase("special", f"cli.evaluate is on the ours_ed samples: {is_mean:.4f}; cli.export_torch "
          "--model ours_ed: G loads strictly into BgFgGenerator")
    return tuple(totals)


def special_phase(seed: int, tmp_dir: str, dev, card: str, reps: int) -> dict:
    """The special families at full width, then through the CLIs. Returns
    the ISLA launches of the Ours-ED main path (3 steps, the CLIs' runs and
    sampling), the captured calls' sums and the step times."""
    import shutil

    t0 = time.perf_counter()
    root = os.path.join(tmp_dir, "special")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ours = _ours_ed_steps(seed, root, dev, card, reps)
    l2i = _layout2im_steps(seed, dev, card)
    clis = _special_clis(seed, root, dev)
    launches = tuple(a + b for a, b in zip(ours["launches"], clis))
    shutil.rmtree(root, ignore_errors=True)
    phase("special", f"main path ran the ISLA forward kernel {launches[0]} times, the backward's "
          f"main kernel {launches[1]} and its finishing kernel {launches[2]} times; "
          f"{time.perf_counter() - t0:.1f}s")
    return {"launches": launches, "ours_ed": ours, "layout2im": l2i}


# the export phase: the serving artifact at the CLI's defaults (context_app_v2: ch=64, 128 px,
# 184 classes, o=8), f32 and bf16, b=8 (checked) and b=128 (timed)
EXPORT_B, EXPORT_RATE_B = 8, 128
# the artifacts the phase writes: (b, precision); b=128 in the serving precision only
EXPORTS = ((EXPORT_B, "f32"), (EXPORT_B, "bf16"), (EXPORT_RATE_B, "bf16"))
EXPORT_BF16_BAR = 1e-2  # the kernel phases' bf16 bar, here on images in [-1, 1]
PLAIN_EINSUM = "bohw,boc->bchw"  # isla_modulate_plain's contraction


def _artifact_graph(ep) -> tuple[int, int]:
    """(ISLA operator nodes, plain-twin einsums) in an exported program."""
    import torch

    nodes = list(ep.graph.nodes)
    isla = sum(n.target == torch.ops.layout2img_tpu_torch.isla_norm.default for n in nodes)
    plain = sum(n.target == torch.ops.aten.einsum.default and n.args[0] == PLAIN_EINSUM
                for n in nodes)
    return isla, plain


def _export_run_subprocess(path: str) -> str:
    """``cli.export --run`` in a fresh interpreter; returns its line, and
    fails if that process imported a module of ``models/``."""
    code = ("import json, sys\nfrom layout2img_tpu_torch.cli.export import main\n"
            f"main(['--run', {path!r}])\n"
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.startswith('layout2img_tpu_torch.models'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    need(out.returncode == 0, f"cli.export --run exited {out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    need(json.loads(lines[-1]) == [], f"cli.export --run imported model code: {lines[-1]}")
    return lines[-2]


def export_phase(seed: int, tmp_dir: str, dev, card: str) -> int:
    """The serving artifact through ``cli.export`` at full width; returns the
    ISLA launches of the checked artifact calls (2 seeds x f32 and bf16 at
    b=8)."""
    import shutil

    import torch

    from layout2img_tpu_torch.cli import export as export_cli
    from layout2img_tpu_torch.cli.sample import checkpoint_generator_dict, load_generator
    from layout2img_tpu_torch.ops import interp
    from layout2img_tpu_torch.sample import latents_from_seed, make_sample_fn
    from layout2img_tpu_torch.train.checkpoint import CheckpointManager
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.utils.casting import cast_floating
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator

    t_phase = time.perf_counter()
    root = os.path.join(tmp_dir, "export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # a checkpoint with an EMA (moved off the raw weights), written through the train state
    gen = init_generator(seed, COCO_CLASSES, device=dev)
    state = create_train_state(gen, init_discriminator(seed, COCO_CLASSES, device=dev),
                               TrainConfig(ema_decay=0.999))
    g = torch.Generator(device=dev).manual_seed(seed)
    for v in state.ema.values():
        v.add_(torch.randn(v.shape, generator=g, device=dev) * 0.1 * v.abs().mean())
    ckpt = os.path.join(root, "ckpt")
    CheckpointManager(ckpt).save(state)
    del state, gen
    ema = load_generator(checkpoint_generator_dict(ckpt), dev).eval()
    ema_bf16 = cast_floating(load_generator(checkpoint_generator_dict(ckpt), dev).eval(),
                             torch.bfloat16)
    layouts = {b: synthetic_layouts_np(seed, b, 128) for b in (EXPORT_B, EXPORT_RATE_B)}
    args = {b: (lay["boxes"].to(dev), lay["labels"].to(dev)) for b, lay in layouts.items()}

    def eager(gen, b, s, dtype):
        z, z_im = latents_from_seed(torch.tensor([s], device=dev), b, COCO_OBJ, 128, 2.0, dtype)
        with torch.no_grad():
            return gen(z, *args[b], z_im)

    before = eager(ema, EXPORT_B, 0, torch.float32)
    paths = {}
    for b, dname in EXPORTS:
        path = os.path.join(root, f"G_b{b}_{dname}.pt2")
        interp._DEVICE_TABLES.clear()  # the export builds its resize tables under tracing
        t0 = time.perf_counter()
        export_cli.main(["--model", "context_app_v2", "--ckpt_dir", ckpt, "--out", path,
                         "--batch_size", str(b), *(["--bf16"] if dname == "bf16" else [])])
        phase("export", f"cli.export {dname} b={b}: {time.perf_counter() - t0:.1f}s, "
              f"{os.path.getsize(path) / 1e6:.1f} MB")
        paths[b, dname] = path
    after = eager(ema, EXPORT_B, 0, torch.float32)
    need(type(after) is torch.Tensor and torch.equal(after, before),
         f"after the exports an eager forward gives a {type(after).__name__} that differs from "
         f"the one before by {(after.float() - before.float()).abs().max().item()}")
    phase("export", f"after {len(EXPORTS)} exports (resize tables rebuilt under tracing) an eager forward "
          "returns a real tensor equal bit for bit to the one before")
    with open(paths[EXPORT_B, "f32"] + ".json") as f:
        meta = json.load(f)
    need(meta == {"batch_size": EXPORT_B, "num_objects": COCO_OBJ, "num_classes": COCO_CLASSES,
                  "img_size": 128, "model": "context_app_v2"}, f"sidecar {meta}")
    t0 = time.perf_counter()
    line = _export_run_subprocess(paths[EXPORT_B, "f32"])
    need(line.startswith(f"ran exported artifact: ({EXPORT_B}, 3, 128, 128) range"), line)
    phase("export", f"--run f32 in a fresh process (no module of models/ imported), "
          f"{time.perf_counter() - t0:.1f}s: {line}")

    t0 = time.perf_counter()
    programs = {key: torch.export.load(p) for key, p in paths.items()}
    phase("export", f"torch.export.load of {len(programs)} artifacts: "
          f"{time.perf_counter() - t0:.1f}s")
    for key, ep in programs.items():
        isla, plain = _artifact_graph(ep)
        need(isla == 10 and plain == 0, f"artifact {key}: {isla} ISLA operator nodes and {plain} "
             f"plain-twin einsums, not 10 and 0")
    modules = {key: ep.module() for key, ep in programs.items()}
    phase("export", "each artifact holds 10 layout2img_tpu_torch::isla_norm nodes and no "
          f"'{PLAIN_EINSUM}' einsum")

    # the main path: 4 artifact calls, counts set to 0 just before and read just after
    _reset_isla_counts()
    with torch.no_grad():
        outs = {(dname, s): modules[EXPORT_B, dname](*args[EXPORT_B], torch.tensor([s], device=dev))
                for dname in ("f32", "bf16") for s in (0, 1)}
    sync_all()
    launches = _isla_counts()
    need(launches == (40, 0, 0), f"4 artifact calls launched the ISLA kernels {launches}, "
         "not (40, 0, 0)")
    for dname, dtype, gen, bar in (("f32", torch.float32, ema, 1e-5),
                                   ("bf16", torch.bfloat16, ema_bf16, EXPORT_BF16_BAR)):
        for s in (0, 1):
            got, want = outs[dname, s], eager(gen, EXPORT_B, s, dtype)
            err = (got.float() - want.float()).abs().max().item()
            need(got.shape == (EXPORT_B, 3, 128, 128) and got.dtype == dtype
                 and torch.isfinite(got.float()).all().item() and err <= bar,
                 f"artifact {dname} seed {s}: {tuple(got.shape)} {got.dtype}, off the eager EMA "
                 f"generator by {err} > {bar}")
            phase("export", f"artifact {dname} seed {s} vs the eager EMA generator on "
                  f"latents_from_seed: max_abs_diff={err:.3e} (bar {bar:g})")
        diff = (outs[dname, 0].float() - outs[dname, 1].float()).abs().max().item()
        need(diff > 1e-2, f"artifact {dname}: seeds 0 and 1 give the same images ({diff})")
    raw = load_generator(CheckpointManager(ckpt).read()["generator"], dev).eval()
    served = (outs["f32", 0] - eager(raw, EXPORT_B, 0, torch.float32)).abs().max().item()
    need(served > 1e-3, f"the artifact serves the raw weights, not the EMA ({served})")
    phase("export", f"main path: 4 artifact calls launched the ISLA forward kernel {launches[0]} "
          f"times (10 a call); the raw weights' images differ by {served:.3e} (EMA served)")

    # where one f32 b=8 call spends its time: the artifact against the eager sampler
    seed_t = torch.tensor([0], device=dev)
    sample = make_sample_fn(ema)
    rng = torch.Generator(device=dev).manual_seed(seed)
    calls = {"artifact": lambda *_: modules[EXPORT_B, "f32"](*args[EXPORT_B], seed_t),
             "eager sampler": lambda *_: sample(*args[EXPORT_B], rng)}
    for tag, call in calls.items():
        with torch.no_grad():
            dev_ms, wall_ms, kernels, rows = _profile_steps(call, None, None, n=3)
        if not rows:
            phase("export", f"profile {tag}: the profiler saw no device time; not measured")
            continue
        isla_n = sum(n for k, _, n in rows if "isla" in k)
        need(isla_n == 10, f"the profile shows {isla_n} ISLA kernels per {tag} call, not 10")
        phase("export", f"profile f32 b={EXPORT_B} {tag}: {dev_ms:.3f} ms of device time in "
              f"{wall_ms:.3f} ms traced, {kernels} kernels per call, the ISLA kernel x{isla_n}")

    for b, dname in EXPORTS:
        reps = 10 if b == EXPORT_B else 5
        dtype, gen = (torch.float32, ema) if dname == "f32" else (torch.bfloat16, ema_bf16)
        mod = modules[b, dname]
        sample = make_sample_fn(gen, dtype=dtype)
        with torch.no_grad():
            a_ms, a_lo, a_hi = time_ms(lambda: mod(*args[b], seed_t), reps)
        e_ms, e_lo, e_hi = time_ms(lambda: sample(*args[b], rng), reps)
        phase("export", f"{dname} b={b}: artifact {a_ms:.3f} ms/batch [{a_lo:.3f}, {a_hi:.3f}] "
              f"{1e3 * b / a_ms:.1f} img/s; eager sampler {e_ms:.3f} ms/batch [{e_lo:.3f}, "
              f"{e_hi:.3f}] {1e3 * b / e_ms:.1f} img/s; over {reps} batches on {card}")
    shutil.rmtree(root, ignore_errors=True)
    phase("export", f"{time.perf_counter() - t_phase:.1f}s")
    return launches[0]


def conditioning_phase(tmp_dir: str, reps: int) -> tuple[tuple[int, int, int], tuple[float, ...]]:
    """The conditioning check for the flagship at the script's defaults (800
    steps); its own gate decides. Then the ISLA calls of one of its steps
    against the plain versions. Returns the ISLA launches of the run and the
    calls' summed (forward ms, plain, bound, backward ms, plain, bound)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from layout2img_tpu_torch.models.generators import make_generator
    from layout2img_tpu_torch.scripts import train_conditioning_check as check

    a = check.parse_args(["--image_out", os.path.join(tmp_dir, "conditioning.png")])
    # two norms a block: 8 at 64 px
    calls = make_generator(a.preset, a.num_classes, device="meta", ch=a.ch, image_size=a.img_size,
                           num_mask_classes=a.num_classes).isla_calls
    _reset_isla_counts()
    t0 = time.perf_counter()
    result = check.run_check(a)
    sync_all()
    launches = _isla_counts()
    wall = time.perf_counter() - t0
    per_step = tuple(result["isla_launches_per_step"])
    need(per_step == (calls,) * 3, f"ISLA launches per step {per_step}, not {(calls,) * 3}")
    passed = check.learned(result, a.min_score)
    # the ISLA calls of one step of this path (b=32, o=4, c 24-384, bf16) against the plain
    # versions, outside the counted run
    dev = torch.device("cuda")
    _, step, batch_fn, *_ = check.build_family(a, dev)
    built = SimpleNamespace(step=step, batch=check.to_device(batch_fn(np.random.default_rng(0)), dev),
                            rng=torch.Generator(device=dev).manual_seed(1))
    sums = check_captured("conditioning step", capture_isla_calls(built), want_o=a.objects,
                          reps=reps, want_calls=calls, name="conditioning")
    phase("conditioning", f"{a.preset} b={a.batch_size} ch={a.ch} {a.img_size}px "
          f"{result['steps']} steps: score {result['score_before']:+.3f} -> "
          f"{result['score_after']:+.3f} (gate: above {a.min_score} and 0.3 above the start: "
          f"{'passed' if passed else 'FAILED'}); trajectory "
          + ", ".join(f"{t['step']}: {t['score']:+.3f}" for t in result["trajectory"])
          + f"; {result['train_seconds']:.1f}s training, {wall:.1f}s in all; ISLA per step "
          f"forward {per_step[0]:g}, backward {per_step[1]:g} + {per_step[2]:g} finishing (bf16); "
          f"the run's launches {launches}")
    need(passed, "the conditioning check's gate failed: the port did not learn")
    return launches, sums


DDP_STEPS = 5
# what torchrun starts: this file (its --ddp_child mode)
DDP_ENTRY = os.path.abspath(__file__)
DDP_CLI = ["--model", "context_app_v2", "--dataset", "synthetic", "--batch_size", str(B),
           "--steps", str(DDP_STEPS), "--steps_per_epoch", str(DDP_STEPS), "--total_epoch", "1",
           "--log_every", str(DDP_STEPS)]


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block (runs compared bit for bit)."""
    import torch

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


@contextlib.contextmanager
def _timed_train_steps():
    """Yields a list that collects each train step's ms (synchronised on
    both sides) of the steps ``make_train_step`` builds inside the block."""
    import torch

    import layout2img_tpu_torch.train.step as step_mod

    times, make = [], step_mod.make_train_step

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(batch, rng):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch, rng)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            return out

        timed.with_latents = step.with_latents
        return timed

    step_mod.make_train_step = timed_make
    try:
        yield times
    finally:
        step_mod.make_train_step = make


def _ddp_inputs(seed: int):
    """The ddp phase's global batch (b=8, CPU) and latents."""
    import numpy as np
    import torch

    batch = _train_batch(np.random.default_rng(seed + 11), B, "cpu")
    g = torch.Generator().manual_seed(seed + 11)
    return batch, torch.randn(B, O, 128, generator=g), torch.randn(B, 128, generator=g)


def _ddp_rank_step(paths: dict, seed: int) -> tuple[dict, int]:
    """One rank of the gloo run: the saved train weights, one f32 step without
    dropout on this rank's rows of ``_ddp_inputs``, its ISLA launches, then 3
    timed steps; the state checked bit-equal across the ranks."""
    import torch

    from layout2img_tpu_torch.parallel import mesh as data_mesh

    mesh = data_mesh.initialize(backend="gloo")
    dev = mesh.device
    batch, z, z_im = _ddp_inputs(seed)
    state, step = _trainer(paths, dev, seed, deterministic=True)
    data_mesh.replicate(mesh, state)
    mine = {k: mesh.rows(v).to(dev) for k, v in batch.items()}
    _reset_isla_counts()
    metrics = step.with_latents(mine, mesh.rows(z).to(dev), mesh.rows(z_im).to(dev))
    sync_all()
    counts = _isla_counts()
    grads = {n: {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
             for n, net in (("G", state.generator), ("D", state.discriminator))}
    rng, times = torch.Generator(device=dev).manual_seed(seed), []
    for _ in range(3):
        sync_all()
        t0 = time.perf_counter()
        step(mine, rng)
        sync_all()
        times.append(1e3 * (time.perf_counter() - t0))
    data_mesh.check_replicated(mesh, state)
    data_mesh.shutdown()
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "counts": counts, "ms": times,
            "grads": grads, "world": mesh.world}, mesh.rank


def ddp_child(argv: list[str]) -> int:
    """A process of the ddp phase, alone or under torchrun:
    ``cli OUT ARGS...`` runs ``cli.train`` on ARGS with deterministic cuDNN;
    ``step OUT PATHS_JSON SEED`` runs ``_ddp_rank_step``. Rank 0 writes what
    it found (ISLA launches, step ms, ...) to OUT with ``torch.save``."""
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mode, out = argv[0], argv[1]
    if mode == "cli":
        from layout2img_tpu_torch.cli import train as train_cli

        with _deterministic_cudnn(), _timed_train_steps() as times:
            train_cli.main(argv[2:])
        result, rank = {"counts": _isla_counts(), "ms": times}, int(os.environ.get("RANK", 0))
    else:
        result, rank = _ddp_rank_step(json.loads(argv[2]), int(argv[3]))
    if rank == 0:
        torch.save(result, out)
    return 0


def _torchrun(nproc: int, args: list[str], what: str) -> None:
    """``torchrun --standalone --nproc_per_node=nproc chip_smoke.py --ddp_child ARGS``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", DDP_ENTRY, "--ddp_child", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=400)
    need(out.returncode == 0, f"{what}: torchrun exited {out.returncode}: "
                              f"{(out.stdout + out.stderr)[-3000:]}")
    phase("ddp", f"{what}: torchrun --nproc_per_node={nproc} exit 0 in "
                 f"{time.perf_counter() - t0:.1f}s")


def _median(xs: list[float]) -> float:
    return sorted(xs)[len(xs) // 2]


def ddp_phase(seed: int, tmp_dir: str, dev, card: str, paths: dict | None) -> tuple[int, int, int]:
    """Data parallelism at full width; returns the ISLA launches of the
    NCCL run and of rank 0's step in the gloo run."""
    import shutil

    import torch

    from layout2img_tpu_torch.cli import train as train_cli
    from layout2img_tpu_torch.parallel.mesh import flat_tensors

    t_phase = time.perf_counter()
    paths = paths or save_train_weights(seed, tmp_dir)
    args = DDP_CLI + ["--seed", str(seed)]
    runs = {name: os.path.join(tmp_dir, f"ddp_{name}") for name in ("one", "nccl")}
    for d in runs.values():
        shutil.rmtree(d, ignore_errors=True)

    # the one-process run, in this process, and torchrun's one rank over NCCL
    _reset_isla_counts()
    with _deterministic_cudnn(), _timed_train_steps() as one_ms:
        train_cli.main(args + ["--out_path", runs["one"]])
    sync_all()
    one_counts = _isla_counts()
    out = os.path.join(tmp_dir, "ddp_nccl.pt")
    _torchrun(1, ["cli", out] + args + ["--out_path", runs["nccl"]], "cli.train, 1 rank, NCCL")
    nccl = torch.load(out, weights_only=False)
    want = (10 * DDP_STEPS + 10, 10 * DDP_STEPS, 10 * DDP_STEPS)  # and one grid at the log point
    for tag, counts in (("one process", one_counts), ("NCCL rank", tuple(nccl["counts"]))):
        need(counts == want, f"ddp {tag}: ISLA launches {counts}, not {want} for {DDP_STEPS} "
                             "steps and one image grid")
    sub = os.path.join("synthetic", str(train_cli.parse_args(args).img_size or 128),
                       "context_app_v2")
    lines = [_logged(os.path.join(runs[n], sub)) for n in ("one", "nccl")]
    strip = [[{k: v for k, v in ln.items() if k != "time"} for ln in ls] for ls in lines]
    need(strip[0] == strip[1] and len(strip[0]) == 1,
         f"ddp: the NCCL rank's metrics differ from the one process's: {strip}")
    same, total = 0, 0
    for name in ("G.pth", "D.pth", os.path.join("ckpt", str(DDP_STEPS), "state.pt")):
        a, b = (torch.load(os.path.join(runs[n], sub, name), map_location="cpu", weights_only=True)
                for n in ("one", "nccl"))
        flat_a, flat_b = flat_tensors(a), flat_tensors(b)
        need(flat_a.keys() == flat_b.keys(), f"ddp: {name} holds other tensors")
        bad = [k for k in flat_a if not torch.equal(flat_a[k], flat_b[k])]
        need(not bad, f"ddp: the NCCL rank's {name} differs from the one process's at {bad[:5]}")
        same, total = same + len(flat_a), total + len(flat_a)
    phase("ddp", f"cli.train {DDP_STEPS} f32 steps at b={B}: one process and one NCCL rank give "
                 f"the same losses ({' '.join(f'{k}={v:.6f}' for k, v in strip[0][0].items() if k != 'step')}) "
                 f"and the same bits in all {total} tensors of G.pth, D.pth and the checkpoint; "
                 f"ISLA forward x{want[0]}, backward x{want[1]}, finishing x{want[2]} in each run "
                 "(10 of each a step, 10 forward for the grid)")

    # 2 ranks on the one card over gloo, against the one-process step at b=8
    batch, z, z_im = _ddp_inputs(seed)
    m_one, g_one, _ = _step_grads(paths, dev, seed, batch, z, z_im)
    out = os.path.join(tmp_dir, "ddp_gloo.pt")
    _torchrun(2, ["step", out, json.dumps(paths), str(seed)], "2 ranks on one card, gloo")
    gloo = torch.load(out, weights_only=False)
    need(tuple(gloo["counts"]) == (10, 10, 10),
         f"ddp gloo rank 0: ISLA launches {gloo['counts']} in its step, not (10, 10, 10)")
    worst = max(abs(gloo["metrics"][k] - m_one[k]) for k in m_one)
    need(worst <= 2e-3, f"ddp gloo: losses differ from the one-process step by {worst} > 2e-3")
    phase("ddp", f"2 ranks x b={B // 2} (gloo, one card) against one process at b={B}: losses "
                 f"within {worst:.3e} (bar 2e-3); every rank's state bit-equal after the steps")
    phase("ddp", _grad_report("D", gloo["grads"]["D"], g_one["D"], B))
    phase("ddp", _grad_report("G", gloo["grads"]["G"], g_one["G"], B))
    ms = {"one process": _median(one_ms[1:]), "NCCL, 1 rank": _median(nccl["ms"][1:]),
          "gloo, 2 ranks on one card (a check of correctness, not a speed)": _median(gloo["ms"])}
    phase("ddp", f"f32 step at global b={B}, median ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" | {card}")
    phase("ddp", f"{time.perf_counter() - t_phase:.1f}s")
    return tuple(a + b for a, b in zip(nccl["counts"], gloo["counts"]))


def synthetic_layouts_np(seed: int, b: int, size: int) -> dict:
    """COCO-shaped layouts (o=8, 3-8 objects) as CPU tensors."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.data.synthetic import synthetic_layouts

    layout = synthetic_layouts(np.random.default_rng(seed), b, COCO_OBJ, COCO_CLASSES)
    return {"boxes": torch.from_numpy(layout["boxes"]),
            "labels": torch.from_numpy(layout["labels"]).long()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--ddp_child"]:  # a process the ddp phase starts
        return ddp_child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated phases to run, of {','.join(PHASES)} (default: all)")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed launches per kernel and shape in the kernel phases (default 50)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown or ("rate" in phases and "slice" not in phases) or (
            "train_rate" in phases and "train" not in phases):
        ap.error(f"--phases {args.phases}: phases are {','.join(PHASES)}; rate needs slice and "
                 "train_rate needs train")

    if not os.path.isdir(os.path.join(ROOT, "layout2img_tpu_torch")):
        phase("device", f"FAIL: no layout2img_tpu_torch package beside {os.path.basename(__file__)}; "
              "run it from a checkout of the repository")
        return 1
    import torch

    if not torch.cuda.is_available():
        phase("device", "FAIL: torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, ROOT)
    tmp_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(tmp_dir, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    rows = {}
    spent: dict[str, float] = {}  # seconds per phase, printed at the end
    current = [None, t_start]

    def begin(name: str | None) -> None:
        now = time.perf_counter()
        if current[0] is not None:
            spent[current[0]] = now - current[1]
        current[:] = [name, now]

    try:
        card = gpu_line()
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        phase("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
              f"{kind} x{count}")
        dev = torch.device("cuda")
        if "build" in phases:
            begin("build")
            t0 = time.perf_counter()
            build_phase()
            phase("build", f"{time.perf_counter() - t0:.1f}s")
        if "kernel" in phases:
            begin("kernel")
            rows["isla_norm"] = kernel_phase(args.reps)
        if "kernel_bwd" in phases:
            begin("kernel_bwd")
            rows["isla_norm_bwd"], rows["isla_norm_bwd_finish"] = kernel_bwd_phase(args.reps)
        if "bwd_vg" in phases:
            begin("bwd_vg")
            vg = bwd_vg_phase(args.reps)
            if "isla_norm_bwd" in rows:
                rows["isla_norm_bwd"].update(
                    ms_vg=vg["float32"][0], main_kernel_ms_vg=vg["float32"][1],
                    ms_vg_bf16=vg["bfloat16"][0], main_kernel_ms_vg_bf16=vg["bfloat16"][1])
        fwd, bwd, fin = (rows.get(k, {}) for k in ("isla_norm", "isla_norm_bwd", "isla_norm_bwd_finish"))
        if "slice" in phases:
            begin("slice")
            fwd["launches"], gens = slice_phase(args.seed, tmp_dir, dev)
        if "train" in phases:
            begin("train")
            (fwd["launches_train"], bwd["launches"], fin["launches"]), paths = train_phase(
                args.seed, tmp_dir, dev)
            bwd["launches_train"], fin["launches_train"] = bwd["launches"], fin["launches"]
        if "rate" in phases:
            begin("rate")
            fwd["ms_in_forward_traced"] = rate_phase(args.seed, card, gens)
            del gens
        if "train_rate" in phases:
            begin("train_rate")
            (fwd["ms_in_step_traced"], bwd["ms_in_step_traced"],
             fin["ms_in_step_traced"]) = train_rate_phase(args.seed, card, paths)
        if "train_mixed" in phases:
            begin("train_mixed")
            mixed = train_mixed_phase(args.seed, tmp_dir, dev, card,
                                      paths if "train" in phases else None, max(5, args.reps // 5))
            (fwd["launches_mixed"], bwd["launches_mixed"], fin["launches_mixed"]) = mixed["launches"]
            for tag, suffix in (("bench default", "b128"), ("bench VG budgeted", "b128_vg_o12")):
                f_ms, pf_ms, f_bound, b_ms, pb_ms, b_bound = mixed[tag]
                fwd.update({f"ms_bf16_{suffix}": f_ms, f"plain_ms_bf16_{suffix}": pf_ms,
                            f"bound_ms_bf16_{suffix}": f_bound})
                bwd.update({f"ms_bf16_{suffix}": b_ms, f"plain_ms_bf16_{suffix}": pb_ms,
                            f"bound_ms_bf16_{suffix}": b_bound})
        if "presets" in phases:
            begin("presets")
            pre = presets_phase(args.seed, tmp_dir, dev, card, max(5, args.reps // 20))
            (fwd["launches_presets"], bwd["launches_presets"],
             fin["launches_presets"]) = pre["launches"]
            for exp_name, run in pre["runs"].items():
                for dname in ("f32", "bf16"):
                    f_ms, pf_ms, f_bound, b_ms, pb_ms, b_bound = run[dname]
                    fwd[f"ms_{dname}_{exp_name}"] = f_ms
                    fwd[f"plain_ms_{dname}_{exp_name}"] = pf_ms
                    fwd[f"bound_ms_{dname}_{exp_name}"] = f_bound
                    bwd[f"ms_{dname}_{exp_name}"] = b_ms
                    bwd[f"plain_ms_{dname}_{exp_name}"] = pb_ms
                    bwd[f"bound_ms_{dname}_{exp_name}"] = b_bound
        if "data" in phases:
            begin("data")
            (fwd["launches_data"], bwd["launches_data"],
             fin["launches_data"]) = data_phase(args.seed, tmp_dir, dev, card)
        if "eval" in phases:
            begin("eval")
            counts = eval_phase(args.seed, tmp_dir, dev, card)
            for row, n in zip((fwd, bwd, fin), counts):
                row["launches_eval"] = n
                row["launches"] = row.get("launches", 0) + n
        if "special" in phases:
            begin("special")
            special = special_phase(args.seed, tmp_dir, dev, card, max(5, args.reps // 20))
            for row, n in zip((fwd, bwd, fin), special["launches"]):
                row["launches_special"] = n
                row["launches"] = row.get("launches", 0) + n
            f_ms, pf_ms, f_bound, b_ms, pb_ms, b_bound = special["ours_ed"]["sums"]
            fwd.update(ms_f32_ours_ed=f_ms, plain_ms_f32_ours_ed=pf_ms, bound_ms_f32_ours_ed=f_bound)
            bwd.update(ms_f32_ours_ed=b_ms, plain_ms_f32_ours_ed=pb_ms, bound_ms_f32_ours_ed=b_bound)
        if "export" in phases:
            begin("export")
            fwd["launches_export"] = export_phase(args.seed, tmp_dir, dev, card)
            for row in (bwd, fin):
                row["launches_export"] = 0
            fwd["launches"] = fwd.get("launches", 0) + fwd["launches_export"]
        if "conditioning" in phases:
            begin("conditioning")
            launches, sums = conditioning_phase(tmp_dir, max(5, args.reps // 20))
            for row, n in zip((fwd, bwd, fin), launches):
                row["launches_conditioning"] = n
                row["launches"] = row.get("launches", 0) + n
            f_ms, pf_ms, f_bound, b_ms, pb_ms, b_bound = sums
            fwd.update(ms_bf16_conditioning=f_ms, plain_ms_bf16_conditioning=pf_ms,
                       bound_ms_bf16_conditioning=f_bound)
            bwd.update(ms_bf16_conditioning=b_ms, plain_ms_bf16_conditioning=pb_ms,
                       bound_ms_bf16_conditioning=b_bound)
        if "ddp" in phases:
            begin("ddp")
            counts = ddp_phase(args.seed, tmp_dir, dev, card, paths if "train" in phases else None)
            for row, n in zip((fwd, bwd, fin), counts):
                row["launches_ddp"] = n
                row["launches"] = row.get("launches", 0) + n
    except SmokeFailure as e:
        phase("FAIL", str(e))
        return 1
    begin(None)
    phase("done", f"{time.perf_counter() - t_start:.1f}s; by phase: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in spent.items()))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
