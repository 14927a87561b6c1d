#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``layout2img_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout. It builds the port's CUDA kernels from
the checkout's sources (``nvcc`` into ``build/kernels/``) and runs these
phases in order, each printing its own lines; any failure exits non-zero:

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
4. kernel  -- the same for the ISLA backward kernel, with batch statistics
   (bwd)      that need a gradient: every gradient (x through the
              statistics, the source mask, gamma, beta) against autograd of
              the plain version, two launches compared bit for bit, and per
              shape the function's time (the launch, the fixed-order sums of
              its partial buffers and the transposed resize) and the launch's
              alone, against the plain backward's and the bound.
5. slice   -- full-width ``ours_d_context128`` (ch=64, 179 classes, o=31 with
              6 valid objects, b=8) from seeded weights, saved and reloaded
              strictly, sampled 3x in f32 and 3x in bf16 through the
              sampler; checks shape, range, 10 kernel launches per forward,
              ``obj_budget``, and one f32 batch of 2 against the CPU path.
6. train   -- the same generator with ``d128_app`` (ch=64) and the VGG loss,
              seeded, saved and reloaded strictly, 5 f32 train steps at b=8:
              finite losses, parameters, BN statistics and SN vectors moved,
              10 forward and 10 backward ISLA launches per step; then one
              step on the card against the same step on the CPU at b=2 and
              b=8, with the per-layer bars of ``tests/test_torch_port_train.py``.
7. rate    -- sampler img/s at b=8 and b=128, train-step ms and img/s at b=8
              and b=32 (CUDA events, after warm-up) with peak memory, in f32
              as ``cli/train.py`` runs it and, for comparison, with TF32 in
              cuDNN and matmul; the profiler's breakdown of one sampler
              forward and one f32 train step.
8. the ``{"kernels": [...]}`` line, the card's line, then the result line.

fp32 comparisons run with TF32 off in cuDNN and matmul: cuDNN's TF32
default keeps about three decimal digits.
"""

from __future__ import annotations

import argparse
import json
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32; bf16 tensor cores
B, O, N_VALID, NUM_CLASSES, CH = 8, 31, 6, 179, 64
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
    zero. ``dense``: every object non-zero everywhere, the most work."""
    import torch

    dev = g.device
    if pattern == "dense":
        return (torch.rand(b, o, hs, hs, device=dev, generator=g) + 0.01).to(dtype)
    lo = 0.6 * torch.rand(b, N_VALID, 2, 1, device=dev, generator=g)  # box corner (y, x)
    size = 0.1 + 0.4 * torch.rand(b, N_VALID, 2, 1, device=dev, generator=g)
    pos = (torch.arange(hs, device=dev) + 0.5) / hs
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


def kernel_phase(reps: int = 100) -> dict:
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


def kernel_bwd_phase(reps: int = 100) -> dict:
    """The ISLA backward kernel against autograd of the plain version, at the
    ten shapes of one forward; bars against max|plain| of each gradient:
    1e-4 in f32 (sums over up to 131k pixels in another order, 1/d up to
    1e6 where no object covers a pixel), 2e-2 in bf16 (inputs, dx and the
    outputs rounded to bf16; the plain oracle runs in f32). With the ReLU,
    the output gradient is zeroed at the gate's ties (``_off_gate_ties``).
    The function's time is the wrapper's: the launch, the fixed-order sums of
    its partial buffers and the transposed resize; the plain version is
    autograd of ``isla_norm_plain`` from the same inputs."""
    import torch

    from layout2img_tpu_torch.nn.norms import batch_stats
    from layout2img_tpu_torch.ops.interp import resize_bilinear
    from layout2img_tpu_torch.ops.isla import (_launch_backward, _plain_backward, backward_config,
                                               isla_norm, isla_norm_backward, isla_norm_plain)

    dev = torch.device("cuda")
    flush = torch.empty(2**28, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(4321)
    worst_abs, worst_rel, n_checks = 0.0, 0.0, 0
    per_forward = {}  # (dtype, o, pattern) -> [wrapper, launch, plain, bound, bytes-bound, ops-bound]
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
                    # the kernel alone, at the statistics the training path gives it
                    mean, var = batch_stats(x)
                    args = (x, mean, var, 1e-5, mask, gamma, beta, grad, relu)
                    first = isla_norm_backward(*args)
                    second = isla_norm_backward(*args)
                    need(all(torch.equal(a, b) for a, b in zip(first, second)),
                         f"ISLA backward not bit-identical run to run at {where}")
                    cfg = backward_config(B, c, h, h, o)
                    w_ms, w_lo, w_hi = time_ms(lambda: isla_norm_backward(*args), reps, flush)
                    k_ms, _, _ = time_ms(lambda: _launch_backward(*args, cfg), reps, flush)
                    p_ms, _, _ = time_ms(lambda: _plain_backward(*args), reps, flush)
                    live = int((resize_bilinear(mask.float(), (h, h)) != 0).sum().item())
                    bound_ms, t_b, t_o = isla_bwd_cost(x, mask, live, dname)
                    phase("kernel", f"isla_norm_bwd {where}: rel_err {', '.join(errs)} (bar {rel_tol:g}) "
                          f"ms={w_ms:.5f} [{w_lo:.5f}, {w_hi:.5f}] launch_ms={k_ms:.5f} "
                          f"plain_ms={p_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
                          f"({'bytes' if t_b >= t_o else 'operations'}) share={bound_ms / w_ms:.3f} "
                          f"spans={cfg.n_spans} groups={cfg.n_groups} smem={cfg.smem_bytes}")
                    acc = per_forward.setdefault((dname, o, pattern), [0.0] * 6)
                    for j, v in enumerate((w_ms, k_ms, p_ms, bound_ms, t_b, t_o)):
                        acc[j] += v
    for (dname, o, pattern), (w_ms, k_ms, p_ms, bound_ms, _, _) in per_forward.items():
        phase("kernel", f"isla_norm_bwd {dname} o={o} {pattern} per forward (b={B}, ten calls): "
              f"ms={w_ms:.5f} launch_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
              f"bound_ms={bound_ms:.5f} share_of_bound={bound_ms / w_ms:.3f}")
    w_ms, k_ms, p_ms, bound_ms, t_b, t_o = per_forward[("float32", O, "sparse")]
    bf = per_forward[("bfloat16", O, "sparse")]
    return {"name": "isla_norm_bwd", "route": "cuda", "source": ISLA_BWD_SOURCE,
            "replaces": ISLA_BWD_REPLACES, "launches": None, "max_abs_err": worst_abs,
            "max_rel_err": worst_rel, "checks": n_checks,
            "ms": w_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_b >= t_o else "operations", "library_ms": None,
            "launch_ms": k_ms, "ms_bf16": bf[0], "launch_ms_bf16": bf[1], "plain_ms_bf16": bf[2],
            "bound_ms_bf16": bf[3],
            "timed_as": f"sum of the ten calls of one forward's backward, b={B}, o={O}, sparse "
                        "masks, L2 flushed; ms = isla_norm_backward (the launch, the fixed-order "
                        "sums of its partial buffers, the transposed resize), launch_ms = the "
                        "launch alone; plain = autograd of isla_norm_plain from the same inputs"}


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
    from layout2img_tpu_torch.sample import cast_floating, make_sample_fn
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


def _trainer(paths: dict, dev, seed: int, deterministic: bool = False):
    """(state, train_step) from the saved G and D, with the seeded VGG loss."""
    import torch

    from layout2img_tpu_torch.cli.sample import load_generator
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.convert import init_vgg

    gen = load_generator(paths["G"], dev)
    disc = make_discriminator("d128_app", NUM_CLASSES, device=dev, ch=CH)
    disc.load_state_dict(torch.load(paths["D"], map_location="cpu", weights_only=True), strict=True)
    state = create_train_state(gen, disc, TrainConfig())
    vgg = VGGLoss(init_vgg(seed + 2, device=dev))
    return state, make_train_step(state, TrainConfig(), vgg_loss=vgg, deterministic=deterministic)


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


def train_phase(seed: int, tmp_dir: str, dev) -> tuple[tuple[int, int], dict]:
    """Drive the train step at full width; returns the ISLA forward and
    backward launches of its TRAIN_STEPS steps and the saved weights' paths."""
    import numpy as np
    import torch

    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator

    t0 = time.perf_counter()
    paths = {"G": os.path.join(tmp_dir, "train_G.pth"), "D": os.path.join(tmp_dir, "train_D.pth")}
    torch.save(init_generator(seed, NUM_CLASSES, device="cpu", ch=CH).state_dict(), paths["G"])
    torch.save(init_discriminator(seed + 1, NUM_CLASSES, device="cpu", ch=CH).state_dict(), paths["D"])
    state, step = _trainer(paths, dev, seed)
    gen, disc = state.generator, state.discriminator
    phase("train", f"ours_d_context128 + d128_app ch={CH} classes={NUM_CLASSES}: "
          f"{sum(p.numel() for p in gen.parameters())} + {sum(p.numel() for p in disc.parameters())} "
          f"parameters, seeded, saved and reloaded strict in {time.perf_counter() - t0:.1f}s")
    before = {f"G.{k}": v.clone() for k, v in gen.state_dict().items()}
    before |= {f"D.{k}": v.clone() for k, v in disc.state_dict().items()}
    data_rng = np.random.default_rng(seed)
    batches = [_train_batch(data_rng, B, dev) for _ in range(TRAIN_STEPS)]
    rng = torch.Generator(device=dev).manual_seed(seed)

    isla_norm.launches = isla_norm_backward.launches = 0
    for i, batch in enumerate(batches):
        f0, b0 = isla_norm.launches, isla_norm_backward.launches
        metrics = step(batch, rng)
        sync(dev)
        fwd, bwd = isla_norm.launches - f0, isla_norm_backward.launches - b0
        need((fwd, bwd) == (10, 10), f"train step {i + 1}: {fwd} ISLA forward and {bwd} backward "
                                     "launches, not 10 and 10")
        values = {k: v.item() for k, v in metrics.items()}
        need(all(np.isfinite(v) for v in values.values()), f"train step {i + 1}: non-finite {values}")
        phase("train", f"f32 b={B} step {i + 1}: " + " ".join(f"{k}={v:.5f}" for k, v in values.items()))
    launches = (isla_norm.launches, isla_norm_backward.launches)
    phase("train", f"main path ran the ISLA forward kernel {launches[0]} times and the backward "
          f"kernel {launches[1]} times ({TRAIN_STEPS} steps, 10 each per step)")

    after = {f"G.{k}": v for k, v in gen.state_dict().items()}
    after |= {f"D.{k}": v for k, v in disc.state_dict().items()}
    params = {f"G.{k}": p for k, p in gen.named_parameters()}
    params |= {f"D.{k}": p for k, p in disc.named_parameters()}
    # a parameter whose gradient is exactly zero stays put (D's score biases:
    # while every hinge term is active, the real and fake terms cancel)
    zero_grad = sorted(k for k, p in params.items() if not p.grad.any())
    for what, keys in (("parameters", sorted(set(params) - set(zero_grad))),
                       ("BN running statistics", [k for k in after if k.endswith("running_mean")]),
                       ("SN u vectors", [k for k in after if k.endswith("weight_u")])):
        still = [k for k in keys if torch.equal(before[k], after[k])]
        need(keys and not still, f"train: {len(still)} of {len(keys)} {what} did not move: {still[:5]}")
        phase("train", f"all {len(keys)} {what} moved")
    phase("train", f"{len(zero_grad)} parameters had an exactly zero gradient in the last step: "
          f"{zero_grad[:6]}")

    # b=2 as the CPU tests run it, where the PSP head's 1x1 stage sees two
    # values per channel; b=8, where it sees eight
    for b in (2, 8):
        card_vs_cpu(seed, paths, dev, b)
    return launches, paths


def train_rate_phase(seed: int, card: str, paths: dict) -> tuple[float | None, float | None]:
    """Train-step rates at b=8 and b=32, in f32 (as ``cli/train.py`` runs
    it) and with TF32 in cuDNN and matmul, then a profiled f32 b=8 step;
    returns the ISLA forward and backward kernels' device ms in that step."""
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
        return None, None
    rows.sort(key=lambda r: -r[1])
    fwd = [(ms, n) for k, ms, n in rows if "isla_norm_kernel" in k]
    bwd = [(ms, n) for k, ms, n in rows if "isla_norm_bwd_kernel" in k]
    f_ms, f_n = sum(ms for ms, _ in fwd), sum(n for _, n in fwd)
    b_ms, b_n = sum(ms for ms, _ in bwd), sum(n for _, n in bwd)
    need((f_n, b_n) == (10, 10), f"the train profile shows {f_n} ISLA forward and {b_n} backward "
                                 "kernels per step, not 10 and 10")
    phase("rate", f"train profile f32 b={B}: device kernel time {total:.3f} ms of {wall_ms:.3f} ms "
          f"wall per step (traced), {sum(n for _, _, n in rows)} kernels per step, ISLA forward x{f_n} "
          f"{f_ms:.4f} ms ({100 * f_ms / total:.1f}%), ISLA backward x{b_n} {b_ms:.4f} ms "
          f"({100 * b_ms / total:.1f}%) on {card}")
    for key, ms, n in rows[:15]:
        phase("rate", f"  {ms:8.4f} ms  {100 * ms / total:5.1f}%  x{n:<4d} {key[:90]}")
    return f_ms, b_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
    try:
        card = gpu_line()
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        phase("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
              f"{kind} x{count}")
        t0 = time.perf_counter()
        build_phase()
        phase("build", f"{time.perf_counter() - t0:.1f}s")
        row = kernel_phase()
        bwd_row = kernel_bwd_phase()
        row["launches"], gens = slice_phase(args.seed, tmp_dir, torch.device("cuda"))
        (row["launches_train"], bwd_row["launches"]), paths = train_phase(args.seed, tmp_dir,
                                                                         torch.device("cuda"))
        bwd_row["launches_train"] = bwd_row["launches"]
        row["ms_in_forward_traced"] = rate_phase(args.seed, card, gens)
        del gens
        row["ms_in_step_traced"], bwd_row["ms_in_step_traced"] = train_rate_phase(args.seed, card,
                                                                                  paths)
    except SmokeFailure as e:
        phase("FAIL", str(e))
        return 1
    phase("done", f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [row, bwd_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
