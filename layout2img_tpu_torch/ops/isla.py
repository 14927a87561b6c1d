"""The ISLA norm: BatchNorm with given statistics, bilinear stage-mask resize,
the mask-weighted per-object affine and an optional ReLU, in one kernel launch
on the card, and its gradient in two more.

Per pixel p and channel c, with m_o the source mask resized to x's size::

    y   = (x - mean_c) * rsqrt(var_c + eps)
    out = y * (sum_o m_o g_oc / (sum_o m_o + 1e-6) + 1) + sum_o m_o b_oc / (sum_o m_o + 1e-6)

and ``relu(out)`` when asked. mean and var are the running statistics in
eval and the batch statistics in training (computed by the caller, which
lets autograd carry their gradients back into x). Counterparts in the JAX
package: ``SyncBatchNorm`` and ``SpatialAdaptiveNorm`` of ``nn/norms.py``,
``ops/interp.py::resize_bilinear``, the ReLU after each norm in
``nn/blocks.py``, and the fused Pallas kernel ``ops/pallas/isla.py::isla_modulate``
with its ``custom_vjp`` backward (removed from that tree in commit d0260d0).

On CUDA tensors ``isla_norm`` launches ``csrc/isla_norm.cu`` and, when autograd
needs a gradient, ``csrc/isla_norm_bwd.cu``, both as ``torch.library``
operators that a trace keeps. On CPU tensors it runs ``isla_norm_plain``,
which autograd differentiates: that is the plain version of both kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from layout2img_tpu_torch.ops import _build
from layout2img_tpu_torch.ops.interp import device_table, resize_bilinear

EPS = 1e-6
MAX_OBJECTS = 64  # the kernel tracks live objects in one 64-bit word
MAX_THREADS = 128  # threads per block, kMaxThreads in the kernel
BWD_THREADS = 256  # most threads per block of the backward, kThreads in its kernel
SMEM_PER_SM = 228 * 1024  # shared memory of one Hopper SM
BWD_SMEM_BUDGET = SMEM_PER_SM // 4 - 1024  # shared memory bytes a backward block may take
_DTYPES = (torch.float32, torch.bfloat16)


def isla_modulate_plain(xn: torch.Tensor, mask: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor) -> torch.Tensor:
    """The modulation alone: the denominator, then one contraction over o of
    gamma and beta side by side.

    xn (b, c, h, w); mask (b, o, h, w) at xn's size; gamma, beta (b, o, c).
    Computed in f32, returned in ``xn.dtype``.
    """
    f32 = torch.float32
    c = xn.shape[1]
    m = mask.to(f32)
    d = m.sum(dim=1, keepdim=True) + EPS  # (b, 1, h, w)
    maps = torch.einsum("bohw,boc->bchw", m, torch.cat([gamma, beta], dim=-1).to(f32)) / d
    return (xn.to(f32) * (maps[:, :c] + 1.0) + maps[:, c:]).to(xn.dtype)


def isla_norm_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                    mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    relu: bool = False) -> torch.Tensor:
    """Plain torch version, pass by pass: the BN apply (in f32, rounded to x's
    dtype), ``resize_bilinear`` of the source mask to x's size, the
    modulation, then the ReLU. The CPU path and the kernels' oracle: under
    autograd it is also the plain version of the backward."""
    f32 = torch.float32
    rstd = torch.rsqrt(var.to(f32)[:, None, None] + eps)
    y = ((x.to(f32) - mean.to(f32)[:, None, None]) * rstd).to(x.dtype)
    mask = resize_bilinear(mask_src, tuple(x.shape[-2:]))
    out = isla_modulate_plain(y, mask, gamma, beta)
    return torch.relu(out) if relu else out


class LaunchConfig(NamedTuple):
    tp: int  # pixels per tile (power of two, 16..64)
    threads: int  # threads per block; each owns 4 pixels x 4 channels of a chunk
    cc: int  # channels per chunk
    n_tiles: int
    n_groups: int  # blocks that split one pixel tile's channels
    chunks_per_group: int
    smem_bytes: int


def launch_config(b: int, c: int, h: int, w: int, o: int, itemsize: int,
                  num_sms: int = 132) -> LaunchConfig:
    """The kernel's tiling for x (b, c, h, w) and o objects: one block per
    (pixel tile, channel group, batch), with channel groups added until the
    grid has about two blocks per SM. Shared memory: the (o, tp) f32 mask
    tile, 1/d and its per-thread partial sums, the live list, one word per
    warp, and two stages of x, gamma and beta. Small blocks (64 pixels,
    128 threads) keep several resident per SM, so one block's mask work
    overlaps another's stream."""
    p = h * w
    tp = min(64, max(16, 1 << (p - 1).bit_length()))
    threads = min(MAX_THREADS, 4 * tp)
    cc = 16 * threads // tp
    n_tiles = -(-p // tp)
    n_chunks = -(-c // cc)
    groups = min(n_chunks, max(1, -(-2 * num_sms // (b * n_tiles))))
    per_group = -(-n_chunks // groups)
    groups = -(-n_chunks // per_group)
    smem = (4 * (o * tp + tp + MAX_THREADS + MAX_OBJECTS) + 8 * (MAX_THREADS // 32)
            + itemsize * (2 * cc * tp + 4 * o * cc))
    return LaunchConfig(tp, threads, cc, n_tiles, groups, per_group, smem)


class BackwardConfig(NamedTuple):
    threads: int  # threads per block: 256, or 128 or 64 where the map is tiny
    tp: int  # pixels per tile (16, 32 or 64)
    cc: int  # channels per chunk, 8 * threads // tp: each thread owns 4 pixels x 2 channels
    n_tiles: int
    tiles_per_span: int  # pixel tiles one block walks
    n_spans: int
    n_groups: int  # blocks that split one span's channels
    chunks_per_group: int
    ksplit: int  # threads that split the channels of one 4 x 4 block of U
    smem_bytes: int


def _bwd_smem_bytes(o: int, tp: int, cc: int, cg: int, threads: int) -> int:
    """Shared memory of one backward block (``smem_words`` in the kernel): the
    two padded gradient stages, gamma and beta of the chunk transposed, the
    folded mask tile, 1/d, the mask-weighted sum of U, the per-thread mask
    sums, the warps' live words, the live list, and the span's per-channel
    and per-object sums."""
    o4 = -(-o // 4) * 4
    return 4 * (2 * cc * (tp + 4) + 2 * cc * (o4 + 4) + o * tp + 2 * tp + threads + 16 + 64
                + 2 * cg + 2 * o * cg)


def blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Blocks of the backward kernel one Hopper SM holds at once: 32 blocks,
    2048 threads, and 228 KB of shared memory of which each block also takes 1 KB
    (registers are capped by the kernel's launch bounds to fit four blocks
    of 256 threads)."""
    return min(32, 2048 // threads, SMEM_PER_SM // (smem_bytes + 1024))


def slot_bucket(o: int) -> int:
    """The slot count the backward's tiling is chosen for: o rounded up to 8
    (COCO's layouts), 32 (Visual Genome's 31) or 64 (the most the kernels
    take)."""
    return next(s for s in (8, 32, MAX_OBJECTS) if o <= s)


def backward_config(b: int, c: int, h: int, w: int, o: int, num_sms: int = 132) -> BackwardConfig:
    """The backward kernel's tiling. Blocks of 256 threads, halved (to 64 at
    least) while the grid would not give every SM a block or a one-chunk
    block would not fit the budget (four blocks per SM); channel groups until
    the grid has about two blocks per SM and a group's shared sums fit the
    budget; then spans of pixel tiles: the fewest tiles per block that let
    the whole grid be resident at once, four blocks per SM (no second wave;
    fewer spans, smaller partial sums in device memory). U's
    channels are split over as many threads as the blocks of U leave room
    for (ksplit). Every choice is made for ``slot_bucket(o)`` slots, not for
    o: the tiling fixes the order of every sum, so pad slots within a bucket
    change no bit of the other gradients (``smem_bytes`` is o's own)."""
    p = h * w
    tp = min(64, max(16, 1 << (p - 1).bit_length()))
    slots = slot_bucket(o)
    n_tiles = -(-p // tp)
    fewest = max(64, tp, slots * tp // 16)  # a thread per mask pixel and per 4 x 4 block of U
    threads = BWD_THREADS
    while threads // 2 >= fewest:
        cc = 8 * threads // tp
        if (b * n_tiles * -(-c // cc) >= num_sms
                and _bwd_smem_bytes(slots, tp, cc, cc, threads) <= BWD_SMEM_BUDGET):
            break
        threads //= 2
    cc = 8 * threads // tp
    n_chunks = -(-c // cc)
    groups = min(n_chunks, max(1, -(-2 * num_sms // (b * n_tiles))))
    per_group = -(-n_chunks // groups)
    while per_group > 1 and _bwd_smem_bytes(slots, tp, cc, per_group * cc,
                                            threads) > BWD_SMEM_BUDGET:
        per_group -= 1
    groups = -(-n_chunks // per_group)
    smem = _bwd_smem_bytes(o, tp, cc, per_group * cc, threads)
    tiles_per_span = -(-b * n_tiles * groups // (4 * num_sms))
    n_spans = -(-n_tiles // tiles_per_span)
    ksplit = 1
    while 2 * ksplit * (slots // 4) * (tp // 4) <= threads:
        ksplit *= 2
    return BackwardConfig(threads, tp, cc, n_tiles, tiles_per_span, n_spans, groups, per_group,
                          ksplit, smem)


def _check(x, mean, var, mask_src, gamma, beta) -> None:
    if x.ndim != 4 or mask_src.ndim != 4 or gamma.ndim != 3 or beta.ndim != 3:
        raise ValueError("isla_norm wants x (b,c,h,w), mask_src (b,o,hs,ws), gamma/beta (b,o,c)")
    b, c = x.shape[:2]
    o = mask_src.shape[1]
    if mask_src.shape[0] != b:
        raise ValueError(f"mask_src {tuple(mask_src.shape)} does not match x {tuple(x.shape)}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (b, o, c):
            raise ValueError(f"{name} {tuple(t.shape)} is not (b, o, c) = {(b, o, c)}")
    for name, t in (("mean", mean), ("var", var)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} {tuple(t.shape)} is not (c,) = {(c,)}")
    tensors = (x, mean, var, mask_src, gamma, beta)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("isla_norm inputs lie on different devices")
    if len({t.dtype for t in (x, mask_src, gamma, beta)}) != 1 or x.dtype not in _DTYPES:
        raise TypeError(f"isla_norm wants x, mask_src, gamma and beta in one dtype of {_DTYPES}, "
                        f"got {[t.dtype for t in (x, mask_src, gamma, beta)]}")


def _check_cuda(tensors, mean, var, o: int) -> None:
    """What the kernels want beyond ``_check``."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("isla_norm's kernels want contiguous inputs")
    if mean.dtype != torch.float32 or var.dtype != torch.float32:
        raise TypeError("isla_norm's kernels want f32 statistics")
    if not 1 <= o <= MAX_OBJECTS:
        raise ValueError(f"isla_norm's kernels take 1..{MAX_OBJECTS} objects, got {o}")
    if tensors[0].device.index != torch.cuda.current_device():
        raise ValueError(f"x lies on {tensors[0].device}, not on the current device")
    _check_int32(**{f"input {i}": t.numel() for i, t in enumerate(tensors)},
                 batch_grid=tensors[0].shape[0] * 2**15)


def _check_int32(**elements: int) -> None:
    """Raise where a buffer the kernels index with 32-bit ints would hold
    2^31 elements or more (``batch_grid``: the batch, which is gridDim.y, at
    most 65535, scaled to that limit)."""
    over = {k: n for k, n in elements.items() if n >= 2**31}
    if over:
        raise ValueError(f"isla_norm's kernels index with 32-bit ints; these buffers are too "
                         f"large for them (elements): {over}")


@functools.cache
def _kernel():
    lib = _build.library("isla_norm")
    fn = lib.isla_norm_forward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                   i, i, i, i, i, i, p]
    fn.restype = i
    return lib, fn


@functools.cache
def _backward_kernel():
    lib = _build.library("isla_norm_bwd")
    fn = lib.isla_norm_backward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                   i, i, i, i, i, i, p]
    fn.restype = i
    return lib, fn


@functools.cache
def _finish_kernel():
    lib = _build.library("isla_norm_bwd")
    fn = lib.isla_norm_backward_finish
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = i
    return lib, fn


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_forward(x, mean, var, eps, mask_src, gamma, beta, relu) -> torch.Tensor:
    b, c, h, w = x.shape
    o, hs, ws = mask_src.shape[1:]
    out = torch.empty_like(x)
    cfg = launch_config(b, c, h, w, o, x.element_size(), _num_sms(x.device.index))
    vec = 16 // x.element_size()
    aligned = (h * w) % vec == 0 and c % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, gamma, beta, out))
    lib, fn = _kernel()
    err = fn(int(x.dtype == torch.bfloat16), int(aligned), x.data_ptr(), mean.data_ptr(),
             var.data_ptr(), mask_src.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             out.data_ptr(), b, c, h, w, o, hs, ws, float(eps), int(relu), cfg.tp, cfg.threads,
             cfg.cc, cfg.n_groups, cfg.chunks_per_group, cfg.smem_bytes,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "isla_norm launch")
    isla_norm.launches += 1
    return out


# The kernels as operators of PyTorch's dispatcher (``torch.library``), so that a
# trace keeps them: ``torch.export`` records one ``isla_norm`` node per call on
# CUDA tensors, and a loaded program launches the kernel through the same
# implementation (counted as an eager call is). Each has a CUDA implementation
# only and a fake one (shapes and dtypes) for tracing. CPU tensors never reach
# them: ``isla_norm`` and ``isla_norm_backward`` take the plain versions there,
# so a trace on the CPU decomposes into plain ops.
OPS_NAMESPACE = "layout2img_tpu_torch"


@torch.library.custom_op(f"{OPS_NAMESPACE}::isla_norm", mutates_args=(), device_types="cuda")
def _isla_norm_op(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                  mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  relu: bool) -> torch.Tensor:
    return _launch_forward(x, mean, var, eps, mask_src, gamma, beta, relu)


@_isla_norm_op.register_fake
def _(x, mean, var, eps, mask_src, gamma, beta, relu):
    return torch.empty_like(x)


@torch.library.custom_op(f"{OPS_NAMESPACE}::isla_norm_backward", mutates_args=(),
                         device_types="cuda")
def _isla_norm_backward_op(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                           mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           grad: torch.Tensor, relu: bool
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    b, c, h, w = x.shape
    o = mask_src.shape[1]
    cfg = backward_config(b, c, h, w, o, _num_sms(x.device.index))
    _check_int32(part_stats=b * cfg.n_spans * 2 * c, part_gb=b * cfg.n_spans * 2 * o * c,
                 part_dm=cfg.n_groups * b * o * h * w)
    dx, *parts = _launch_backward(x, mean, var, eps, mask_src, gamma, beta, grad, relu, cfg)
    return (dx, *_launch_finish(*parts, var, eps, mask_src, gamma))


@_isla_norm_backward_op.register_fake
def _(x, mean, var, eps, mask_src, gamma, beta, grad, relu):
    stat = x.new_empty(x.shape[1], dtype=torch.float32)
    return (torch.empty_like(x), stat, torch.empty_like(stat), torch.empty_like(mask_src),
            torch.empty_like(gamma), torch.empty_like(beta))


def _save_inputs(ctx, inputs, output) -> None:
    """Nothing of the forward is saved but its inputs."""
    x, mean, var, eps, mask_src, gamma, beta, relu = inputs
    ctx.save_for_backward(x, mean, var, mask_src, gamma, beta)
    ctx.eps, ctx.relu = eps, relu


def _isla_norm_grads(ctx, grad):
    """The gradients of x, mean, var, mask_src, gamma and beta by the
    backward's two kernels (mean and var are inputs: autograd carries their
    gradients back into x where they are batch statistics); None for eps,
    relu and every input that needs none."""
    x, mean, var, mask_src, gamma, beta = ctx.saved_tensors
    dx, dmean, dvar, dmask, dgamma, dbeta = _isla_norm_backward_op(
        x, mean, var, ctx.eps, mask_src, gamma, beta, grad.contiguous(), ctx.relu)
    grads = (dx, dmean, dvar, None, dmask, dgamma, dbeta, None)
    return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


_isla_norm_op.register_autograd(_isla_norm_grads, setup_context=_save_inputs)


def isla_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
              mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              relu: bool = False) -> torch.Tensor:
    """Fused ISLA norm. x (b, c, h, w); mean, var (c,) f32, the running or the
    batch statistics; mask_src (b, o, hs, ws), the stage mask at its own size;
    gamma, beta (b, o, c). x, mask_src, gamma and beta share one dtype (f32 or
    bf16).

    CUDA tensors go through the ``layout2img_tpu_torch::isla_norm`` operator:
    the forward kernel (counted in ``isla_norm.launches``) and, under
    autograd, the backward's two kernels (``isla_norm_backward``); the
    kernels want contiguous inputs, f32 statistics and at most 64 objects,
    and raise otherwise. CPU tensors run ``isla_norm_plain``."""
    _check(x, mean, var, mask_src, gamma, beta)
    if x.device.type == "cpu":
        return isla_norm_plain(x, mean, var, eps, mask_src, gamma, beta, relu)
    if x.device.type != "cuda":
        raise ValueError(f"isla_norm has no kernel for device {x.device}")
    _check_cuda((x, mean, var, mask_src, gamma, beta), mean, var, mask_src.shape[1])
    return _isla_norm_op(x, mean, var, float(eps), mask_src, gamma, beta, bool(relu))


isla_norm.launches = 0


def _plain_backward(x, mean, var, eps, mask_src, gamma, beta, grad, relu=False):
    """The backward's plain version: autograd of ``isla_norm_plain`` with
    mean and var as inputs of their own, so the x gradient is the direct part."""
    leaves = [t.detach().requires_grad_(True) for t in (x, mean, var, mask_src, gamma, beta)]
    with torch.enable_grad():
        out = isla_norm_plain(leaves[0], leaves[1], leaves[2], eps, *leaves[3:], relu=relu)
        return torch.autograd.grad(out, leaves, grad)


@functools.cache
def _transposed_taps_np(out_size: int, in_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The transposed 2-tap resize as a gather: for each source index s, the
    destination indices whose taps reach it, in ascending order, and the
    weight each reads s with, padded to one width with index 0 and weight 0.
    Taps and weights in f32 as ``csrc/isla_common.cuh::src_taps`` computes
    them (half-pixel centres, clamped at both ends)."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.maximum((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale
                     - np.float32(0.5), np.float32(0.0))
    i0 = np.minimum(src.astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0.astype(np.float32)
    reach = [np.flatnonzero((i0 <= s) & (s <= i1)) for s in range(in_size)]
    width = max(1, max(len(d) for d in reach))
    idx = np.zeros((in_size, width), np.int64)
    wgt = np.zeros((in_size, width), np.float32)
    for s, dst in enumerate(reach):
        idx[s, :len(dst)] = dst
        wgt[s, :len(dst)] = (np.where(i0[dst] == s, np.float32(1.0) - w1[dst], np.float32(0.0))
                             + np.where(i1[dst] == s, w1[dst], np.float32(0.0)))
    return idx, wgt


def _transposed_taps(out_size: int, in_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``_transposed_taps_np`` on ``device``, kept there as real tensors only
    (``ops/interp.py::device_table``)."""
    idx, wgt = _transposed_taps_np(out_size, in_size)
    key = ("transposed_taps", out_size, in_size)
    return (device_table(key + ("idx",), idx, torch.long, device),
            device_table(key + ("wgt",), wgt, torch.float32, device))


def resize_bilinear_gather_backward(dm: torch.Tensor, src_hw: tuple[int, int]) -> torch.Tensor:
    """The transpose of the 2-tap bilinear resize (``ops/interp.py::
    resize_bilinear``, align_corners=False) of dm (..., h, w) onto the source
    grid ``src_hw``, as the finishing kernel computes it: rows first (each
    source row sums the destination rows that reach it, in ascending
    order), then columns. f32."""
    h, w = dm.shape[-2:]
    out = dm.float()
    for dim, (n_out, n_in) in ((-2, (h, src_hw[0])), (-1, (w, src_hw[1]))):
        idx, wgt = _transposed_taps(n_out, n_in, dm.device)
        shape = [1] * out.ndim
        shape[dim] = n_in
        acc = torch.zeros((*out.shape[:dim % out.ndim], n_in, *out.shape[dim % out.ndim + 1:]),
                          dtype=torch.float32, device=dm.device)
        for k in range(idx.shape[1]):
            acc = acc + wgt[:, k].view(shape) * out.index_select(dim, idx[:, k])
        out = acc
    return out


def finish_backward_plain(part_stats: torch.Tensor, part_gb: torch.Tensor, part_dm: torch.Tensor,
                          var: torch.Tensor, eps: float, src_hw: tuple[int, int],
                          dtypes: tuple[torch.dtype, torch.dtype, torch.dtype]):
    """Plain version of the finishing kernel: the backward kernel's partial
    buffers (part_stats (b, spans, 2, c), part_gb (b, spans, 2, o, c),
    part_dm (groups, b, o, h, w), f32) into (dmean, dvar, dmask_src, dgamma,
    dbeta). dmean = -r sum a and dvar = -r^2 sum a y / 2 with
    r = 1 / sqrt(var + eps), f32; dmask_src, dgamma and dbeta in ``dtypes``.
    The sums over spans, batches and groups are torch's (another order than
    the kernel's: equal to round-off); the transposed resize is the
    kernel's gather (``resize_bilinear_gather_backward``)."""
    r = 1.0 / torch.sqrt(var + eps)
    sums = part_stats.sum(dim=(0, 1))
    gb = part_gb.sum(dim=1)
    dmask = resize_bilinear_gather_backward(part_dm.sum(dim=0), src_hw)
    return (-r * sums[0], -0.5 * r * r * sums[1], dmask.to(dtypes[0]), gb[:, 0].to(dtypes[1]),
            gb[:, 1].to(dtypes[2]))


def _launch_backward(x, mean, var, eps, mask_src, gamma, beta, grad, relu, cfg: BackwardConfig):
    """One launch of the backward kernel; returns dx_direct and the three
    partial-sum buffers."""
    b, c, h, w = x.shape
    o, hs, ws = mask_src.shape[1:]
    f32 = dict(device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    part_stats = torch.empty(b, cfg.n_spans, 2, c, **f32)
    part_gb = torch.empty(b, cfg.n_spans, 2, o, c, **f32)
    part_dm = torch.empty(cfg.n_groups, b, o, h, w, **f32)
    aligned = (h * w) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, grad, dx))
    lib, fn = _backward_kernel()
    err = fn(int(x.dtype == torch.bfloat16), int(aligned), x.data_ptr(), mean.data_ptr(),
             var.data_ptr(), mask_src.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             grad.data_ptr(), dx.data_ptr(), part_stats.data_ptr(), part_gb.data_ptr(),
             part_dm.data_ptr(), b, c, h, w, o, hs, ws, float(eps), int(relu), cfg.threads, cfg.tp,
             cfg.tiles_per_span, cfg.n_groups, cfg.chunks_per_group, cfg.ksplit,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "isla_norm backward launch")
    isla_norm_backward.launches += 1
    return dx, part_stats, part_gb, part_dm


def _launch_finish(part_stats, part_gb, part_dm, var, eps, mask_src, gamma):
    """One launch of the finishing kernel; returns (dmean, dvar, dmask_src,
    dgamma, dbeta)."""
    groups, b, o, h, w = part_dm.shape
    hs, ws = mask_src.shape[-2:]
    c = gamma.shape[-1]
    dmean = torch.empty(c, device=var.device, dtype=torch.float32)
    dvar = torch.empty_like(dmean)
    dmask, dgamma, dbeta = torch.empty_like(mask_src), torch.empty_like(gamma), torch.empty_like(gamma)
    lib, fn = _finish_kernel()
    err = fn(int(gamma.dtype == torch.bfloat16), part_stats.data_ptr(), part_gb.data_ptr(),
             part_dm.data_ptr(), var.data_ptr(), dmean.data_ptr(), dvar.data_ptr(),
             dmask.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), b, c, h, w, o, hs, ws,
             float(eps), part_stats.shape[1], groups, torch.cuda.current_stream(var.device).cuda_stream)
    _build.check(lib, err, "isla_norm backward finishing launch")
    isla_norm_backward.finish_launches += 1
    return dmean, dvar, dmask, dgamma, dbeta


def isla_norm_backward(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                       mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       grad: torch.Tensor, relu: bool = False):
    """Gradients of ``isla_norm`` given its output gradient ``grad`` (x's shape
    and dtype): (dx_direct, dmean, dvar, dmask_src, dgamma, dbeta). dx_direct
    is the part through y alone; autograd adds the parts through the
    statistics. dmean and dvar are f32, the rest in their input's dtype.

    CUDA tensors go through the ``layout2img_tpu_torch::isla_norm_backward``
    operator: two launches of ``csrc/isla_norm_bwd.cu`` and nothing else on
    the card: the main kernel (dx_direct and three partial-sum
    buffers; counted in ``isla_norm_backward.launches``) and the finishing
    kernel (the fixed-order sums of those buffers and the transposed resize;
    counted in ``isla_norm_backward.finish_launches``). CPU tensors run
    autograd of ``isla_norm_plain``."""
    _check(x, mean, var, mask_src, gamma, beta)
    if grad.shape != x.shape or grad.dtype != x.dtype or grad.device != x.device:
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return _plain_backward(x, mean, var, eps, mask_src, gamma, beta, grad, relu)
    if x.device.type != "cuda":
        raise ValueError(f"isla_norm_backward has no kernel for device {x.device}")
    _check_cuda((x, mean, var, mask_src, gamma, beta, grad), mean, var, mask_src.shape[1])
    return _isla_norm_backward_op(x, mean, var, float(eps), mask_src, gamma, beta, grad,
                                  bool(relu))


isla_norm_backward.launches = 0
isla_norm_backward.finish_launches = 0
