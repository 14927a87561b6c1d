"""The ISLA norm: eval BatchNorm, bilinear stage-mask resize, the mask-weighted
per-object affine and an optional ReLU, in one kernel launch on the card.

Per pixel p and channel c, with m_o the source mask resized to x's size::

    y   = (x - mean_c) * rsqrt(var_c + eps)
    out = y * (sum_o m_o g_oc / (sum_o m_o + 1e-6) + 1) + sum_o m_o b_oc / (sum_o m_o + 1e-6)

and ``relu(out)`` when asked. Counterparts in the JAX package: the eval
``SyncBatchNorm`` and ``SpatialAdaptiveNorm`` of ``nn/norms.py``,
``ops/interp.py::resize_bilinear``, the ReLU after each norm in
``nn/blocks.py``, and the fused Pallas kernel ``ops/pallas/isla.py::isla_modulate``
(removed from that tree in commit d0260d0). On a CUDA tensor ``isla_norm``
launches the hand-written kernel ``csrc/isla_norm.cu``; on a CPU tensor it runs
``isla_norm_plain``. Forward only: the backward kernel arrives with the training
path, and until then the CUDA path refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from layout2img_tpu_torch.ops import _build
from layout2img_tpu_torch.ops.interp import resize_bilinear

EPS = 1e-6
MAX_OBJECTS = 64  # the kernel tracks live objects in one 64-bit word
MAX_THREADS = 128  # threads per block, kMaxThreads in the kernel
_DTYPES = (torch.float32, torch.bfloat16)


def isla_modulate_plain(xn: torch.Tensor, mask: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor) -> torch.Tensor:
    """The modulation alone: the denominator, then two contractions over o.

    xn (b, c, h, w); mask (b, o, h, w) at xn's size; gamma, beta (b, o, c).
    Computed in f32, returned in ``xn.dtype``.
    """
    f32 = torch.float32
    m = mask.to(f32)
    d = m.sum(dim=1, keepdim=True) + EPS  # (b, 1, h, w)
    gmap = torch.einsum("bohw,boc->bchw", m, gamma.to(f32)) / d + 1.0
    bmap = torch.einsum("bohw,boc->bchw", m, beta.to(f32)) / d
    return (xn.to(f32) * gmap + bmap).to(xn.dtype)


def isla_norm_plain(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float, mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    relu: bool = False) -> torch.Tensor:
    """Plain torch version, pass by pass: the eval BN apply (in f32, rounded to
    x's dtype), ``resize_bilinear`` of the source mask to x's size, the
    modulation, then the ReLU. The CPU path and the kernel's oracle."""
    f32 = torch.float32
    mean = running_mean.to(f32)[:, None, None]
    rstd = torch.rsqrt(running_var.to(f32)[:, None, None] + eps)
    y = ((x.to(f32) - mean) * rstd).to(x.dtype)
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


def _check(x, running_mean, running_var, mask_src, gamma, beta) -> None:
    if x.ndim != 4 or mask_src.ndim != 4 or gamma.ndim != 3 or beta.ndim != 3:
        raise ValueError("isla_norm wants x (b,c,h,w), mask_src (b,o,hs,ws), gamma/beta (b,o,c)")
    b, c = x.shape[:2]
    o = mask_src.shape[1]
    if mask_src.shape[0] != b:
        raise ValueError(f"mask_src {tuple(mask_src.shape)} does not match x {tuple(x.shape)}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (b, o, c):
            raise ValueError(f"{name} {tuple(t.shape)} is not (b, o, c) = {(b, o, c)}")
    for name, t in (("running_mean", running_mean), ("running_var", running_var)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} {tuple(t.shape)} is not (c,) = {(c,)}")
    tensors = (x, running_mean, running_var, mask_src, gamma, beta)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("isla_norm inputs lie on different devices")
    if len({t.dtype for t in (x, mask_src, gamma, beta)}) != 1 or x.dtype not in _DTYPES:
        raise TypeError(f"isla_norm wants x, mask_src, gamma and beta in one dtype of {_DTYPES}, "
                        f"got {[t.dtype for t in (x, mask_src, gamma, beta)]}")


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
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def isla_norm(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
              eps: float, mask_src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              relu: bool = False) -> torch.Tensor:
    """Fused ISLA norm. x (b, c, h, w); running_mean, running_var (c,) f32;
    mask_src (b, o, hs, ws), the stage mask at its own size; gamma, beta
    (b, o, c). x, mask_src, gamma and beta share one dtype (f32 or bf16).

    CUDA tensors launch the kernel (counted in ``isla_norm.launches``); it
    wants contiguous inputs, f32 statistics and at most 64 objects, and
    raises otherwise, or when autograd would need its backward. CPU tensors
    run ``isla_norm_plain``."""
    _check(x, running_mean, running_var, mask_src, gamma, beta)
    if x.device.type == "cpu":
        return isla_norm_plain(x, running_mean, running_var, eps, mask_src, gamma, beta, relu)
    if x.device.type != "cuda":
        raise ValueError(f"isla_norm has no kernel for device {x.device}")
    tensors = (x, running_mean, running_var, mask_src, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("isla_norm's CUDA kernel has no backward yet (it arrives with the "
                           "training path); run the forward under torch.no_grad() or "
                           "torch.inference_mode()")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("isla_norm's kernel wants contiguous inputs")
    if running_mean.dtype != torch.float32 or running_var.dtype != torch.float32:
        raise TypeError("isla_norm's kernel wants f32 running statistics")
    b, c, h, w = x.shape
    o, hs, ws = mask_src.shape[1:]
    if not 1 <= o <= MAX_OBJECTS:
        raise ValueError(f"isla_norm's kernel takes 1..{MAX_OBJECTS} objects, got {o}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x lies on {x.device}, not on the current device")
    out = torch.empty_like(x)
    cfg = launch_config(b, c, h, w, o, x.element_size(), _num_sms(x.device.index))
    vec = 16 // x.element_size()
    aligned = (h * w) % vec == 0 and c % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, gamma, beta, out))
    lib, fn = _kernel()
    err = fn(int(x.dtype == torch.bfloat16), int(aligned), x.data_ptr(), running_mean.data_ptr(),
             running_var.data_ptr(), mask_src.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             out.data_ptr(), b, c, h, w, o, hs, ws, float(eps), int(relu), cfg.tp, cfg.threads,
             cfg.cc, cfg.n_groups, cfg.chunks_per_group, cfg.smem_bytes,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "isla_norm launch")
    isla_norm.launches += 1
    return out


isla_norm.launches = 0
