"""The discriminator's 2x2 average-pool downsampling with the residual add
after it, in one kernel launch on the card, and its gradient in one more.

For a and b of (n, c, h, w) (h and w even) and r of (n, c, h/2, w/2)::

    out = avgpool2x2(a) [+ avgpool2x2(b)] [+ r]

b and r are optional. ``nn/blocks.py`` calls it at every downsampling site
of ``DiscResBlock`` (the block's output and its shortcut conv as a and b)
and ``DiscOptimizedBlock`` (its image shortcut alone, then its output with
the shortcut's 1x1 conv as r). Counterpart in the JAX package:
``nn/blocks.py::avg_pool2x`` and the adds after it, which XLA fuses.

On CUDA tensors ``pool2x2_add`` launches ``csrc/d_pool.cu``'s forward
kernel, and autograd its backward kernel, both as ``torch.library``
operators: the gradient of a and b is one tensor, the output gradient
upsampled 2x times 0.25, served to both; r's gradient is the output
gradient itself. In f32 the kernels give the plain version's numbers bit
for bit; in bf16 the forward rounds once where the plain version rounds
after each pool and each add, and the backward is exact. On CPU tensors it
runs ``pool2x2_add_plain``, which autograd differentiates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from layout2img_tpu_torch.ops import _build
from layout2img_tpu_torch.ops.isla import OPS_NAMESPACE

_DTYPES = (torch.float32, torch.bfloat16)
VECTOR = 8  # input columns a thread of the vector path takes, kVec in the kernel


def pool2x2_add_plain(a: torch.Tensor, b: torch.Tensor | None = None,
                      r: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version: ``F.avg_pool2d(a, 2) [+ F.avg_pool2d(b, 2)] [+ r]``,
    each pool and add rounded to the inputs' dtype. The CPU path and the
    kernels' oracle; under autograd also the plain version of the backward."""
    out = F.avg_pool2d(a, 2)
    if b is not None:
        out = out + F.avg_pool2d(b, 2)
    if r is not None:
        out = out + r
    return out


def _check(a: torch.Tensor, b: torch.Tensor | None, r: torch.Tensor | None) -> None:
    if a.ndim != 4:
        raise ValueError(f"pool2x2_add wants a (n, c, h, w), got {tuple(a.shape)}")
    n, c, h, w = a.shape
    if h % 2 or w % 2:
        raise ValueError(f"pool2x2_add wants an even height and width, got {tuple(a.shape)}")
    if b is not None and b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} does not match a {tuple(a.shape)}")
    if r is not None and tuple(r.shape) != (n, c, h // 2, w // 2):
        raise ValueError(f"r {tuple(r.shape)} is not the pooled size {(n, c, h // 2, w // 2)}")
    tensors = [t for t in (a, b, r) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("pool2x2_add inputs lie on different devices")
    if len({t.dtype for t in tensors}) != 1 or a.dtype not in _DTYPES:
        raise TypeError(f"pool2x2_add wants its inputs in one dtype of {_DTYPES}, "
                        f"got {[t.dtype for t in tensors]}")


def _check_cuda(tensors: list[torch.Tensor]) -> None:
    """What the kernels want beyond ``_check``."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pool2x2_add's kernels want contiguous inputs")
    if tensors[0].device.index != torch.cuda.current_device():
        raise ValueError(f"a lies on {tensors[0].device}, not on the current device")
    if tensors[0].numel() >= 2**31:
        raise ValueError(f"pool2x2_add's kernels index with 32-bit ints; a holds "
                         f"{tensors[0].numel()} elements")


def _vector(w: int, *tensors: torch.Tensor) -> int:
    """1 where the kernels may take 2 x 8 patches: w a multiple of 8 and
    every pointer 16-byte aligned."""
    return int(w % VECTOR == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


@functools.cache
def _kernel(name: str):
    lib = _build.library("d_pool")
    fn = getattr(lib, name)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = ([i, i, p, p, p, p, u, u, p] if name == "pool2x2_forward"
                   else [i, i, p, p, u, u, p])
    fn.restype = i
    return lib, fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_forward(a, b, r) -> torch.Tensor:
    n, c, h, w = a.shape
    out = a.new_empty(n, c, h // 2, w // 2)
    given = [t for t in (a, b, r) if t is not None]
    lib, fn = _kernel("pool2x2_forward")
    err = fn(int(a.dtype == torch.bfloat16), _vector(w, *given, out), a.data_ptr(),
             b.data_ptr() if b is not None else None, r.data_ptr() if r is not None else None,
             out.data_ptr(), n * c * (h // 2), w, _stream(a))
    _build.check(lib, err, "pool2x2_add launch")
    pool2x2_add.kernel_calls += 1
    return out


def _launch_backward(grad: torch.Tensor) -> torch.Tensor:
    n, c, ho, wo = grad.shape
    d = grad.new_empty(n, c, 2 * ho, 2 * wo)
    lib, fn = _kernel("pool2x2_backward")
    err = fn(int(grad.dtype == torch.bfloat16), _vector(2 * wo, grad, d), grad.data_ptr(),
             d.data_ptr(), n * c * ho, 2 * wo, _stream(grad))
    _build.check(lib, err, "pool2x2_add backward launch")
    pool2x2_add.backward_calls += 1
    return d


# As ``ops/isla.py``'s: operators of PyTorch's dispatcher with a CUDA
# implementation and a fake one (shapes) for tracing; CPU tensors never reach them.
@torch.library.custom_op(f"{OPS_NAMESPACE}::pool2x2_add", mutates_args=(), device_types="cuda")
def _pool2x2_add_op(a: torch.Tensor, b: Optional[torch.Tensor],
                    r: Optional[torch.Tensor]) -> torch.Tensor:
    return _launch_forward(a, b, r)


@_pool2x2_add_op.register_fake
def _(a, b, r):
    n, c, h, w = a.shape
    return a.new_empty(n, c, h // 2, w // 2)


@torch.library.custom_op(f"{OPS_NAMESPACE}::pool2x2_add_backward", mutates_args=(),
                         device_types="cuda")
def _pool2x2_add_backward_op(grad: torch.Tensor) -> torch.Tensor:
    return _launch_backward(grad)


@_pool2x2_add_backward_op.register_fake
def _(grad):
    n, c, ho, wo = grad.shape
    return grad.new_empty(n, c, 2 * ho, 2 * wo)


def _pool2x2_add_grads(ctx, grad):
    """(da, db, dr): one upsampled tensor for a and b, grad itself for r.
    Nothing of the forward is saved."""
    need_a, need_b, need_r = ctx.needs_input_grad
    up = _pool2x2_add_backward_op(grad.contiguous()) if need_a or need_b else None
    return (up if need_a else None, up if need_b else None, grad if need_r else None)


_pool2x2_add_op.register_autograd(_pool2x2_add_grads)


def pool2x2_add(a: torch.Tensor, b: torch.Tensor | None = None,
                r: torch.Tensor | None = None) -> torch.Tensor:
    """``avgpool2x2(a) [+ avgpool2x2(b)] [+ r]``: a and b (n, c, h, w) with h
    and w even, r (n, c, h/2, w/2), in one dtype (f32 or bf16) on one device.

    CUDA tensors go through the ``layout2img_tpu_torch::pool2x2_add``
    operator: one forward launch (counted in ``pool2x2_add.kernel_calls``)
    and, under autograd, one backward launch for a and b together
    (``pool2x2_add.backward_calls``); the kernels want contiguous inputs on
    the current device and raise otherwise. CPU tensors run
    ``pool2x2_add_plain`` (counted in ``pool2x2_add.plain_calls``)."""
    _check(a, b, r)
    if a.device.type == "cpu":
        pool2x2_add.plain_calls += 1
        return pool2x2_add_plain(a, b, r)
    if a.device.type != "cuda":
        raise ValueError(f"pool2x2_add has no kernel for device {a.device}")
    _check_cuda([t for t in (a, b, r) if t is not None])
    return _pool2x2_add_op(a, b, r)


pool2x2_add.kernel_calls = 0
pool2x2_add.backward_calls = 0
pool2x2_add.plain_calls = 0
