"""Tracing leaves the port's eager path as it found it, and the ISLA kernels
are operators that a trace keeps (on the CPU).

- The constant tables of ``ops/interp.py`` and ``ops/isla.py`` (resize
  matrices, nearest indices, the transposed taps) are kept per device for
  real tensors only: after a ``torch.export`` of the generator, built with
  its tables emptied first so that the export builds them under tracing, an
  eager call returns a real tensor equal bit for bit to the one before it.
  The same holds for ``resize_bilinear_gather_backward``.
- The operators ``layout2img_tpu_torch::isla_norm`` and
  ``::isla_norm_backward`` have fake implementations with the kernels'
  shapes and dtypes, on fake CUDA tensors (which this torch makes without a
  card). A trace of the generator on fake CUDA tensors is not possible here
  (a CPU build cannot move a fake tensor to CUDA, nor run autograd on one):
  that check, 10 operator nodes and no plain-twin einsum, lives in the
  ``cuda`` case of ``tests/test_torch_port_kernels.py`` and in
  ``chip_smoke.py``'s export phase. The autograd registration is checked on
  the meta device.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from layout2img_tpu_torch.ops import interp
from layout2img_tpu_torch.ops.isla import resize_bilinear_gather_backward
from layout2img_tpu_torch.utils.convert import init_generator
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

OPS = torch.ops.layout2img_tpu_torch


def _generator_args(b: int = 2, o: int = 8, num_classes: int = 184):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((b, o, 128)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 0.5, (b, o, 2)), rng.uniform(0.1, 0.5, (b, o, 2))],
                           -1).astype(np.float32)
    labels = rng.integers(1, num_classes, (b, o))
    z_im = rng.standard_normal((b, 128)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (z, boxes, labels, z_im))


def _only_real_tables() -> bool:
    return all(type(t) is torch.Tensor for t in interp._DEVICE_TABLES.values())


def test_eager_after_export_is_real_and_unchanged():
    gen = init_generator(0, 184, preset="ours_d_context128", device="cpu", ch=8).eval()
    args = _generator_args()
    with torch.no_grad():
        first = gen(*args)
        interp._DEVICE_TABLES.clear()
        torch.export.export(gen, args, strict=False)
        last = gen(*args)
    assert type(last) is torch.Tensor
    assert torch.equal(last, first)
    assert _only_real_tables()


def test_gather_backward_after_a_trace():
    dm = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 16, 12))).float()
    want = resize_bilinear_gather_backward(dm, (8, 5))

    class Gather(torch.nn.Module):
        def forward(self, x):
            return resize_bilinear_gather_backward(x, (8, 5))

    interp._DEVICE_TABLES.clear()
    ep = torch.export.export(Gather(), (dm,), strict=False)
    got = resize_bilinear_gather_backward(dm, (8, 5))
    assert type(got) is torch.Tensor and torch.equal(got, want)
    assert torch.equal(ep.module()(dm), want)
    assert _only_real_tables()


def test_tables_built_under_fake_mode_are_not_kept():
    interp._DEVICE_TABLES.clear()
    with FakeTensorMode():
        x = torch.empty(1, 2, 8, 8)
        y = interp.resize_nearest(interp.resize_bilinear(x, (16, 16)), (4, 4))
    assert isinstance(y, FakeTensor)
    assert not interp._DEVICE_TABLES
    x = torch.ones(1, 2, 8, 8)
    assert torch.equal(interp.resize_bilinear(x, (16, 16)), torch.ones(1, 2, 16, 16))
    assert len(interp._DEVICE_TABLES) == 1 and _only_real_tables()


def _fake_inputs(dtype, device, b=2, o=3, c=16, hw=(8, 8), src=(4, 4)):
    return (torch.empty(b, c, *hw, device=device, dtype=dtype),
            torch.empty(c, device=device), torch.empty(c, device=device), 1e-5,
            torch.empty(b, o, *src, device=device, dtype=dtype),
            torch.empty(b, o, c, device=device, dtype=dtype),
            torch.empty(b, o, c, device=device, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operator_fake_implementations_on_fake_cuda_tensors(dtype):
    with FakeTensorMode():
        x, mean, var, eps, mask, gamma, beta = _fake_inputs(dtype, "cuda")
        out = OPS.isla_norm(x, mean, var, eps, mask, gamma, beta, True)
        grads = OPS.isla_norm_backward(x, mean, var, eps, mask, gamma, beta, x, False)
        graph = make_fx(lambda *t: OPS.isla_norm(*t[:3], eps, *t[3:], False))(
            x, mean, var, mask, gamma, beta).graph
    assert (out.shape, out.dtype, out.device.type) == (x.shape, dtype, "cuda")
    want = [(x.shape, dtype), ((16,), torch.float32), ((16,), torch.float32),
            (mask.shape, dtype), (gamma.shape, dtype), (beta.shape, dtype)]
    assert [(tuple(t.shape), t.dtype) for t in grads] == [(tuple(s), d) for s, d in want]
    assert all(t.device.type == "cuda" for t in grads)
    targets = [n.target for n in graph.nodes if n.op == "call_function"]
    assert targets == [OPS.isla_norm.default]


def test_operator_autograd_registration_on_meta_tensors():
    """The forward operator's gradient goes through the backward operator:
    x, var, mask and gamma get gradients of their shapes; mean and beta,
    which need none, get none."""
    x, mean, var, eps, mask, gamma, beta = _fake_inputs(torch.float32, "meta")
    for t in (x, var, mask, gamma):
        t.requires_grad_(True)
    out = OPS.isla_norm(x, mean, var, eps, mask, gamma, beta, True)
    assert "isla_norm" in out.grad_fn.name()
    grads = torch.autograd.grad(out.sum(), [x, var, mask, gamma])
    assert [g.shape for g in grads] == [x.shape, var.shape, mask.shape, gamma.shape]
    assert mean.grad is None and beta.grad is None
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(OPS.isla_norm(x, mean, var, eps, mask, gamma, beta, True).sum(), [mean])


def test_operators_have_no_cpu_implementation():
    """CPU tensors never reach the operators: ``isla_norm`` takes the plain
    version there, and the operators themselves have none."""
    with pytest.raises(NotImplementedError):
        OPS.isla_norm(torch.zeros(2, 16, 8, 8), torch.zeros(16), torch.ones(16), 1e-5,
                      torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 16), torch.zeros(2, 3, 16), False)
