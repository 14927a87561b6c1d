"""The port's mixed-precision train step on the CPU: what it computes in
bf16 (``test_torch_port_mixed_jax.py`` holds its numbers against the JAX
package's step).

``TrainConfig(mixed_precision=True)``: G, D and VGG run with bf16 casts of
their f32 masters (``torch.func.functional_call``), as JAX's
``{"params": cast_floating(params), **state}`` does. A dtype audit
(``TorchDispatchMode``) finds every convolution and every matrix-matrix
product of the step (with and without the VGG loss), forward and backward,
on bf16 operands, with one named
exemption: the f32 contraction of the ISLA norm's plain twin
(``ops/isla.py::isla_modulate_plain``), exactly 10 per G forward (20 under
remat "g": the forward and its recompute) and 2 per call in the backward;
the VGG loss in bf16 against f32 (the JAX package's bars,
``tests/test_train_step.py:459-476``) and under the audit.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from layout2img_tpu_torch.losses.perceptual import VGGLoss
from layout2img_tpu_torch.ops import isla as isla_ops
from layout2img_tpu_torch.train.state import TrainConfig
from layout2img_tpu_torch.utils.convert import init_vgg
from test_torch_port_step_knobs import _few_threads, make_setup, run_port  # noqa: F401

HEAVY = {"convolution": (0, 1), "convolution_backward": (0, 1, 2), "mm": (0, 1),
         "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}


class DtypeAudit(TorchDispatchMode):
    """Records every convolution and matrix-matrix product with an f32
    operand. One inside ``isla_modulate_plain`` (forward) or inside an
    autograd node that call made (backward) counts as the ISLA exemption."""

    def __init__(self):
        super().__init__()
        self.violations, self.isla_forward, self.isla_backward, self.total = [], 0, 0, 0
        self.in_isla, self.isla_nodes = False, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HEAVY:
            self.total += 1
            ops = [args[i] for i in HEAVY[name]]
            mat_vec = name == "mm" and (ops[0].shape[0] == 1 or ops[1].shape[-1] == 1)
            if not mat_vec and any(t.dtype == torch.float32 for t in ops):
                node = torch._C._current_autograd_node()
                seq = None if node is None else node._sequence_nr()
                if self.in_isla:
                    self.isla_forward += 1
                elif seq is not None and any(lo < seq < hi for lo, hi in self.isla_nodes):
                    self.isla_backward += 1
                else:
                    self.violations.append(f"{func} {[tuple(t.shape) for t in ops]} "
                                           f"{[t.dtype for t in ops]} in {node}")
        return func(*args, **(kwargs or {}))


def _sequence_nr() -> int:
    """The autograd sequence number of a node made now."""
    return (torch.zeros((), requires_grad=True) * 1).grad_fn._sequence_nr()


@pytest.fixture
def audit(monkeypatch):
    mode = DtypeAudit()
    plain = isla_ops.isla_modulate_plain

    def flagged(*args, **kwargs):
        lo = _sequence_nr()
        mode.in_isla = True
        try:
            return plain(*args, **kwargs)
        finally:
            mode.in_isla = False
            mode.isla_nodes.append((lo, _sequence_nr()))

    monkeypatch.setattr(isla_ops, "isla_modulate_plain", flagged)
    return mode


@pytest.fixture(scope="module")
def audit_setup():
    """Weights for the dispatch audit, which compares with no JAX step: the
    port's seeded draws (no JAX init to compile)."""
    return make_setup(from_port=True)


@pytest.mark.parametrize("remat,g_forwards", [("none", 1), ("g", 2)])
def test_mixed_step_runs_every_matmul_in_bf16(audit_setup, audit, remat, g_forwards):
    cfg = TrainConfig(use_vgg_loss=False, mixed_precision=True, remat=remat)
    with audit:
        run_port(audit_setup, cfg)
    assert audit.total > 300, f"the audit saw only {audit.total} heavy ops"
    assert not audit.violations, "f32 heavy ops under mixed precision:\n" + "\n".join(
        audit.violations[:10])
    assert audit.isla_forward == 10 * g_forwards
    assert audit.isla_backward == 2 * 10


def test_mixed_step_with_vgg_runs_every_matmul_in_bf16(audit_setup, audit, vgg):
    """The whole step, VGG loss included, as the JAX audit traces it."""
    with audit:
        port = run_port(audit_setup, TrainConfig(mixed_precision=True), vgg_loss=vgg)
    assert np.isfinite(port.metrics["feat_loss"]) and port.metrics["feat_loss"] > 0
    assert audit.total > 400 and not audit.violations, audit.violations[:10]
    assert (audit.isla_forward, audit.isla_backward) == (10, 20)


def test_f32_step_fails_the_audit(audit_setup, audit):
    """The audit sees f32 operands where they are."""
    with audit:
        run_port(audit_setup, TrainConfig(use_vgg_loss=False))
    assert len(audit.violations) > 100


@pytest.fixture(scope="module")
def vgg():
    return VGGLoss(init_vgg(0, device="cpu"))


def _images(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(2, 3, 64, 64)).clip(-1, 1).astype(np.float32))
            for _ in range(2)]


def test_vgg_loss_bf16_close_to_f32(vgg):
    fake, real = _images(0)
    f32, bf16 = vgg(fake, real), vgg(fake, real, dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.float32
    assert abs(f32.item() - bf16.item()) < 0.05 * abs(f32.item()) + 1e-3
    fake = fake.requires_grad_(True)
    (g,) = torch.autograd.grad(vgg(fake, real, dtype=torch.bfloat16), fake)
    assert g.dtype == torch.float32 and torch.isfinite(g).all() and g.abs().max() > 0
    assert all(p.dtype == torch.float32 for p in vgg.parameters())  # the casts are copies


def test_vgg_loss_bf16_runs_every_conv_in_bf16(vgg):
    fake, real = _images(1)
    fake = fake.requires_grad_(True)
    audit = DtypeAudit()
    with audit:
        torch.autograd.grad(vgg(fake, real, dtype=torch.bfloat16), fake)
    assert audit.total >= 3 * 12 and not audit.violations, audit.violations[:5]
