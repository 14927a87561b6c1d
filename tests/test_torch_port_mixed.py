"""The port's mixed-precision train step against the JAX package's, on the CPU.

``TrainConfig(mixed_precision=True)``: G, D and VGG run with bf16 casts of
their f32 masters (``torch.func.functional_call``), as JAX's
``{"params": cast_floating(params), **state}`` does. The JAX step under
mixed precision runs the ISLA einsums in bf16, while the port's ISLA (kernel
and plain twin) contracts in f32 and rounds once, so the port is not held to
JAX's bf16 step but to JAX's f32 step, with JAX's own bf16 gap as the
scale. At ch=4, b=2, 128 px, o=8, VGG off, from the weights, batch and
latents of ``test_torch_port_step_knobs.make_setup``:

- every loss: |port_bf16 - jax_f32| <= 2 |jax_bf16 - jax_f32| + 2^-8 |jax_f32| + 1e-4
  (one bf16 rounding of the value, and an absolute floor for the small app
  terms);
- every updated parameter: within 2*lr (+1e-6, the rounding of a value
  near 2) of JAX f32's, and the elements whose
  update differs from JAX f32's by over 1e-6 (a flipped Adam sign, 2*lr) at
  most 2x JAX bf16's count plus 1% of the tensor plus 8;
- every gradient tensor (error norms): 2x JAX bf16's gap plus 2^-8 of its
  norm for D and for G's res5 and final, 8x for G's layers before the PSP
  head (round-off there is amplified some thousand times at b=2,
  ``tests/test_torch_port_train.py``), the 2^-8 floor an absolute 1e-6 of
  the net's largest norm for a round-off zero of f32.
The factors were read from a sweep over six seeds (7-12) of this setup:
the worst loss ratio beyond its floor was 1.26, the worst flip-count ratio
1.42, the worst gradient ratio 1.53 for D and after the PSP head and 5.19
before it (``res4.conv_mask.0.stages.0.1.weight``, seed 7).

Also: the masters, their gradients and every buffer stay f32; a dtype audit
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
from test_torch_port_step_knobs import (AFTER_PSP, LR, _few_threads, make_setup, named,  # noqa: F401
                                        nets, run_jax, run_port)

ULP = 2.0 ** -8
LOSS_FACTOR, FLIP_FACTOR, GRAD_FACTOR, GRAD_FACTOR_BEFORE_PSP = 2.0, 2.0, 2.0, 8.0
HEAVY = {"convolution": (0, 1), "convolution_backward": (0, 1, 2), "mm": (0, 1),
         "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}


@pytest.fixture(scope="module")
def steps():
    """(port bf16 step, JAX f32 step, JAX bf16 step) from one setup."""
    setup = make_setup()
    mixed = TrainConfig(use_vgg_loss=False, mixed_precision=True)
    return (run_port(setup, mixed), run_jax(setup, TrainConfig(use_vgg_loss=False)),
            run_jax(setup, mixed))


def test_mixed_losses_within_twice_jax_bf16_gap(steps):
    port, f32, bf16 = steps
    assert set(port.metrics) == set(f32[4])
    for k, v in f32[4].items():
        v = float(v)
        gap, jax_gap = abs(port.metrics[k] - v), abs(float(bf16[4][k]) - v)
        assert gap <= LOSS_FACTOR * jax_gap + ULP * abs(v) + 1e-4, (k, gap, jax_gap)


def test_mixed_updates_within_twice_jax_bf16_flips(steps):
    port, f32, bf16 = steps
    for (net, module, convert, want, _), (_, _, _, jax_bf16, _) in zip(nets(port, f32),
                                                                       nets(port, bf16)):
        want, jax_bf16 = convert(want), convert(jax_bf16)
        for name, p in module.named_parameters():
            w = want[name].numpy()
            diff = np.abs(p.detach().numpy() - w)
            assert diff.max() <= 2 * LR + 1e-6, (net, name, diff.max())  # + the f32 ulp at 2
            flips, jax_flips = int((diff > 1e-6).sum()), int((np.abs(jax_bf16[name].numpy() - w)
                                                               > 1e-6).sum())
            assert flips <= FLIP_FACTOR * jax_flips + 0.01 * diff.size + 8, (name, flips, jax_flips)


def test_mixed_gradients_within_jax_bf16_gap(steps):
    port, f32, bf16 = steps
    for (net, module, convert, var, grads), (_, _, _, var_bf, grads_bf) in zip(nets(port, f32),
                                                                              nets(port, bf16)):
        want, jax_bf16 = named(convert, var, grads, module), named(convert, var_bf, grads_bf, module)
        largest = max(np.linalg.norm(w) for w in want.values())
        for name, p in module.named_parameters():
            w = want[name]
            norm = np.linalg.norm(w)
            gap, jax_gap = np.linalg.norm(p.grad.numpy() - w), np.linalg.norm(jax_bf16[name] - w)
            before_psp = net == "generator" and not name.startswith(AFTER_PSP)
            factor = GRAD_FACTOR_BEFORE_PSP if before_psp else GRAD_FACTOR
            floor = 1e-6 * largest if norm < 1e-5 * largest else ULP * norm
            assert gap <= factor * jax_gap + floor, (net, name, gap, jax_gap, norm)


def test_mixed_step_keeps_f32_masters_and_buffers(steps):
    port = steps[0]
    assert all(np.isfinite(v) for v in port.metrics.values())
    for net in (port.state.generator, port.state.discriminator):
        for name, p in net.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        for name, t in net.named_buffers():
            assert t.dtype in (torch.float32, torch.int64), name


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
    return make_setup()


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
