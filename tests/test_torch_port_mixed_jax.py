"""The port's mixed-precision train step against the JAX package's, on the CPU
(``test_torch_port_mixed.py`` audits what it computes in bf16).

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

Also: the masters, their gradients and every buffer stay f32.
"""

import numpy as np
import pytest
import torch

from layout2img_tpu_torch.train.state import TrainConfig
from test_torch_port_step_knobs import (AFTER_PSP, LR, _few_threads, make_setup, named,  # noqa: F401
                                        nets, run_jax, run_port)

ULP = 2.0 ** -8
LOSS_FACTOR, FLIP_FACTOR, GRAD_FACTOR, GRAD_FACTOR_BEFORE_PSP = 2.0, 2.0, 2.0, 8.0


@pytest.fixture(scope="module")
def steps():
    """(port bf16 step, JAX f32 step, JAX bf16 step) from one setup."""
    setup = make_setup()
    mixed = TrainConfig(use_vgg_loss=False, mixed_precision=True)
    return (run_port(setup, mixed), run_jax(setup, TrainConfig(use_vgg_loss=False), fast=True),
            run_jax(setup, mixed, fast=True))


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
