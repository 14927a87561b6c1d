"""The port's ISLA norm (``layout2img_tpu_torch/ops/isla.py``) on the CPU.

The plain versions against the JAX package's ``SpatialAdaptiveNorm``
(``nn/norms.py``): the modulation alone, fed the norm's own captured BN output
and SN projections, and the whole fused norm (eval BN, bilinear resize of the
source-resolution mask, modulation, ReLU), both at 1e-5; the wrapper's checks
and its kernel tiling, which the CPU can reach. The CUDA kernel's own tests
need a card and no JAX: they are in ``test_torch_port_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.nn.norms import SpatialAdaptiveNorm as JaxSpatialAdaptiveNorm
from layout2img_tpu_torch.nn.norms import SpatialAdaptiveNorm
from layout2img_tpu_torch.ops.isla import (isla_modulate_plain, isla_norm, isla_norm_plain,
                                           launch_config)

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def _inputs(rng, b, o, h, c, n_valid):
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    vectors = rng.standard_normal((b, o, 24)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, o, h, h)).astype(np.float32)
    mask[:, n_valid:] = 0.0  # pad objects splat to all-zero masks
    mask[:, :, : h // 4] = 0.0  # rows no object covers: the 1e-6 denominator
    return x, vectors, mask


def _jax_norm(rng, x, vectors, mask):
    """Apply the JAX norm with perturbed running statistics; returns its
    output and variables and the captured BN output and projections."""
    norm = JaxSpatialAdaptiveNorm()
    variables = dict(norm.init(jax.random.PRNGKey(0), x, vectors, mask))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda s: s + jnp.asarray(rng.uniform(0.1, 0.5, s.shape), s.dtype), variables["batch_stats"])
    out, state = norm.apply(variables, x, vectors, mask, use_running_average=True,
                            update_spectral=False, capture_intermediates=True)
    return out, variables, state["intermediates"]


@pytest.mark.parametrize("o,h,c", [(8, 8, 16), (31, 8, 16), (31, 16, 32), (8, 4, 64)])
def test_plain_matches_jax_norm(rng, o, h, c):
    b = 2
    x, vectors, mask = _inputs(rng, b, o, h, c, n_valid=min(o, 6))
    out, _, inter = _jax_norm(rng, x, vectors, mask)
    xn = np.asarray(inter["bn"]["__call__"][0]).transpose(0, 3, 1, 2)
    gamma = np.asarray(inter["weight_proj"]["__call__"][0])
    beta = np.asarray(inter["bias_proj"]["__call__"][0])

    got = isla_modulate_plain(*(torch.from_numpy(np.array(a))
                                for a in (xn, mask, gamma, beta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(out).transpose(0, 3, 1, 2), atol=1e-5, rtol=0)


def _box_masks(rng, b, o, hs, ws, n_valid):
    """Source masks as the generator makes them: each valid object non-zero
    only inside its box, pad objects all zero."""
    mask = np.zeros((b, o, hs, ws), np.float32)
    for i in range(b):
        for j in range(n_valid):
            y0, x0 = rng.integers(0, hs // 2 + 1), rng.integers(0, ws // 2 + 1)
            y1, x1 = rng.integers(y0 + 1, hs + 1), rng.integers(x0 + 1, ws + 1)
            mask[i, j, y0:y1, x0:x1] = rng.uniform(0.05, 1.0, (y1 - y0, x1 - x0))
    return mask


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("o", [8, 31])
@pytest.mark.parametrize("src,dst", [((64, 64), (4, 4)), ((8, 8), (8, 8)), ((8, 8), (16, 16)),
                                     ((5, 7), (9, 13))])
def test_norm_plain_matches_jax_norm(rng, src, dst, o, relu):
    """The fused plain version, fed the source-resolution mask, against the
    JAX norm (which resizes it itself), and its ReLU against jax.nn.relu."""
    b, c = 2, 16
    x = rng.standard_normal((b, *dst, c)).astype(np.float32) * 2 + 0.3
    vectors = rng.standard_normal((b, o, 24)).astype(np.float32)
    mask = _box_masks(rng, b, o, *src, n_valid=min(o, 6))
    out, variables, inter = _jax_norm(rng, x, vectors, mask)
    if relu:
        out = jax.nn.relu(out)
    stats = variables["batch_stats"]["bn"]
    gamma = np.array(inter["weight_proj"]["__call__"][0])
    beta = np.array(inter["bias_proj"]["__call__"][0])

    t = torch.from_numpy
    got = isla_norm_plain(t(x.transpose(0, 3, 1, 2).copy()), t(np.array(stats["mean"])),
                          t(np.array(stats["var"])), 1e-5, t(mask), t(gamma), t(beta), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(out).transpose(0, 3, 1, 2), atol=1e-5, rtol=0)
    if relu:
        assert got.min().item() == 0.0


def _torch_inputs(gen, b, o, h, c, dtype, device, hs=8):
    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)

    mask = torch.rand(b, o, hs, hs, generator=gen)
    mask[:, o // 2:] = 0.0
    stats = torch.randn(c, generator=gen), torch.rand(c, generator=gen) + 0.5
    return (rand(b, c, h, h), *(s.to(device) for s in stats), 1e-5,
            mask.to(device=device, dtype=dtype), rand(b, o, c), rand(b, o, c))


def test_wrapper_on_cpu_runs_the_plain_version():
    args = _torch_inputs(torch.Generator().manual_seed(0), 2, 8, 16, 16, torch.float32, "cpu")
    before = isla_norm.launches
    for relu in (False, True):
        torch.testing.assert_close(isla_norm(*args, relu=relu), isla_norm_plain(*args, relu=relu),
                                   rtol=0, atol=0)
    assert isla_norm.launches == before, "the CPU path launches no kernel"


@pytest.mark.parametrize("bad", ["mask_shape", "gamma_shape", "dtype", "rank", "stats_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    x, mean, var, eps, mask, gamma, beta = _torch_inputs(torch.Generator().manual_seed(0), 2, 8, 8,
                                                         16, torch.float32, "cpu")
    if bad == "mask_shape":
        mask = mask[:1]
    elif bad == "gamma_shape":
        gamma = gamma[:, :, :8]
    elif bad == "dtype":
        beta = beta.to(torch.bfloat16)
    elif bad == "rank":
        x = x[0]
    else:
        var = var[:8]
    with pytest.raises((ValueError, TypeError)):
        isla_norm(x, mean, var, eps, mask, gamma, beta)


def test_cpu_path_is_differentiable():
    """The plain CPU path keeps its autograd graph (the CUDA wrapper refuses
    inputs that need a gradient until the backward kernel lands)."""
    x, mean, var, eps, mask, gamma, beta = _torch_inputs(torch.Generator().manual_seed(1), 2, 8, 8,
                                                         16, torch.float32, "cpu")
    x.requires_grad_(True)
    gamma.requires_grad_(True)
    isla_norm(x, mean, var, eps, mask, gamma, beta, relu=True).square().sum().backward()
    for g in (x.grad, gamma.grad):
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0


def test_norm_refuses_training_mode():
    norm = SpatialAdaptiveNorm(16, 24).train()
    with pytest.raises(NotImplementedError, match="training path"):
        norm(torch.zeros(1, 16, 4, 4), torch.zeros(1, 3, 24), torch.zeros(1, 3, 8, 8))


# (b, c, h, w, o): the ten norms of one Ours-D 128px forward at b=8 and b=128,
# the odd shapes of the card tests, and the most objects the kernel takes
_SERVING = [(4, 1024), (8, 1024), (16, 512), (32, 256), (64, 128), (128, 64)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("b,c,h,w,o", [(8, c, h, h, 31) for h, c in _SERVING]
                         + [(128, c, h, h, 31) for h, c in _SERVING]
                         + [(2, 48, 9, 13, 8), (1, 200, 33, 17, 3), (1, 3, 1, 1, 64),
                            (8, 1024, 4, 4, 64)])
def test_launch_config_covers_the_map(b, c, h, w, o, itemsize):
    cfg = launch_config(b, c, h, w, o, itemsize, num_sms=132)
    assert cfg.tp & (cfg.tp - 1) == 0 and 16 <= cfg.tp <= 128
    assert cfg.threads * 16 == cfg.cc * cfg.tp, "each thread owns 4 pixels x 4 channels"
    assert cfg.threads % 32 == 0 and cfg.tp <= cfg.threads <= 128, "one pixel per mask thread"
    assert cfg.cc * itemsize % 16 == 0, "gamma and beta rows are 16-byte pieces"
    assert (cfg.n_tiles - 1) * cfg.tp < h * w <= cfg.n_tiles * cfg.tp
    covered = cfg.n_groups * cfg.chunks_per_group * cfg.cc
    assert covered >= c and (cfg.n_groups - 1) * cfg.chunks_per_group * cfg.cc < c
    assert cfg.smem_bytes <= SMEM_LIMIT
    n_chunks = -(-c // cfg.cc)
    blocks = b * cfg.n_tiles * cfg.n_groups
    assert blocks >= min(2 * 132, b * cfg.n_tiles * n_chunks) // 2, "the grid fills the card"
