"""The port's ISLA norm (``layout2img_tpu_torch/ops/isla.py``) on the CPU.

The plain versions against the JAX package's ``SpatialAdaptiveNorm``
(``nn/norms.py``): the modulation alone, fed the norm's own captured BN output
and SN projections, and the whole fused norm (eval BN, bilinear resize of the
source-resolution mask, modulation, ReLU), both at 1e-5; the wrapper's checks
and its kernel tiling, which the CPU can reach. The CUDA kernel's own tests
need a card and no JAX: they are in ``test_torch_port_kernels.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.nn.norms import SpatialAdaptiveNorm as JaxSpatialAdaptiveNorm
from layout2img_tpu.ops.interp import resize_bilinear as jax_resize_bilinear
from layout2img_tpu_torch.nn.norms import SpatialAdaptiveNorm
from layout2img_tpu_torch.ops.interp import _resize_matrix_np
from layout2img_tpu_torch.ops import isla
from layout2img_tpu_torch.ops.isla import (_bwd_smem_bytes, backward_config, blocks_per_sm,
                                           finish_backward_plain, isla_modulate_plain, isla_norm,
                                           isla_norm_plain, launch_config,
                                           resize_bilinear_gather_backward, slot_bucket)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

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
    """The plain CPU path keeps its autograd graph (on the card the backward
    kernel takes its place)."""
    x, mean, var, eps, mask, gamma, beta = _torch_inputs(torch.Generator().manual_seed(1), 2, 8, 8,
                                                         16, torch.float32, "cpu")
    x.requires_grad_(True)
    gamma.requires_grad_(True)
    isla_norm(x, mean, var, eps, mask, gamma, beta, relu=True).square().sum().backward()
    for g in (x.grad, gamma.grad):
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("relu", [False, True])
def test_norm_training_mode_uses_batch_statistics(rng, relu):
    """In training the norm normalizes with the batch mean and biased
    variance and folds them into its running statistics, as the JAX norm
    with ``use_running_average=False`` does (1e-5)."""
    b, o, h, c = 2, 8, 8, 16
    x, vectors, mask = _inputs(rng, b, o, h, c, n_valid=6)
    x = x * 2 + 0.3
    jn = JaxSpatialAdaptiveNorm()
    variables = dict(jn.init(jax.random.PRNGKey(0), x, vectors, mask))
    out, state = jn.apply(variables, x, vectors, mask, use_running_average=False,
                          update_spectral=False, mutable=["batch_stats"])
    if relu:
        out = jax.nn.relu(out)
    norm = SpatialAdaptiveNorm(c, 24).train()
    with torch.no_grad():
        for name in ("weight_proj", "bias_proj"):
            proj = getattr(norm, name)
            proj.weight_orig.copy_(torch.from_numpy(np.array(variables["params"][name]["kernel"]).T))
            proj.bias.copy_(torch.from_numpy(np.array(variables["params"][name]["bias"])))
            proj.weight_u.copy_(torch.from_numpy(np.array(variables["spectral"][name]["u"])))
    norm.weight_proj.eval(), norm.bias_proj.eval()  # sigma from the stored u, as update_spectral=False
    got = norm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(vectors),
               torch.from_numpy(mask), relu=relu)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=0)
    bn = norm.batch_norm2d
    for mine, theirs in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(mine.numpy(), np.asarray(state["batch_stats"]["bn"][theirs]),
                                   atol=1e-5, rtol=0)


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


@pytest.mark.parametrize("b,c,h,w,o", [(8, c, h, h, 31) for h, c in _SERVING]
                         + [(32, c, h, h, 31) for h, c in _SERVING]
                         + [(128, c, h, h, o) for h, c in _SERVING for o in (8, 12)]
                         + [(2, 48, 9, 13, 3), (2, 48, 9, 13, 64), (1, 200, 33, 17, 8),
                            (128, 1024, 8, 8, 64), (1, 3, 1, 1, 64)])
def test_backward_config_covers_the_map(b, c, h, w, o):
    """The backward kernel's tiling: tiles cover the map, spans cover the
    tiles, channel groups cover the channels, a block fits the card, and
    there are enough threads for the mask tile and U. At the serving shapes
    (o=31) 32 warps fit on an SM from h=16 up, and h=4 gets two blocks per
    SM at b=8."""
    cfg = backward_config(b, c, h, w, o, num_sms=132)
    assert cfg.threads in (64, 128, 256) and cfg.tp in (16, 32, 64)
    assert cfg.tp * cfg.cc == 8 * cfg.threads, "each thread owns 4 pixels x 2 channels"
    slots = slot_bucket(o)
    assert o <= slots and slots % 4 == 0
    assert cfg.threads >= cfg.tp and cfg.ksplit * (slots * cfg.tp // 16) <= cfg.threads
    assert cfg.ksplit & (cfg.ksplit - 1) == 0 and 2 * cfg.ksplit * (slots * cfg.tp // 16) > cfg.threads
    assert (cfg.n_tiles - 1) * cfg.tp < h * w <= cfg.n_tiles * cfg.tp
    assert (cfg.n_spans - 1) * cfg.tiles_per_span < cfg.n_tiles <= cfg.n_spans * cfg.tiles_per_span
    covered = cfg.n_groups * cfg.chunks_per_group * cfg.cc
    assert covered >= c and (cfg.n_groups - 1) * cfg.chunks_per_group * cfg.cc < c
    assert cfg.smem_bytes <= SMEM_LIMIT
    assert cfg.smem_bytes == _bwd_smem_bytes(o, cfg.tp, cfg.cc, cfg.chunks_per_group * cfg.cc,
                                             cfg.threads)
    if o == 31 and h >= 16:
        assert blocks_per_sm(cfg.threads, cfg.smem_bytes) * cfg.threads // 32 >= 32
    if o == 31 and h == 4 and b == 8:
        assert b * cfg.n_spans * cfg.n_groups >= 256, "about two blocks per SM"


@pytest.mark.parametrize("o", [8, 12, 31, 64])
@pytest.mark.parametrize("h,c", _SERVING)
def test_buffers_fit_int32_at_the_bench_batch(h, c, o):
    """At the bench's b=128 (bf16 mixed steps, o=8 on COCO, 12 under VG's
    budgets, up to the 64 the kernels take) every buffer the three launches
    index with 32-bit ints (x, dx, the backward's three partial-sum buffers)
    has under 2^31 elements, the batch fits gridDim.y of both kernels, and
    the partial sums take at most about 1 GiB of device memory."""
    b = 128
    cfg = backward_config(b, c, h, h, o, num_sms=132)
    fwd = launch_config(b, c, h, h, o, 2, num_sms=132)
    elements = {"x": b * c * h * h, "part_stats": b * cfg.n_spans * 2 * c,
                "part_gb": b * cfg.n_spans * 2 * o * c, "part_dm": cfg.n_groups * b * o * h * h}
    assert max(elements.values()) < 2**31, elements
    assert b <= 65535 and fwd.n_tiles * fwd.n_groups < 2**31 and cfg.n_spans * cfg.n_groups < 2**31
    partial_bytes = 4 * (elements["part_stats"] + elements["part_gb"] + elements["part_dm"])
    assert partial_bytes <= 1.1 * 2**30, partial_bytes


@pytest.mark.parametrize("b,c,h,o_full,o_cut", [(2, 64, 16, 31, 15), (8, 1024, 4, 31, 9),
                                              (8, 64, 128, 31, 9), (2, 48, 9, 8, 3),
                                              (2, 48, 9, 64, 40)])
def test_backward_config_ignores_pad_slots(b, c, h, o_full, o_cut):
    """Cutting pad slots within a bucket leaves the backward's tiling, and with
    it the order of every sum, as it was: only the shared memory shrinks."""
    full, cut = (backward_config(b, c, h, h, o, num_sms=132) for o in (o_full, o_cut))
    assert slot_bucket(o_full) == slot_bucket(o_cut)
    assert full._replace(smem_bytes=0) == cut._replace(smem_bytes=0)
    assert cut.smem_bytes <= full.smem_bytes


def test_bwd_smem_bytes_mirrors_the_kernel():
    """``_bwd_smem_bytes`` against ``smem_words`` of ``csrc/isla_norm_bwd.cu``,
    whose expression is read from the source and evaluated here."""
    src = (Path(isla.__file__).resolve().parent.parent / "csrc" / "isla_norm_bwd.cu").read_text()
    expr = re.search(r"inline int smem_words\(int O, int O4, int tp, int cc, int cg, int threads\) "
                     r"\{\s*return ([^;]+);", src).group(1)
    for o, tp, cc, cg, threads in [(31, 64, 32, 64, 256), (3, 16, 32, 32, 64), (64, 32, 64, 128, 256),
                                   (8, 16, 64, 192, 128)]:
        words = eval(" ".join(expr.split()), {}, dict(O=o, O4=-(-o // 4) * 4, tp=tp, cc=cc, cg=cg, threads=threads))
        assert _bwd_smem_bytes(o, tp, cc, cg, threads) == 4 * words


# (h, hs): the ten ISLA norms of one Ours-D 128px forward (x at h, its source
# mask at hs), then odd sizes: 9x13 <- 5x7, 1x1 both ways, up- and
# down-sampling by non-integer ratios
_RESIZE_PAIRS = ([((h, h), (hs, hs)) for h, _, hs in
                  [(4, 1024, 64), (8, 1024, 64), (8, 1024, 8), (16, 512, 8), (16, 512, 16),
                   (32, 256, 16), (32, 256, 32), (64, 128, 32), (64, 128, 64), (128, 64, 64)]]
                 + [((9, 13), (5, 7)), ((1, 1), (1, 1)), ((1, 1), (6, 5)), ((7, 3), (1, 1)),
                    ((5, 7), (9, 13)), ((12, 20), (7, 3))])


def _resize_transpose(g: torch.Tensor, in_hw: tuple[int, int]) -> torch.Tensor:
    """The transpose of ``resize_bilinear`` as its two matrices,
    ``W_y^T @ g @ W_x`` on the input grid ``in_hw``."""
    wy, wx = (torch.from_numpy(_resize_matrix_np(n_out, n_in, False)).to(g.dtype)
              for n_out, n_in in zip(g.shape[-2:], in_hw))
    return wy.T @ g @ wx


@pytest.mark.parametrize("dst,src", _RESIZE_PAIRS)
def test_gather_backward_matches_resize_transpose(rng, dst, src):
    """The finishing kernel's transposed resize, written as its index gather,
    against the resize's matrix transpose and JAX's VJP of its resize. Bar:
    f32 round-off, 1e-6 of max|result| (sums of at most a few dozen taps;
    the taps' weights are computed in f32 here and in f64 in the matrices)."""
    g = rng.standard_normal((2, 3, *dst)).astype(np.float32)
    got = resize_bilinear_gather_backward(torch.from_numpy(g), src).numpy()
    mine = _resize_transpose(torch.from_numpy(g), src).numpy()
    _, vjp = jax.vjp(lambda m: jax_resize_bilinear(m, dst), jnp.zeros((2, 3, *src), jnp.float32))
    (theirs,) = vjp(jnp.asarray(g))
    assert got.shape == (2, 3, *src) and got.dtype == np.float32
    bar = 1e-6 * max(1.0, np.abs(theirs).max())
    np.testing.assert_allclose(got, np.asarray(theirs), atol=bar, rtol=0)
    np.testing.assert_allclose(got, mine, atol=bar, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,o,c,dst,src,spans,groups",
                         [(2, 3, 16, (9, 13), (5, 7), 3, 2), (2, 31, 8, (4, 4), (64, 64), 1, 4),
                          (1, 8, 4, (16, 16), (8, 8), 5, 1)])
def test_finish_plain_matches_the_wrapper_formulas(rng, dtype, b, o, c, dst, src, spans, groups):
    """The finishing step's plain version on random partial buffers against
    the formulas the wrapper applied around its single launch before the
    finishing kernel: rsqrt, sums over spans and groups, the matrix
    transpose of the resize. Bar: f32 round-off (1e-6 of max|result|),
    then one rounding to the output dtype."""
    part_stats = torch.from_numpy(rng.standard_normal((b, spans, 2, c)).astype(np.float32))
    part_gb = torch.from_numpy(rng.standard_normal((b, spans, 2, o, c)).astype(np.float32))
    part_dm = torch.from_numpy(rng.standard_normal((groups, b, o, *dst)).astype(np.float32))
    var = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    got = finish_backward_plain(part_stats, part_gb, part_dm, var, 1e-5, src, (dtype,) * 3)

    r = torch.rsqrt(var + 1e-5)
    sums = part_stats.sum(dim=(0, 1))
    gb = part_gb.sum(dim=1)
    dmask = _resize_transpose(part_dm.sum(dim=0), src)
    want = (-r * sums[0], -0.5 * r * r * sums[1], dmask, gb[:, 0], gb[:, 1])
    for name, a, w, dt in zip(("dmean", "dvar", "dmask", "dgamma", "dbeta"), got, want,
                              (torch.float32, torch.float32, dtype, dtype, dtype)):
        assert a.dtype == dt and a.shape == w.shape, name
        bar = 1e-6 * w.abs().max().item()
        # bf16: one rounding of the f32 result, at most half a bf16 ulp (2^-9 relative)
        np.testing.assert_allclose(a.float().numpy(), w.numpy(), atol=bar,
                                   rtol=0 if dt == torch.float32 else 2 ** -8, err_msg=name)
