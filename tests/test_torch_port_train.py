"""The port's train step and its training-mode layers against the JAX
package's, on the CPU.

- ``SyncBatchNorm`` with batch statistics: output and running statistics at 1e-5.
- ``SpatialAdaptiveNorm`` + ReLU in training: output, and the gradients of
  x (through the batch statistics), the style vectors and the mask against
  ``jax.grad``, each at 1e-5 of its largest element; the backward kernel's
  formulas, written out here, against the plain backward (autograd).
- The PSP head's live Dropout2d: whole channels, about 10% dropped, the
  rest scaled by 1/0.9 (torch cannot draw JAX's masks, so the step parity
  below runs with dropout off, as JAX's ``deterministic=True``).
- One full train step of ``ours_d_context128`` + ``d128_app`` (ch=4, 10
  classes, b=2, o=6 with pad slots, 128 px, VGG off) against a JAX step
  built here from the JAX modules, ``losses/gan.py`` and ``optax.adam``,
  line for line as ``layout2img_tpu/train/step.py:129-209`` with z and z_im
  injected. Bars: losses 2e-3 (PARITY.md); params after the step within
  2*lr of JAX's, under 1% of elements beyond 1e-6 (Adam at beta1=0 moves
  each element by about lr, so a gradient element near round-off may flip
  sign); each gradient tensor's error norm within 1e-3 of its norm for D
  and for G's layers after the PSP head (res5, final), and within 1e-2 for
  G's layers before it. Why 1e-2 there, pinned by
  ``test_step_gradient_gap_is_the_f32_spread``: at b=2 the BN of the PSP
  pyramid's 1x1 stage sees two pooled values per channel, some of them
  nearly equal, and turns a round-off change of its input into a change
  some thousand times larger in its output; an ulp of noise on G's weights
  then moves the gradients before the PSP head as far as JAX's differ from
  the port's. The conv feeding that BN is held to 5e-2 at b=2: a BN over
  two values outputs +-y with y near 1 in most channels, so its input
  gradient, r/2 (g1 - g2)(1 - y^2), is mostly what f32 leaves of 1 - y^2
  (the same test shows its ulp spread is as large as its gap). Any other
  gradient whose norm is under 1e-5 of the net's largest is round-off of
  an exact zero (a bias before a batch-statistics BN; the app head's class
  embedding, whose real and fake terms cancel) and is held to an absolute
  1e-6 of that largest norm.
  BN running statistics and SN u at 1e-5, except the PSP bottleneck BN's
  statistics (downstream of that stage, 1e-4) and the u of the app head's
  class embedding (its weight moved by Adam on round-off, 1e-4).
- The train CLI on the CPU, and the sampling CLI loading its ``G.pth``.

Run as a script, the file repeats the step comparison at other batch sizes
and prints, per size, the worst gradient gaps, the port's own spread under
an ulp of weight noise, and where the gap enters (the gradient D hands G):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_train.py 2 4 8
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.losses.gan import g_adv, hinge_d_fake, hinge_d_real
from layout2img_tpu.models.discriminators import make_discriminator as jax_make_discriminator
from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.nn.norms import SpatialAdaptiveNorm as JaxSpatialAdaptiveNorm
from layout2img_tpu.nn.norms import SyncBatchNorm as JaxSyncBatchNorm
from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import synthetic_batch
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.nn.blocks import PSPModule
from layout2img_tpu_torch.nn.norms import SpatialAdaptiveNorm, SyncBatchNorm
from layout2img_tpu_torch.ops.interp import _resize_matrix_np, resize_bilinear
from layout2img_tpu_torch.ops.isla import isla_norm_backward
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                                generator_state_dict_from_jax)

CH, NC, B, O = 4, 10, 2, 6
LR = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _rel_close(got, want, rtol, what=""):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


@pytest.mark.parametrize("affine", [True, False])
def test_sync_batch_norm_train(rng, affine):
    x = rng.standard_normal((3, 5, 7, 6)).astype(np.float32) * 2 + 0.5
    jbn = JaxSyncBatchNorm(affine=affine)
    variables = jax.tree_util.tree_map(np.asarray, dict(jbn.init(jax.random.PRNGKey(0), x)))
    variables["batch_stats"] = {k: v + 0.3 for k, v in variables["batch_stats"].items()}
    if affine:
        variables["params"] = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                               "bias": rng.standard_normal(6).astype(np.float32)}
    want, new = jbn.apply(variables, x, use_running_average=False, mutable=["batch_stats"])
    bn = SyncBatchNorm(6, affine=affine).train()
    with torch.no_grad():
        bn.running_mean.copy_(_t(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(_t(variables["batch_stats"]["var"]))
        if affine:
            bn.weight.copy_(_t(variables["params"]["scale"]))
            bn.bias.copy_(_t(variables["params"]["bias"]))
    got = bn(_t(_nchw(x)))
    np.testing.assert_allclose(got.detach().numpy(), _nchw(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), new["batch_stats"]["mean"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), new["batch_stats"]["var"], atol=1e-5, rtol=0)
    assert bn.num_batches_tracked.item() == 1


def _box_masks(rng, b, o, hs, n_valid):
    mask = np.zeros((b, o, hs, hs), np.float32)
    for i in range(b):
        for j in range(n_valid):
            y0, x0 = rng.integers(0, hs // 2, 2)
            y1, x1 = rng.integers(hs // 2 + 1, hs + 1, 2)
            mask[i, j, y0:y1, x0:x1] = rng.uniform(0.05, 1.0, (y1 - y0, x1 - x0))
    return mask


@pytest.mark.parametrize("h,hs", [(8, 8), (16, 8), (9, 5)])
def test_spatial_adaptive_norm_train_and_grads(rng, h, hs):
    b, o, c, num_w = 2, 5, 8, 12
    x = rng.standard_normal((b, h, h, c)).astype(np.float32) * 1.5 + 0.2
    vectors = rng.standard_normal((b, o, num_w)).astype(np.float32)
    mask = _box_masks(rng, b, o, hs, n_valid=3)
    cot = rng.standard_normal((b, h, h, c)).astype(np.float32)
    jn = JaxSpatialAdaptiveNorm()
    variables = jax.tree_util.tree_map(np.asarray, dict(jn.init(jax.random.PRNGKey(3), x, vectors, mask)))

    def loss(x, vectors, mask):
        out, _ = jn.apply(variables, x, vectors, mask, use_running_average=False,
                          update_spectral=True, mutable=["batch_stats", "spectral"])
        out = jax.nn.relu(out)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        x, vectors, mask)

    norm = SpatialAdaptiveNorm(c, num_w).train()
    with torch.no_grad():
        for name in ("weight_proj", "bias_proj"):
            proj = getattr(norm, name)
            proj.weight_orig.copy_(_t(variables["params"][name]["kernel"].T))
            proj.bias.copy_(_t(variables["params"][name]["bias"]))
            proj.weight_u.copy_(_t(variables["spectral"][name]["u"]))
    leaves = [_t(_nchw(x)).requires_grad_(True), _t(vectors).requires_grad_(True),
              _t(mask).requires_grad_(True)]
    out = norm(*leaves, relu=True)
    _rel_close(out, _nchw(want), 1e-5, "out")
    got = torch.autograd.grad((out * _t(_nchw(cot))).sum(), leaves)
    for name, g, w in zip(("x", "vectors", "mask"), got, grads):
        _rel_close(g, _nchw(w) if name == "x" else w, 1e-5, name)


def _resize_transpose(g: torch.Tensor, in_hw: tuple[int, int]) -> torch.Tensor:
    """The transpose of ``resize_bilinear`` as its two matrices,
    ``W_y^T @ g @ W_x`` on the input grid ``in_hw``."""
    wy, wx = (torch.from_numpy(_resize_matrix_np(n_out, n_in, False)).to(g.dtype)
              for n_out, n_in in zip(g.shape[-2:], in_hw))
    return wy.T @ g @ wx


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b,o,c,hw,src", [(2, 5, 6, (9, 13), (5, 7)), (2, 3, 8, (8, 8), (8, 8)),
                                          (1, 4, 4, (4, 4), (16, 16))])
def test_isla_backward_plain_matches_autograd(b, o, c, hw, src, relu):
    """The formulas the backward kernel computes (the direct dx, dmean, dvar,
    dmask through the transposed resize, dgamma, dbeta), written out here in
    f64 from the same f32 inputs, against the backward's plain version:
    ``isla_norm_backward`` on CPU tensors, autograd of ``isla_norm_plain``."""
    g = torch.Generator().manual_seed(b * o + c)
    x = torch.randn(b, c, *hw, generator=g)
    mean, var = 0.3 * torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.5
    mask = torch.rand(b, o, *src, generator=g)
    mask[:, o // 2 + 1:] = 0.0
    mask[:, :, : src[0] // 3] = 0.0
    gamma, beta = torch.randn(b, o, c, generator=g), torch.randn(b, o, c, generator=g)
    cot = torch.randn(b, c, *hw, generator=g)
    got = isla_norm_backward(x, mean, var, 1e-5, mask, gamma, beta, cot, relu)

    x, mean, var, mask, gamma, beta, cot = (t.double() for t in (x, mean, var, mask, gamma, beta, cot))
    r = torch.rsqrt(var + 1e-5)
    y = (x - mean[:, None, None]) * r[:, None, None]
    m = resize_bilinear(mask, hw)
    inv = 1.0 / (m.sum(dim=1, keepdim=True) + 1e-6)  # 1/d
    gd = torch.einsum("bohw,boc->bchw", m, gamma) * inv  # G/d
    bd = torch.einsum("bohw,boc->bchw", m, beta) * inv  # B/d
    gate = cot * (y * (gd + 1.0) + bd > 0) if relu else cot  # g'
    a = gate * (gd + 1.0)
    wm = m * inv  # m_o/d
    u = torch.einsum("bchw,boc->bohw", gate * y, gamma) + torch.einsum("bchw,boc->bohw", gate, beta)
    want = (a * r[:, None, None], -r * a.sum(dim=(0, 2, 3)), -0.5 * r * r * (a * y).sum(dim=(0, 2, 3)),
            _resize_transpose((u - (wm * u).sum(dim=1, keepdim=True)) * inv, src),
            torch.einsum("bohw,bchw->boc", wm, gate * y), torch.einsum("bohw,bchw->boc", wm, gate))
    for name, a, w in zip(("x", "mean", "var", "mask", "gamma", "beta"), got, want):
        # the plain version computes in f32
        assert (a.double() - w).abs().max() <= 1e-6 * w.abs().max(), name


def test_psp_dropout_drops_whole_channels():
    psp = PSPModule(4, 64).train()
    torch.manual_seed(0)
    x = torch.randn(16, 4, 6, 6)
    with torch.no_grad():
        ref = psp(x, deterministic=True)
        for mod in psp.modules():
            if isinstance(mod, SyncBatchNorm):
                mod.eval()  # same statistics for both calls
        ref = psp(x, deterministic=True)
        out = psp(x, deterministic=False)
    dropped = (out == 0).all(dim=(2, 3)) & (ref != 0).any(dim=(2, 3))
    live = (out != 0).any(dim=(2, 3))
    share = dropped.float().sum() / (dropped | live).float().sum()
    assert 0.06 < share.item() < 0.14, share.item()  # p = 0.1 over 1024 channels
    torch.testing.assert_close(out[live.nonzero(as_tuple=True)], ref[live.nonzero(as_tuple=True)] / 0.9)


# ---- one full train step against a JAX step built from the JAX modules ----

def _jax_step(gen, disc, g_vars, d_vars, batch, z, z_im, cfg):
    """``layout2img_tpu/train/step.py:129-209`` for f32, no budgets, no
    VGG, dropout off, with z and z_im given; returns the new variables,
    both gradients, the metrics, the gradient of the G loss at the fake
    images (the cotangent D hands G) and the fake images."""
    images, boxes, labels = batch["images"], batch["boxes"], batch["labels"]
    g_params, g_state = g_vars["params"], {k: v for k, v in g_vars.items() if k != "params"}
    d_params, d_state = d_vars["params"], {k: v for k, v in d_vars.items() if k != "params"}
    tx = optax.adam(LR, b1=cfg.beta1, b2=cfg.beta2)
    valid = (labels != 0).astype(jnp.float32)

    def d_apply(p, st, imgs):
        return disc.apply({"params": p, **st}, imgs, boxes, labels, mutable=["spectral"])

    def g_forward(p):
        return gen.apply({"params": p, **g_state}, z, boxes, labels, z_im, train=True,
                         update_stats=True, deterministic=True, mutable=["batch_stats", "spectral"])

    fake, g_vjp, g_new_state = jax.vjp(g_forward, g_params, has_aux=True)
    fake_sg = jax.lax.stop_gradient(fake)

    def d_loss_fn(p):
        out_r, ds = d_apply(p, d_state, images)
        out_f, ds = d_apply(p, ds, fake_sg)
        m = {"d_loss_real": hinge_d_real(out_r["image"]), "d_loss_fake": hinge_d_fake(out_f["image"]),
             "d_loss_robj": hinge_d_real(out_r["object"], valid),
             "d_loss_fobj": hinge_d_fake(out_f["object"], valid),
             "d_loss_rapp": hinge_d_real(out_r["app"], valid),
             "d_loss_fapp": hinge_d_fake(out_f["app"], valid)}
        loss = (cfg.lamb_obj * (m["d_loss_robj"] + m["d_loss_fobj"])
                + cfg.lamb_img * (m["d_loss_real"] + m["d_loss_fake"])
                + cfg.lamb_app * (m["d_loss_rapp"] + m["d_loss_fapp"]))
        return loss, (ds, m)

    (d_loss, (d_state, d_m)), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(d_params)
    d_updates, _ = tx.update(d_grads, tx.init(d_params), d_params)
    d_params = optax.apply_updates(d_params, d_updates)

    def g_loss_fn(f):
        out_g, ds = d_apply(d_params, d_state, f)
        m = {"g_loss_fake": g_adv(out_g["image"]), "g_loss_obj": g_adv(out_g["object"], valid),
             "g_loss_app": g_adv(out_g["app"], valid),
             "pixel_loss": jnp.mean(jnp.abs(f - images).astype(jnp.float32))}
        loss = (cfg.lamb_obj * m["g_loss_obj"] + cfg.lamb_img * m["g_loss_fake"]
                + cfg.lamb_app * m["g_loss_app"] + m["pixel_loss"])
        return loss, (ds, m)

    (g_loss, (d_state, g_m)), fake_grad = jax.value_and_grad(g_loss_fn, has_aux=True)(fake)
    (g_grads,) = g_vjp(fake_grad)
    g_updates, _ = tx.update(g_grads, tx.init(g_params), g_params)
    g_params = optax.apply_updates(g_params, g_updates)
    metrics = {"d_loss": d_loss, "g_loss": g_loss, **d_m, **g_m}
    return ({"params": g_params, **g_new_state}, {"params": d_params, **d_state},
            g_grads, d_grads, metrics, fake_grad, fake)


def _setup(b: int, seed: int = 7) -> SimpleNamespace:
    """Inputs (b layouts, two pad slots each, z and z_im) and JAX weights
    (alphas drawn in [-2, 2], so the stage masks mix) from one numpy seed."""
    rng = np.random.default_rng(seed)
    batch = synthetic_batch(rng, b, 128, O, NC)
    batch["labels"][:, 4:] = 0  # at least two pad slots in each layout
    batch["boxes"][:, 4:] = (-0.6, -0.6, 0.5, 0.5)
    z = rng.standard_normal((b, O, 128)).astype(np.float32)
    z_im = rng.standard_normal((b, 128)).astype(np.float32)
    jbatch = {**batch, "images": batch["images"].transpose(0, 2, 3, 1)}
    jgen = jax_make_generator("ours_d_context128", NC, ch=CH, num_mask_classes=NC)
    jdisc = jax_make_discriminator("d128_app", NC, ch=CH)
    g_vars = jax.jit(jgen.init)(jax.random.PRNGKey(0), z, batch["boxes"], batch["labels"], z_im)
    d_vars = jax.jit(jdisc.init)(jax.random.PRNGKey(1), jbatch["images"], batch["boxes"],
                                 batch["labels"])
    g_vars = jax.tree_util.tree_map(np.asarray, dict(g_vars))
    d_vars = jax.tree_util.tree_map(np.asarray, dict(d_vars))
    for k in [k for k in g_vars["params"] if k.startswith("alpha")]:
        g_vars["params"][k] = rng.uniform(-2, 2, g_vars["params"][k].shape).astype(np.float32)
    cfg = TrainConfig(use_vgg_loss=False)
    step = jax.jit(lambda gv, dv, bt, z, zi: _jax_step(jgen, jdisc, gv, dv, bt, z, zi, cfg))
    jax_out = jax.tree_util.tree_map(np.asarray, step(g_vars, d_vars, jbatch, z, z_im))
    tbatch = {k: _t(v) for k, v in batch.items()}
    tbatch["labels"] = tbatch["labels"].long()
    return SimpleNamespace(cfg=cfg, jax=jax_out, batch=tbatch, z=_t(z), z_im=_t(z_im),
                           g_sd=generator_state_dict_from_jax(g_vars),
                           d_sd=discriminator_state_dict_from_jax(d_vars))


# the PSP head's 1x1 pyramid stage: (adaptive pool, conv, BN, ReLU)
_PSP_STAGE = "res4.conv_mask.0.stages.0"


def _port_step(setup: SimpleNamespace, noise: float = 0.0, fake=None) -> SimpleNamespace:
    """The port's step from the setup's weights, G's weights first scaled by
    (1 + noise * N(0, 1)) when ``noise``, and D shown ``fake`` in place of
    G's images when given (G's gradient still flows); returns the state, the
    metrics, G's images, the gradient of the G loss at the images D saw and
    the PSP stage's conv and BN outputs."""
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, num_mask_classes=NC)
    gen.load_state_dict(setup.g_sd, strict=True)
    disc = make_discriminator("d128_app", NC, device="cpu", ch=CH)
    disc.load_state_dict(setup.d_sd, strict=True)
    if noise:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in gen.parameters():
                p.mul_(1 + noise * torch.randn(p.shape, generator=g))
    seen = {}

    def keep_cot(module, args, out):
        seen["fake"] = out.detach()
        if fake is not None:
            out = fake + (out - out.detach())
        out.register_hook(lambda grad: seen.__setitem__("cot", grad))
        return out

    gen.register_forward_hook(keep_cot)
    stage = gen.get_submodule(_PSP_STAGE)
    for i, key in ((1, "psp_conv"), (2, "psp_bn")):
        stage[i].register_forward_hook(lambda m, args, out, key=key: seen.__setitem__(key, out.detach()))
    state = create_train_state(gen, disc, setup.cfg)
    metrics = make_train_step(state, setup.cfg, deterministic=True).with_latents(
        setup.batch, setup.z, setup.z_im)
    return SimpleNamespace(state=state, metrics=metrics, **seen)


@pytest.fixture(scope="module")
def step_pair():
    """The JAX step's results and the port's, from one set of weights and inputs."""
    setup = _setup(B)
    return setup, _port_step(setup)


def test_step_losses_match_jax(step_pair):
    setup, port = step_pair
    want, got = setup.jax[4], port.metrics
    assert set(got) == set(want) and port.state.step == 1
    for k, v in want.items():
        assert abs(got[k].item() - float(v)) <= 2e-3, (k, got[k].item(), float(v))


def _named(convert, tree, module):
    """A JAX params-shaped tree (params or gradients) under the port's
    parameter names, through the weight converter."""
    sd = convert(tree)
    return {n: sd[n] for n, _ in module.named_parameters()}


def _variables_like(variables, params):
    return {**variables, "params": params}


# G's layers downstream of the PSP head's ill-conditioned pyramid stage
_AFTER_PSP = ("res5.", "final.")
# the conv feeding that stage's BN, which at b=2 sees two values per channel
_PSP_STAGE_CONV = _PSP_STAGE + ".1.weight"


def _grad_gaps(setup, state, net: str) -> dict:
    """{name: (error norm, norm, bar, relative tolerance or None)} of each
    parameter gradient of ``net`` against JAX's, with the bars of the module
    docstring; None marks the absolute bar of a round-off zero."""
    new_g, new_d, g_grads, d_grads = setup.jax[:4]
    module, convert, grads, variables = (
        (state.generator, generator_state_dict_from_jax, g_grads, new_g) if net == "generator"
        else (state.discriminator, discriminator_state_dict_from_jax, d_grads, new_d))
    want = _named(convert, _variables_like(variables, grads), module)
    largest = max(np.linalg.norm(w.numpy()) for w in want.values())
    gaps = {}
    for name, p in module.named_parameters():
        w = want[name].numpy()
        err, norm = np.linalg.norm(p.grad.numpy() - w), np.linalg.norm(w)
        if name == _PSP_STAGE_CONV and setup.z.shape[0] == 2:
            tol, bar = 5e-2, 5e-2 * norm
        elif norm < 1e-5 * largest:
            tol, bar = None, 1e-6 * largest
        else:
            tol = 1e-3 if net == "discriminator" or name.startswith(_AFTER_PSP) else 1e-2
            bar = tol * norm
        gaps[name] = (err, norm, bar, tol)
    return gaps


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_step_gradients_match_jax(step_pair, net):
    setup, port = step_pair
    for name, (err, norm, bar, _) in _grad_gaps(setup, port.state, net).items():
        assert err <= bar, (name, err, norm)


def _spread(a: SimpleNamespace, b: SimpleNamespace) -> dict:
    """{name: relative change} of each G gradient from port run a to run b."""
    grads = dict(b.state.generator.named_parameters())
    return {n: ((p.grad - grads[n].grad).norm() / p.grad.norm()).item()
            for n, p in a.state.generator.named_parameters()}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def test_step_gradient_gap_is_the_f32_spread(step_pair):
    """Why G's layers before the PSP head get a 1e-2 bar, and the conv of
    its 1x1 stage 5e-2: one ulp of noise on G's weights (6e-8 relative)
    moves the stage's BN output over 100 times as far as its input, and
    moves every G gradient that misses JAX's by more than 1e-3 by at least
    half that gap, while res5 and final stay well within 1e-3."""
    setup, port = step_pair
    noisy = _port_step(setup, noise=6e-8)
    gain = _rel(noisy.psp_bn, port.psp_bn) / _rel(noisy.psp_conv, port.psp_conv)
    assert gain > 100, gain
    spread = _spread(port, noisy)
    wide = 0
    for name, (err, norm, _, tol) in _grad_gaps(setup, port.state, "generator").items():
        if tol == 1e-3:
            assert spread[name] < 1e-4, (name, spread[name])
        elif tol in (1e-2, 5e-2) and err > 1e-3 * norm:
            wide += 1
            assert spread[name] >= 0.5 * err / norm, (name, spread[name], err / norm)
    assert wide > 0  # the 1e-2 bar is needed at this seed


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_step_params_and_state_match_jax(step_pair, net):
    setup, port = step_pair
    new_g, new_d = setup.jax[:2]
    module, convert, variables = (
        (port.state.generator, generator_state_dict_from_jax, new_g) if net == "generator"
        else (port.state.discriminator, discriminator_state_dict_from_jax, new_d))
    want = convert(variables)
    params = dict(module.named_parameters())
    beyond = total = 0
    for name, t in module.state_dict().items():
        w = want[name].numpy()
        if name in params:
            diff = np.abs(t.numpy() - w)
            assert diff.max() <= 2 * LR, (name, diff.max())
            beyond += int((diff > 1e-6).sum())
            total += diff.size
        elif name.endswith(("weight_u", "running_mean", "running_var")):
            loose = name.startswith(("res4.conv_mask.0.bottleneck.", "l_y_app."))
            np.testing.assert_allclose(t.numpy(), w, atol=1e-4 if loose else 1e-5, rtol=0,
                                       err_msg=name)
    assert beyond < 0.01 * total, (beyond, total)


def test_train_cli_writes_weights_the_sampler_loads(tmp_path):
    out = tmp_path / "run"
    train_cli.main(["--dataset", "synthetic", "--steps", "2", "--batch_size", "2", "--ch", "4",
                    "--no_vgg", "--device", "cpu", "--out_path", str(out)])
    lines = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["d_loss"]) and np.isfinite(ln["g_loss"]) for ln in lines)
    assert "feat_loss" not in lines[0] and "d_loss_rapp" in lines[0]
    sd = torch.load(out / "D.pth", weights_only=True)
    disc = make_discriminator("d128_app", train_cli.SYNTHETIC_CLASSES, device="cpu", ch=4)
    disc.load_state_dict(sd, strict=True)
    sample_cli.main(["--weights", str(out / "G.pth"), "--sample_path", str(tmp_path / "s"),
                     "--num_img", "1", "--batch_size", "2", "--device", "cpu"])
    assert len(os.listdir(tmp_path / "s")) == 2 * sample_cli.SYNTHETIC_BATCHES


def _sweep(b: int) -> None:
    """The step comparison at b layouts: the worst gradient gaps to JAX,
    the port's own spread under an ulp of weight noise, and the gradient
    D hands G (the port's against JAX's, and G's gradients when the port's
    G is fed JAX's)."""
    setup = _setup(b)
    port, noisy = _port_step(setup), _port_step(setup, noise=6e-8)
    spread = _spread(port, noisy)
    print(f"b={b} an ulp of noise on G's weights moves the PSP 1x1 stage's BN input by "
          f"{_rel(noisy.psp_conv, port.psp_conv):.2e} and its output by {_rel(noisy.psp_bn, port.psp_bn):.2e}")
    for net in ("generator", "discriminator"):
        gaps = _grad_gaps(setup, port.state, net)
        largest = max(norm for _, norm, _, _ in gaps.values())
        parts = ({"before the PSP head": 1e-2, "the PSP 1x1 stage's conv": 5e-2, "res5 and final": 1e-3}
                 if net == "generator" else {"": 1e-3})
        for part, tol in parts.items():
            rows = sorted((err / norm, n, norm) for n, (err, norm, _, t) in gaps.items() if t == tol)
            if not rows:
                continue
            gap, name, norm = rows[-1]
            line = f"b={b} {net} {part}: worst gap {gap:.2e} ({name}, norm {norm / largest:.1e} of the largest)"
            if net == "generator":
                line += f"; port's ulp spread at most {max(spread[n] for _, n, _ in rows):.2e}"
            print(line, flush=True)
    jax_cot, jax_fake = _t(_nchw(setup.jax[5])), _t(_nchw(setup.jax[6]))
    shown = _port_step(setup, fake=jax_fake)
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, num_mask_classes=NC)
    gen.load_state_dict(setup.g_sd, strict=True)
    fake = gen.train()(setup.z, setup.batch["boxes"], setup.batch["labels"], setup.z_im,
                       deterministic=True)
    fed = dict(zip((n for n, _ in gen.named_parameters()),
                   torch.autograd.grad(fake, list(gen.parameters()), jax_cot)))
    want = _named(generator_state_dict_from_jax,
                  _variables_like(setup.jax[0], setup.jax[2]), gen)
    largest = max(w.norm().item() for w in want.values())
    fed_gap = max((_rel(fed[n], w), n) for n, w in want.items() if w.norm() >= 1e-5 * largest)
    loss_gap = max(abs(port.metrics[k].item() - float(v)) for k, v in setup.jax[4].items())
    print(f"b={b} fake images: port's vs JAX's {_rel(port.fake, jax_fake):.2e}; the gradient D hands "
          f"G: port's vs JAX's {_rel(port.cot, jax_cot):.2e}, {_rel(shown.cot, jax_cot):.2e} when the "
          f"port's D is shown JAX's images; port's G fed JAX's: worst gap {fed_gap[0]:.2e} "
          f"({fed_gap[1]}); losses within {loss_gap:.2e}", flush=True)


if __name__ == "__main__":
    for arg in sys.argv[1:] or ["2", "4", "8"]:
        _sweep(int(arg))
