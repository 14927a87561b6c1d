"""The port's discriminator path against the JAX package's, on the CPU.

RoIAlign and its dual-scale routing at 1e-5; a ``d128_app`` discriminator
(ch=4, 10 classes, b=2, o=6 with pad slots, 128 px) initialized in JAX and
converted with ``utils.convert.discriminator_state_dict_from_jax`` (equal
key for key to ``export_lostgan_discriminator``): its image, object and app
scores at 2e-3 (the PARITY.md bar), in eval and in training, where every
spectral norm advances (``block_obj4`` twice per call); the spectral-norm
power iteration of each layer kind after one and three updates at 1e-5;
the masked hinge losses; and the VGG19 perceptual loss at 64 px with JAX's
random filters converted by ``vgg19_state_dict_from_jax``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.losses.gan import g_adv as jax_g_adv
from layout2img_tpu.losses.gan import hinge_d_fake as jax_hinge_d_fake
from layout2img_tpu.losses.gan import hinge_d_real as jax_hinge_d_real
from layout2img_tpu.losses.perceptual import VGGLoss as JaxVGGLoss
from layout2img_tpu.models.discriminators import make_discriminator as jax_make_discriminator
from layout2img_tpu.nn.spectral import SNConv as JaxSNConv
from layout2img_tpu.nn.spectral import SNDense as JaxSNDense
from layout2img_tpu.nn.spectral import SNEmbed as JaxSNEmbed
from layout2img_tpu.ops.roi import dual_scale_roi_align as jax_dual_scale_roi_align
from layout2img_tpu.ops.roi import roi_align as jax_roi_align
from layout2img_tpu.utils.torch_export import export_lostgan_discriminator
from layout2img_tpu_torch.data.synthetic import PAD_BOX
from layout2img_tpu_torch.losses.gan import g_adv, hinge_d_fake, hinge_d_real
from layout2img_tpu_torch.losses.perceptual import VGG19Features, VGGLoss
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.nn.spectral import SNConv, SNDense, SNEmbed
from layout2img_tpu_torch.ops.roi import dual_scale_roi_align, roi_align
from layout2img_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                                vgg19_state_dict_from_jax)
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)

TOL = 2e-3
CH, NC, B, O, N_VALID = 4, 10, 2, 6, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _rel_close(got, want, rtol):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def _boxes_px(rng, b, o):
    """xyxy pixel boxes at 128 px: small and large ones, one partly off the
    map, one thinner than a pixel."""
    xy = rng.uniform(0, 100, (b, o, 2))
    wh = rng.uniform(4, 120, (b, o, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, 0] = (-20.0, -10.0, 40.0, 30.0)  # off the map's top-left corner
    boxes[:, 1] = (10.0, 10.0, 10.3, 70.0)  # extent clamped to 1
    boxes[:, 2] = (5.0, 5.0, 60.0, 62.0)  # small: both sides under 64
    boxes[:, 3] = (5.0, 5.0, 70.0, 30.0)  # large: one side over 64
    return boxes.astype(np.float32)


@pytest.mark.parametrize("size,scale", [(32, 0.25), (16, 0.125), (13, 0.1)])
def test_roi_align(rng, size, scale):
    feats = rng.standard_normal((B, size, size + 3, 5)).astype(np.float32)
    boxes = _boxes_px(rng, B, O)
    want = jax.jit(jax_roi_align, static_argnums=(2, 3))(feats, boxes, 8, scale)  # (b, o, 8, 8, c)
    got = roi_align(_t(_nchw(feats)), _t(boxes), 8, scale)
    assert got.shape == (B, O, 5, 8, 8)
    _rel_close(got, np.asarray(want).transpose(0, 1, 4, 2, 3), 1e-5)


def test_dual_scale_roi_align_routes_by_size(rng):
    small = rng.standard_normal((B, 32, 32, 5)).astype(np.float32)
    large = rng.standard_normal((B, 16, 16, 5)).astype(np.float32)
    boxes = _boxes_px(rng, B, O)
    dual = jax.jit(jax_dual_scale_roi_align, static_argnums=(3, 4, 5, 6))
    want = np.asarray(dual(small, large, boxes, 8, 0.25, 0.125, 64.0))
    got = dual_scale_roi_align(_t(_nchw(small)), _t(_nchw(large)), _t(boxes), 8, 0.25, 0.125, 64.0)
    _rel_close(got, want.transpose(0, 1, 4, 2, 3), 1e-5)
    from_small = roi_align(_t(_nchw(small)), _t(boxes), 8, 0.25)
    from_large = roi_align(_t(_nchw(large)), _t(boxes), 8, 0.125)
    assert torch.equal(got[:, 2], from_small[:, 2]) and torch.equal(got[:, 3], from_large[:, 3])


@pytest.fixture(scope="module")
def discs():
    """(JAX module, numpy variables, port D, numpy inputs)."""
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (B, 128, 128, 3)).astype(np.float32)
    xy = rng.uniform(0, 0.6, (B, O, 2))
    wh = rng.uniform(0.05, 0.4, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    boxes[0, 0] = (0.1, 0.1, 0.3, 0.2)  # small: under 64 px on both sides
    boxes[0, 1] = (0.1, 0.1, 0.6, 0.3)  # large
    labels = rng.integers(1, NC, (B, O)).astype(np.int32)
    labels[:, N_VALID:] = 0
    boxes[:, N_VALID:] = PAD_BOX
    jd = jax_make_discriminator("d128_app", NC, ch=CH)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax.jit(jd.init)(jax.random.PRNGKey(1), images, boxes, labels)))
    port = make_discriminator("d128_app", NC, device="cpu", ch=CH)
    port.load_state_dict(discriminator_state_dict_from_jax(variables), strict=True)
    return jd, variables, port, dict(images=images, boxes=boxes, labels=labels)


def test_state_dict_matches_reference_export(discs):
    _, variables, _, _ = discs
    ours = discriminator_state_dict_from_jax(variables)
    ref = export_lostgan_discriminator(variables)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def _port_d(discs):
    """A fresh copy of the converted port D (training mode mutates u)."""
    _, variables, port, _ = discs
    d = make_discriminator("d128_app", NC, device="cpu", ch=CH)
    d.load_state_dict(port.state_dict(), strict=True)
    return d


@pytest.mark.parametrize("train", [False, True])
def test_scores_match_jax(discs, train):
    jd, variables, _, inp = discs
    port = _port_d(discs).train(train)
    args = (inp["images"], inp["boxes"], inp["labels"])
    apply = fast_jit(lambda v, *a: jd.apply(v, *a, update_stats=train, mutable=["spectral"]))
    want, new_state = apply(variables, *args)
    with torch.no_grad():
        got = port(_t(_nchw(inp["images"])), _t(inp["boxes"]), _t(inp["labels"]).long())
    assert set(got) == {"image", "object", "app", "valid"}
    for k in ("image", "object", "app"):
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    if train:  # every u advanced as in JAX, block_obj4's twice
        converted = discriminator_state_dict_from_jax({**variables, **new_state})
        for name, buf in port.state_dict().items():
            if name.endswith("weight_u"):
                np.testing.assert_allclose(buf.numpy(), converted[name].numpy(), atol=1e-5,
                                           rtol=0, err_msg=name)


def _jax_sn_layer(kind, rng):
    """(JAX module, variables, input, port module with the same weights)."""
    if kind == "dense":
        mod, x = JaxSNDense(7), rng.standard_normal((3, 5)).astype(np.float32)
    elif kind == "conv":
        mod, x = JaxSNConv(6, (3, 3)), rng.standard_normal((2, 5, 5, 4)).astype(np.float32)
    else:
        mod, x = JaxSNEmbed(9, 6), rng.integers(0, 9, (4,)).astype(np.int32)
    variables = jax.tree_util.tree_map(np.asarray, dict(mod.init(jax.random.PRNGKey(2), x)))
    p, u = variables["params"], variables["spectral"]["u"]
    if kind == "dense":
        port, w = SNDense(5, 7), p["kernel"].T
    elif kind == "conv":
        port, w = SNConv(4, 6, 3), p["kernel"].transpose(3, 2, 0, 1)
    else:
        port, w = SNEmbed(9, 6), p["embedding"]
    with torch.no_grad():
        port.weight_orig.copy_(_t(w))
        port.weight_u.copy_(_t(u))
        port.weight_v.zero_()
        if port.bias is not None:
            port.bias.copy_(_t(p["bias"]))
    return mod, variables, x, port


@pytest.mark.parametrize("kind", ["dense", "conv", "embed"])
def test_spectral_norm_power_iteration(rng, kind):
    """u after one and after three training calls, and each call's output,
    at 1e-5; v is detached, so W's gradient has no term through it."""
    mod, variables, x, port = _jax_sn_layer(kind, rng)
    port.train()
    xt = _t(x).long() if kind == "embed" else _t(x if kind == "dense" else _nchw(x))
    for n in (1, 2, 3):
        want, new = mod.apply(variables, x, mutable=["spectral"])
        variables = {**variables, **jax.tree_util.tree_map(np.asarray, dict(new))}
        got = port(xt)
        if n in (1, 3):
            np.testing.assert_allclose(port.weight_u.numpy(), variables["spectral"]["u"],
                                       atol=1e-5, rtol=0)
            want = np.asarray(want) if kind != "conv" else _nchw(want)
            np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    # the gradient of W matches JAX's, whose u and v carry stop_gradient
    def jax_loss(params):
        out, _ = mod.apply({**variables, "params": params}, x, mutable=["spectral"])
        return jnp.sum(jnp.square(out))

    jgrad = jax.grad(jax_loss)(variables["params"])
    port.zero_grad()
    port(xt).square().sum().backward()
    key = {"dense": "kernel", "conv": "kernel", "embed": "embedding"}[kind]
    jw = np.asarray(jgrad[key])
    if kind == "dense":
        jw = jw.T
    elif kind == "conv":
        jw = jw.transpose(3, 2, 0, 1)
    _rel_close(port.weight_orig.grad, jw, 1e-4)


def test_spectral_norm_eval_keeps_u(rng):
    _, _, x, port = _jax_sn_layer("dense", rng)
    u = port.weight_u.clone()
    port.eval()(_t(x))
    assert torch.equal(port.weight_u, u)


def test_hinge_losses(rng):
    scores = rng.standard_normal((B, O)).astype(np.float32) * 2
    mask = (rng.uniform(size=(B, O)) < 0.6).astype(np.float32)
    image = rng.standard_normal((B, 1)).astype(np.float32)
    for jf, pf in ((jax_hinge_d_real, hinge_d_real), (jax_hinge_d_fake, hinge_d_fake),
                   (jax_g_adv, g_adv)):
        for s, m in ((scores, mask), (image, None), (scores, np.zeros_like(mask))):
            want = jf(s, m)
            got = pf(_t(s), None if m is None else _t(m))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)


def test_vgg_loss_at_64px(rng):
    jloss = JaxVGGLoss(seed=0)
    vgg = VGG19Features()
    vgg.load_state_dict(vgg19_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jloss.params)),
                        strict=True)
    port = VGGLoss(vgg)
    fake = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    want, jgrad = jax.jit(jax.value_and_grad(lambda f: jloss(f, real)))(fake)
    ft = _t(_nchw(fake)).requires_grad_(True)
    got = port(ft, _t(_nchw(real)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)
    got.backward()
    _rel_close(ft.grad, _nchw(jgrad), 1e-4)
    assert not any(p.requires_grad for p in port.parameters())
