"""Parity of the PyTorch port's nn modules with the JAX package's, on the CPU.

One JAX ``ours_d_context128`` generator (ch=4, 10 classes) is initialized
per module, its BN statistics and alphas perturbed away from 0/1, and
converted with ``layout2img_tpu_torch.utils.convert``; each JAX submodule
is applied with its slice of the variables, and the port's submodule of the
converted generator must agree to 1e-4 (NHWC outputs transposed to NCHW).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.nn.attention import BoxMultiHeadedAttention as JaxAttention
from layout2img_tpu.nn.blocks import GenResBlock as JaxGenResBlock
from layout2img_tpu.nn.blocks import PSPModule as JaxPSPModule
from layout2img_tpu.nn.blocks import upsample2x_nearest as jax_upsample2x_nearest
from layout2img_tpu.nn.mask_regress import MaskRegressNetV2 as JaxMaskRegressNetV2
from layout2img_tpu.nn.norms import InstanceNorm2d as JaxInstanceNorm2d
from layout2img_tpu.nn.norms import SpatialAdaptiveNorm as JaxSpatialAdaptiveNorm
from layout2img_tpu.nn.norms import SyncBatchNorm as JaxSyncBatchNorm
from layout2img_tpu.nn.spectral import SNConv as JaxSNConv
from layout2img_tpu.nn.spectral import SNDense as JaxSNDense
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.nn.attention import BoxMultiHeadedAttention
from layout2img_tpu_torch.nn.blocks import upsample2x_nearest
from layout2img_tpu_torch.nn.norms import InstanceNorm2d
from layout2img_tpu_torch.utils.convert import generator_state_dict_from_jax
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

TOL = 1e-4
CH, NC, B, O = 4, 10, 2, 8
NUM_W = 128 + 180


def _layout(rng):
    xy = rng.uniform(0, 0.5, (B, O, 2))
    wh = rng.uniform(0.05, 0.45, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.integers(1, NC, (B, O)).astype(np.int32)
    labels[:, 5:] = 0
    boxes[:, 5:] = (-0.6, -0.6, 0.5, 0.5)
    return boxes, labels


@pytest.fixture(scope="module")
def gens():
    """(JAX variables, port generator, numpy inputs), shared by the module."""
    rng = np.random.default_rng(1)
    boxes, labels = _layout(rng)
    z = rng.standard_normal((B, O, 128)).astype(np.float32)
    z_im = rng.standard_normal((B, 128)).astype(np.float32)
    jgen = jax_make_generator("ours_d_context128", NC, ch=CH, num_mask_classes=NC)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0), z, boxes, labels, z_im)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda s: s + rng.uniform(0.1, 0.5, s.shape).astype(s.dtype), variables["batch_stats"])
    for k in [k for k in variables["params"] if k.startswith("alpha")]:
        variables["params"][k] = rng.uniform(-2, 2, variables["params"][k].shape).astype(np.float32)
    port = make_generator("ours_d_context128", NC, device="cpu", ch=CH, num_mask_classes=NC)
    port.load_state_dict(generator_state_dict_from_jax(variables), strict=True)
    inputs = dict(boxes=boxes, labels=labels, z=z, z_im=z_im,
                  vectors=rng.standard_normal((B, O, NUM_W)).astype(np.float32),
                  mask64=rng.uniform(0, 1, (B, O, 64, 64)).astype(np.float32))
    return variables, port, inputs


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats", "spectral"):
        tree = variables.get(col, {})
        try:
            for k in path:
                tree = tree[k]
        except KeyError:
            continue
        out[col] = tree
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def test_sn_dense(gens):
    variables, port, inp = gens
    want = JaxSNDense(4 * 4 * 16 * CH).apply(_sub(variables, "fc"), inp["z_im"], update_stats=False)
    _close(port.fc(_t(inp["z_im"])), np.asarray(want))


@pytest.mark.parametrize("name,in_ch,out_ch,k", [("conv1", 64, 64, 3), ("c_sc", 64, 64, 1)])
def test_sn_conv(gens, rng, name, in_ch, out_ch, k):
    variables, port, _ = gens
    x = rng.standard_normal((B, 6, 6, in_ch)).astype(np.float32)
    want = JaxSNConv(out_ch, (k, k)).apply(_sub(variables, "res1", name), x, update_stats=False)
    _close(getattr(port.res1, name)(_t(_nchw(x))), _nchw(want))


@pytest.mark.parametrize("path,affine", [(("final_bn",), True), (("res1", "b1", "bn"), False)])
def test_sync_batch_norm_eval(gens, rng, path, affine):
    variables, port, _ = gens
    c = np.asarray(_sub(variables, *path)["batch_stats"]["mean"]).shape[0]
    x = rng.standard_normal((B, 5, 5, c)).astype(np.float32) * 2 + 0.3
    want = JaxSyncBatchNorm(affine=affine).apply(_sub(variables, *path), x, use_running_average=True)
    module = port.final[0] if affine else port.res1.b1.batch_norm2d
    _close(module(_t(_nchw(x))), _nchw(want))


def test_instance_norm(rng):
    x = rng.standard_normal((B, 8, 8, 5)).astype(np.float32) * 3 + 1
    want = JaxInstanceNorm2d().apply({}, x)
    _close(InstanceNorm2d()(_t(_nchw(x))), _nchw(want))


@pytest.mark.parametrize("block,norm,c,h", [("res1", "b1", 64, 4), ("res2", "b2", 32, 16),
                                            ("res5", "b2", 4, 128)])
def test_spatial_adaptive_norm(gens, rng, block, norm, c, h):
    variables, port, inp = gens
    x = rng.standard_normal((B, h, h, c)).astype(np.float32)
    want = JaxSpatialAdaptiveNorm().apply(
        _sub(variables, block, norm), x, inp["vectors"], inp["mask64"],
        use_running_average=True, update_spectral=False)
    got = getattr(getattr(port, block), norm)(_t(_nchw(x)), _t(inp["vectors"]), _t(inp["mask64"]))
    _close(got, _nchw(want))


@pytest.mark.parametrize("legacy_view", [False, True])
def test_box_attention(gens, legacy_view):
    variables, port, inp = gens
    w = inp["vectors"]
    want = JaxAttention(heads=1, d_model=NUM_W, legacy_view=legacy_view).apply(
        _sub(variables, "context"), w, w, w, inp["boxes"], inp["labels"])
    module = BoxMultiHeadedAttention(1, NUM_W, legacy_view=legacy_view)
    module.load_state_dict(port.context.state_dict(), strict=True)
    got = module(_t(w), _t(w), _t(w), _t(inp["boxes"]), _t(inp["labels"]).long())
    _close(got, np.asarray(want))


def test_mask_regress_v2(gens):
    variables, port, inp = gens
    want = JaxMaskRegressNetV2().apply(
        _sub(variables, "mask_regress"), inp["vectors"], inp["boxes"], update_stats=False)
    _close(port.mask_regress(_t(inp["vectors"]), _t(inp["boxes"])), np.asarray(want))


@pytest.mark.parametrize("block,in_ch,out_ch,h,predict_mask,psp", [
    ("res1", 64, 64, 4, True, False),  # plain conv mask head
    ("res4", 16, 8, 32, True, True),  # PSP mask head
    ("res5", 8, 4, 64, False, False),  # no mask head
])
def test_gen_res_block(gens, rng, block, in_ch, out_ch, h, predict_mask, psp):
    variables, port, inp = gens
    x = rng.standard_normal((B, h, h, in_ch)).astype(np.float32)
    out, smask = JaxGenResBlock(out_ch, predict_mask=predict_mask, psp_module=psp,
                                num_mask_classes=NC).apply(
        _sub(variables, block), x, inp["vectors"], inp["mask64"], train=False,
        update_stats=False, deterministic=True)
    got, got_mask = getattr(port, block)(_t(_nchw(x)), _t(inp["vectors"]), _t(inp["mask64"]))
    _close(got, _nchw(out))
    if predict_mask:
        _close(got_mask, _nchw(smask))
    else:
        assert got_mask is None and smask is None


def test_psp_module(gens, rng):
    variables, port, _ = gens
    x = rng.standard_normal((B, 32, 32, 8)).astype(np.float32)
    want = JaxPSPModule(100).apply(_sub(variables, "res4", "psp"), x, train=False, deterministic=True)
    _close(port.res4.conv_mask[0](_t(_nchw(x))), _nchw(want))


def test_upsample2x_nearest(rng):
    x = rng.standard_normal((B, 3, 5, 4)).astype(np.float32)
    want = jax_upsample2x_nearest(jnp.asarray(x))
    np.testing.assert_array_equal(upsample2x_nearest(_t(_nchw(x))).numpy(), _nchw(want))
