"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same numpy inputs go through ``layout2img_tpu.ops`` and
``layout2img_tpu_torch.ops``; outputs must agree to 1e-5 (f32 round-off).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from layout2img_tpu.ops import bbox as jbbox
from layout2img_tpu.ops import interp as jinterp
from layout2img_tpu.ops import relation as jrelation
from layout2img_tpu_torch.ops import bbox, interp, relation
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

TOL = 1e-5


def _boxes(rng, b=2, o=5, pad=True):
    xy = rng.uniform(0, 0.6, (b, o, 2))
    wh = rng.uniform(0.05, 0.4, (b, o, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    if pad:
        boxes[:, -1] = (-0.6, -0.6, 0.5, 0.5)
    return boxes


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("hw", [(64, 64), (16, 24), (5, 3)])
def test_bbox_mask(rng, hw):
    boxes = _boxes(rng)
    want = jbbox.bbox_mask(jnp.asarray(boxes), *hw)
    got = bbox.bbox_mask(torch.from_numpy(boxes), *hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_xywh_to_xyxy(rng):
    boxes = _boxes(rng)
    _close(bbox.xywh_to_xyxy(torch.from_numpy(boxes)), jbbox.xywh_to_xyxy(jnp.asarray(boxes)))


@pytest.mark.parametrize("in_hw,out_hw,align", [
    ((64, 64), (4, 4), False),  # the ISLA mask down to res1
    ((8, 8), (16, 16), False),
    ((16, 16), (128, 128), False),
    ((4, 4), (8, 8), False),
    ((5, 7), (9, 3), False),
    ((1, 1), (64, 64), True),  # PSP prior at size 1
    ((3, 3), (64, 64), True),
    ((6, 6), (32, 32), True),
])
def test_resize_bilinear(rng, in_hw, out_hw, align):
    x = rng.standard_normal((2, 3, *in_hw)).astype(np.float32)
    want = jinterp.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align)
    got = interp.resize_bilinear(torch.from_numpy(x), out_hw, align_corners=align)
    _close(got, want)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 64), (8, 8)), ((64, 64), (128, 128)), ((5, 7), (9, 3))])
def test_resize_nearest(rng, in_hw, out_hw):
    x = rng.standard_normal((2, 3, *in_hw)).astype(np.float32)
    want = jinterp.resize_nearest(jnp.asarray(x), out_hw)
    np.testing.assert_array_equal(interp.resize_nearest(torch.from_numpy(x), out_hw).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("out", [1, 2, 3, 6])
def test_adaptive_avg_pool2d(rng, out):
    x = rng.standard_normal((2, 4, 64, 64)).astype(np.float32)
    want = jinterp.adaptive_avg_pool2d(jnp.asarray(x), (out, out))
    _close(interp.adaptive_avg_pool2d(torch.from_numpy(x), (out, out)), want)


def test_sample_matrix_1d(rng):
    src = rng.uniform(-3.0, 20.0, (2, 5, 11)).astype(np.float32)
    src[0, 0, :3] = (np.inf, -np.inf, 16.0)
    want = jinterp.sample_matrix_1d(jnp.asarray(src), 16)
    _close(interp.sample_matrix_1d(torch.from_numpy(src), 16), want)


@pytest.mark.parametrize("canvas", [64, 16])
def test_masks_to_layout(rng, canvas):
    boxes = _boxes(rng, o=6)
    # a zero-width box off the canvas grid: +-inf source positions, zero taps
    boxes[1, 0] = (0.33, 0.2, 0.0, 0.3)
    masks = rng.uniform(0, 1, (2, 6, 16, 16)).astype(np.float32)
    want = jinterp.masks_to_layout(jnp.asarray(boxes), jnp.asarray(masks), canvas)
    got = interp.masks_to_layout(torch.from_numpy(boxes), torch.from_numpy(masks), canvas)
    _close(got, want)
    assert not got[:, -1].any(), "the pad box must splat to an all-zero mask"


def test_masks_to_layout_zero_width_box_on_grid_is_finite():
    # x0 on a canvas pixel: 0/0 there. The JAX op lets that NaN through; the
    # port maps it out of range so the integer cast stays defined.
    boxes = torch.tensor([[[0.0, 0.1, 0.0, 0.3]]])
    got = interp.masks_to_layout(boxes, torch.ones(1, 1, 4, 4), 8)
    assert torch.isfinite(got).all() and not got.any()


@pytest.mark.parametrize("trig", [True, False])
def test_box_relational_embedding(rng, trig):
    boxes = _boxes(rng, o=7)
    want = jrelation.box_relational_embedding(jnp.asarray(boxes), trignometric=trig)
    got = relation.box_relational_embedding(torch.from_numpy(boxes), trignometric=trig)
    assert got.shape == want.shape
    tol = TOL
    if trig:
        # sin/cos take 100 * log-deltas, arguments up to ~700: XLA's and
        # torch's f32 log differ by an ulp, which sin/cos pass on as an
        # absolute error of a few ulp of the argument
        pos = relation.box_relational_embedding(torch.from_numpy(boxes), trignometric=False)
        tol = 4 * np.finfo(np.float32).eps * float(100 * pos.abs().max())
    _close(got, want, tol)


def test_cached_resize_tensors_serve_inference_and_autograd(rng):
    # the resize matrices and nearest indices are cached per size: a first
    # call under inference mode must not leave tensors autograd cannot use
    x = torch.from_numpy(rng.standard_normal((2, 3, 7, 5)).astype(np.float32))
    with torch.inference_mode():
        interp.resize_bilinear(x, (11, 13))
        interp.resize_nearest(x, (11, 13))
    xg = x.clone().requires_grad_()
    (interp.resize_bilinear(xg, (11, 13)).sum() + interp.resize_nearest(xg, (11, 13)).sum()).backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
