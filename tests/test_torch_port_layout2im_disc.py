"""The port's layout2im discriminators against the JAX package's, on the CPU.

- ``Layout2ImImageDiscriminator`` and ``Layout2ImObjectDiscriminator``
  (AC-GAN classifier, Gram appearance head), with and without spectral
  norm, in training mode (one SN power iteration per layer): every score at
  2e-3 (the PARITY.md bar) and every SN u vector after the call at 1e-5.
  The port's seeded weights go to JAX by the inverse of
  ``utils.convert.layout2im_state_dict_from_jax`` and come back through it.

b=2, o=4 with pad slots, conv_dim 8.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.models import layout2im as jl
from layout2img_tpu.ops.interp import crop_boxes as jax_crop_boxes
from layout2img_tpu_torch.models import layout2im as pl
from test_torch_port_layout2im import (CD, NC, _abs, _load, _nchw, _seeded, _stats_match, _t,
                                      jax_variables)
from test_torch_port_layout2im import inputs  # noqa: F401  (fixture)
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)


@pytest.mark.parametrize("spectral", [True, False])
def test_discriminators_match_jax(inputs, spectral):
    a = inputs
    crops = np.asarray(jax_crop_boxes(a["images"], a["boxes"], 32))
    d_img, d_obj = jl.Layout2ImImageDiscriminator(CD, spectral), jl.Layout2ImObjectDiscriminator(
        NC, CD, spectral)
    vi = jax_variables(d_img, _seeded(pl.Layout2ImImageDiscriminator(CD, spectral), 6), a["images"])
    vo = jax_variables(d_obj, _seeded(pl.Layout2ImObjectDiscriminator(NC, CD, spectral), 7), crops,
                       a["labels"])
    want_i, new_i = fast_jit(functools.partial(d_img.apply, mutable=["spectral"]))(vi, a["images"])
    want_o, new_o = fast_jit(functools.partial(d_obj.apply, mutable=["spectral"]))(
        vo, crops, a["labels"])
    port_i = _load(pl.Layout2ImImageDiscriminator(CD, spectral), vi, True)
    port_o = _load(pl.Layout2ImObjectDiscriminator(NC, CD, spectral), vo, True)
    _abs(port_i(_t(a["images"]).permute(0, 3, 1, 2)), want_i, what="image")
    got_o = port_o(_t(_nchw(crops)), _t(a["labels"]).long())
    assert set(got_o) == set(want_o)
    for k, v in want_o.items():
        _abs(got_o[k], v, what=k)
    if spectral:
        assert _stats_match(port_i, vi, new_i) == 16
        assert _stats_match(port_o, vo, new_o) == 25

