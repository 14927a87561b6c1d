"""Every discriminator preset of the port against the JAX package's, on the CPU.

For ``d64``, ``d128``, ``d128_app`` and ``d256``, and for ``app_head=True``
at 64 and 256 px as the JAX bench builds its D (``bench.py:66-68``), at
ch=4, 10 classes, b=2, o=6 with two pad slots, small and large boxes: the
port's seeded discriminator, its biases drawn, is read into JAX variables
by the JAX package's importer (``layout2img_tpu.utils.torch_import``,
which spares a JAX ``init`` compile per case) and converted back with
``utils.convert.discriminator_state_dict_from_jax``, which must equal
``export_lostgan_discriminator`` key for key and give back the port's
dict. Its image, object and (with the app head) app scores agree to 2e-3
(the PARITY.md bar) in eval and in training, where every spectral norm
advances (the RoI blocks shared by two scales twice per call): the SN u
vectors after it at 1e-5. The routing:
``d64`` crops its 32x32 map with single-scale RoIAlign at 1/2, ``d256``
crops at 1/8 and 1/16 with a 128-px threshold, ``d128`` at 1/4 and 1/8
with 64 px.
"""

import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.models.discriminators import make_discriminator as jax_make_discriminator
from layout2img_tpu.utils.torch_export import export_lostgan_discriminator
from layout2img_tpu.utils.torch_import import import_lostgan_discriminator
from layout2img_tpu_torch.data.synthetic import PAD_BOX
from layout2img_tpu_torch.models import discriminators
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.utils.convert import discriminator_state_dict_from_jax, init_discriminator
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)

TOL = 2e-3
CH, NC, B, O, N_VALID = 4, 10, 2, 6, 4
# (preset, overrides): the four presets, and the app head at the other sizes
CASES = [("d64", {}), ("d128", {}), ("d128_app", {}), ("d256", {}),
         ("d64", {"app_head": True}), ("d256", {"app_head": True})]
IDS = ["d64", "d128", "d128_app", "d256", "d64_app", "d256_app"]
SIZES = {"d64": 64, "d128": 128, "d128_app": 128, "d256": 256}


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(size: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    xy = rng.uniform(0, 0.6, (B, O, 2))
    wh = rng.uniform(0.05, 0.4, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    boxes[0, 0] = (0.1, 0.1, 0.3, 0.2)  # small at every size
    boxes[0, 1] = (0.1, 0.1, 0.6, 0.3)  # large at every size
    boxes[1, 0] = (0.2, 0.2, 0.45, 0.45)  # 57.6 px at 128 (small), 115.2 at 256 (small)
    labels = rng.integers(1, NC, (B, O)).astype(np.int32)
    labels[:, N_VALID:] = 0
    boxes[:, N_VALID:] = PAD_BOX
    return dict(images=images, boxes=boxes, labels=labels)


_CACHE = {}


def setup(i: int):
    """(JAX module, numpy variables, port D, numpy inputs) of CASES[i]."""
    if i not in _CACHE:
        preset, over = CASES[i]
        inp = _inputs(SIZES[preset], 10 + i)
        jd = jax_make_discriminator(preset, NC, ch=CH, **over)
        rng = np.random.default_rng(20 + i)
        sd = {k: (torch.from_numpy(rng.normal(0.0, 0.1, v.shape).astype(np.float32))
                  if k.endswith(".bias") else v)
              for k, v in init_discriminator(i, NC, preset=preset, device="cpu", ch=CH,
                                             **over).state_dict().items()}
        variables = jax.tree_util.tree_map(np.asarray, import_lostgan_discriminator(sd))
        port = make_discriminator(preset, NC, device="cpu", ch=CH, **over)
        port.load_state_dict(discriminator_state_dict_from_jax(variables), strict=True)
        for k, v in sd.items():  # the round trip through JAX's importer
            if not k.endswith("weight_v"):  # recomputed from W and u, as the exporter does
                assert torch.equal(port.state_dict()[k], v), k
        _CACHE[i] = (jd, variables, port, inp)
    return _CACHE[i]


def _port_args(inp):
    return _t(inp["images"].transpose(0, 3, 1, 2)), _t(inp["boxes"]), _t(inp["labels"]).long()


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_state_dict_matches_reference_export(i):
    _, variables, port, _ = setup(i)
    ours = discriminator_state_dict_from_jax(variables)
    ref = export_lostgan_discriminator(variables)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert set(port.state_dict()) == set(ref)
    assert ("app_conv.conv1.weight_orig" in ref) == port.app_head


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_scores_match_jax(i, train):
    jd, variables, port, inp = setup(i)
    preset, over = CASES[i]
    d = make_discriminator(preset, NC, device="cpu", ch=CH, **over).train(train)
    d.load_state_dict(port.state_dict(), strict=True)
    apply = fast_jit(lambda v, *a: jd.apply(v, *a, update_stats=train, mutable=["spectral"]))
    want, new_state = apply(variables, inp["images"], inp["boxes"], inp["labels"])
    with torch.no_grad():
        got = d(*_port_args(inp))
    assert set(got) == set(want)
    assert ("app" in got) == d.app_head
    for k in ("image", "object", "app"):
        if k in want:
            assert got[k].shape == np.asarray(want[k]).shape, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL, rtol=0,
                                       err_msg=k)
    if train:  # every u advanced as in JAX, the shared RoI block's twice
        converted = discriminator_state_dict_from_jax({**variables, **new_state})
        for name, buf in d.state_dict().items():
            if name.endswith("weight_u"):
                np.testing.assert_allclose(buf.numpy(), converted[name].numpy(), atol=1e-5,
                                           rtol=0, err_msg=name)


@pytest.mark.parametrize("preset,calls", [
    ("d64", [("roi_align", (1.0 / 2.0,), 32)]),
    ("d128", [("dual", (1.0 / 4.0, 1.0 / 8.0, 64.0), 32)]),
    ("d256", [("dual", (1.0 / 8.0, 1.0 / 16.0, 128.0), 32)]),
])
def test_roi_routing(monkeypatch, preset, calls):
    """Which RoIAlign each size runs, at which scales and threshold, on a map
    of which size: single scale on the 32x32 map at 64 px, dual scale with
    the small boxes' map at 32x32 at 128 and 256 px."""
    seen = []
    single, dual = discriminators.roi_align, discriminators.dual_scale_roi_align

    def rec_single(features, boxes, out_size, scale, *rows):
        seen.append(("roi_align", (scale,), features.shape[-1]))
        return single(features, boxes, out_size, scale, *rows)

    def rec_dual(small, large, boxes, out_size, s_small, s_large, threshold, *rows):
        seen.append(("dual", (s_small, s_large, threshold), small.shape[-1]))
        assert large.shape[-1] == small.shape[-1] // 2
        return dual(small, large, boxes, out_size, s_small, s_large, threshold, *rows)

    monkeypatch.setattr(discriminators, "roi_align", rec_single)
    monkeypatch.setattr(discriminators, "dual_scale_roi_align", rec_dual)
    i = IDS.index(preset)
    _, _, port, inp = setup(i)
    with torch.no_grad():
        port(*_port_args(inp))
    assert seen == calls


def test_app_head_takes_the_crop_width():
    """The app head's first block reads the crops: 4*ch channels at 64 px,
    8*ch at 128 and 256 px (the fault a fixed ch*8 input would be)."""
    for preset, crop in (("d64", 4), ("d128", 8), ("d256", 8)):
        d = make_discriminator(preset, NC, device="cpu", ch=CH, app_head=True)
        assert d.app_conv.conv1.weight_orig.shape == (8 * CH, crop * CH, 3, 3), preset
        assert d.app_conv.c_sc is not None or crop == 8
