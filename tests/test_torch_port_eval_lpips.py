"""The port's LPIPS against the JAX package's: the converter on JAX
variables, both loaders on the three checkpoint layouts they read, and the
distances on the same variables and seeded images (NHWC into JAX, NCHW into
the port). Bar: 1e-6 absolute on distances of about 1e-2 (measured on an Intel
Xeon CPU: 1.5e-8 on distances of 2.3e-2 with the JAX fallback carried across)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.eval.lpips import LPIPS as JaxLPIPS
from layout2img_tpu.eval.lpips import load_torch_lpips as jax_load
from layout2img_tpu_torch.eval.lpips import (ALEX_CHANNELS, ALEX_CONV_INDEX, LPIPS, load_lpips,
                                             load_torch_lpips, random_lpips_state_dict)
from layout2img_tpu_torch.utils.convert import lpips_state_dict_from_jax
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

ATOL = 1e-6


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2)]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_dist(lp: LPIPS, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        return lp(_nchw(a), _nchw(b)).numpy()


def _alexnet(seed: int) -> dict:
    """A seeded torchvision ``alexnet`` state dict (features and classifier)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    cin = 3
    for idx, c, k in zip(ALEX_CONV_INDEX, ALEX_CHANNELS, (11, 5, 3, 3, 3)):
        sd[f"features.{idx}.weight"] = torch.randn(c, cin, k, k, generator=g) * (1 / (cin * k * k)) ** 0.5
        sd[f"features.{idx}.bias"] = 0.1 * torch.randn(c, generator=g)
        cin = c
    sd["classifier.1.weight"] = torch.randn(4096, 9216, generator=g)
    return sd


def _lins(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
            for i, c in enumerate(ALEX_CHANNELS)}


def _full_lpips(alex: dict, lins: dict) -> dict:
    """``lpips.LPIPS(net='alex').state_dict()`` layout: ``net.sliceK.N``
    backbone keys with the global features index, the scaling layer's
    buffers and the heads."""
    slice_of = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    sd = {"scaling_layer.shift": torch.zeros(1, 3, 1, 1), "scaling_layer.scale": torch.ones(1, 3, 1, 1)}
    for k, v in alex.items():
        if k.startswith("features."):
            idx = int(k.split(".")[1])
            sd[f"net.slice{slice_of[idx]}.{idx}.{k.split('.')[2]}"] = v
    return {**sd, **lins}


@pytest.mark.parametrize("layout", ["full", "lins_and_backbone", "torchvision", "torchvision_lins"])
def test_loaders_agree_in_every_layout(tmp_path, images, layout):
    alex, lins = _alexnet(1), _lins(2)
    path, backbone = str(tmp_path / "lpips.pth"), None
    if layout == "full":
        torch.save(_full_lpips(alex, lins), path)
    elif layout == "lins_and_backbone":
        torch.save(lins, path)
        backbone = str(tmp_path / "alexnet.pth")
        torch.save(alex, backbone)
    else:
        torch.save({**alex, **(lins if layout == "torchvision_lins" else {})}, path)
    port = load_torch_lpips(path, backbone)
    jv = jax.tree_util.tree_map(np.asarray, jax_load(path, backbone))
    converted = lpips_state_dict_from_jax(jv)
    assert set(converted) == set(port) == set(LPIPS().state_dict())
    for k in port:
        assert torch.equal(converted[k], port[k]), k
    for idx in ALEX_CONV_INDEX:
        assert torch.equal(port[f"net.features.{idx}.weight"], alex[f"features.{idx}.weight"])
    uniform = layout == "torchvision"
    for i, c in enumerate(ALEX_CHANNELS):
        want = torch.full((c,), 1.0 / c) if uniform else lins[f"lin{i}.model.1.weight"][0, :, 0, 0]
        assert torch.equal(port[f"lin{i}"], want)

    a, b = images
    got = _port_dist(load_lpips(path, backbone, "cpu"), a, b)
    want = np.asarray(JaxLPIPS(jax_load(path, backbone))(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_heads_only_checkpoint_needs_a_backbone(tmp_path):
    path = str(tmp_path / "alex.pth")
    torch.save(_lins(0), path)
    for load in (load_torch_lpips, jax_load):
        with pytest.raises(ValueError, match="carries no AlexNet backbone weights"):
            load(path)


def test_jax_random_variables_carried_across(images):
    """JAX's own random fallback, carried across, gives JAX's distances;
    a pair of equal images is 0 and distinct ones are not."""
    jlp = JaxLPIPS()
    sd = lpips_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jlp.variables))
    lp = LPIPS()
    lp.load_state_dict(sd, strict=True)
    a, b = images
    got = _port_dist(lp.eval(), a, b)
    want = np.asarray(jlp(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got > 0).all()
    np.testing.assert_allclose(_port_dist(lp, a, a), 0.0, atol=1e-6)


def test_port_random_fallback():
    """lecun-normal kernels (std within 5% of sqrt(1/fan_in)), zero biases,
    uniform heads; the same seed gives the same bits, drawn without
    touching torch's global generator."""
    state = torch.get_rng_state()
    sd = random_lpips_state_dict(0)
    assert torch.equal(torch.get_rng_state(), state)
    for idx in ALEX_CONV_INDEX:
        w = sd[f"net.features.{idx}.weight"]
        target = (1.0 / w[0].numel()) ** 0.5
        assert abs(w.std().item() / target - 1) < 0.05, idx
        assert not sd[f"net.features.{idx}.bias"].any()
    for i, c in enumerate(ALEX_CHANNELS):
        assert torch.equal(sd[f"lin{i}"], torch.full((c,), 1.0 / c))
    again = random_lpips_state_dict(0)
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
