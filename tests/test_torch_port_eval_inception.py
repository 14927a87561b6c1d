"""The port's InceptionV3 against the JAX package's: the same variables
carried across by the converter, the same seeded images (NHWC into JAX,
NCHW into the port), the same features and probabilities; both packages'
torchvision loaders on one written state dict.

Bars (measured on an Intel Xeon CPU, seed 0, b=2 at 128 px: features differ by
1.9e-6 of their largest magnitude, logits by 4.8e-6 absolute (max |logit|
2.9), probabilities by 4.7e-8): features and logits 1e-5 relative to the
largest magnitude, probabilities 1e-6 absolute."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.eval.inception import InceptionV3 as JaxInceptionV3
from layout2img_tpu.eval.inception import load_torch_inception_v3 as jax_load
from layout2img_tpu.eval.inception import random_inception_variables
from layout2img_tpu_torch.eval.inception import (InceptionV3, load_inception,
                                                 load_torch_inception_v3)
from layout2img_tpu_torch.eval.metrics import run_inception
from layout2img_tpu_torch.utils.convert import inception_state_dict_from_jax
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

REL, PROB_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax_apply():
    """One jitted JAX forward with the softmax, shared by the file's tests
    (its compile is the costly part)."""
    net = JaxInceptionV3()

    @jax.jit
    def apply(variables, x):
        f, logits = net.apply(variables, x)
        return f, logits, jax.nn.softmax(logits, -1)

    return lambda v, x: tuple(np.asarray(a) for a in apply(v, jnp.asarray(x)))


@pytest.fixture(scope="module")
def jax_variables():
    return jax.tree_util.tree_map(np.asarray, random_inception_variables(0))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)


def _port(net: InceptionV3, images_nhwc: np.ndarray):
    with torch.inference_mode():
        f, logits = net(torch.from_numpy(images_nhwc).permute(0, 3, 1, 2))
    return f.numpy(), logits.numpy(), torch.softmax(logits, -1).numpy()


def _close(got, want) -> None:
    for g, w, kind in zip(got, want, ("features", "logits", "probabilities")):
        assert g.shape == w.shape, kind
        err = np.abs(g - w).max()
        bar = PROB_ATOL if kind == "probabilities" else REL * np.abs(w).max()
        assert err <= bar, f"{kind}: {err:.3e} > {bar:.3e}"


def test_names_are_torchvision_inception_v3():
    """Every key the JAX loader reads from a torchvision dict (minus
    ``AuxLogits``) is the port's, and nothing else."""
    keys = set(InceptionV3().state_dict())
    assert "Mixed_7c.branch3x3dbl_3b.bn.running_var" in keys
    assert "fc.weight" in keys and not any(k.startswith("AuxLogits") for k in keys)
    assert sum(k.endswith("conv.weight") for k in keys) == 94


def test_carried_jax_variables_match(jax_apply, jax_variables, images):
    sd = inception_state_dict_from_jax(jax_variables)
    net = InceptionV3()
    net.load_state_dict(sd, strict=True)
    got = _port(net.eval(), images)
    want = jax_apply(jax_variables, images)
    _close(got, want)
    assert got[0].shape == (2, 2048) and got[2].shape == (2, 1000)
    # run_inception (NHWC numpy chunks, a ragged tail, the softmax inside) gives the same
    feats, probs = run_inception(net, np.concatenate([images, images[:1]]), batch_size=2)
    np.testing.assert_allclose(feats[:2], got[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(feats[2], got[0][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs[:2], got[2], rtol=0, atol=1e-7)


def _torchvision_dict(seed: int) -> dict:
    """A seeded state dict in torchvision ``inception_v3`` form: the net's
    keys plus ``AuxLogits.*``, BN statistics away from identity."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("conv.weight"):
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    sd["AuxLogits.conv0.conv.weight"] = torch.randn(128, 768, 1, 1, generator=g)
    sd["AuxLogits.fc.weight"] = torch.randn(1000, 768, generator=g)
    return sd


def test_torchvision_loaders_agree(tmp_path, jax_apply, images):
    """Both packages load one written torchvision dict; the same features;
    the converter on the JAX import gives the written dict back, key for key
    (minus ``AuxLogits.*`` and ``num_batches_tracked``)."""
    path = str(tmp_path / "inception_v3.pth")
    written = _torchvision_dict(3)
    torch.save(written, path)
    loaded = load_torch_inception_v3(path)
    assert not any(k.startswith("AuxLogits") for k in loaded)
    net = load_inception(path, "cpu")  # strict
    jv = jax.tree_util.tree_map(np.asarray, jax_load(path))
    _close(_port(net, images), jax_apply(jv, images))

    converted = inception_state_dict_from_jax(jv)
    want = {k: v for k, v in written.items()
            if not k.startswith("AuxLogits") and not k.endswith("num_batches_tracked")}
    assert set(k for k in converted if not k.endswith("num_batches_tracked")) == set(want)
    for k, v in want.items():
        assert torch.equal(converted[k], v), k
