"""Every generator preset of the port against the JAX package's, on the CPU.

For each of the JAX package's nine presets (``layout2img_tpu/models/
generators.py``), at ch=4, 10 classes, b=2, o=8 with three pad slots and
the preset's own image size: the port's seeded generator, with its biases,
BN statistics and alphas moved away from their initial 0 and 1, is written
as a reference-format dict and read into JAX variables by the JAX
package's importer (``layout2img_tpu.utils.torch_import``; this spares a
JAX ``init`` compile per preset). From those variables:

- ``utils.convert.generator_state_dict_from_jax`` equals
  ``layout2img_tpu.utils.torch_export.export_lostgan_generator`` key for
  key (``res_start=2`` for the 64px ``lostgan64``, whose blocks the
  reference names ``res2..res5``), gives back the port's dict, and loads
  into the port's preset with ``strict=True``. For ``context128_nogeo``
  the round trip carries ``context.WGs.*``, which the reference's nogeo
  module and ``.pth`` files have (unused); a JAX-initialized nogeo tree
  has no ``geo_proj``, and there the JAX exporter raises while the
  converter writes zeros (``test_nogeo_export_gap_of_the_jax_package``);
- the eval forward agrees to 2e-3 (the PARITY.md bar);
- a training-mode forward (batch-statistics BNs, one spectral-norm power
  iteration per layer, dropout off as JAX's ``deterministic=True``) agrees
  to 2e-3, and the BN running statistics and SN u vectors after it agree
  to 1e-5, except those of the PSP head's bottleneck BN, downstream of the
  1x1 pyramid stage whose BN amplifies round-off at b=2, held to 1e-4 as
  ``tests/test_torch_port_train.py`` holds them.
"""

import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.utils.torch_export import export_lostgan_generator
from layout2img_tpu.utils.torch_import import import_lostgan_generator
from layout2img_tpu_torch.data.synthetic import PAD_BOX
from layout2img_tpu_torch.models.generators import _GENERATOR_PRESETS, make_generator
from layout2img_tpu_torch.utils.convert import generator_state_dict_from_jax, init_generator
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)

TOL = 2e-3
LOOSE_STATE = "res4.conv_mask.0.bottleneck."  # the PSP head's bottleneck BN at 128 px
CH, NC, B, O, N_VALID = 4, 10, 2, 8, 5
PRESETS = sorted(_GENERATOR_PRESETS)


def _t(a):
    return torch.from_numpy(np.array(a))


def res_start(preset: str) -> int:
    return 2 if preset == "lostgan64" else 1


def inputs(seed: int) -> dict:
    """Boxes (some overlapping, three pad slots per layout), labels, z, z_im."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (B, O, 2))
    wh = rng.uniform(0.05, 0.45, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.integers(1, NC, (B, O)).astype(np.int32)
    labels[:, N_VALID:] = 0
    boxes[:, N_VALID:] = PAD_BOX
    labels[0, 1] = labels[0, 0]  # two objects of one class (the GCN's edges)
    z = rng.standard_normal((B, O, 128)).astype(np.float32)
    z_im = rng.standard_normal((B, 128)).astype(np.float32)
    return dict(z=z, boxes=boxes, labels=labels, z_im=z_im)


def moved_state(sd: dict, seed: int) -> dict:
    """The dict with biases and alphas drawn and BN statistics moved off
    their initial 0 and 1, so that every path carries signal."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            v = v + torch.from_numpy(rng.uniform(0.1, 0.5, v.shape).astype(np.float32))
        elif k.endswith(".bias"):
            v = torch.from_numpy(rng.normal(0.0, 0.1, v.shape).astype(np.float32))
        elif k.startswith("alpha"):
            v = torch.from_numpy(rng.uniform(-2, 2, v.shape).astype(np.float32))
        out[k] = v
    return out


def jax_variables(preset: str, seed: int = 3):
    """(JAX module, numpy variables, the port's dict they were read from)."""
    port = init_generator(seed, NC, preset=preset, device="cpu", ch=CH, num_mask_classes=NC)
    sd = moved_state(port.state_dict(), seed)
    variables = jax.tree_util.tree_map(np.asarray, import_lostgan_generator(sd))
    return jax_make_generator(preset, NC, ch=CH, num_mask_classes=NC), variables, sd


_CACHE = {}


def setup(preset: str):
    """(JAX module, variables, inputs, port generator, the port's dict),
    built once per preset."""
    if preset not in _CACHE:
        inp = inputs(sum(map(ord, preset)))
        gen, variables, sd = jax_variables(preset)
        port = make_generator(preset, NC, device="cpu", ch=CH, num_mask_classes=NC)
        port.load_state_dict(generator_state_dict_from_jax(variables, res_start=res_start(preset)),
                             strict=True)
        _CACHE[preset] = (gen, variables, inp, port, sd)
    return _CACHE[preset]


_FORWARDS = {}


def jax_forwards(preset: str):
    """JAX's eval forward, and its training-mode forward with the state after
    it, from one compiled function per preset (numpy)."""
    if preset not in _FORWARDS:
        gen, variables, inp, _, _ = setup(preset)

        def both(v, *args):
            return (gen.apply(v, *args, train=False, update_stats=False),
                    gen.apply(v, *args, train=True, update_stats=True, deterministic=True,
                              mutable=["batch_stats", "spectral"]))

        out = fast_jit(both)(variables, inp["z"], inp["boxes"], inp["labels"], inp["z_im"])
        _FORWARDS[preset] = jax.tree_util.tree_map(np.asarray, out)
    return _FORWARDS[preset]


def port_args(inp: dict):
    return _t(inp["z"]), _t(inp["boxes"]), _t(inp["labels"]).long(), _t(inp["z_im"])


@pytest.mark.parametrize("preset", PRESETS)
def test_state_dict_matches_reference_export(preset):
    _, variables, _, port, sd = setup(preset)
    ours = generator_state_dict_from_jax(variables, res_start=res_start(preset))
    ref = export_lostgan_generator(variables, res_start=res_start(preset))
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert set(port.state_dict()) == set(ref) == set(sd)
    for k, v in sd.items():  # the round trip through JAX's importer
        if not k.endswith("weight_v"):  # recomputed from W and u, as the exporter does
            np.testing.assert_array_equal(ours[k].numpy(), v.numpy(), err_msg=k)
    blocks = sorted({k.split(".")[0] for k in ref if k.startswith("res")})
    assert blocks[0] == f"res{res_start(preset)}" and len(blocks) == port.n_blocks


def test_nogeo_export_gap_of_the_jax_package():
    """A JAX-initialized nogeo tree has no ``geo_proj``: the JAX exporter
    raises on it, and the converter writes ``context.WGs.*`` as zeros,
    which is what the exporter gives once a zero ``geo_proj`` is added."""
    gen, variables, inp, _, _ = setup("context128_nogeo")
    init = jax.eval_shape(gen.init, jax.random.PRNGKey(0), inp["z"], inp["boxes"], inp["labels"],
                          inp["z_im"])
    assert "geo_proj" not in init["params"]["context"]
    context = {k: v for k, v in variables["params"]["context"].items() if k != "geo_proj"}
    bare = {**variables, "params": {**variables["params"], "context": context}}
    with pytest.raises(KeyError, match="geo_proj"):
        export_lostgan_generator(bare)
    ours = generator_state_dict_from_jax(bare)
    zero = {"kernel": np.zeros((64, 1), np.float32), "bias": np.zeros((1,), np.float32)}
    ref = export_lostgan_generator({**bare, "params": {**bare["params"],
                                                       "context": {**context, "geo_proj": zero}}})
    assert list(ours) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    port = make_generator("context128_nogeo", NC, device="cpu", ch=CH)
    port.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("preset", PRESETS)
def test_eval_forward_matches_jax(preset):
    _, _, inp, port, _ = setup(preset)
    want = jax_forwards(preset)[0]
    with torch.inference_mode():
        got = port.eval()(*port_args(inp))
    size = port.image_size
    assert got.shape == (B, 3, size, size) and want.shape == (B, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), atol=TOL, rtol=0)


@pytest.mark.parametrize("preset", PRESETS)
def test_train_forward_and_state_match_jax(preset):
    _, variables, inp, port, _ = setup(preset)
    fresh = make_generator(preset, NC, device="cpu", ch=CH, num_mask_classes=NC)
    fresh.load_state_dict(port.state_dict(), strict=True)
    want, new_state = jax_forwards(preset)[1]
    with torch.no_grad():
        got = fresh.train()(*port_args(inp), deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=TOL,
                               rtol=0)
    converted = generator_state_dict_from_jax({**variables, **new_state},
                                              res_start=res_start(preset))
    state = fresh.state_dict()
    checked = 0
    for name, buf in state.items():
        if name.endswith(("running_mean", "running_var", "weight_u")):
            atol = 1e-4 if name.startswith(LOOSE_STATE) else 1e-5
            np.testing.assert_allclose(buf.numpy(), converted[name].numpy(), atol=atol, rtol=0,
                                       err_msg=name)
            checked += 1
    assert checked > 20
    # the state moved: the running statistics folded in a batch
    assert not torch.equal(state["final.0.running_mean"], port.state_dict()["final.0.running_mean"])
