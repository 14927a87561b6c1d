"""The PyTorch port's Ours-D 128px generator against the JAX package's, on the CPU.

One JAX ``ours_d_context128`` generator (ch=4, 10 classes, b=2, o=8 with
pad slots) is initialized per module, its BN statistics and alphas moved
away from 0/1. Its weights reach the port through
``utils.convert.generator_state_dict_from_jax``, which must equal
``layout2img_tpu.utils.torch_export.export_lostgan_generator`` key for key.
The full eval forward, with z injected, must agree to 2e-3 (the PARITY.md
bar; in practice the difference is f32 round-off). A ``.pth`` written the
way ``layout2img_tpu.cli.export_torch`` writes one drives the port's
sampling CLI on the CPU.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.utils.torch_export import export_lostgan_generator
from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.data.synthetic import PAD_BOX, synthetic_layouts
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.sample import cast_floating, make_sample_fn
from layout2img_tpu_torch.utils.convert import generator_state_dict_from_jax, init_generator
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

TOL = 2e-3
CH, NC, B, O, N_VALID = 4, 10, 2, 8, 5


@pytest.fixture(scope="module")
def jax_gen():
    """(JAX module, perturbed numpy variables, numpy inputs)."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 0.5, (B, O, 2))
    wh = rng.uniform(0.05, 0.45, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.integers(1, NC, (B, O)).astype(np.int32)
    labels[:, N_VALID:] = 0
    boxes[:, N_VALID:] = PAD_BOX
    z = rng.standard_normal((B, O, 128)).astype(np.float32)
    z_im = rng.standard_normal((B, 128)).astype(np.float32)
    gen = jax_make_generator("ours_d_context128", NC, ch=CH, num_mask_classes=NC)
    variables = jax.jit(gen.init)(jax.random.PRNGKey(0), z, boxes, labels, z_im)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda s: s + rng.uniform(0.1, 0.5, s.shape).astype(s.dtype), variables["batch_stats"])
    for k in [k for k in variables["params"] if k.startswith("alpha")]:
        variables["params"][k] = rng.uniform(-2, 2, variables["params"][k].shape).astype(np.float32)
    return gen, variables, dict(z=z, boxes=boxes, labels=labels, z_im=z_im)


@pytest.fixture(scope="module")
def port_gen(jax_gen):
    _, variables, _ = jax_gen
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, num_mask_classes=NC)
    gen.load_state_dict(generator_state_dict_from_jax(variables), strict=True)
    return gen


def _t(a):
    return torch.from_numpy(np.array(a))


def test_state_dict_matches_reference_export(jax_gen):
    _, variables, _ = jax_gen
    ours = generator_state_dict_from_jax(variables)
    ref = export_lostgan_generator(variables)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_reference_export_loads_strict(jax_gen):
    _, variables, _ = jax_gen
    ref = {k: _t(v) for k, v in export_lostgan_generator(variables, prefix="module.").items()}
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, num_mask_classes=NC)
    gen.load_state_dict({k.removeprefix("module."): v for k, v in ref.items()}, strict=True)
    assert gen.alpha1.shape == (1, NC, 1)
    assert gen.res1.b1.batch_norm2d.running_mean.shape == (16 * CH,)


def test_forward_matches_jax(jax_gen, port_gen):
    gen, variables, inp = jax_gen
    apply = jax.jit(functools.partial(gen.apply, train=False, update_stats=False))
    want = apply(variables, inp["z"], inp["boxes"], inp["labels"], inp["z_im"])
    with torch.inference_mode():
        got = port_gen(_t(inp["z"]), _t(inp["boxes"]), _t(inp["labels"]).long(), _t(inp["z_im"]))
    assert got.shape == (B, 3, 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_obj_budget_gives_the_same_images(jax_gen, dtype):
    _, _, inp = jax_gen
    gen = init_generator(0, NC, device="cpu", ch=CH, num_mask_classes=NC)
    cast_floating(gen, dtype)
    boxes, labels = _t(inp["boxes"]), _t(inp["labels"])
    # shuffle the pad slots in among the valid ones: compaction must reorder
    perm = torch.tensor([0, 5, 1, 6, 2, 3, 7, 4])
    boxes, labels = boxes[:, perm], labels[:, perm]
    full = make_sample_fn(gen, dtype=dtype)(boxes, labels, torch.Generator().manual_seed(7))
    budget = make_sample_fn(gen, dtype=dtype, obj_budget=N_VALID)(
        boxes, labels, torch.Generator().manual_seed(7))
    assert full.dtype == dtype and full.shape == (B, 3, 128, 128)
    assert torch.isfinite(full.float()).all() and full.abs().max() <= 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(budget.float(), full.float(), atol=tol, rtol=0)


def test_sample_fn_latents_come_from_the_generator(port_gen):
    rng = np.random.default_rng(0)
    layout = synthetic_layouts(rng, B, O, NC)
    sample = make_sample_fn(port_gen)
    boxes, labels = _t(layout["boxes"]), _t(layout["labels"])
    a = sample(boxes, labels, torch.Generator().manual_seed(1))
    b = sample(boxes, labels, torch.Generator().manual_seed(1))
    c = sample(boxes, labels, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3


def test_synthetic_layouts_pad_convention():
    layout = synthetic_layouts(np.random.default_rng(0), 4, 31, 179, max_objects=6)
    labels, boxes = layout["labels"], layout["boxes"]
    assert labels.shape == (4, 31) and boxes.shape == (4, 31, 4)
    valid = labels != 0
    assert (valid.sum(1) >= 3).all() and (valid.sum(1) <= 6).all()
    assert (labels < 179).all()
    np.testing.assert_array_equal(boxes[~valid], np.tile(np.float32(PAD_BOX), ((~valid).sum(), 1)))
    # valid slots sit at the front
    assert all(valid[i, : valid[i].sum()].all() for i in range(4))


def test_cli_samples_an_exported_pth(jax_gen, tmp_path):
    _, variables, _ = jax_gen
    pth = tmp_path / "G.pth"
    # what `python -m layout2img_tpu.cli.export_torch --out_g` writes
    torch.save({k: torch.from_numpy(np.array(v, copy=True))
                for k, v in export_lostgan_generator(variables).items()}, pth)
    out = tmp_path / "samples"
    sample_cli.main(["--weights", str(pth), "--dataset", "synthetic", "--sample_path", str(out),
                     "--num_img", "1", "--batch_size", "2", "--obj_budget", "6",
                     "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert len(names) == 2 * sample_cli.SYNTHETIC_BATCHES
    assert names[0] == "sample0_numb0.jpg"
    from PIL import Image

    with Image.open(out / names[0]) as im:
        assert im.size == (128, 128) and im.mode == "RGB"
