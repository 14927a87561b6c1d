"""The port's serving artifact (``cli.export``, a ``torch.export`` program)
against the eager generator and the JAX package's generator, on the CPU.

For ``lostgan`` (the v1 mask trunk) and ``context_app_v2`` (context
attention and stage masks), both at 64 px, ch=8, 184 classes, b=2, o=8, from
seeded random weights (``cli.export`` without ``--ckpt_dir``): the artifact,
written and loaded back with ``torch.export.load``, equals the eager
generator on ``latents_from_seed``'s latents at 1e-6 (the same ops on the
same inputs; on the CPU the ISLA norms are their plain versions), and JAX's
generator (``gen.apply(..., train=False, update_stats=False)``) with the
same weights, read by the JAX package's importer, on the same latents
equals it at 2e-3 (the PARITY.md bar). Seeds 0 and 1 give other images.
"""

import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.utils.torch_import import import_lostgan_generator
from layout2img_tpu_torch.cli import export as export_cli
from layout2img_tpu_torch.cli.presets import experiment
from layout2img_tpu_torch.sample import latents_from_seed
from layout2img_tpu_torch.utils.convert import init_generator
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)

CH, SIZE, B, NC = 8, 64, 2, 184
MODELS = ["lostgan", "context_app_v2"]
TOL_EAGER, TOL_JAX = 1e-6, 2e-3
_BUILT = {}


def built(model: str, tmp_path_factory):
    """(loaded artifact module, eager generator, batch) for ``model``, once."""
    if model not in _BUILT:
        path = str(tmp_path_factory.mktemp(model) / "G.pt2")
        export_cli.main(["--model", model, "--dataset", "synthetic", "--img_size", str(SIZE),
                         "--ch", str(CH), "--batch_size", str(B), "--out", path,
                         "--device", "cpu"])
        gen = init_generator(0, NC, preset=experiment(model).gen_preset, device="cpu", ch=CH,
                             image_size=SIZE).eval()
        boxes, labels = export_cli.run_layouts(B, 8, NC)
        batch = (torch.from_numpy(boxes), torch.from_numpy(labels).long())
        _BUILT[model] = (torch.export.load(path).module(), gen, batch)
    return _BUILT[model]


@pytest.mark.parametrize("model", MODELS)
def test_artifact_equals_the_eager_generator(model, tmp_path_factory):
    served, gen, (boxes, labels) = built(model, tmp_path_factory)
    outs = []
    for seed in (0, 1):
        seed_t = torch.tensor([seed])
        z, z_im = latents_from_seed(seed_t, B, 8)
        with torch.no_grad():
            got = served(boxes, labels, seed_t)
            want = gen(z, boxes, labels, z_im)
        assert got.shape == (B, 3, SIZE, SIZE) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL_EAGER, rtol=0)
        outs.append(got)
    assert (outs[0] - outs[1]).abs().max().item() > 1e-3


@pytest.mark.parametrize("model", MODELS)
def test_artifact_equals_the_jax_generator(model, tmp_path_factory):
    served, gen, (boxes, labels) = built(model, tmp_path_factory)
    jax_gen = jax_make_generator(experiment(model).gen_preset, NC, ch=CH, image_size=SIZE)
    variables = jax.tree_util.tree_map(np.asarray, import_lostgan_generator(gen.state_dict()))
    seed_t = torch.tensor([3])
    z, z_im = latents_from_seed(seed_t, B, 8)
    want = fast_jit(lambda v, *a: jax_gen.apply(v, *a, train=False, update_stats=False))(
        variables, z.numpy(), boxes.numpy(), labels.numpy().astype(np.int32), z_im.numpy())
    with torch.no_grad():
        got = served(boxes, labels, seed_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=TOL_JAX,
                               rtol=0)
