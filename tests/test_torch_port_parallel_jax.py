"""The port's LostGAN step under 2 ranks (gloo, on the CPU) against JAX's
step on a 2-device CPU mesh (``jit_train_step(make_mesh(jax.devices("cpu")
[:2]))``, the JAX package's data-parallel path), from the same weights
(the port's seeded draws, read into JAX by its importer, with the stage
masks' alphas drawn in [-2, 2]; JAX's variables go back through the
converter) and the same latents: ``ours_d_context128`` +
``d128_app`` at ch=4, 64 px, 4 layouts (2 per rank and per device) with pad
slots, f32, VGG off, dropout off. The JAX step is
``test_torch_port_train.py``'s line-for-line copy of
``layout2img_tpu/train/step.py`` with z and z_im injected (they ride in the
sharded batch), compiled at XLA's lowest backend optimization level; the
port's ranks take JAX's latents through ``.with_latents``. Bars of the one-device parity tests: losses 2e-3;
parameters within 2 lr of JAX's, under 1% of elements beyond 1e-6; SN
vectors and BN statistics to 1e-5 (1e-4 for the PSP bottleneck BN and the
app head's class embedding). Both ranks end with the same bits. The same
inputs also go through the port's 2-D mesh (one model group of 2 ranks, in
tensor and then in spatial mode, ``torch_parallel_ranks.given2d_rank``),
held to the same JAX step at the same bars: JAX's own tests hold its 2-D
step to its one-device step (``tests/test_train_step.py``), so the one
compile serves all three."""

import numpy as np
import pytest
import torch

import jax

import torch_parallel_ranks as ranks
from layout2img_tpu.models.discriminators import make_discriminator as jax_make_discriminator
from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.parallel.mesh import jit_train_step, make_mesh, replicate, shard_batch
from layout2img_tpu.utils.torch_import import import_lostgan_discriminator, import_lostgan_generator
from layout2img_tpu_torch.data.synthetic import synthetic_batch
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.train.state import TrainConfig
from layout2img_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                                generator_state_dict_from_jax, init_discriminator,
                                                init_generator)
from test_torch_port_step_knobs import FAST_COMPILE
from test_torch_port_train import _jax_step

NC, CH, IMG, O, B, LR = ranks.NC, ranks.CH, ranks.IMG, ranks.O, 2 * ranks.B_RANK, 1e-4


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    rng = np.random.default_rng(7)
    batch = synthetic_batch(rng, B, IMG, O, NC)
    batch["labels"][:, 4:] = 0
    batch["boxes"][:, 4:] = (-0.6, -0.6, 0.5, 0.5)
    z = rng.standard_normal((B, O, 128)).astype(np.float32)
    z_im = rng.standard_normal((B, 128)).astype(np.float32)
    images = batch["images"].transpose(0, 2, 3, 1)
    jgen = jax_make_generator("ours_d_context128", NC, ch=CH, image_size=IMG, num_mask_classes=NC)
    jdisc = jax_make_discriminator("d128_app", NC, ch=CH, image_size=IMG)
    # the port's seeded draws (cli.train's), read into JAX by its importer
    g_vars = import_lostgan_generator(init_generator(
        0, NC, device="cpu", ch=CH, image_size=IMG, num_mask_classes=NC).state_dict())
    d_vars = import_lostgan_discriminator(init_discriminator(
        1, NC, device="cpu", ch=CH, image_size=IMG).state_dict())
    g_vars = jax.tree_util.tree_map(np.asarray, dict(g_vars))
    d_vars = jax.tree_util.tree_map(np.asarray, dict(d_vars))
    for k in [k for k in g_vars["params"] if k.startswith("alpha")]:
        g_vars["params"][k] = rng.uniform(-2, 2, g_vars["params"][k].shape).astype(np.float32)
    cfg = TrainConfig(use_vgg_loss=False)

    def step(state, sharded, rng_key):
        out = _jax_step(jgen, jdisc, *state, {k: sharded[k] for k in ("images", "boxes", "labels")},
                        sharded["z"], sharded["z_im"], cfg)
        return (out[0], out[1]), out[4]

    res_start = make_generator("ours_d_context128", NC, device="cpu", ch=CH, image_size=IMG,
                               num_mask_classes=NC).res_start
    # the ranks run while JAX compiles
    out = tmp_path_factory.mktemp("given")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb["labels"] = tb["labels"].long()
    torch.save({"g_sd": generator_state_dict_from_jax(g_vars, res_start=res_start),
                "d_sd": discriminator_state_dict_from_jax(d_vars), "batch": tb,
                "z": torch.from_numpy(z), "z_im": torch.from_numpy(z_im)}, out / "inputs.pt")
    ctx = ranks.start_ranks(ranks.given_rank, 2, str(out / "inputs.pt"), str(out))
    ctx2d = ranks.start_ranks(ranks.given2d_rank, 2, str(out / "inputs.pt"), str(out))
    try:
        mesh = make_mesh(jax.devices("cpu")[:2])
        jbatch = {"images": images, "boxes": batch["boxes"], "labels": batch["labels"], "z": z,
                  "z_im": z_im}
        args = (replicate(mesh, (g_vars, d_vars)), shard_batch(mesh, jbatch),
                replicate(mesh, jax.random.PRNGKey(0)))
        (new_g, new_d), metrics = jit_train_step(step, mesh, donate_state=False).lower(
            *args).compile(FAST_COMPILE)(*args)
        want = {"generator": generator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_g),
                                                           res_start=res_start),
                "discriminator": discriminator_state_dict_from_jax(
                    jax.tree_util.tree_map(np.asarray, new_d)),
                "metrics": {k: float(v) for k, v in metrics.items()}}
    finally:
        ranks.wait_ranks(ctx, timeout=60)
        ranks.wait_ranks(ctx2d, timeout=60)
    return (want, [torch.load(out / f"given.{r}.pt") for r in range(2)],
            {mode: torch.load(out / f"given2d.{mode}.pt") for mode in ("tensor", "spatial")})


def test_two_rank_losses_match_the_jax_mesh_step(both):
    want, got, _ = both
    assert set(got[0]["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert abs(got[0]["metrics"][k] - v) <= 2e-3, (k, got[0]["metrics"][k], v)
    assert got[0]["metrics"] == got[1]["metrics"]


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_two_rank_params_and_state_match_the_jax_mesh_step(both, net):
    want, got, _ = both
    for name, t in got[0][net].items():
        assert torch.equal(t, got[1][net][name]), f"{name} differs across the ranks"
    _hold_net(got[0][net], want[net])


@pytest.mark.parametrize("mode", ["tensor", "spatial"])
def test_mesh2d_losses_match_the_jax_mesh_step(both, mode):
    want, _, got = both
    assert set(got[mode]["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert abs(got[mode]["metrics"][k] - v) <= 2e-3, (k, got[mode]["metrics"][k], v)


@pytest.mark.parametrize("mode", ["tensor", "spatial"])
@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_mesh2d_params_and_state_match_the_jax_mesh_step(both, mode, net):
    """The 2-D mesh's networks, gathered whole, against JAX's."""
    want, _, got = both
    _hold_net(got[mode][net], want[net])


def _hold_net(got: dict, want: dict) -> None:
    """A state dict against JAX's converted one at the parity tests' bars."""
    beyond = total = 0
    for name, t in got.items():
        w = want[name].numpy()
        if name.endswith(("weight_u", "running_mean", "running_var")):
            loose = name.startswith(("res4.conv_mask.0.bottleneck.", "l_y_app."))
            np.testing.assert_allclose(t.numpy(), w, atol=1e-4 if loose else 1e-5, rtol=0,
                                       err_msg=name)
        elif t.is_floating_point() and not name.endswith(("weight_v", "num_batches_tracked")):
            diff = np.abs(t.numpy() - w)
            assert diff.max() <= 2 * LR, (name, diff.max())
            beyond += int((diff > 1e-6).sum())
            total += diff.size
    assert beyond < 0.01 * total, (beyond, total)
