"""The port's train step learns the conditioning task as the JAX step does
(on the CPU).

From the JAX conditioning script's own initial weights (``create_train_state``
with ``PRNGKey(0)``, read into the port by the converter), its batches (the
flagship task, 12 classes, o=4) and JAX's latents (``jax.random.normal`` of
each step's key, handed to the port's ``with_latents``), N steps of the JAX
step and of the port's step run side by side, each with its own optimizer
state, SN vectors and BN statistics carried from step to step. The first
step's losses agree at 1e-3 in f32 and 1e-2 in mixed precision; the color score of the eval batch (eval-mode
generator, the same truncated latents) agrees at 0.05 after every few
steps, however far the trajectories drift apart (a GAN amplifies f32
round-off: the images differ by 0.4 after 200 steps while the scores stay
within 0.01). So a conditioning run's score is the step's, and not a fault
of the port, once the initial weights are the same.

``CONDITIONING_PARITY="steps,ch,batch"`` sets N, the width and the batch
(default "5,4,4": the first step's losses and the scores after steps 1 and
5); the trajectories are printed (``-s``). The JAX step is compiled at
XLA's lowest backend optimization level, which about halves its compile
and agrees with the optimized build at round-off. This file runs the
mixed-precision step (the check's); ``..._f32.py`` the f32 step.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.models.discriminators import LayoutDiscriminator
from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.train.state import TrainConfig as JaxTrainConfig
from layout2img_tpu.train.state import create_train_state as jax_create_train_state
from layout2img_tpu.train.step import make_train_step as jax_make_train_step
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.scripts import train_conditioning_check as check
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                                generator_state_dict_from_jax)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

STEPS, CH, BATCH = (int(v) for v in os.environ.get("CONDITIONING_PARITY", "5,4,4").split(","))
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SCORE_BAR = 0.05
LOSS_BAR = {True: 1e-2, False: 1e-3}  # mixed: bf16 rounds at other places in the two packages


def _torch_batch(b: dict) -> dict:
    return {"images": torch.from_numpy(b["images"]).permute(0, 3, 1, 2).contiguous(),
            "labels": torch.from_numpy(b["labels"]).long(), "boxes": torch.from_numpy(b["boxes"])}


def track(mixed: bool) -> None:
    """Run both steps side by side and hold them to the bars above."""
    a = check.parse_args(["--ch", str(CH), "--batch_size", str(BATCH)])
    palette = check.make_palette(a.num_classes)
    rng = np.random.default_rng(0)
    batches = [check.make_batch(rng, a, palette) for _ in range(8)]
    ev = check.make_batch(rng, a, palette)
    jgen = jax_make_generator(a.preset, a.num_classes, ch=a.ch, image_size=a.img_size,
                              num_mask_classes=a.num_classes)
    jdisc = LayoutDiscriminator(num_classes=a.num_classes, image_size=a.img_size, ch=a.ch,
                                app_head=True)
    jcfg = JaxTrainConfig(use_vgg_loss=False, mixed_precision=mixed)
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jgen, jdisc,
                                    check.make_batch(np.random.default_rng(99), a, palette), jcfg)
    jstep = jax.jit(jax_make_train_step(jgen, jdisc, jcfg)).lower(
        jstate, batches[0], jax.random.PRNGKey(0)).compile(FAST_COMPILE)
    jsample = jax.jit(lambda p, s, *args: jgen.apply({"params": p, **s}, *args, train=False,
                                                      update_stats=False))

    def numpy_vars(params, state):
        return jax.tree_util.tree_map(np.asarray, {"params": params, **state})

    gen = make_generator(a.preset, a.num_classes, device="cpu", ch=a.ch, image_size=a.img_size,
                         num_mask_classes=a.num_classes)
    gen.load_state_dict(generator_state_dict_from_jax(
        numpy_vars(jstate.g_params, jstate.g_state), res_start=2), strict=True)
    disc = make_discriminator("d128_app", a.num_classes, device="cpu", ch=a.ch,
                              image_size=a.img_size)
    disc.load_state_dict(discriminator_state_dict_from_jax(
        numpy_vars(jstate.d_params, jstate.d_state)), strict=True)
    cfg = TrainConfig(use_vgg_loss=False, mixed_precision=mixed)
    step = make_train_step(create_train_state(gen, disc, cfg), cfg)

    z = np.random.default_rng(5).standard_normal((BATCH, a.objects, 128)).clip(-2, 2)
    z_im = np.random.default_rng(6).standard_normal((BATCH, 128)).clip(-2, 2)
    z, z_im = z.astype(np.float32), z_im.astype(np.float32)

    def scores() -> tuple[float, float]:
        want = jsample(jstate.g_params, jstate.g_state, z, ev["boxes"], ev["labels"], z_im)
        gen.eval()
        with torch.no_grad():
            got = gen(*(torch.from_numpy(t) for t in (z, ev["boxes"])),
                      torch.from_numpy(ev["labels"]).long(), torch.from_numpy(z_im))
        return tuple(check.color_score(np.asarray(img), ev["labels"], ev["boxes"], a.img_size,
                                       palette)
                     for img in (want, got.permute(0, 2, 3, 1).numpy()))

    dtype = jnp.bfloat16 if mixed else jnp.float32
    marks = {1, 5, STEPS} | set(range(25, STEPS + 1, 25))
    for i in range(STEPS):
        key = jax.random.PRNGKey(1000 + i)
        batch = batches[(i // 50) % len(batches)]
        jstate, want = jstep(jstate, batch, key)
        rng_z, rng_zim, _ = jax.random.split(key, 3)  # the JAX step's own split
        latents = (np.asarray(jax.random.normal(k, shape, dtype)).astype(np.float32)
                   for k, shape in ((rng_z, (BATCH, a.objects, 128)), (rng_zim, (BATCH, 128))))
        got = step.with_latents(_torch_batch(batch), *(torch.from_numpy(t) for t in latents))
        if i == 0:
            for k in ("d_loss", "g_loss"):
                assert abs(float(got[k]) - float(want[k])) <= LOSS_BAR[mixed] * abs(float(want[k])), k
        if i + 1 in marks:
            s_jax, s_port = scores()
            print(f"step {i + 1}: color score JAX {s_jax:+.3f} port {s_port:+.3f}; d_loss JAX "
                  f"{float(want['d_loss']):.4f} port {float(got['d_loss']):.4f}")
            assert abs(s_jax - s_port) <= SCORE_BAR, (i + 1, s_jax, s_port)


def test_port_mixed_step_tracks_the_jax_step():
    track(mixed=True)
