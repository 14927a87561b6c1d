"""Train step and sampler of the two-stream Ours-ED family (counterpart of
``layout2img_tpu/train/step_bgfg.py``).

The fg/bg latents and layouts (``data.coco.split_fg_bg_batch``) feed the two
streams of ``BgFgGenerator``; the 64px discriminator (``d64``, no app head)
critiques the composite against the full layout. As in the JAX step:

- the generator forward runs once, in training mode;
- D update: D on the real batch, then on the detached fake; hinge on the
  object scores (masked to the full layout's valid objects, weight
  ``lamb_obj``) and on the image scores (``lamb_img``); Adam steps D;
- G update against the updated D: the adversarial object and image terms,
  the L1 pixel loss and the VGG perceptual loss;
- f32 throughout. ``TrainConfig.mixed_precision`` is accepted and has no
  effect, as in the JAX step, which never reads it; the other knobs of
  ``TrainConfig`` (EMA, budgets, fused D, remat) have no path here either.

Latents: z_fg, z_bg (b, o, z_dim), z_im_fg, z_im_bg (b, z_dim), standard
normal draws from the step's ``torch.Generator`` in that order (the JAX
step's order of keys), each drawn for the global batch and cut to the
rank's rows under a data-parallel mesh (``train/step.py::global_normal``);
the sampler draws them truncated to ``[-truncation, truncation]``.
"""

from __future__ import annotations

from typing import Callable

import torch

from layout2img_tpu_torch.losses.gan import g_adv, hinge_d_fake, hinge_d_real
from layout2img_tpu_torch.models.generators import BgFgGenerator
from layout2img_tpu_torch.train.state import GANTrainState, TrainConfig, _adam
from layout2img_tpu_torch.parallel import mesh as data_mesh
from layout2img_tpu_torch.train.step import _apply_grads, global_normal

STREAM_KEYS = ("labels_fg", "boxes_fg", "labels_bg", "boxes_bg")


def create_bgfg_state(generator: BgFgGenerator, discriminator: torch.nn.Module,
                      config: TrainConfig) -> GANTrainState:
    """Wrap initialized networks (``utils.convert.init_bgfg_generator`` and
    ``init_discriminator(preset="d64")``, or loaded state dicts) with fresh
    Adams."""
    return GANTrainState(generator, discriminator, _adam(generator, config.g_lr, config),
                         _adam(discriminator, config.d_lr, config))


def make_bgfg_train_step(state: GANTrainState, config: TrainConfig,
                         vgg_loss: Callable | None = None) -> Callable:
    """Returns ``train_step(batch, rng) -> metrics``; ``train_step.with_latents(
    batch, z_fg, z_bg, z_im_fg, z_im_bg)`` is the same step with the latents
    given. batch: ``images`` (b, 3, 64, 64), ``labels``, ``boxes`` and the
    streams' ``labels_fg``, ``boxes_fg``, ``labels_bg``, ``boxes_bg``, on
    the networks' device. Metrics are f32 scalar tensors, detached."""
    gen, disc = state.generator, state.discriminator
    g_params, d_params = list(gen.parameters()), list(disc.parameters())

    def with_latents(batch: dict, z_fg: torch.Tensor, z_bg: torch.Tensor, z_im_fg: torch.Tensor,
                     z_im_bg: torch.Tensor) -> dict[str, torch.Tensor]:
        images, boxes, labels = batch["images"], batch["boxes"], batch["labels"]
        valid = (labels != 0).to(torch.float32)
        gen.train()
        disc.train()
        fake = gen(z_fg, batch["boxes_fg"], batch["labels_fg"], z_bg, batch["boxes_bg"],
                   batch["labels_bg"], z_im_fg, z_im_bg, deterministic=False)

        # ---- D update ----
        out_r = disc(images, boxes, labels)
        out_f = disc(fake.detach(), boxes, labels)
        d_loss = (config.lamb_obj * (hinge_d_real(out_r["object"], valid)
                                     + hinge_d_fake(out_f["object"], valid))
                  + config.lamb_img * (hinge_d_real(out_r["image"]) + hinge_d_fake(out_f["image"])))
        _apply_grads(state.d_opt, d_params, d_loss, "d")

        # ---- G update, against the updated D ----
        out_g = disc(fake, boxes, labels)
        metrics = {"g_loss_fake": g_adv(out_g["image"]),
                   "g_loss_obj": g_adv(out_g["object"], valid)}
        g_loss = config.lamb_obj * metrics["g_loss_obj"] + config.lamb_img * metrics["g_loss_fake"]
        if config.use_pixel_loss:
            metrics["pixel_loss"] = (fake - images).abs().mean()
            g_loss = g_loss + metrics["pixel_loss"]
        if config.use_vgg_loss and vgg_loss is not None:
            metrics["feat_loss"] = vgg_loss(fake, images)
            g_loss = g_loss + metrics["feat_loss"]
        _apply_grads(state.g_opt, g_params, g_loss, "g")
        state.step += 1
        return data_mesh.current().mean_metrics(
            {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
             **{k: v.detach() for k, v in metrics.items()}})

    def train_step(batch: dict, rng: torch.Generator) -> dict[str, torch.Tensor]:
        b, o = batch["labels"].shape
        dev = batch["labels"].device
        z, f32 = gen.z_dim, torch.float32
        return with_latents(batch, global_normal(rng, (b, o, z), f32, dev),
                            global_normal(rng, (b, o, z), f32, dev),
                            global_normal(rng, (b, z), f32, dev), global_normal(rng, (b, z), f32, dev))

    train_step.with_latents = with_latents
    return train_step


def make_bgfg_sample_fn(generator: BgFgGenerator, truncation: float = 2.0,
                        dtype: torch.dtype = torch.float32) -> Callable:
    """``sample(batch, rng) -> (b, 3, 64, 64)`` images in [-1, 1]: the
    generator in eval mode (running BN statistics) on truncated-normal
    latents, z_fg, z_bg, z_im_fg, z_im_bg in that order. ``batch`` holds
    ``labels`` and the streams' keys (``split_fg_bg_batch``), tensors or
    arrays; ``generator`` already holds its weights in ``dtype`` (bf16
    serves with bf16 latents; boxes stay f32). The generator's mode is
    restored after each call. Under a data-parallel mesh the batch is this
    rank's rows and each latent its rows of the global draw."""
    from layout2img_tpu_torch.sample import global_truncated_normal as draw

    @torch.no_grad()
    def sample(batch: dict, rng: torch.Generator) -> torch.Tensor:
        device = next(generator.parameters()).device
        t = {k: torch.as_tensor(batch[k]).to(device) for k in STREAM_KEYS}
        for k in ("labels_fg", "labels_bg"):
            t[k] = t[k].long()
        for k in ("boxes_fg", "boxes_bg"):
            t[k] = t[k].float()
        b, o = t["labels_fg"].shape
        z = generator.z_dim
        z_fg, z_bg = (draw((b, o, z), truncation, rng, device, dtype) for _ in range(2))
        z_im_fg, z_im_bg = (draw((b, z), truncation, rng, device, dtype) for _ in range(2))
        was_training = generator.training
        generator.eval()
        try:
            return generator(z_fg, t["boxes_fg"], t["labels_fg"], z_bg, t["boxes_bg"],
                             t["labels_bg"], z_im_fg, z_im_bg)
        finally:
            generator.train(was_training)

    return sample
