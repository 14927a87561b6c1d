"""One GAN train step (counterpart of ``layout2img_tpu/train/step.py::make_train_step``).

As in the JAX step (reference ``train_ours_d.py:119-150``):

- the generator forward runs once, in training mode (batch-statistics BN,
  one spectral-norm power iteration per layer, PSP dropout live unless
  ``deterministic``);
- D update: D on the real batch, then on the detached fake, hinge losses on
  the image, object and app scores (object terms masked to valid objects);
  Adam steps D;
- G update against the freshly updated D: adversarial image, object and
  app terms, L1 pixel loss and the VGG perceptual loss; the gradient
  reaches G only, through the graph of the one forward;
- so each D layer's spectral norm advances three times per step and G's
  once.

Gradients are taken with ``torch.autograd.grad``, so D's gradient from the
G loss never reaches D's optimizer, and a parameter with no gradient gets a
zero one (optax updates every leaf; torch's Adam skips a ``None``). Each
parameter's ``.grad`` holds its last step's gradient.
"""

from __future__ import annotations

from typing import Callable

import torch

from layout2img_tpu_torch.losses.gan import g_adv, hinge_d_fake, hinge_d_real
from layout2img_tpu_torch.train.state import GANTrainState, TrainConfig


def _apply_grads(opt: torch.optim.Optimizer, params: list[torch.Tensor], loss: torch.Tensor) -> None:
    """Set each parameter's ``.grad`` to this loss's gradient (replacing, not
    adding to, the last step's) and step the optimizer."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()


def make_train_step(state: GANTrainState, config: TrainConfig,
                    vgg_loss: Callable | None = None, deterministic: bool = False) -> Callable:
    """Returns ``train_step(batch, rng) -> metrics``; ``train_step.with_latents(batch,
    z, z_im)`` is the same step with the latents given (tests inject them).

    batch: {"images": (b, 3, s, s) in [-1, 1], "boxes": (b, o, 4) xywh,
    "labels": (b, o)} on the networks' device. ``rng`` is a ``torch.Generator``
    on that device; z (b, o, z_dim) and z_im (b, z_dim) are standard normal
    draws from it, in that order. ``deterministic=True`` turns the PSP
    dropout off (the JAX step's ``deterministic`` flag). Metrics are f32
    scalar tensors, detached."""
    gen, disc = state.generator, state.discriminator
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())

    def with_latents(batch: dict, z: torch.Tensor, z_im: torch.Tensor) -> dict[str, torch.Tensor]:
        images, boxes, labels = batch["images"], batch["boxes"], batch["labels"]
        valid = (labels != 0).to(torch.float32)
        gen.train()
        disc.train()

        fake = gen(z, boxes, labels, z_im, deterministic=deterministic)

        # ---- D update ----
        out_r = disc(images, boxes, labels)
        out_f = disc(fake.detach(), boxes, labels)
        metrics = {
            "d_loss_real": hinge_d_real(out_r["image"]),
            "d_loss_fake": hinge_d_fake(out_f["image"]),
            "d_loss_robj": hinge_d_real(out_r["object"], valid),
            "d_loss_fobj": hinge_d_fake(out_f["object"], valid),
            "d_loss_rapp": hinge_d_real(out_r["app"], valid),
            "d_loss_fapp": hinge_d_fake(out_f["app"], valid),
        }
        d_loss = (config.lamb_obj * (metrics["d_loss_robj"] + metrics["d_loss_fobj"])
                  + config.lamb_img * (metrics["d_loss_real"] + metrics["d_loss_fake"])
                  + config.lamb_app * (metrics["d_loss_rapp"] + metrics["d_loss_fapp"]))
        _apply_grads(state.d_opt, d_params, d_loss)

        # ---- G update, against the updated D ----
        out_g = disc(fake, boxes, labels)
        metrics["g_loss_fake"] = g_adv(out_g["image"])
        metrics["g_loss_obj"] = g_adv(out_g["object"], valid)
        metrics["g_loss_app"] = g_adv(out_g["app"], valid)
        g_loss = (config.lamb_obj * metrics["g_loss_obj"] + config.lamb_img * metrics["g_loss_fake"]
                  + config.lamb_app * metrics["g_loss_app"])
        if config.use_pixel_loss:
            metrics["pixel_loss"] = (fake - images).abs().to(torch.float32).mean()
            g_loss = g_loss + metrics["pixel_loss"]
        if config.use_vgg_loss and vgg_loss is not None:
            metrics["feat_loss"] = vgg_loss(fake, images)
            g_loss = g_loss + metrics["feat_loss"]
        _apply_grads(state.g_opt, g_params, g_loss)

        state.step += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                **{k: v.detach() for k, v in metrics.items()}}

    def train_step(batch: dict, rng: torch.Generator) -> dict[str, torch.Tensor]:
        b, o = batch["labels"].shape
        dev = batch["labels"].device
        z = torch.randn((b, o, config.z_dim), generator=rng, device=rng.device).to(dev)
        z_im = torch.randn((b, config.z_dim), generator=rng, device=rng.device).to(dev)
        return with_latents(batch, z, z_im)

    train_step.with_latents = with_latents
    return train_step
