"""Train step of the layout2im CVAE-GAN family (counterpart of
``layout2img_tpu/train/step_layout2im.py``), the layout2im objective
(zhaobozb/layout2im, CVPR'19) with the appearance head:

    L_G = l1 * |img_rec - img|_1 + kl * KL(q(z|crop) || N(0, 1))
        + z_rec * |z_rand_rec - z_rand|_1
        + adv(img_rec) + adv(img_rand) + adv_obj(crops) + adv_app(crops)
        + cls * CE(class_logits, labels)
    L_D = hinge on the real, rec and rand images and crops (+ app), + CE aux.

Per-object terms are masked to the valid slots. As in the JAX step:

- the generator forward runs once in training mode, its transformer
  fusions' dropout (0.1) live: the dropout draws come from torch's global
  generator, seeded from the step's ``rng`` for the forward (so a step is a
  function of its ``rng``), or from the caller's global state through
  ``with_latents``;
- the D update runs the image D on the real, rec and rand images, then the
  object D on their crops, each call one SN power iteration per layer; the
  two Ds are one ``nn.ModuleDict({"img", "obj"})`` under one Adam (JAX's one
  optax Adam over ``{"img", "obj"}``);
- the G update runs each updated D on rec and rand, and the gradient
  reaches G through the one forward's graph.

Latents: z_rand (b, o, z_dim) from the step's ``torch.Generator``, then the
VAE noise of the real crops' and the random image's crops' encodings
(eps_real, eps_rand, each (b, o, z_dim)), then the dropout seed. Under a
data-parallel mesh each latent is drawn for the global batch and cut to the
rank's rows, the dropout masks likewise (``parallel/mesh.py::dropout``), and
the masked BN counts and masked means are global.

``make_layout2im_sample_fn`` is the family's sampler (the JAX CLIs'
``Layout2ImGenerator.sample`` closures): truncated-normal z in eval mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.losses.gan import g_adv, hinge_d_fake, hinge_d_real, masked_mean
from layout2img_tpu_torch.ops.bbox import bbox_mask
from layout2img_tpu_torch.ops.interp import crop_boxes
from layout2img_tpu_torch.train.state import GANTrainState
from layout2img_tpu_torch.parallel import mesh as data_mesh
from layout2img_tpu_torch.train.step import _apply_grads, global_normal

CROP = 32  # the object crops' size


@dataclasses.dataclass(frozen=True)
class Layout2ImConfig:
    z_dim: int = 8
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1: float = 0.0
    beta2: float = 0.999
    lamb_img_rec: float = 1.0
    lamb_kl: float = 0.01
    lamb_z_rec: float = 10.0
    lamb_obj: float = 1.0
    lamb_app: float = 1.0
    lamb_img: float = 1.0
    lamb_cls: float = 1.0


def create_layout2im_state(generator: nn.Module, d_img: nn.Module, d_obj: nn.Module,
                           cfg: Layout2ImConfig) -> GANTrainState:
    """The state over initialized networks (``utils.convert.init_layout2im_*``
    or loaded state dicts): the discriminator is ``ModuleDict({"img": d_img,
    "obj": d_obj})``; one Adam per side, optax's defaults (eps 1e-8)."""
    disc = nn.ModuleDict({"img": d_img, "obj": d_obj})

    def adam(module: nn.Module, lr: float) -> torch.optim.Adam:
        return torch.optim.Adam(module.parameters(), lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)

    return GANTrainState(generator, disc, adam(generator, cfg.lr_g), adam(disc, cfg.lr_d))


def make_layout2im_train_step(state: GANTrainState, cfg: Layout2ImConfig) -> Callable:
    """Returns ``train_step(batch, rng) -> metrics``; ``train_step.with_latents(
    batch, z_rand, eps_real, eps_rand, deterministic=False)`` is the same step
    with the latents and the VAE noise given. batch: ``images`` (b, 3, 64,
    64), ``labels`` (b, o), ``boxes`` (b, o, 4) on the networks' device.
    Metrics are f32 scalar tensors, detached."""
    gen, disc = state.generator, state.discriminator
    d_img, d_obj = disc["img"], disc["obj"]
    g_params, d_params = list(gen.parameters()), list(disc.parameters())

    def with_latents(batch: dict, z_rand: torch.Tensor, eps_real: torch.Tensor,
                     eps_rand: torch.Tensor,
                     deterministic: bool = False) -> dict[str, torch.Tensor]:
        images, labels, boxes = batch["images"], batch["labels"], batch["boxes"]
        valid = (labels != 0).to(torch.float32)
        masks = bbox_mask(boxes, 64, 64)
        gen.train()
        disc.train()
        out = gen(images, labels, boxes, masks, z_rand, eps_real, eps_rand, deterministic)
        img_rec, img_rand = out["img_rec"], out["img_rand"]
        real_crops = crop_boxes(images, boxes, CROP)

        def ce(logits: torch.Tensor) -> torch.Tensor:
            pick = F.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
            return -masked_mean(pick, valid)

        # ---- D update: the image D thrice, then the object D thrice ----
        fakes = (img_rec.detach(), img_rand.detach())
        real_s, rec_s, rand_s = (d_img(x) for x in (images, *fakes))
        crops = (real_crops, *(crop_boxes(x, boxes, CROP) for x in fakes))
        o_real, o_rec, o_rand = (d_obj(c, labels) for c in crops)
        d_loss = cfg.lamb_img * (hinge_d_real(real_s)
                                 + 0.5 * (hinge_d_fake(rec_s) + hinge_d_fake(rand_s)))
        for key, lamb in (("object", cfg.lamb_obj), ("app", cfg.lamb_app)):
            d_loss = d_loss + lamb * (hinge_d_real(o_real[key], valid)
                                      + 0.5 * (hinge_d_fake(o_rec[key], valid)
                                               + hinge_d_fake(o_rand[key], valid)))
        d_loss = d_loss + cfg.lamb_cls * ce(o_real["class_logits"])
        _apply_grads(state.d_opt, d_params, d_loss)

        # ---- G update, against the updated Ds ----
        rec_s, rand_s = d_img(img_rec), d_img(img_rand)
        o_rec, o_rand = (d_obj(crop_boxes(x, boxes, CROP), labels) for x in (img_rec, img_rand))
        mu, logvar = out["mu"], out["logvar"]
        img_rec_l1 = (img_rec - images).abs().mean()
        kl = masked_mean((0.5 * (logvar.exp() + mu.square() - 1.0 - logvar)).sum(-1), valid)
        z_rec_l1 = masked_mean((out["z_rand_rec"] - z_rand).abs().mean(-1), valid)
        adv = cfg.lamb_img * 0.5 * (g_adv(rec_s) + g_adv(rand_s))
        for key, lamb in (("object", cfg.lamb_obj), ("app", cfg.lamb_app)):
            adv = adv + lamb * 0.5 * (g_adv(o_rec[key], valid) + g_adv(o_rand[key], valid))
        aux = cfg.lamb_cls * 0.5 * (ce(o_rec["class_logits"]) + ce(o_rand["class_logits"]))
        g_loss = (cfg.lamb_img_rec * img_rec_l1 + cfg.lamb_kl * kl + cfg.lamb_z_rec * z_rec_l1
                  + adv + aux)
        _apply_grads(state.g_opt, g_params, g_loss)
        state.step += 1
        metrics = {"d_loss": d_loss, "g_loss": g_loss, "img_rec_l1": img_rec_l1, "kl": kl,
                   "z_rec_l1": z_rec_l1, "g_adv": adv}
        return data_mesh.current().mean_metrics({k: v.detach() for k, v in metrics.items()})

    def train_step(batch: dict, rng: torch.Generator) -> dict[str, torch.Tensor]:
        b, o = batch["labels"].shape
        dev = batch["labels"].device
        z_rand, eps_real, eps_rand = (global_normal(rng, (b, o, cfg.z_dim), torch.float32, dev)
                                      for _ in range(3))
        seed = int(torch.randint(2**62, (1,), generator=rng, device=rng.device).item())
        devices = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices, device_type=dev.type):
            torch.manual_seed(seed)
            return with_latents(batch, z_rand, eps_real, eps_rand)

    train_step.with_latents = with_latents
    return train_step


def make_layout2im_sample_fn(generator: nn.Module, truncation: float = 2.0,
                             dtype: torch.dtype = torch.float32) -> Callable:
    """``sample(batch, rng) -> (b, 3, 64, 64)`` images: ``generator.sample``
    in eval mode on z (b, o, z_dim) drawn truncated to ``[-truncation,
    truncation]`` from ``rng``, and the layouts' box masks. ``batch`` holds
    ``labels`` and ``boxes`` (tensors or arrays); ``generator`` already
    holds its weights in ``dtype``, and the masks and z are cast to it (f32
    masks would promote the trunk back to f32). The generator's mode is
    restored after each call."""
    from layout2img_tpu_torch.sample import truncated_normal

    @torch.no_grad()
    def sample(batch: dict, rng: torch.Generator) -> torch.Tensor:
        device = next(generator.parameters()).device
        boxes = torch.as_tensor(batch["boxes"]).to(device=device, dtype=torch.float32)
        labels = torch.as_tensor(batch["labels"]).to(device=device, dtype=torch.long)
        z = truncated_normal((*labels.shape, generator.z_dim), truncation, rng, device, dtype)
        was_training = generator.training
        generator.eval()
        try:
            return generator.sample(labels, boxes, bbox_mask(boxes, 64, 64).to(dtype), z)
        finally:
            generator.train(was_training)

    return sample
