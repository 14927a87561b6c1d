"""The plain reference train step and sampler.

Train step (LostGAN-V2's ``train_ours_d.py`` loop): G's forward once; D on
the real images and on the detached fake; the hinge losses on the image,
object and (with an app head) app scores (object terms masked to real
objects), weighted by ``lamb_img`` / ``lamb_obj`` / ``lamb_app``; Adam on D;
then D, already updated, on the fake for G's adversarial terms, plus the L1
pixel loss and the VGG19 perceptual loss where the configuration turns them
on; Adam on G. Each loss is differentiated part by part (sums of the same
terms), so that one D graph at a time is held: at b=128 and 31 slots the
whole graph of the step in f32 does not fit one card. Adam is written out
(eps 1e-8, bias corrected), and every parameter gets a gradient, zero where
none reaches it. Learning rates, betas and loss weights come from the
configuration (``HYPER``: LostGAN's).

The networks are found by the configuration's preset names
(``reference/models/<name>.py``); ``supported`` refuses a configuration
whose step this reference does not compute. Run as ranks (``shard.py``),
every reduction over the batch is global and the gradients are summed over
the ranks.

``fault`` plants one fault in the step, for the tests and the readings that
show the check can fail: ``half_batch`` keeps the first half of the rows
(losses are means over the rest); ``no_exchange`` leaves out the sum of the
gradients over the ranks.
"""

from __future__ import annotations

import importlib

import torch
from torch import nn

from benchmark.reference import nets, ops, shard

HYPER = {"g_lr": 1e-4, "d_lr": 1e-4, "beta1": 0.0, "beta2": 0.999, "lamb_obj": 1.0,
         "lamb_app": 1.0, "lamb_img": 0.1}


class Adam:
    def __init__(self, params: list[nn.Parameter], lr: float = 1e-4, beta1: float = 0.0,
                 beta2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, beta1, beta2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))


def hinge_real(s, mask=None):
    return _mean(torch.relu(1.0 - s), mask)


def hinge_fake(s, mask=None):
    return _mean(torch.relu(1.0 + s), mask)


def _mean(x, mask):
    """This rank's share of the global batch's (masked) mean."""
    ranks = shard.current()
    if mask is None:
        return x.mean() / ranks.world
    x = x.reshape(mask.shape)
    return (x * mask).sum() / ranks.sum_detached(mask.sum()).clamp_min(1.0)


def _grads(loss: torch.Tensor, params: list[nn.Parameter]) -> list[torch.Tensor]:
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


class TrainStep:
    """The step on reference networks; ``__call__(batch, z, z_im)`` runs one
    and returns ``{"d_loss", "g_loss"}`` (scalar tensors), leaving each
    Adam's state readable. The caller seeds the dropout generator."""

    def __init__(self, gen: nn.Module, disc: nn.Module, vgg: nn.Module | None,
                 hyper: dict | None = None, fault: str | None = None):
        if fault not in (None, "half_batch", "no_exchange"):
            raise ValueError(f"unknown fault {fault!r}")
        self.gen, self.disc, self.fault = gen, disc, fault
        self.h = {**HYPER, **(hyper or {})}
        self.vgg = vgg if self.h.get("use_vgg_loss", True) else None
        betas = dict(beta1=self.h["beta1"], beta2=self.h["beta2"])
        self.g_params = list(gen.parameters())
        self.d_params = list(disc.parameters())
        self.g_opt = Adam(self.g_params, self.h["g_lr"], **betas)
        self.d_opt = Adam(self.d_params, self.h["d_lr"], **betas)
        if vgg is not None:
            vgg.requires_grad_(False)

    def _exchange(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        return grads if self.fault == "no_exchange" else shard.current().sum_grads(grads)

    def __call__(self, batch: dict, z: torch.Tensor, z_im: torch.Tensor) -> dict[str, torch.Tensor]:
        images, boxes, labels = batch["images"].float(), batch["boxes"].float(), batch["labels"]
        z, z_im = z.float(), z_im.float()
        if self.fault == "half_batch":
            k = labels.shape[0] // 2
            images, boxes, labels, z, z_im = images[:k], boxes[:k], labels[:k], z[:k], z_im[:k]
        valid = (labels != 0).float()
        self.gen.train()
        self.disc.train()
        fake = self.gen(z, boxes, labels, z_im, live_dropout=True)
        h = self.h

        # D's loss is a sum of a real and a fake part: each part's graph is
        # freed before the next D call, so at most one D graph is held
        out_r = self.disc(images, boxes, labels)
        real = self._d_loss(out_r, valid, hinge_real)
        d_grads = _grads(real, self.d_params)
        del out_r
        out_f = self.disc(fake.detach(), boxes, labels)
        fake_part = self._d_loss(out_f, valid, hinge_fake)
        d_grads = [a + b for a, b in zip(d_grads, _grads(fake_part, self.d_params))]
        del out_f
        d_loss = real.detach() + fake_part.detach()
        self.d_opt.step(self._exchange(d_grads))

        # G's loss: the adversarial part's gradient at the fake images first
        # (D's graph freed), then the pixel and VGG parts, then G's backward
        out_g = self.disc(fake, boxes, labels)
        adv = (-h["lamb_obj"] * _mean(out_g["object"], valid)
               - h["lamb_img"] * _mean(out_g["image"], None))
        if "app" in out_g:
            adv = adv - h["lamb_app"] * _mean(out_g["app"], valid)
        (d_fake,) = torch.autograd.grad(adv, fake)
        del out_g
        rest = torch.zeros((), device=fake.device)
        if h.get("use_pixel_loss", True):
            rest = rest + _mean((fake - images).abs(), None)
        if self.vgg is not None:
            rest = rest + self.vgg.loss(fake, images) / shard.current().world
        gs = torch.autograd.grad([fake, rest], self.g_params, grad_outputs=[d_fake, None],
                                 allow_unused=True)
        g_grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.g_params, gs)]
        self.g_opt.step(self._exchange(g_grads))
        g_loss = adv.detach() + rest.detach()
        ranks = shard.current()
        return {"d_loss": ranks.sum_detached(d_loss), "g_loss": ranks.sum_detached(g_loss)}

    def _d_loss(self, out: dict, valid: torch.Tensor, hinge) -> torch.Tensor:
        h = self.h
        loss = h["lamb_obj"] * hinge(out["object"], valid) + h["lamb_img"] * hinge(out["image"])
        if "app" in out:  # a D without the app head has no app terms
            loss = loss + h["lamb_app"] * hinge(out["app"], valid)
        return loss


# train_config keys the reference computes, and keys it may ignore because
# they change how the program computes the step, not what it computes
COMPUTED = {"g_lr", "d_lr", "beta1", "beta2", "lamb_obj", "lamb_app", "lamb_img",
            "use_pixel_loss", "use_vgg_loss"}
HOW = {"mixed_precision", "fused_d", "remat", "ema_decay"}


def supported(config: dict) -> None:
    """Raise ``ValueError`` unless this reference computes ``config``'s step
    and sampler: a module for each preset, and no knob it does not model."""
    for key in ("generator", "discriminator"):
        _module(config[key])
    tc = config.get("train_config", {})
    unknown = sorted(set(tc) - COMPUTED - HOW - {"g_obj_budget", "d_obj_budget"})
    if unknown:
        raise ValueError(f"the reference does not model train_config {unknown}")
    budgets = {k: tc[k] for k in ("g_obj_budget", "d_obj_budget") if tc.get(k)}
    if budgets:
        raise ValueError(f"the reference has no object budgets: {budgets}")


def _module(name: str):
    try:
        return importlib.import_module(f"benchmark.reference.models.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no reference network for preset {name!r}: add "
                         f"benchmark/reference/models/{name}.py") from e


def build(config: dict, device, precision: str = "f32",
          dropout_dtype: torch.dtype = torch.float32, parts=("G", "D", "VGG")) -> dict:
    """``{"G", "D", "VGG"}`` (those of ``parts``; VGG only where the
    configuration has it) reference networks of ``config``'s presets with
    empty tensors on ``device`` (``"meta"``: none), their products at
    ``precision``; fill them with ``load_state_dict``."""
    supported(config)
    names = {"G": config["generator"], "D": config["discriminator"]}
    if config.get("vgg"):
        names["VGG"] = "vgg19"
    q = ops.Quantizer(precision)
    out = {}
    for part in parts:
        if part in names:
            with torch.device("meta"):
                net = _module(names[part]).build(config, dropout_dtype)
            out[part] = nets.set_precision(net if str(device) == "meta" else
                                           net.to_empty(device=device), q)
    return out


def train_latents(rng: torch.Generator, b: int, o: int, z_dim: int,
                  dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The train step's latents: z then z_im, standard normals drawn for the
    global batch in the configuration's compute dtype on the generator's
    device, this rank's rows."""
    ranks = shard.current()
    z = torch.randn((b * ranks.world, o, z_dim), generator=rng, device=rng.device, dtype=dtype)
    z_im = torch.randn((b * ranks.world, z_dim), generator=rng, device=rng.device, dtype=dtype)
    return ranks.rows(z), ranks.rows(z_im)


def truncated_latents(rng: torch.Generator, b: int, o: int, z_dim: int = 128,
                      truncation: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The sampler's latents: z then z_im, standard normals truncated to
    ``±truncation``, drawn in f32 on the generator's device."""
    z = torch.empty((b, o, z_dim), device=rng.device)
    nn.init.trunc_normal_(z, a=-truncation, b=truncation, generator=rng)
    z_im = torch.empty((b, z_dim), device=rng.device)
    nn.init.trunc_normal_(z_im, a=-truncation, b=truncation, generator=rng)
    return z, z_im


@torch.no_grad()
def sample(gen: nets.Generator, boxes: torch.Tensor, labels: torch.Tensor, z: torch.Tensor,
           z_im: torch.Tensor) -> torch.Tensor:
    """Images (b, 3, h, w) in [-1, 1] of G in eval mode (running statistics,
    no power iteration, no dropout)."""
    gen.eval()
    return gen(z.float(), boxes.float(), labels, z_im.float(), live_dropout=False)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> uint8 NCHW, as the sampling CLI writes its JPEGs:
    ``clip(x / 2 + 1 / 2, 0, 1) * 255``, truncated."""
    return ((images.float() * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
