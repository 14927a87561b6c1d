"""One GAN train step (counterpart of ``layout2img_tpu/train/step.py::make_train_step``).

As in the JAX step (reference ``train_ours_d.py:119-150``):

- the generator forward runs once, in training mode (batch-statistics BN,
  one spectral-norm power iteration per layer, PSP and GCN dropout live
  unless ``deterministic``);
- D update: D on the real batch, then on the detached fake, hinge losses on
  the image, object and (with D's app head) app scores (object terms
  masked to valid objects); Adam steps D;
- G update against the freshly updated D: adversarial image, object and
  (with the app head) app terms, L1 pixel loss and the VGG perceptual loss;
  the gradient reaches G only, through the graph of the one forward;
- so each D layer's spectral norm advances three times per step and G's
  once.

The knobs of ``TrainConfig``, with the JAX step's semantics:

- ``mixed_precision``: G, D and VGG run with bf16 casts of their parameters
  (``torch.func.functional_call`` with ``utils.casting.cast_params``), so
  the gradients land on the f32 masters through the casts; z, z_im and the
  images are bf16; BN statistics, SN power iterations and the losses stay
  f32 inside the modules; the pixel loss takes ``abs`` in bf16 and the mean
  in f32. Not ``torch.autocast``: it picks a precision per op, which is
  another precision mix than JAX's cast-the-parameters scheme.
- ``g_obj_budget`` K: the valid slots move to the front (a stable sort of
  ``labels == 0``) and the whole step runs on the first K. z is drawn at
  full width first, so each slot's draw is the unbudgeted step's.
  ``d_obj_budget`` does the same for D's view only, after the G budget.
  Each adds its overflow metric (the share of layouts with more valid
  objects than K) when K is below the step's slot count. A generator for
  which compaction is not exact (``models/generators.py::obj_budget_error``)
  refuses ``g_obj_budget``.
- ``fused_d``: the D update runs one D call on ``cat([images, fake])`` with
  the boxes and labels twice, split at b: the same scores, and two power
  iterations per D layer per step instead of three.
- ``remat`` ("g", "d", "gd"): G's forward and/or each D call run under
  ``nn/remat.py::checkpoint``, which recomputes them in the backward with
  the SN vectors of the forward and without folding BN statistics twice, so
  the step equals the plain one. (``LayoutDiscriminator(remat_blocks=N)`` is
  the per-block form for D's trunk.)
- ``ema_decay`` > 0: the EMA of G's parameters is updated after G's Adam
  step (``train/ema.py``).

Spans (``utils/tracing.py``; recorded only under a profiler or
``tracing.enable(True)``): ``train.step``, the root of each step, over
``train.cast`` (``net``: g, d; mixed precision), ``train.g_forward``,
``train.d_forward`` (``role``: real, fake, fused, for_g), ``train.vgg``,
``train.backward`` and ``train.adam`` (``net``), ``train.ema``, and the
collectives' ``mesh.all_reduce``.

Data parallelism (``parallel/mesh.py``): each rank runs this step on its
shard of the global batch; z and z_im are drawn for the global batch and
cut to the rank's rows (before any budget compaction); the BN statistics,
masked means, gradients and metrics are global; ``fused_d`` and the SN power
iterations run on each rank on replicated weights, so they stay bit-equal.
On the 2-D mesh the batch shard, latents and dropout masks are the data
group's. In tensor mode the step is unchanged: the sharded layers gather
their outputs. In spatial mode the step runs on row shards
(``row_shards``): each rank keeps its rows of the real images, G returns its
rows of the fake ones, D's scores are whole, and the pixel and VGG losses'
means are model-summed; every rank's gradients are parts, summed over all W.

Gradients are taken with ``torch.autograd.grad``, so D's gradient from the
G loss never reaches D's optimizer, and a parameter with no gradient gets a
zero one (optax updates every leaf; torch's Adam skips a ``None``). Each
parameter's ``.grad`` holds its last step's gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from layout2img_tpu_torch.losses.gan import g_adv, hinge_d_fake, hinge_d_real
from layout2img_tpu_torch.models.generators import obj_budget_error
from layout2img_tpu_torch.nn import remat
from layout2img_tpu_torch.parallel import mesh as data_mesh
from layout2img_tpu_torch.train.ema import ema_update
from layout2img_tpu_torch.train.state import GANTrainState, TrainConfig
from layout2img_tpu_torch.utils import tracing
from layout2img_tpu_torch.utils.casting import cast_params


def _apply_grads(opt: torch.optim.Optimizer, params: list[torch.Tensor], loss: torch.Tensor,
                 net: str) -> None:
    """Set each parameter's ``.grad`` to this loss's gradient (replacing, not
    adding to, the last step's), averaged over the data-parallel ranks in
    one f32 buffer (``parallel/mesh.py::DataMesh.all_reduce_grads``), and
    step the optimizer; ``net`` ("d" or "g") names the spans."""
    with tracing.span("train.backward", net=net):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    for p, g in zip(params, data_mesh.current().all_reduce_grads(grads, params)):
        p.grad = g
    with tracing.span("train.adam", net=net):
        opt.step()


def global_normal(rng: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """This rank's rows of a standard normal draw for the global batch:
    ``shape[0]`` rows per data group, as many times more drawn from ``rng``
    as there are groups, so each rank draws what one process draws at the
    global batch."""
    mesh = data_mesh.current()
    full = torch.randn((shape[0] * mesh.data_size, *shape[1:]), generator=rng, device=rng.device,
                       dtype=dtype)
    return mesh.rows(full).to(device)


def compact_order(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(b, k) slot indices: the valid slots first, in their order (a stable
    sort of ``labels == 0``), then pads."""
    return torch.argsort((labels == 0).to(torch.int32), dim=1, stable=True)[:, :k]


def _take(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The slots ``order`` (b, k) of t (b, o, ...)."""
    return torch.take_along_dim(t, order.reshape(*order.shape, *[1] * (t.ndim - 2)), dim=1)


def _overflow(labels: torch.Tensor, k: int) -> torch.Tensor:
    """The share of layouts with more than k valid objects."""
    return ((labels != 0).sum(dim=1) > k).to(torch.float32).mean()


def _call(module: nn.Module, params: dict | None, *args, **kwargs):
    """``module(*args, **kwargs)``, with ``params`` in place of its own
    parameters when given."""
    if params is None:
        return module(*args, **kwargs)
    return torch.func.functional_call(module, params, args, kwargs)


def make_train_step(state: GANTrainState, config: TrainConfig,
                    vgg_loss: Callable | None = None, deterministic: bool = False) -> Callable:
    """Returns ``train_step(batch, rng) -> metrics``; ``train_step.with_latents(batch,
    z, z_im)`` is the same step with the latents given (tests inject them).

    batch: {"images": (b, 3, s, s) in [-1, 1], "boxes": (b, o, 4) xywh,
    "labels": (b, o)} on the networks' device. ``rng`` is a ``torch.Generator``
    on that device; z (b, o, z_dim) and z_im (b, z_dim) are standard normal
    draws from it in the compute dtype, in that order. Given latents are
    cast to the compute dtype. ``deterministic=True`` turns the PSP and GCN
    dropouts off (the JAX step's ``deterministic`` flag). Metrics are f32 scalar
    tensors, detached."""
    gen, disc = state.generator, state.discriminator
    why = obj_budget_error(gen) if config.g_obj_budget else None
    if why is not None:
        raise ValueError(f"g_obj_budget is not exact for this generator: {why}")
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())
    dtype = torch.bfloat16 if config.mixed_precision else torch.float32

    def cast(module: nn.Module, net: str) -> dict | None:
        if not config.mixed_precision:
            return None
        with tracing.span("train.cast", net=net):
            return cast_params(module, dtype)

    def g_apply(params, *args, **kwargs):
        with tracing.span("train.g_forward"):
            if "g" in config.remat:
                return remat.checkpoint(_call, gen, params, *args, **kwargs)
            return _call(gen, params, *args, **kwargs)

    def d_apply(role: str, params, *args):
        with tracing.span("train.d_forward", role=role):
            if "d" in config.remat:
                return remat.checkpoint(_call, disc, params, *args)
            return _call(disc, params, *args)

    def with_latents(batch: dict, z: torch.Tensor, z_im: torch.Tensor) -> dict[str, torch.Tensor]:
        with tracing.span("train.step"), \
                data_mesh.row_shards(data_mesh.current().mode == "spatial"):
            return step(batch, z, z_im)

    def step(batch: dict, z: torch.Tensor, z_im: torch.Tensor) -> dict[str, torch.Tensor]:
        images, boxes, labels = batch["images"].to(dtype), batch["boxes"], batch["labels"]
        if data_mesh.rows_sharded():
            images = data_mesh.split_rows(images)
        z, z_im = z.to(dtype), z_im.to(dtype)
        b, o = labels.shape
        budget = {}
        if 0 < config.g_obj_budget < o:
            budget["g_budget_overflow"] = _overflow(labels, config.g_obj_budget)
            order = compact_order(labels, config.g_obj_budget)
            labels, boxes, z = _take(labels, order), _take(boxes, order), _take(z, order)
            o = config.g_obj_budget
        d_boxes, d_labels = boxes, labels
        if 0 < config.d_obj_budget < o:
            budget["d_budget_overflow"] = _overflow(labels, config.d_obj_budget)
            order = compact_order(labels, config.d_obj_budget)
            d_boxes, d_labels = _take(boxes, order), _take(labels, order)
        valid = (d_labels != 0).to(torch.float32)
        gen.train()
        disc.train()

        fake = g_apply(cast(gen, "g"), z, boxes, labels, z_im, deterministic=deterministic)

        # ---- D update ----
        d_cast = cast(disc, "d")
        if config.fused_d:
            out = d_apply("fused", d_cast, torch.cat([images, fake.detach()]),
                          torch.cat([d_boxes, d_boxes]), torch.cat([d_labels, d_labels]))
            out_r = {k: v[:b] for k, v in out.items()}
            out_f = {k: v[b:] for k, v in out.items()}
        else:
            out_r = d_apply("real", d_cast, images, d_boxes, d_labels)
            out_f = d_apply("fake", d_cast, fake.detach(), d_boxes, d_labels)
        metrics = {
            "d_loss_real": hinge_d_real(out_r["image"]),
            "d_loss_fake": hinge_d_fake(out_f["image"]),
            "d_loss_robj": hinge_d_real(out_r["object"], valid),
            "d_loss_fobj": hinge_d_fake(out_f["object"], valid),
        }
        d_loss = (config.lamb_obj * (metrics["d_loss_robj"] + metrics["d_loss_fobj"])
                  + config.lamb_img * (metrics["d_loss_real"] + metrics["d_loss_fake"]))
        if "app" in out_r:  # a D without the app head adds no app terms and no app metrics
            metrics["d_loss_rapp"] = hinge_d_real(out_r["app"], valid)
            metrics["d_loss_fapp"] = hinge_d_fake(out_f["app"], valid)
            d_loss = d_loss + config.lamb_app * (metrics["d_loss_rapp"] + metrics["d_loss_fapp"])
        _apply_grads(state.d_opt, d_params, d_loss, "d")

        # ---- G update, against the updated D ----
        out_g = d_apply("for_g", cast(disc, "d"), fake, d_boxes, d_labels)
        metrics["g_loss_fake"] = g_adv(out_g["image"])
        metrics["g_loss_obj"] = g_adv(out_g["object"], valid)
        g_loss = config.lamb_obj * metrics["g_loss_obj"] + config.lamb_img * metrics["g_loss_fake"]
        if "app" in out_g:
            metrics["g_loss_app"] = g_adv(out_g["app"], valid)
            g_loss = g_loss + config.lamb_app * metrics["g_loss_app"]
        if config.use_pixel_loss:
            metrics["pixel_loss"] = data_mesh.row_mean((fake - images).abs().to(torch.float32))
            g_loss = g_loss + metrics["pixel_loss"]
        if config.use_vgg_loss and vgg_loss is not None:
            # under mixed precision the VGG stack runs in bf16 too
            with tracing.span("train.vgg"):
                metrics["feat_loss"] = vgg_loss(fake, images,
                                                dtype=dtype if config.mixed_precision else None)
            g_loss = g_loss + metrics["feat_loss"]
        _apply_grads(state.g_opt, g_params, g_loss, "g")
        if config.ema_decay > 0 and state.ema is not None:
            with tracing.span("train.ema"):
                ema_update(state.ema, gen, config.ema_decay)

        state.step += 1
        return data_mesh.current().mean_metrics(
            {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
             **{k: v.detach() for k, v in {**metrics, **budget}.items()}})

    def train_step(batch: dict, rng: torch.Generator) -> dict[str, torch.Tensor]:
        b, o = batch["labels"].shape
        dev = batch["labels"].device
        z = global_normal(rng, (b, o, config.z_dim), dtype, dev)
        z_im = global_normal(rng, (b, config.z_dim), dtype, dev)
        return with_latents(batch, z, z_im)

    train_step.with_latents = with_latents
    return train_step
