"""The train step's knobs in the port against the JAX package's step, on the CPU.

A JAX step is built here from the JAX modules, ``losses/gan.py``,
``utils/casting.py`` and ``optax.adam``, line for line as
``layout2img_tpu/train/step.py:49-225`` with every knob (mixed precision,
both object budgets, ``fused_d``, EMA) and with z and z_im injected and the
PSP dropout off (torch cannot draw JAX's masks). The port's step runs from
the same weights (``utils/convert.py``), batch and latents. Sizes: ch=4,
10 classes, b=2, 128 px, o=8 slots, VGG off.

Bars, those of ``tests/test_torch_port_train.py`` (where the module
docstring gives the reasons): losses within 2e-3; each gradient tensor's
error norm within 1e-3 of its norm for D and for G's res5 and final, 1e-2
for G's layers before the PSP head, 5e-2 for the conv of its 1x1 stage at
b=2, and an absolute 1e-6 of the net's largest norm for a round-off zero;
parameters after the step within 2*lr, under 1% of elements beyond 1e-6;
SN u and BN running statistics within 1e-5 (1e-4 for the PSP bottleneck
BN and the app head's class embedding).

This file holds the JAX reference step and the comparison; the other
``test_torch_port_*`` knob files import them. Here:

- ``fused_d`` against JAX's fused step (two power iterations per D layer,
  not three);
- both object budgets against JAX's budgeted step (same metric keys,
  ``g_budget_overflow`` and ``d_budget_overflow`` included), and against
  the port's unbudgeted step when K covers every layout (the JAX package's
  own bars: losses rtol 1e-4 + atol 1e-5, parameters within 2.1e-4);
- the generator gate of ``g_obj_budget`` and the accepted knobs.
"""

import collections
import functools
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.losses.gan import g_adv, hinge_d_fake, hinge_d_real
from layout2img_tpu.models.discriminators import make_discriminator as jax_make_discriminator
from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.utils.casting import cast_floating
from layout2img_tpu.utils.torch_import import import_lostgan_discriminator, import_lostgan_generator
from layout2img_tpu_torch.data.synthetic import PAD_BOX, synthetic_layouts
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.nn.spectral import _SNWeight
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                                generator_state_dict_from_jax, init_discriminator,
                                                init_generator)

CH, NC, B, O = 4, 10, 2, 8
LR = 1e-4
AFTER_PSP = ("res5.", "final.")  # G's layers after the PSP head
PSP_STAGE_CONV = "res4.conv_mask.0.stages.0.1.weight"  # feeds the BN of its 1x1 stage
LOOSE_STATE = ("res4.conv_mask.0.bottleneck.", "l_y_app.")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while a module that uses this runs (every port
    test file imports it): the suite runs one module per worker on six
    workers of an 8-core host, and eight spinning OpenMP threads in each
    starve the others and the JAX tests. (The part-mask preset's
    label-embedding gradient reads 3.9e-3 from JAX's at one thread, past
    its 1e-3 bar, and passes at two: ROADMAP §3.)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_step(gen, disc, cfg, g_vars, d_vars, batch, z, z_im):
    """``layout2img_tpu/train/step.py:49-225`` with z and z_im given and the
    dropout off: (new G variables, new D variables, G gradients, D
    gradients, metrics, EMA parameters or None)."""
    cdt = jnp.bfloat16 if cfg.mixed_precision else jnp.float32

    def cast(tree):
        return cast_floating(tree, cdt)

    g_params, g_state = g_vars["params"], {k: v for k, v in g_vars.items() if k != "params"}
    d_params, d_state = d_vars["params"], {k: v for k, v in d_vars.items() if k != "params"}
    tx = optax.adam(LR, b1=cfg.beta1, b2=cfg.beta2)
    images, boxes, labels = batch["images"].astype(cdt), batch["boxes"], batch["labels"]
    z, z_im = z.astype(cdt), z_im.astype(cdt)
    b, o = labels.shape
    budget = {}
    if 0 < cfg.g_obj_budget < o:
        budget["g_budget_overflow"] = jnp.mean(
            (jnp.sum(labels != 0, axis=1) > cfg.g_obj_budget).astype(jnp.float32))
        g_order = jnp.argsort((labels == 0).astype(jnp.int32), axis=1, stable=True)[:, :cfg.g_obj_budget]
        labels = jnp.take_along_axis(labels, g_order, axis=1)
        boxes = jnp.take_along_axis(boxes, g_order[:, :, None], axis=1)
        z = jnp.take_along_axis(z, g_order[:, :, None], axis=1)
        o = cfg.g_obj_budget
    valid = (labels != 0).astype(jnp.float32)
    d_boxes, d_labels, d_valid = boxes, labels, valid
    if 0 < cfg.d_obj_budget < o:
        budget["d_budget_overflow"] = jnp.mean(
            (jnp.sum(labels != 0, axis=1) > cfg.d_obj_budget).astype(jnp.float32))
        order = jnp.argsort((labels == 0).astype(jnp.int32), axis=1, stable=True)[:, :cfg.d_obj_budget]
        d_labels = jnp.take_along_axis(labels, order, axis=1)
        d_boxes = jnp.take_along_axis(boxes, order[:, :, None], axis=1)
        d_valid = (d_labels != 0).astype(jnp.float32)

    def d_apply(p, st, imgs, bxs, lbls):
        return disc.apply({"params": p, **st}, imgs, bxs, lbls, mutable=["spectral"])

    def g_forward(p):
        return gen.apply({"params": cast(p), **g_state}, z, boxes, labels, z_im, train=True,
                         update_stats=True, deterministic=True, mutable=["batch_stats", "spectral"])

    fake, g_vjp, g_new_state = jax.vjp(g_forward, g_params, has_aux=True)
    fake_sg = jax.lax.stop_gradient(fake)

    def d_loss_fn(p):
        d_p = cast(p)
        if cfg.fused_d:
            out, ds = d_apply(d_p, d_state, jnp.concatenate([images, fake_sg]),
                              jnp.concatenate([d_boxes, d_boxes]), jnp.concatenate([d_labels, d_labels]))
            out_r = {k: v[:b] for k, v in out.items()}
            out_f = {k: v[b:] for k, v in out.items()}
        else:
            out_r, ds = d_apply(d_p, d_state, images, d_boxes, d_labels)
            out_f, ds = d_apply(d_p, ds, fake_sg, d_boxes, d_labels)
        m = {"d_loss_real": hinge_d_real(out_r["image"]), "d_loss_fake": hinge_d_fake(out_f["image"]),
             "d_loss_robj": hinge_d_real(out_r["object"], d_valid),
             "d_loss_fobj": hinge_d_fake(out_f["object"], d_valid)}
        loss = (cfg.lamb_obj * (m["d_loss_robj"] + m["d_loss_fobj"])
                + cfg.lamb_img * (m["d_loss_real"] + m["d_loss_fake"]))
        if "app" in out_r:
            m |= {"d_loss_rapp": hinge_d_real(out_r["app"], d_valid),
                  "d_loss_fapp": hinge_d_fake(out_f["app"], d_valid)}
            loss = loss + cfg.lamb_app * (m["d_loss_rapp"] + m["d_loss_fapp"])
        return loss, (ds, m)

    (d_loss, (d_state, d_m)), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(d_params)
    d_updates, _ = tx.update(d_grads, tx.init(d_params), d_params)
    d_params = optax.apply_updates(d_params, d_updates)

    def g_loss_fn(f):
        out_g, ds = d_apply(cast(d_params), d_state, f, d_boxes, d_labels)
        m = {"g_loss_fake": g_adv(out_g["image"]), "g_loss_obj": g_adv(out_g["object"], d_valid),
             "pixel_loss": jnp.mean(jnp.abs(f - images).astype(jnp.float32))}
        loss = cfg.lamb_obj * m["g_loss_obj"] + cfg.lamb_img * m["g_loss_fake"] + m["pixel_loss"]
        if "app" in out_g:
            m["g_loss_app"] = g_adv(out_g["app"], d_valid)
            loss = loss + cfg.lamb_app * m["g_loss_app"]
        return loss, (ds, m)

    (g_loss, (d_state, g_m)), fake_grad = jax.value_and_grad(g_loss_fn, has_aux=True)(fake)
    (g_grads,) = g_vjp(fake_grad)
    g_updates, _ = tx.update(g_grads, tx.init(g_params), g_params)
    new_g_params = optax.apply_updates(g_params, g_updates)
    ema = None
    if cfg.ema_decay > 0:
        ema = jax.tree_util.tree_map(lambda e, p: cfg.ema_decay * e + (1.0 - cfg.ema_decay) * p,
                                     g_params, new_g_params)
    metrics = {"d_loss": d_loss, "g_loss": g_loss, **d_m, **g_m, **budget}
    return ({"params": new_g_params, **g_new_state}, {"params": d_params, **d_state},
            g_grads, d_grads, metrics, ema)


def make_setup(valid=(6, 3), seed: int = 7, gen_preset: str = "ours_d_context128",
               disc_preset: str = "d128_app", ch: int = CH,
               from_port: bool = False) -> SimpleNamespace:
    """JAX weights (alphas drawn in [-2, 2], so the stage masks mix), a batch
    whose layout i holds ``valid[i]`` objects in front of pad slots, and
    latents, from one numpy seed; the JAX models and the port's weights.
    The presets' image size is the generator's (64px: ``res_start=2``).
    ``from_port``: the weights are the port's seeded ones, read into JAX
    variables by the JAX package's importer, in place of JAX's ``init``
    (which costs a compile per network)."""
    rng = np.random.default_rng(seed)
    jgen = jax_make_generator(gen_preset, NC, ch=ch, num_mask_classes=NC)
    size = jgen.image_size
    res_start = 2 if size == 64 else 1
    images = rng.uniform(-1, 1, (B, 3, size, size)).astype(np.float32)
    layouts = [synthetic_layouts(rng, 1, O, NC, min_objects=n, max_objects=n) for n in valid]
    boxes = np.concatenate([lay["boxes"] for lay in layouts])
    labels = np.concatenate([lay["labels"] for lay in layouts])
    assert (boxes[labels == 0] == np.asarray(PAD_BOX, np.float32)).all()
    z = rng.standard_normal((B, O, 128)).astype(np.float32)
    z_im = rng.standard_normal((B, 128)).astype(np.float32)
    jdisc = jax_make_discriminator(disc_preset, NC, ch=ch)
    jimages = images.transpose(0, 2, 3, 1)
    if from_port:
        g_vars = import_lostgan_generator(init_generator(
            seed, NC, preset=gen_preset, device="cpu", ch=ch, num_mask_classes=NC).state_dict())
        d_vars = import_lostgan_discriminator(init_discriminator(
            seed + 1, NC, preset=disc_preset, device="cpu", ch=ch).state_dict())
    else:
        g_vars = jax.jit(jgen.init)(jax.random.PRNGKey(0), z, boxes, labels, z_im)
        d_vars = jax.jit(jdisc.init)(jax.random.PRNGKey(1), jimages, boxes, labels)
    g_vars = jax.tree_util.tree_map(np.asarray, dict(g_vars))
    d_vars = jax.tree_util.tree_map(np.asarray, dict(d_vars))
    for k in [k for k in g_vars["params"] if k.startswith("alpha")]:
        g_vars["params"][k] = rng.uniform(-2, 2, g_vars["params"][k].shape).astype(np.float32)
    t = torch.from_numpy
    g_convert = functools.partial(generator_state_dict_from_jax, res_start=res_start)
    return SimpleNamespace(
        jgen=jgen, jdisc=jdisc, g_vars=g_vars, d_vars=d_vars, gen_preset=gen_preset,
        disc_preset=disc_preset, ch=ch, g_convert=g_convert,
        jbatch={"images": jimages, "boxes": boxes, "labels": labels}, z=z, z_im=z_im,
        batch={"images": t(images), "boxes": t(boxes), "labels": t(labels).long()},
        g_sd=g_convert(g_vars), d_sd=discriminator_state_dict_from_jax(d_vars))


# XLA's lowest backend optimization level: about half the compile time of a
# JAX step, whose results agree with the optimized build's at round-off
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """``jax.jit(fn)`` compiled with ``FAST_COMPILE`` at its first call's
    arguments (for functions a test calls once)."""
    jitted = jax.jit(fn)
    return lambda *args: jitted.lower(*args).compile(FAST_COMPILE)(*args)


def run_jax(setup: SimpleNamespace, cfg: TrainConfig, fast: bool = False):
    """The JAX reference step on the setup, as numpy trees; ``fast``
    compiles it with ``FAST_COMPILE`` (every step but the part-mask
    generator's, whose label-embedding gradient moves past its 1e-3 bar
    under that build's other rounding: 3.9e-3 seen; ROADMAP §3)."""
    args = (setup.g_vars, setup.d_vars, setup.jbatch, setup.z, setup.z_im)
    step = jax.jit(lambda gv, dv, bt, z, zi: jax_step(setup.jgen, setup.jdisc, cfg, gv, dv, bt, z, zi))
    if fast:
        step = step.lower(*args).compile(FAST_COMPILE)
    return jax.tree_util.tree_map(np.asarray, step(*args))


def port_nets(setup: SimpleNamespace, remat_blocks: int = 0):
    gen = make_generator(setup.gen_preset, NC, device="cpu", ch=setup.ch, num_mask_classes=NC)
    gen.load_state_dict(setup.g_sd, strict=True)
    disc = make_discriminator(setup.disc_preset, NC, device="cpu", ch=setup.ch,
                              remat_blocks=remat_blocks)
    disc.load_state_dict(setup.d_sd, strict=True)
    return gen, disc


def run_port(setup: SimpleNamespace, cfg: TrainConfig, remat_blocks: int = 0,
             deterministic: bool = True, batch=None, vgg_loss=None) -> SimpleNamespace:
    """The port's step from the setup's weights, batch and latents."""
    gen, disc = port_nets(setup, remat_blocks)
    state = create_train_state(gen, disc, cfg)
    step = make_train_step(state, cfg, vgg_loss=vgg_loss, deterministic=deterministic)
    metrics = step.with_latents(setup.batch if batch is None else batch,
                                torch.from_numpy(setup.z), torch.from_numpy(setup.z_im))
    return SimpleNamespace(state=state, metrics={k: v.item() for k, v in metrics.items()},
                           g_convert=setup.g_convert)


def named(convert, variables: dict, params, module) -> dict[str, np.ndarray]:
    """A JAX params-shaped tree under the port's parameter names."""
    sd = convert({**variables, "params": params})
    return {n: sd[n].numpy() for n, _ in module.named_parameters()}


def nets(port: SimpleNamespace, ref):
    """(name, port module, converter, JAX new variables, JAX gradients) per net."""
    return (("generator", port.state.generator, port.g_convert, ref[0], ref[2]),
            ("discriminator", port.state.discriminator, discriminator_state_dict_from_jax, ref[1],
             ref[3]))


def check_losses(port: SimpleNamespace, ref, atol: float = 2e-3) -> None:
    want = ref[4]
    assert set(port.metrics) == set(want), (sorted(port.metrics), sorted(want))
    for k, v in want.items():
        assert abs(port.metrics[k] - float(v)) <= atol, (k, port.metrics[k], float(v))


def check_gradients(port: SimpleNamespace, ref) -> None:
    """The bars of the module doc. In a generator with stage masks, the 1e-2
    bar covers the layers up to its last mask head (at 128 px the PSP head:
    res1..res4, all but ``AFTER_PSP``), whose batch-statistics BNs see b=2
    images; a generator without stage masks is held to 1e-3 in every
    layer, as D is. A round-off zero's absolute bar grows with the image's
    side past 128 px: its error is round-off of sums over the pixels, which
    grows as their count's square root."""
    zero_bar = 1e-6 * max(1.0, port.state.generator.image_size / 128)
    for net, module, convert, variables, grads in nets(port, ref):
        want = named(convert, variables, grads, module)
        largest = max(np.linalg.norm(w) for w in want.values())
        last = max((int(n.split(".")[0][3:]) for n in want if n.startswith("res")), default=0)
        heads = any(".conv_mask." in n for n in want)
        for name, p in module.named_parameters():
            w = want[name]
            err, norm = np.linalg.norm(p.grad.numpy() - w), np.linalg.norm(w)
            if name == PSP_STAGE_CONV and B == 2:
                bar = 5e-2 * norm
            elif norm < 1e-5 * largest:
                bar = zero_bar * largest
            else:
                loose = net == "generator" and heads and not name.startswith((f"res{last}.",
                                                                              "final."))
                bar = (1e-2 if loose else 1e-3) * norm
            assert err <= bar, (net, name, err, norm)


def check_params_and_state(port: SimpleNamespace, ref) -> None:
    for net, module, convert, variables, _ in nets(port, ref):
        want = convert(variables)
        params = dict(module.named_parameters())
        beyond = total = 0
        for name, t in module.state_dict().items():
            w = want[name].numpy()
            if name in params:
                diff = np.abs(t.numpy() - w)
                assert diff.max() <= 2 * LR, (net, name, diff.max())
                beyond += int((diff > 1e-6).sum())
                total += diff.size
            elif name.endswith(("weight_u", "running_mean", "running_var")):
                atol = 1e-4 if name.startswith(LOOSE_STATE) else 1e-5
                np.testing.assert_allclose(t.numpy(), w, atol=atol, rtol=0, err_msg=name)
        assert beyond < 0.01 * total, (net, beyond, total)


def check_same_step(a: SimpleNamespace, b: SimpleNamespace, state_atol: float | None = None) -> None:
    """Two port steps that do the same math: losses at rtol 1e-4 + atol 1e-5
    and parameters within 2.1e-4 (one Adam step of a flipped round-off
    gradient), the JAX package's bars for its remat and budget tests;
    with ``state_atol``, every SN vector and BN running statistic too."""
    assert set(a.metrics) <= set(b.metrics) or set(b.metrics) <= set(a.metrics)
    for k in set(a.metrics) & set(b.metrics):
        assert abs(a.metrics[k] - b.metrics[k]) <= 1e-5 + 1e-4 * abs(b.metrics[k]), k
    for ma, mb in ((a.state.generator, b.state.generator),
                   (a.state.discriminator, b.state.discriminator)):
        sa, sb = ma.state_dict(), mb.state_dict()
        for name, p in ma.named_parameters():
            assert (p - sb[name]).abs().max().item() <= 2.1e-4, name
        if state_atol is not None:
            for name in sa:
                if name.endswith(("weight_u", "weight_v", "running_mean", "running_var",
                                  "num_batches_tracked")):
                    torch.testing.assert_close(sa[name], sb[name], atol=state_atol, rtol=0,
                                               msg=name)


@pytest.fixture(scope="module")
def setup():
    """The knobs' weights: the port's seeded draws read into JAX (no JAX
    init to compile)."""
    return make_setup(from_port=True)


@pytest.fixture(scope="module")
def fused(setup):
    cfg = TrainConfig(use_vgg_loss=False, fused_d=True)
    return run_port(setup, cfg), run_jax(setup, cfg, fast=True)


@pytest.fixture(scope="module")
def budgeted(setup):
    """g_obj_budget 6 covers both layouts (6 and 3 objects); d_obj_budget 5
    drops one object of the first from D's view."""
    cfg = TrainConfig(use_vgg_loss=False, g_obj_budget=6, d_obj_budget=5)
    return run_port(setup, cfg), run_jax(setup, cfg, fast=True)


@pytest.mark.parametrize("check", [check_losses, check_gradients, check_params_and_state])
def test_fused_d_matches_jax_fused_step(fused, check):
    check(*fused)


@pytest.mark.parametrize("fused_d,per_call", [(False, 3), (True, 2)])
def test_fused_d_runs_two_power_iterations(setup, monkeypatch, fused_d, per_call):
    """Each D layer runs its power iteration twice per step under fused_d, as
    JAX's fused step does, and three times in the plain step (block_obj4,
    called on both RoI scales, twice as often); G's layers once."""
    counts = collections.Counter()
    advance = _SNWeight.normalized_weight

    def counted(self):
        counts[id(self)] += self.training
        return advance(self)

    monkeypatch.setattr(_SNWeight, "normalized_weight", counted)
    port = run_port(setup, TrainConfig(use_vgg_loss=False, fused_d=fused_d))
    for net, calls in ((port.state.discriminator, per_call), (port.state.generator, 1)):
        for name, m in net.named_modules():
            if isinstance(m, _SNWeight):
                assert counts[id(m)] == calls * (2 if name.startswith("block_obj4.") else 1), name


@pytest.mark.parametrize("check", [check_losses, check_gradients, check_params_and_state])
def test_budgets_match_jax_budgeted_step(budgeted, check):
    check(*budgeted)


def test_budget_overflow_metrics(budgeted):
    port, ref = budgeted
    assert {"g_budget_overflow", "d_budget_overflow"} <= set(port.metrics)
    assert port.metrics["g_budget_overflow"] == 0.0 and port.metrics["d_budget_overflow"] == 0.5
    assert set(port.metrics) == set(ref[4])


@pytest.mark.parametrize("budgets", [dict(g_obj_budget=6), dict(d_obj_budget=6),
                                     dict(g_obj_budget=6, d_obj_budget=6),
                                     dict(g_obj_budget=8, d_obj_budget=8)])
def test_budgets_covering_every_layout_match_the_unbudgeted_step(setup, budgets):
    """K >= the most valid objects of a layout: the same step (pad slots
    weigh nothing), with an overflow metric of 0 where K is below the slots
    it cuts (D's after G's budget) and no metric otherwise, as in the JAX
    step."""
    plain = run_port(setup, TrainConfig(use_vgg_loss=False))
    port = run_port(setup, TrainConfig(use_vgg_loss=False, **budgets))
    check_same_step(port, plain)
    extra = {k for k in port.metrics if k.endswith("_budget_overflow")}
    g, d = budgets.get("g_obj_budget", 0), budgets.get("d_obj_budget", 0)
    d_slots = g if 0 < g < O else O  # D's budget applies after G's
    assert extra == ({"g_budget_overflow"} if 0 < g < O else set()) | (
        {"d_budget_overflow"} if 0 < d < d_slots else set())
    assert all(port.metrics[k] == 0.0 for k in extra)


def test_g_budget_draws_z_at_full_width(setup):
    """The budget keeps each valid slot's own z: moving the valid slots of a
    layout behind pads changes nothing (its z rows move with them)."""
    cfg = TrainConfig(use_vgg_loss=False, g_obj_budget=6)
    perm = torch.tensor([7, 0, 1, 6, 2, 3, 4, 5])  # pads interleaved before the valid slots
    batch = {k: (v[:, perm] if k != "images" else v) for k, v in setup.batch.items()}
    moved = SimpleNamespace(**{**vars(setup), "z": setup.z[:, perm.numpy()]})
    a = run_port(setup, cfg)
    b = run_port(moved, cfg, batch=batch)
    check_same_step(a, b, state_atol=1e-6)


def test_g_budget_refused_where_compaction_is_not_exact(setup):
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, num_mask_classes=NC,
                         legacy_attention=True)
    _, disc = port_nets(setup)
    cfg = TrainConfig(use_vgg_loss=False, g_obj_budget=4)
    with pytest.raises(ValueError, match="legacy_attention"):
        make_train_step(create_train_state(gen, disc, cfg), cfg)


@pytest.mark.parametrize("knob", [dict(fused_d=True), dict(remat="gd"), dict(mixed_precision=True),
                                  dict(ema_decay=0.999), dict(d_obj_budget=8), dict(g_obj_budget=8)])
def test_train_config_takes_every_knob(knob):
    cfg = TrainConfig(**knob)
    assert all(getattr(cfg, k) == v for k, v in knob.items())
