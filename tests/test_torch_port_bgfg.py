"""The port's Ours-ED family (the fg/bg two-stream generator, its data split
and its train step) against the JAX package's, on the CPU.

- ``split_fg_bg``: item for item equal to JAX's on the COCO fixture (and on
  a hand-made layout with ids 91 and pads), through ``CocoLayoutDataset(
  fg_bg_split=True)`` and ``split_fg_bg_batch``.
- ``bgfg_generator_state_dict_from_jax`` equals ``export_bgfg_generator``
  key for key (the aliased ``combination.model.2/5`` included) and loads
  into ``BgFgGenerator`` with ``strict=True``; the seeded init's dict has
  the same keys.
- Forwards at 2e-3 (the PARITY.md bar), the JAX weights converted, BN
  statistics moved off 0/1: the 64px feature-only generator
  (``rgb_head=False``) and the whole two-stream generator, each in eval and
  in training mode (batch statistics; the running statistics after the
  call at 1e-5). The streams are pad-heavy, as the split leaves them: 1-3
  live objects of o=4.
- One train step (ch=4, b=2, VGG off, f32) against the JAX package's own
  ``make_bgfg_train_step`` (its state built from the port's seeded nets
  through the JAX package's ``torch_import``), with the JAX step's latents (drawn from its key
  as it draws them) given to ``with_latents``; JAX's gradients are its
  Adam's first moments (beta1 = 0). Bars, as ``tests/test_torch_port_train.py``
  sets them: losses 2e-3; each gradient tensor's error norm within 1e-3 of
  its norm for D and 5e-2 for G, and a gradient whose norm is under 1e-5 of
  the net's largest (round-off of an exact zero: the biases before a
  batch-statistics BN) within an absolute 1e-6 of that largest; BN running
  statistics and SN u vectors at 1e-5; parameters after the step within
  2*lr of JAX's (a gradient sign flip, plus 1e-6 for their round-off),
  and under 1% of the elements whose JAX gradient exceeds
  1e-6 (where beta1 = 0 Adam moves an element by lr, whatever the
  gradient's size) beyond 1e-6. Why 5e-2 for G, pinned by
  ``test_bgfg_step_gradient_gap_is_the_f32_spread``: the JAX and port
  forwards differ by f32 round-off (2e-5 in the streams' features), and one
  element at the combination block's shortcut ReLU sits within that of 0
  after its BN (-6e-6), so the two gates differ there; that one element
  moves the gradient into the streams by 0.5%, and their ISLA projections'
  gradients, small sums of large terms, by 2-4%. Two ulps of noise on G's
  weights move every G gradient that misses JAX's by more than 1e-3 as far.
- ``TrainConfig(mixed_precision=True)`` changes nothing: the step is the
  f32 one, as in JAX, whose step never reads the flag.
"""

import functools
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.data import coco as jax_coco
from layout2img_tpu.models.discriminators import make_discriminator as jax_make_discriminator
from layout2img_tpu.models.generators import BgFgGenerator as JaxBgFgGenerator
from layout2img_tpu.models.generators import LostGANGenerator as JaxLostGANGenerator
from layout2img_tpu.train.state import GANTrainState as JaxGANTrainState
from layout2img_tpu.train.state import TrainConfig as JaxTrainConfig
from layout2img_tpu.train.step_bgfg import make_bgfg_train_step as jax_make_bgfg_train_step
from layout2img_tpu.utils.torch_export import export_bgfg_generator
from layout2img_tpu.utils.torch_import import import_bgfg_generator, import_lostgan_discriminator
from layout2img_tpu_torch.data import coco, synthetic
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.models.generators import BgFgGenerator, LostGANGenerator
from layout2img_tpu_torch.train.state import TrainConfig
from layout2img_tpu_torch.train.step_bgfg import create_bgfg_state, make_bgfg_train_step
from layout2img_tpu_torch.utils.convert import (bgfg_generator_state_dict_from_jax,
                                                discriminator_state_dict_from_jax,
                                                generator_state_dict_from_jax,
                                                init_bgfg_generator, init_discriminator)
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)

TOL = 2e-3
CH, B, O, Z = 4, 2, 4, 128
NUM_FG, NUM_BG = 91, 93
NC = NUM_FG + NUM_BG
LR = 1e-4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got: torch.Tensor, want, tol: float = TOL, what: str = "") -> None:
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol, (what, err)


def _nchw(x) -> np.ndarray:
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def coco_fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    _, inst = synthetic.write_synthetic_coco(root, 6, width=96, height=80, seed=3)
    return root, inst, synthetic.write_synthetic_stuff(root, inst, seed=4)


def test_split_fg_bg_matches_jax_on_the_coco_fixture(coco_fixture):
    root, inst, stuff = coco_fixture
    port = coco.CocoLayoutDataset(root, inst, stuff, image_size=64, fg_bg_split=True,
                                  left_right_flip=True)
    ref = jax_coco.CocoLayoutDataset(root, inst, stuff, image_size=64, fg_bg_split=True,
                                     left_right_flip=True)
    assert len(port) == len(ref) > 0
    streams = ("labels_fg", "boxes_fg", "labels_bg", "boxes_bg")
    live = set()
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert set(got) == set(want) == {"images", "labels", "boxes", *streams}
        for k in ("labels", "boxes", *streams):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)
        live |= {(k, int((got[k] != 0).sum())) for k in ("labels_fg", "labels_bg")}
    assert {n for k, n in live if k == "labels_fg"} and {n for k, n in live if k == "labels_bg"}
    batch = {k: np.stack([port[i][k] for i in range(3)]) for k in ("labels", "boxes")}
    got, want = coco.split_fg_bg_batch(batch), jax_coco.split_fg_bg_batch(batch)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert coco.split_fg_bg_batch(got) is got


def test_split_fg_bg_drops_91_and_packs_each_stream():
    labels = np.array([5, 91, 120, 0, 90, 92, 183, 0], np.int32)
    boxes = np.arange(32, dtype=np.float32).reshape(8, 4) / 40
    got, want = coco.split_fg_bg(labels, boxes), jax_coco.split_fg_bg(labels, boxes)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert got["labels_fg"].tolist() == [5, 90, 0, 0, 0, 0, 0, 0]
    assert got["labels_bg"].tolist() == [29, 1, 92, 0, 0, 0, 0, 0]
    assert np.array_equal(got["boxes_bg"][:3], boxes[[2, 5, 6]])
    assert np.array_equal(got["boxes_bg"][3:], np.tile(np.float32(coco.PAD_BOX), (5, 1)))


def _layout(rng, live: list[int], classes: int):
    """(z, boxes, labels, z_im) with ``live[i]`` valid slots in layout i."""
    xy = rng.uniform(0, 0.5, (B, O, 2))
    wh = rng.uniform(0.1, 0.5, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.integers(1, classes, (B, O)).astype(np.int32)
    for i, n in enumerate(live):
        labels[i, n:] = 0
        boxes[i, n:] = coco.PAD_BOX
    return (rng.standard_normal((B, O, Z)).astype(np.float32), boxes, labels,
            rng.standard_normal((B, Z)).astype(np.float32))


def _moved_stats(rng, variables: dict) -> dict:
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda s: s + rng.uniform(0.1, 0.5, s.shape).astype(s.dtype), variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def bgfg(step_pair):
    """The JAX generator, the step's initial variables with their BN
    statistics moved, and pad-heavy inputs."""
    rng = np.random.default_rng(5)
    fg = _layout(rng, [1, 3], NUM_FG)
    bg = _layout(rng, [2, 1], NUM_BG)
    jgen, g_vars = step_pair[0].jax_gen
    args = (fg[0], fg[1], fg[2], bg[0], bg[1], bg[2], fg[3], bg[3])
    return jgen, _moved_stats(rng, g_vars), args


def _port_bgfg(variables) -> BgFgGenerator:
    gen = BgFgGenerator(NUM_FG, NUM_BG, ch=CH)
    gen.load_state_dict(bgfg_generator_state_dict_from_jax(variables), strict=True)
    return gen


def test_bgfg_converter_equals_the_export(bgfg):
    _, variables, _ = bgfg
    got = bgfg_generator_state_dict_from_jax(variables)
    want = export_bgfg_generator(variables)
    assert set(got) == set(want)
    assert {"combination.model.2.weight", "combination.model.5.bias",
            "background_g.res2.b1.batch_norm2d.running_var"} <= set(got)
    assert not any(k.startswith(("background_g.final", "foreground_g.final")) for k in got)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    gen = _port_bgfg(variables)  # strict
    sd = gen.state_dict()
    assert set(sd) == set(want)
    assert gen.combination.model[2] is gen.combination.conv1
    seeded = init_bgfg_generator(0, NUM_FG, NUM_BG, device="cpu", ch=CH)
    assert set(seeded.state_dict()) == set(want)
    assert gen.isla_calls == 16


@pytest.mark.parametrize("train", [False, True])
def test_feature_only_generator_matches_jax(bgfg, train):
    """The 64px v1 generator without its RGB head (one stream of Ours-ED)."""
    _, variables, args = bgfg
    sub = {k: variables[k]["foreground_g"] for k in ("params", "batch_stats", "spectral")}
    jgen = JaxLostGANGenerator(num_classes=NUM_FG, image_size=64, ch=CH, emb_dim=128,
                               mask_trunk="v1", rgb_head=False)
    z, boxes, labels, z_im = args[0], args[1], args[2], args[6]
    want, new = fast_jit(functools.partial(jgen.apply, train=train, update_stats=train,
                                          mutable=["batch_stats", "spectral"]))(
        sub, z, boxes, labels, z_im)
    gen = LostGANGenerator(NUM_FG, image_size=64, ch=CH, emb_dim=128, mask_trunk="v1",
                           rgb_head=False)
    gen.load_state_dict(generator_state_dict_from_jax(sub, res_start=2), strict=True)
    gen.train(train)
    got = gen(_t(z), _t(boxes), _t(labels).long(), _t(z_im))
    assert got.shape == (B, CH, 64, 64)
    _close(got, _nchw(want), what="features")
    if train:
        sd = generator_state_dict_from_jax({**sub, **new}, res_start=2)
        for k, v in gen.state_dict().items():
            if k.endswith(("running_mean", "running_var", "weight_u")):
                _close(v, sd[k].numpy(), 1e-5, k)


@pytest.mark.parametrize("train", [False, True])
def test_bgfg_forward_matches_jax(bgfg, train):
    jgen, variables, args = bgfg
    want, new = fast_jit(functools.partial(jgen.apply, train=train, update_stats=train,
                                          mutable=["batch_stats", "spectral"]))(variables, *args)
    gen = _port_bgfg(variables).train(train)
    t_args = [_t(a) for a in args]
    for i in (2, 5):
        t_args[i] = t_args[i].long()
    got = gen(*t_args)
    assert got.shape == (B, 3, 64, 64)
    _close(got, _nchw(want), what="images")
    if train:
        sd = bgfg_generator_state_dict_from_jax({**variables, **new})
        for k, v in gen.state_dict().items():
            if k.endswith(("running_mean", "running_var", "weight_u")):
                _close(v, sd[k].numpy(), 1e-5, k)


# ---- one train step against the JAX package's make_bgfg_train_step ----

def _batch(rng) -> dict:
    batch = synthetic.synthetic_batch(rng, B, 64, O, NC)
    batch["labels"] = np.array([[3, 120, 91, 0], [150, 7, 0, 0]], np.int32)  # 1-3 live per stream
    batch["boxes"][batch["labels"] == 0] = coco.PAD_BOX
    return coco.split_fg_bg_batch(batch)


@pytest.fixture(scope="module")
def step_pair():
    """The JAX step's new state, gradients and metrics, and ``port(config,
    noise=0)``, the port's step from the same weights and latents (G's
    weights first scaled by 1 + noise * N(0, 1) when ``noise``)."""
    rng = np.random.default_rng(9)
    batch = _batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["images"] = jnp.asarray(batch["images"].transpose(0, 2, 3, 1))
    cfg = JaxTrainConfig(use_vgg_loss=False)
    assert cfg.beta1 == 0.0  # so Adam's first moment after one step is the gradient
    jgen = JaxBgFgGenerator(num_fg_classes=NUM_FG, num_bg_classes=NUM_BG, ch=CH)
    jdisc = jax_make_discriminator("d64", NC, ch=CH)
    # JAX variables from the port's seeded nets through the JAX package's own
    # importers (create_bgfg_state would spend half a minute compiling init)
    g_vars = import_bgfg_generator(init_bgfg_generator(3, NUM_FG, NUM_BG, device="cpu",
                                                       ch=CH).state_dict())
    d_vars = import_lostgan_discriminator(init_discriminator(4, NC, preset="d64", device="cpu",
                                                            ch=CH).state_dict())
    tx = optax.adam(cfg.g_lr, b1=cfg.beta1, b2=cfg.beta2)
    rest = lambda v: {k: x for k, x in v.items() if k != "params"}  # noqa: E731
    state = JaxGANTrainState(step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
                             g_state=rest(g_vars), d_params=d_vars["params"], d_state=rest(d_vars),
                             g_opt_state=tx.init(g_vars["params"]),
                             d_opt_state=tx.init(d_vars["params"]), g_tx=tx, d_tx=tx)
    key = jax.random.PRNGKey(2)
    # the JAX step's latents, drawn from its key as it draws them
    keys = jax.random.split(key, 5)
    latents = [np.asarray(jax.random.normal(keys[i], shape))
               for i, shape in enumerate([(B, O, Z), (B, O, Z), (B, Z), (B, Z)])]
    new, metrics = fast_jit(jax_make_bgfg_train_step(jgen, jdisc, cfg))(state, jbatch, key)

    def tree(params, rest):
        return jax.tree_util.tree_map(np.asarray, {"params": params, **rest})

    g_vars, d_vars = tree(state.g_params, state.g_state), tree(state.d_params, state.d_state)
    want = SimpleNamespace(
        g=bgfg_generator_state_dict_from_jax(tree(new.g_params, new.g_state)),
        d=discriminator_state_dict_from_jax(tree(new.d_params, new.d_state)),
        g_grad=bgfg_generator_state_dict_from_jax(tree(new.g_opt_state[0].mu, state.g_state)),
        d_grad=discriminator_state_dict_from_jax(tree(new.d_opt_state[0].mu, state.d_state)),
        metrics={k: float(v) for k, v in metrics.items()}, jax_gen=(jgen, g_vars))

    def port(config: TrainConfig, noise: float = 0.0):
        gen = _port_bgfg(g_vars)
        if noise:
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in gen.parameters():
                    p.mul_(1 + noise * torch.randn(p.shape, generator=g))
        disc = make_discriminator("d64", NC, device="cpu", ch=CH)
        disc.load_state_dict(discriminator_state_dict_from_jax(d_vars), strict=True)
        st = create_bgfg_state(gen, disc, config)
        tb = {k: _t(v) for k, v in batch.items()}
        for k in ("labels", "labels_fg", "labels_bg"):
            tb[k] = tb[k].long()
        m = make_bgfg_train_step(st, config).with_latents(tb, *(_t(x) for x in latents))
        return st, m

    return want, port, port(TrainConfig(use_vgg_loss=False))


def _grad_gaps(module, grads: dict, tol: float) -> dict:
    """{name: (error norm, bar, relative tolerance or None)} of each gradient
    against JAX's; None marks the absolute bar of a round-off zero."""
    largest = max(np.linalg.norm(grads[n].numpy()) for n, _ in module.named_parameters())
    gaps = {}
    for name, p in module.named_parameters():
        w = grads[name].numpy()
        err, norm = np.linalg.norm(p.grad.numpy() - w), np.linalg.norm(w)
        gaps[name] = ((err, 1e-6 * largest, None) if norm < 1e-5 * largest
                      else (err, tol * norm, tol))
    return gaps


def test_bgfg_step_matches_jax(step_pair):
    want, _, (state, metrics) = step_pair
    assert set(metrics) == set(want.metrics) and state.step == 1
    for k, v in want.metrics.items():
        assert abs(metrics[k].item() - v) <= 2e-3, (k, metrics[k].item(), v)
    for module, sd, grads, tol in ((state.generator, want.g, want.g_grad, 5e-2),
                                   (state.discriminator, want.d, want.d_grad, 1e-3)):
        for name, (err, bar, _) in _grad_gaps(module, grads, tol).items():
            assert err <= bar, (name, err, bar)
        params = dict(module.named_parameters())
        beyond = total = 0
        for name, t in module.state_dict().items():
            w = sd[name].numpy()
            if name in params:
                diff = np.abs(t.numpy() - w)
                assert diff.max() <= 2 * LR + 1e-6, (name, diff.max())  # a flip, plus round-off
                sized = np.abs(grads[name].numpy()) > 1e-6
                beyond += int((diff[sized] > 1e-6).sum())
                total += int(sized.sum())
            elif name.endswith(("weight_u", "running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), w, atol=1e-5, rtol=0, err_msg=name)
        assert total > 1000 and beyond < 0.01 * total, (beyond, total)


def test_bgfg_step_gradient_gap_is_the_f32_spread(step_pair):
    """Why G's gradients get a 5e-2 bar: two ulps of noise on G's weights
    (1e-7 relative) move every G gradient that misses JAX's by more than
    1e-3 by at least half that gap."""
    want, port, (state, _) = step_pair
    noisy, _ = port(TrainConfig(use_vgg_loss=False), noise=1e-7)
    grads = dict(noisy.generator.named_parameters())
    params = dict(state.generator.named_parameters())
    wide = 0
    for name, (err, _, tol) in _grad_gaps(state.generator, want.g_grad, 5e-2).items():
        norm = np.linalg.norm(want.g_grad[name].numpy())
        if tol is not None and err > 1e-3 * norm:
            wide += 1
            p = params[name].grad
            spread = ((p - grads[name].grad).norm() / p.norm()).item()
            assert spread >= 0.5 * err / norm, (name, spread, err / norm)
    assert wide > 0  # the wide bar is needed at this seed


def test_bgfg_mixed_precision_flag_changes_nothing(step_pair):
    """The JAX Ours-ED step never reads ``mixed_precision``; the port's
    step is the f32 one with the flag on, bit for bit."""
    _, port, _ = step_pair
    f32_state, f32 = port(TrainConfig(use_vgg_loss=False))
    mixed_state, mixed = port(TrainConfig(use_vgg_loss=False, mixed_precision=True))
    for k in f32:
        assert torch.equal(f32[k], mixed[k]), k
    for (name, a), b in zip(f32_state.generator.state_dict().items(),
                            mixed_state.generator.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
