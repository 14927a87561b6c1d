"""Remat in the port: the recompute replays the forward's state, so a remat
step is the plain step (``nn/remat.py``), on the CPU.

``jax.checkpoint`` is pure, so the JAX package's remat step equals its plain
step (``tests/test_train_step.py:174-225``). The port's layers write state in
training (SN ``weight_u``, BN running statistics), and a plain
``torch.utils.checkpoint`` would run that forward twice: u advanced twice,
a recomputed sigma that is not the forward's (silently other gradients) and
running statistics folded twice. Held here, at ch=4, b=2, 128 px, o=8, VGG
off, from seeded weights:

- ``remat`` "g", "d", "gd" and ``LayoutDiscriminator(remat_blocks=N)`` (alone
  and inside ``remat="d"``), in f32 and under mixed precision, against the
  plain step: losses at rtol 1e-4 + atol 1e-5 and parameters within 2.1e-4
  (the JAX remat tests' bars), every gradient within 1e-6 of its norm, and
  every SN vector and BN running statistic equal to 1e-6;
- the PSP dropout draws the same mask in the recompute;
- the ISLA norm runs 20 times per step under remat "g" (the forward and its
  recompute), 10 otherwise;
- on one layer: ``nn/remat.py::checkpoint`` advances u once and gives the
  plain gradient, where a bare ``torch.utils.checkpoint`` advances it twice.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from layout2img_tpu_torch.data.synthetic import synthetic_batch
from layout2img_tpu_torch.nn import norms as norms_module
from layout2img_tpu_torch.nn import remat
from layout2img_tpu_torch.nn.norms import SyncBatchNorm
from layout2img_tpu_torch.nn.spectral import SNConv
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

CH, NC, B, O = 4, 10, 2, 8
STATE = ("weight_u", "weight_v", "running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(rng, B, 128, O, NC).items()}
    batch["labels"] = batch["labels"].long()
    g = torch.Generator().manual_seed(12)
    return batch, torch.randn(B, O, 128, generator=g), torch.randn(B, 128, generator=g)


def run(inputs, cfg: TrainConfig, remat_blocks: int = 0, deterministic: bool = True,
        seed: int = 0) -> SimpleNamespace:
    gen = init_generator(0, NC, device="cpu", ch=CH, num_mask_classes=NC)
    disc = init_discriminator(1, NC, device="cpu", ch=CH, remat_blocks=remat_blocks)
    state = create_train_state(gen, disc, cfg)
    step = make_train_step(state, cfg, deterministic=deterministic)
    torch.manual_seed(seed)  # the PSP dropout's draws
    metrics = step.with_latents(*inputs)
    return SimpleNamespace(state=state, metrics={k: v.item() for k, v in metrics.items()})


def check_same(a: SimpleNamespace, b: SimpleNamespace) -> None:
    assert set(a.metrics) == set(b.metrics)
    for k, v in b.metrics.items():
        assert abs(a.metrics[k] - v) <= 1e-5 + 1e-4 * abs(v), (k, a.metrics[k], v)
    for ma, mb in ((a.state.generator, b.state.generator),
                   (a.state.discriminator, b.state.discriminator)):
        pb = dict(mb.named_parameters())
        for name, p in ma.named_parameters():
            assert (p - pb[name]).abs().max().item() <= 2.1e-4, name
            err, norm = (p.grad - pb[name].grad).norm().item(), pb[name].grad.norm().item()
            assert err <= 1e-6 * max(norm, 1e-30) + 1e-12, (name, err, norm)
        sb = mb.state_dict()
        for name, t in ma.state_dict().items():
            if name.endswith(STATE):
                torch.testing.assert_close(t, sb[name], atol=1e-6, rtol=0, msg=name)


@pytest.fixture(scope="module")
def plain(inputs):
    return {mixed: run(inputs, TrainConfig(use_vgg_loss=False, mixed_precision=mixed))
            for mixed in (False, True)}


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("mode", ["g", "d", "gd"])
def test_remat_step_is_the_plain_step(inputs, plain, mode, mixed):
    cfg = TrainConfig(use_vgg_loss=False, remat=mode, mixed_precision=mixed)
    check_same(run(inputs, cfg), plain[mixed])


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("blocks,mode", [(1, "none"), (2, "none"), (3, "none"), (2, "d"), (3, "gd")])
def test_remat_d_blocks_step_is_the_plain_step(inputs, plain, blocks, mode, mixed):
    cfg = TrainConfig(use_vgg_loss=False, remat=mode, mixed_precision=mixed)
    check_same(run(inputs, cfg, remat_blocks=blocks), plain[mixed])


def test_remat_replays_the_dropout_mask(inputs):
    """With the PSP dropout live, the recompute draws the forward's mask
    (``preserve_rng_state``): the remat step equals the plain step from the
    same seed, and another seed gives another step."""
    cfg = TrainConfig(use_vgg_loss=False)
    want = run(inputs, cfg, deterministic=False, seed=5)
    check_same(run(inputs, TrainConfig(use_vgg_loss=False, remat="gd"), deterministic=False,
                   seed=5), want)
    other = run(inputs, cfg, deterministic=False, seed=6)
    assert abs(other.metrics["g_loss"] - want.metrics["g_loss"]) > 1e-6


@pytest.mark.parametrize("mode,calls", [("none", 10), ("g", 20), ("d", 10), ("gd", 20)])
def test_isla_norm_runs_again_only_in_the_g_recompute(inputs, monkeypatch, mode, calls):
    count = []
    isla = norms_module.isla_norm

    def counted(*args, **kwargs):
        count.append(1)
        return isla(*args, **kwargs)

    monkeypatch.setattr(norms_module, "isla_norm", counted)
    run(inputs, TrainConfig(use_vgg_loss=False, remat=mode))
    assert len(count) == calls


def _sn_layer():
    torch.manual_seed(3)
    conv = SNConv(3, 5, 3).train()
    with torch.no_grad():
        conv.weight_orig.normal_()
        conv.bias.normal_()
        conv.weight_u.normal_()
    return conv


@pytest.mark.parametrize("wrap", ["none", "remat", "nested", "bare"])
def test_spectral_norm_under_checkpoint(wrap):
    """One call of an SN conv and its backward. ``remat.checkpoint`` (also
    inside another region) matches the plain call: u advanced once, the
    same gradients. A bare ``torch.utils.checkpoint`` advances u twice and
    changes the gradient: the fault that ``nn/remat.py`` exists for."""
    ref, conv = _sn_layer(), _sn_layer()
    x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(4))
    (ref(x) ** 2).sum().backward()
    u_before = conv.weight_u.clone()
    call = {"none": lambda: conv(x), "remat": lambda: remat.checkpoint(conv, x),
            "nested": lambda: remat.checkpoint(lambda t: remat.checkpoint_module(conv, t), x),
            "bare": lambda: torch.utils.checkpoint.checkpoint(conv, x, use_reentrant=False)}[wrap]
    (call() ** 2).sum().backward()
    if wrap == "bare":
        assert (conv.weight_u - ref.weight_u).abs().max() > 1e-4
        assert (conv.weight_orig.grad - ref.weight_orig.grad).abs().max() > 1e-5
        return
    assert not torch.equal(conv.weight_u, u_before)
    torch.testing.assert_close(conv.weight_u, ref.weight_u, atol=0, rtol=0)
    torch.testing.assert_close(conv.weight_orig.grad, ref.weight_orig.grad, atol=1e-6, rtol=0)


def test_batch_norm_folds_once_under_checkpoint():
    torch.manual_seed(0)
    bn, ref = SyncBatchNorm(4).train(), SyncBatchNorm(4).train()
    x = torch.randn(3, 4, 5, 5, requires_grad=True)
    (remat.checkpoint(bn, x) ** 3).sum().backward()
    grad = x.grad.clone()
    x.grad = None
    (ref(x) ** 3).sum().backward()
    assert bn.num_batches_tracked.item() == 1
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bn, name), getattr(ref, name), atol=0, rtol=0)
    torch.testing.assert_close(grad, x.grad, atol=1e-6, rtol=0)
