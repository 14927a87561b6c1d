"""The port's ``PeriodicEval`` on a real (tiny) training state: it is
deterministic, samples the EMA when the state has one, and leaves every
training tensor, both optimizers and the latent generator as they were;
``cli.train --inception_weights`` adds the Inception Score.

The first two tests put a cheap stand-in for the Frechet distance in the
hook (a distance of the same statistics): the hook's plumbing is under test
there, and the distance itself is held against JAX's in
``test_torch_port_eval_hook.py``."""

import json
import os
import types

import numpy as np
import pytest
import torch

from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import synthetic_batch
from layout2img_tpu_torch.eval.inception import random_inception_state_dict
from layout2img_tpu_torch.train import eval_hook
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

SIZE, B, NC = 64, 2, 10


@pytest.fixture
def stand_in_distance(monkeypatch):
    """The squared mean distance plus the covariances' Frobenius distance."""
    def distance(mu1, s1, mu2, s2):
        return float(np.sum((mu1 - mu2) ** 2) + np.linalg.norm(s1 - s2))

    monkeypatch.setattr(eval_hook, "frechet_distance", distance)


def _batch(seed: int) -> dict:
    b = synthetic_batch(np.random.default_rng(seed), B, SIZE, 4, NC)
    return {**b, "labels": b["labels"].astype(np.int64)}


def _state(ema_decay: float):
    gen = init_generator(0, NC, device="cpu", ch=4, image_size=SIZE, num_mask_classes=NC)
    disc = init_discriminator(1, NC, device="cpu", ch=4, image_size=SIZE)
    cfg = TrainConfig(use_vgg_loss=False, ema_decay=ema_decay)
    return create_train_state(gen, disc, cfg), cfg


def _hook(gen, seed: int = 1):
    pool = [_batch(10), _batch(11)]
    return eval_hook.PeriodicEval(eval_hook.make_train_sample_fn(gen), pool, device="cpu",
                                  seed=seed)


def test_hook_is_deterministic_and_prefers_the_ema(stand_in_distance):
    state, _ = _state(ema_decay=0.9)
    hook = _hook(state.generator)
    a, b = hook(state)["rel_fid"], hook(state)["rel_fid"]
    assert a == b and np.isfinite(a)
    # the EMA starts as a copy of G's parameters: the same number as no EMA
    assert hook(types.SimpleNamespace(ema=None))["rel_fid"] == a
    state.ema = {k: v + 0.5 for k, v in state.ema.items()}
    assert hook(state)["rel_fid"] != a
    # another seed draws other frozen latents
    assert _hook(state.generator, seed=2)(types.SimpleNamespace(ema=None))["rel_fid"] != a


def _snapshot(state, z_rng) -> list:
    tensors = list(state.generator.state_dict().values()) + list(
        state.discriminator.state_dict().values())
    for opt in (state.g_opt, state.d_opt):
        for st in opt.state_dict()["state"].values():
            tensors += [v for v in st.values() if torch.is_tensor(v)]
    tensors += list(state.ema.values())
    return [t.clone() for t in tensors] + [z_rng.get_state(), torch.get_rng_state()]


def test_hook_leaves_the_training_state_untouched(stand_in_distance):
    state, cfg = _state(ema_decay=0.9)
    step = make_train_step(state, cfg)
    z_rng = torch.Generator().manual_seed(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    step(batch, z_rng)  # Adam moments, BN statistics and SN vectors exist
    hook = _hook(state.generator)
    before = _snapshot(state, z_rng)
    out = hook(state)
    after = _snapshot(state, z_rng)
    assert np.isfinite(out["rel_fid"])
    assert len(before) == len(after) > 100
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert state.generator.training and state.discriminator.training


def test_inception_weights_add_the_inception_score(tmp_path):
    """With ``--inception_weights`` (a torchvision-named file) the eval line
    has ``is_mean``/``is_std`` beside ``rel_fid``, and no random-filter
    warning."""
    weights = str(tmp_path / "inception_v3.pth")
    torch.save(random_inception_state_dict(4), weights)
    out = str(tmp_path / "out")
    train_cli.main(["--dataset", "synthetic", "--img_size", "64", "--ch", "4", "--no_vgg",
                    "--batch_size", "2", "--device", "cpu", "--steps", "2", "--log_every", "2",
                    "--eval_every", "2", "--eval_n", "4", "--inception_weights", weights,
                    "--out_path", out])
    run = os.path.join(out, "synthetic", "64", "context_app_v2")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        evals = [ln for ln in map(json.loads, f) if "rel_fid" in ln]
    assert [ln["step"] for ln in evals] == [2]
    assert all(np.isfinite(evals[0][k]) for k in ("rel_fid", "is_mean", "is_std"))
    assert evals[0]["is_mean"] >= 1.0 - 1e-9
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    assert "periodic eval: 4 real images every 2 steps" in log
    assert "random filters" not in log


def test_batch_mode_hands_the_sampler_whole_batches(stand_in_distance):
    """``batch_mode``: the sampler gets each frozen batch without its images
    (every other field kept, as the special families' samplers need) and
    the frozen generator of its index."""
    pool = [{**_batch(20 + i), "fg_labels": np.full((B, 2), i)} for i in range(2)]
    seen = []

    def sample(params, batch, rng):
        seen.append((params, sorted(batch), int(batch["fg_labels"][0, 0]), rng.initial_seed()))
        return torch.zeros(B, 3, SIZE, SIZE)

    hook = eval_hook.PeriodicEval(sample, pool, device="cpu", seed=3, batch_mode=True)
    out = hook(types.SimpleNamespace(ema=None))
    assert np.isfinite(out["rel_fid"]) and hook.n_images == 2 * B
    assert seen == [(None, ["boxes", "fg_labels", "labels"], i, 3 * 100003 + i) for i in range(2)]
