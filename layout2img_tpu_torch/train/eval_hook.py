"""Periodic in-training evaluation (counterpart of ``layout2img_tpu/train/eval_hook.py``).

The reference evaluates offline only (dump JPEGs, then ``IS.py`` and an
external FID). This hook holds a frozen pool of real layouts and images and,
every ``--eval_every`` steps, samples the generator on the same layouts with
the same latents and reports

- ``rel_fid``: the Frechet distance between the fakes' Inception features
  and the real pool's, whose statistics are computed once, at construction.
  With real ``--inception_weights`` it is a small-n FID; with the seeded
  random filters (``eval/inception.py::random_inception_state_dict``) it is
  a relative trajectory only (falling: the distributions converge);
- ``is_mean``/``is_std``: the fakes' Inception Score, only with real weights
  (the softmax of random-filter logits means nothing).

Batch ``i``'s latents come from ``torch.Generator(device).manual_seed(seed *
100003 + i)``, so two evaluations differ only through the generator's
weights. Under a data-parallel mesh each rank holds its own pool, samples
it (rank r's batch i from seed ``(seed * 100003 + i) * W + r``) and runs
Inception on its own images; the features of every rank are gathered, so
every rank computes the same numbers over the W pools. The hook samples
the EMA parameters when the state has them, and
changes no training state: the sampler runs the generator in eval mode
(running BN statistics, no SN power iteration) on generators of its own.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.eval.inception import load_inception
from layout2img_tpu_torch.eval.metrics import (feature_stats, frechet_distance, inception_score,
                                               run_inception_nchw)
from layout2img_tpu_torch.parallel.mesh import DataMesh


def make_train_sample_fn(gen: torch.nn.Module, truncation: float = 2.0) -> Callable:
    """``sample(params, boxes, labels, rng) -> (b, 3, h, w)`` images of the
    training generator ``gen`` in eval mode, with ``params`` (a name ->
    tensor dict such as the EMA) in place of its parameters unless None;
    truncated-normal latents from ``rng``. ``gen`` is back in training mode
    after each call."""
    from layout2img_tpu_torch.sample import truncated_normal

    @torch.no_grad()
    def sample(params: dict | None, boxes: torch.Tensor, labels: torch.Tensor,
               rng: torch.Generator) -> torch.Tensor:
        device = next(gen.parameters()).device
        boxes = boxes.to(device=device, dtype=torch.float32)
        labels = labels.to(device=device, dtype=torch.long)
        b, o = labels.shape
        z = truncated_normal((b, o, gen.z_dim), truncation, rng, device, torch.float32)
        z_im = truncated_normal((b, gen.z_dim), truncation, rng, device, torch.float32)
        gen.eval()
        try:
            if params is None:
                return gen(z, boxes, labels, z_im)
            return torch.func.functional_call(gen, params, (z, boxes, labels, z_im))
        finally:
            gen.train()

    return sample


class PeriodicEval:
    """Callable hook: ``metrics = hook(state)``.

    Args:
      sample_fn: ``(params, boxes, labels, rng) -> images`` (``params``: the
        EMA dict or None; ``make_train_sample_fn``). With ``batch_mode=True``
        it is ``(params, batch, rng) -> images``, ``batch`` a frozen pool
        batch without its ``images``: the shape the special families'
        samplers take.
      eval_batches: the frozen real pool, host batches (dicts of arrays or
        tensors with NCHW ``images`` in [-1, 1], ``labels``, ``boxes``).
      inception_weights: a torchvision ``inception_v3`` ``.pth`` path; empty:
        the seed-0 random filters.
      device: where Inception runs and the latent generators live (default
        cuda).
      seed: the frozen latents' seed.
      mesh: the data-parallel mesh (``parallel/mesh.py``; default: one process).
    """

    def __init__(self, sample_fn: Callable, eval_batches: list, *,
                 inception_weights: str = "", device: str | torch.device | None = None,
                 seed: int = 0, batch_mode: bool = False, mesh: DataMesh | None = None):
        if not eval_batches:
            raise ValueError("PeriodicEval needs at least one eval batch")
        self.device = resolve_device(device)
        self.real_weights = bool(inception_weights)
        self._net = load_inception(inception_weights, self.device)
        self._sample_fn = sample_fn
        self._seed = seed
        self._batch_mode = batch_mode
        self._mesh = mesh or DataMesh()
        if batch_mode:
            self._layouts = [{k: torch.as_tensor(np.asarray(v)) for k, v in b.items()
                              if k != "images"} for b in eval_batches]
        else:
            self._layouts = [(torch.as_tensor(np.asarray(b["boxes"])),
                              torch.as_tensor(np.asarray(b["labels"]))) for b in eval_batches]
        real, _ = run_inception_nchw(
            self._net, (torch.as_tensor(np.asarray(b["images"])) for b in eval_batches))
        real = self._mesh.gather_rows(real)
        self._real_mu, self._real_sigma = feature_stats(real)
        self.n_images = len(real)

    def _fakes(self, params: dict | None):
        for i, layout in enumerate(self._layouts):
            seed = (self._seed * 100003 + i) * self._mesh.world + self._mesh.rank
            rng = torch.Generator(device=self.device).manual_seed(seed)
            if self._batch_mode:
                yield self._sample_fn(params, layout, rng)
            else:
                yield self._sample_fn(params, *layout, rng)

    def __call__(self, state) -> dict:
        feats, probs = run_inception_nchw(self._net, self._fakes(getattr(state, "ema", None)))
        feats, probs = self._mesh.gather_rows(feats), self._mesh.gather_rows(probs)
        mu, sigma = feature_stats(feats)
        out = {"rel_fid": frechet_distance(mu, sigma, self._real_mu, self._real_sigma)}
        if self.real_weights:
            out["is_mean"], out["is_std"] = inception_score(probs)
        return out
