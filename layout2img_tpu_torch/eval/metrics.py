"""Generative metrics: Inception Score, FID and KID (counterpart of
``layout2img_tpu/eval/metrics.py``).

The host half (``inception_score`` .. ``load_feature_stats``) is this
package's own copy of the JAX package's numpy and scipy functions, the same
arithmetic line for line, so both packages give the same numbers and read
each other's ``.npz`` statistics files. IS follows the reference protocol
(``IS.py:111-148``): split the probabilities, IS_split = exp(mean_i
KL(p(y|x_i) || mean_i p(y|x_i))), mean and std over ``splits`` (3, not the
usual 10). FID is the Frechet distance of pool3 features; KID the unbiased
polynomial-kernel MMD.

The device half (``run_inception``, ``run_inception_batches``) moves each
NHWC numpy chunk to the device as NCHW f32 and runs InceptionV3 under
``torch.inference_mode`` with TF32 off in cuDNN and matmul (restored after),
the softmax on the device. Eval-mode BN makes the features per image, so a
ragged last chunk needs no padding.
"""

from __future__ import annotations

import contextlib
from typing import Iterable

import numpy as np
import torch


def inception_score(probs: np.ndarray, splits: int = 3) -> tuple[float, float]:
    """probs: (n, num_classes) softmax outputs."""
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(marginal + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)).

    Rank-deficient covariances (fewer samples than feature dims, the usual
    case below ~2049 images) make sqrtm(s1 s2) numerically unstable; retry
    with eps-regularized diagonals like pytorch-fid when that happens."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    if not np.isfinite(covmean).all():
        print(f"WARNING: singular product of covariances; adding eps={eps} "
              "to the diagonals (sample count likely < feature dim)")
        off = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + off) @ (sigma2 + off))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    f1 = np.asarray(feats1, np.float64)
    f2 = np.asarray(feats2, np.float64)
    mu1, mu2 = f1.mean(0), f2.mean(0)
    s1 = np.cov(f1, rowvar=False)
    s2 = np.cov(f2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


def kid_from_features(feats1: np.ndarray, feats2: np.ndarray, subset_size: int = 1000,
                      num_subsets: int = 100, seed: int = 0) -> tuple[float, float]:
    """Kernel Inception Distance (Binkowski et al., 2018): the unbiased
    squared MMD between pool3 feature sets under k(x, y) = (x.y / d + 1)^3,
    averaged over ``num_subsets`` random subsets of ``subset_size`` drawn
    from ``np.random.default_rng(seed)``. Returns (mean, std across
    subsets)."""
    f1 = np.asarray(feats1, np.float64)
    f2 = np.asarray(feats2, np.float64)
    if f1.ndim != 2 or f2.ndim != 2 or f1.shape[1] != f2.shape[1]:
        raise ValueError(f"feature shapes mismatch: {f1.shape} vs {f2.shape}")
    m = min(subset_size, len(f1), len(f2))
    if m < 2:
        raise ValueError("KID needs at least 2 samples per set")
    d = f1.shape[1]

    def poly3(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        return (x @ y.T / d + 1.0) ** 3

    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(num_subsets):
        x = f1[rng.choice(len(f1), m, replace=False)]
        y = f2[rng.choice(len(f2), m, replace=False)]
        kxx, kyy, kxy = poly3(x, x), poly3(y, y), poly3(x, y)
        mmd2 = (
            (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
            + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
            - 2.0 * kxy.mean()
        )
        vals.append(mmd2)
    return float(np.mean(vals)), float(np.std(vals))


def feature_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, d) features -> (mu (d,), sigma (d, d)) Frechet statistics."""
    f = np.asarray(feats, np.float64)
    return f.mean(0), np.cov(f, rowvar=False)


def save_feature_stats(path: str, mu: np.ndarray, sigma: np.ndarray, n: int) -> None:
    """Write FID statistics (pytorch-fid's ``.npz`` convention: arrays ``mu``
    and ``sigma``, plus ``n``, the sample count they came from)."""
    np.savez(path, mu=np.asarray(mu, np.float64),
             sigma=np.asarray(sigma, np.float64), n=np.int64(n))


def load_feature_stats(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Read stats written by :func:`save_feature_stats` (or any pytorch-fid
    style .npz with ``mu``/``sigma``). Returns (mu, sigma, n) with n = -1 when
    the file does not record a sample count."""
    with np.load(path) as z:
        if "mu" not in z or "sigma" not in z:
            raise ValueError(
                f"{path} is not a FID stats file (needs arrays 'mu' and 'sigma')")
        mu = np.asarray(z["mu"], np.float64)
        sigma = np.asarray(z["sigma"], np.float64)
        n = int(z["n"]) if "n" in z else -1
    if mu.ndim != 1 or sigma.shape != (mu.shape[0], mu.shape[0]):
        raise ValueError(
            f"{path}: bad stats shapes mu{mu.shape} sigma{sigma.shape}")
    return mu, sigma, n


@contextlib.contextmanager
def tf32_off():
    """TF32 off in cuDNN and matmul for the block (an f32 eval, as the port's
    f32 train step runs), the caller's flags restored after."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def run_inception_nchw(net: torch.nn.Module, batches: Iterable[torch.Tensor]
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Features (n, 2048) and probabilities (n, 1000), f32 numpy, of
    (<=b, 3, h, w) image batches in [-1, 1] that lie on ``net``'s device
    (or are moved there)."""
    device = next(net.parameters()).device
    feats, probs = [], []
    with torch.inference_mode(), tf32_off():
        for x in batches:
            f, logits = net(x.to(device=device, dtype=torch.float32))
            feats.append(f.float().cpu().numpy())
            probs.append(torch.softmax(logits.float(), dim=-1).cpu().numpy())
    if not feats:
        raise ValueError("no image batches to run inception on")
    return np.concatenate(feats), np.concatenate(probs)


def run_inception_batches(net: torch.nn.Module, batches: Iterable[np.ndarray], mesh=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """``run_inception_nchw`` over (<=b, h, w, 3) NHWC numpy chunks in
    [-1, 1] (the arrays ``cli.evaluate`` decodes), each moved to the device
    as NCHW f32.

    ``mesh``: a data-parallel mesh (``parallel/mesh.py``) whose every rank
    passes the same chunks: each chunk is padded up to a multiple of W (as
    the JAX function pads to its mesh), each rank runs its rows, and the
    features and probabilities of every rank are gathered and the pad rows
    cut, so every rank returns what one process returns."""
    if mesh is None or mesh.group is None:
        return run_inception_nchw(
            net, (torch.from_numpy(np.ascontiguousarray(c, np.float32)).permute(0, 3, 1, 2)
                  for c in batches))
    feats, probs = [], []
    for c in batches:
        c = np.asarray(c, np.float32)
        n = c.shape[0]
        per = -(-n // mesh.world)
        c = np.concatenate([c, np.zeros((per * mesh.world - n, *c.shape[1:]), np.float32)])
        mine = torch.from_numpy(np.ascontiguousarray(c[mesh.rank * per:(mesh.rank + 1) * per]))
        f, p = run_inception_nchw(net, [mine.permute(0, 3, 1, 2)])
        feats.append(mesh.gather_rows(f)[:n])
        probs.append(mesh.gather_rows(p)[:n])
    if not feats:
        raise ValueError("no image batches to run inception on")
    return np.concatenate(feats), np.concatenate(probs)


def run_inception(net: torch.nn.Module, images: np.ndarray, batch_size: int = 64
                  ) -> tuple[np.ndarray, np.ndarray]:
    """images: (n, h, w, 3) in [-1, 1] -> (features (n, 2048), probs (n,
    1000)), ``batch_size`` images per device call."""
    n = images.shape[0]
    return run_inception_batches(net, (images[i:i + batch_size] for i in range(0, n, batch_size)))
