"""The port's metric functions against the JAX package's on the same seeded
arrays (1e-12: the same numpy and scipy arithmetic), FID statistics files
across the two packages, and the port's random Inception fallback."""

import math

import numpy as np
import pytest
import torch

from layout2img_tpu.eval import metrics as jm
from layout2img_tpu_torch.eval import metrics as pm
from layout2img_tpu_torch.eval.inception import (TRUNC_STD, load_inception,
                                                 random_inception_state_dict)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _eval_threads():
    """Two intra-op torch threads and one BLAS thread while a module that
    uses this runs (the eval files import it): the suite runs one module per
    worker on six workers, and each FID's 2048x2048 matrix square root gains
    little from BLAS threads but starves the other workers with them."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    if threadpool_limits is None:
        yield
    else:
        with threadpool_limits(limits=1, user_api="blas"):
            yield
    torch.set_num_threads(threads)


def _close(a, b) -> None:
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("splits", [1, 3, 10])
def test_inception_score_matches_jax(splits):
    rng = np.random.default_rng(splits)
    logits = rng.standard_normal((31, 20)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    _close(pm.inception_score(probs, splits), jm.inception_score(probs, splits))


@pytest.mark.parametrize("n", [5, 200])  # rank-deficient (eps retry possible) and full rank
def test_fid_matches_jax(n):
    rng = np.random.default_rng(n)
    f1 = rng.standard_normal((n, 16))
    f2 = rng.standard_normal((n, 16)) * 1.3 + 0.2
    _close(pm.fid_from_features(f1, f2), jm.fid_from_features(f1, f2))
    mu1, s1 = pm.feature_stats(f1)
    jmu, js1 = jm.feature_stats(f1)
    _close(mu1, jmu)
    _close(s1, js1)
    mu2, s2 = pm.feature_stats(f2)
    _close(pm.frechet_distance(mu1, s1, mu2, s2), jm.frechet_distance(mu1, s1, mu2, s2))
    assert pm.fid_from_features(f1, f1.copy()) < 1e-6


@pytest.mark.parametrize("subset_size,subsets", [(1000, 3), (7, 10)])
def test_kid_matches_jax(subset_size, subsets):
    rng = np.random.default_rng(subset_size)
    f1, f2 = rng.standard_normal((40, 12)), rng.standard_normal((30, 12)) + 0.1
    _close(pm.kid_from_features(f1, f2, subset_size, subsets, seed=4),
           jm.kid_from_features(f1, f2, subset_size, subsets, seed=4))
    for bad in ((f1, f2[:, :5]), (f1[:1], f2)):
        with pytest.raises(ValueError):
            pm.kid_from_features(*bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stats_files_load_in_both_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((9, 6))
    mu, sigma = pm.feature_stats(feats)
    path = str(tmp_path / "stats.npz")
    (pm if writer == "port" else jm).save_feature_stats(path, mu, sigma, 9)
    for reader in (pm, jm):
        got_mu, got_sigma, n = reader.load_feature_stats(path)
        assert n == 9
        np.testing.assert_array_equal(got_mu, mu)
        np.testing.assert_array_equal(got_sigma, sigma)
    np.savez(str(tmp_path / "no_n.npz"), mu=mu, sigma=sigma)
    assert pm.load_feature_stats(str(tmp_path / "no_n.npz"))[2] == -1
    np.savez(str(tmp_path / "bad.npz"), mu=mu)
    with pytest.raises(ValueError, match="not a FID stats file"):
        pm.load_feature_stats(str(tmp_path / "bad.npz"))
    np.savez(str(tmp_path / "shape.npz"), mu=mu, sigma=sigma[:3])
    with pytest.raises(ValueError, match="bad stats shapes"):
        pm.load_feature_stats(str(tmp_path / "shape.npz"))


def test_random_inception_fallback():
    """Every conv kernel's std is within 5% of sqrt(2/fan_in) (lecun-normal
    times sqrt(2)), the fc kernel's of sqrt(1/fan_in); the draws are
    truncated at two of flax's standard deviations; biases and BN are
    identity; one seed gives the same bits, without touching torch's global
    generator; the pool3 features of distinct images are not degenerate."""
    state = torch.get_rng_state()
    sd = random_inception_state_dict(0)
    assert torch.equal(torch.get_rng_state(), state)
    convs = [k for k in sd if k.endswith("conv.weight")]
    assert len(convs) == 94
    for k in convs + ["fc.weight"]:
        w = sd[k]
        fan_in = w[0].numel()
        target = math.sqrt((1.0 if k == "fc.weight" else 2.0) / fan_in)
        assert abs(w.std().item() / target - 1) < 0.05, (k, w.std().item(), target)
        assert w.abs().max().item() <= 2 * target / TRUNC_STD * (1 + 1e-6), k
    for k, v in sd.items():
        if k.endswith(("bn.bias", "running_mean", "fc.bias", "num_batches_tracked")):
            assert not v.any(), k
        elif k.endswith(("bn.weight", "running_var")):
            assert torch.equal(v, torch.ones_like(v)), k
    again = random_inception_state_dict(0)
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
    assert not torch.equal(random_inception_state_dict(1)["fc.weight"], sd["fc.weight"])

    net = load_inception(sd, "cpu")
    rng = np.random.default_rng(0)
    feats, probs = pm.run_inception(net, rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32))
    assert feats.shape == (4, 2048) and probs.shape == (4, 1000)
    assert np.isfinite(feats).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    # lecun-normal alone would leave about 1e-6 of variance at pool3
    assert feats.var() > 1e-2
    assert feats.std(0).mean() > 1e-4


def test_tf32_off_restores_the_flags():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with pm.tf32_off():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
