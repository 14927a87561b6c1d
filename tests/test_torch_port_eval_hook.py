"""The port's ``PeriodicEval`` against the JAX package's: the same frozen
real pool, the same stub sampler images (NHWC into JAX, NCHW into the port)
and the same Inception weights (one torchvision-named file, which both
packages load), so both report ``rel_fid``, ``is_mean`` and ``is_std``.

Bars (measured on an Intel Xeon CPU: rel_fid 93.08 apart by 2.9e-6 relative, is_mean
by 9e-11 relative, is_std by 1.3e-10 absolute): rel_fid 1e-4 relative (four
images give covariances of rank 3, whose matrix square root amplifies the
features' 2e-6 relative differences), is_mean 1e-6 relative, is_std 1e-9
absolute."""

import itertools
import types

import numpy as np
import torch

from layout2img_tpu.train.eval_hook import PeriodicEval as JaxPeriodicEval
from layout2img_tpu_torch.eval.inception import random_inception_state_dict
from layout2img_tpu_torch.train.eval_hook import PeriodicEval
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

B, SIZE, N_BATCHES = 2, 64, 2


def _pool(rng) -> list[dict]:
    """Real batches, NHWC images as the JAX loader gives them."""
    out = []
    for _ in range(N_BATCHES):
        out.append({"images": rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
                    "labels": rng.integers(1, 10, (B, 4)).astype(np.int32),
                    "boxes": rng.uniform(0, 0.5, (B, 4, 4)).astype(np.float32)})
    return out


def test_rel_fid_and_is_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    pool = _pool(rng)
    fakes = [np.tanh(2 * rng.standard_normal((B, SIZE, SIZE, 3))).astype(np.float32)
             for _ in range(N_BATCHES)]
    path = str(tmp_path / "inception_v3.pth")
    torch.save(random_inception_state_dict(5), path)

    jax_fakes = itertools.cycle(fakes)
    jax_hook = JaxPeriodicEval(lambda p, s, boxes, labels, key: next(jax_fakes), pool,
                               inception_weights=path, batch_size=B, seed=0)
    want = jax_hook(types.SimpleNamespace(ema_params=None, g_params={}, g_state={}))

    port_pool = [{**b, "images": b["images"].transpose(0, 3, 1, 2)} for b in pool]
    port_fakes = itertools.cycle([torch.from_numpy(f.transpose(0, 3, 1, 2)) for f in fakes])
    calls = []

    def sample(params, boxes, labels, rng_):
        calls.append((params, boxes.shape, labels.dtype, rng_.initial_seed()))
        return next(port_fakes)

    hook = PeriodicEval(sample, port_pool, inception_weights=path, device="cpu", seed=0)
    got = hook(types.SimpleNamespace(ema=None))
    assert hook.n_images == jax_hook.n_images == B * N_BATCHES
    assert set(got) == set(want) == {"rel_fid", "is_mean", "is_std"}
    assert got["rel_fid"] > 0
    np.testing.assert_allclose(got["rel_fid"], want["rel_fid"], rtol=1e-4)
    np.testing.assert_allclose(got["is_mean"], want["is_mean"], rtol=1e-6)
    np.testing.assert_allclose(got["is_std"], want["is_std"], rtol=1e-6, atol=1e-9)
    # the frozen latents: batch i seeded with seed * 100003 + i, as JAX's PRNGKey
    assert [c[3] for c in calls] == [0, 1]
    assert all(c[0] is None and c[1] == (B, 4, 4) for c in calls)
