"""Data parallelism on the CPU (``layout2img_tpu_torch/parallel/mesh.py``):
2 ranks over gloo, started with ``torch.multiprocessing``
(``tests/torch_parallel_ranks.py``), each on half of a global batch, against
the port's one-process step on the whole batch.

- ``batch_stats`` (alone and inside an ISLA norm, whose kernels take the
  global statistics) under 2 ranks equals the global one, and so do the
  ranks' mean of ``masked_mean``, the gradients at each rank's half of the
  input and the BN running statistics (unbiased with the global count);
  ``run_inception_batches(mesh=)`` gathers the one-process features.
- The LostGAN step (``ours_d_context128`` + ``d128_app`` at ch=4, 64 px, 6
  slots with pads, 2 images per rank, VGG off, dropout live) in f32 with
  the EMA, mixed precision, ``remat="gd"``, ``fused_d``, G and D object
  budgets, the v1 mask trunk (``lostgan128``) and the part masks
  (``context128_part``), 2 steps each; and the special families' steps,
  one each: Ours-ED (``BgFgGenerator`` at ch=4 against ``d64``) and
  layout2im (the transformer fusion, its masked BN counts global). Across
  the ranks every tensor of the state (parameters, SN vectors, BN
  statistics, Adam moments and counts, EMA) is bit-equal after each step.
  Against the one-process step:

  - D's losses of the first step, computed before any update, to 1e-5
    relative (f32);
  - every other loss to 2e-4 after one step and 1e-3 after two (f32; in
    bf16 1e-2 of the loss, and at least 1e-2: 1.03e-2 seen on a d_loss of
    4.7 after two steps): G's losses read D after its Adam step, and at beta1 = 0 Adam
    moves each element by about lr whatever the size of its gradient, so
    the D elements whose gradients cancel exactly (``l_y_app``, the score
    biases; ROADMAP §3) move by +-lr on round-off, in each run its own way;
  - parameters and EMA within the most two runs can move apart that way:
    2 lr sqrt((1 - beta2^t) / (1 - beta2)) at step t (beta1 = 0), summed
    over the steps (2.0e-4 after one step, 4.83e-4 after two, at lr = 1e-4;
    JAX's own sharded-step test holds 2.1e-4 after one), plus 1e-5; and
    after the first step, as ``test_torch_port_parallel_jax.py`` holds
    them, under 1% of their elements more than 1e-6 apart (f32; 0.030-0.064%
    seen, the special families 0.042% and 0.054%); in bf16 under 10%
    (0.82% seen);
  - BN running statistics and SN vectors to 2e-3 (f32, and bf16's first
    step; 1e-2 bf16's second);
  - each optimizer's first and second moments, taken as one vector,
    ||2 ranks - 1 process|| / ||1 process|| under 5e-3 after the first step
    and 5e-2 after the second in f32, 0.25 in bf16, 5e-2 for the special
    families' one step; and in f32 after the first step, where the moments
    are its gradients (exp_avg at beta1 = 0) and their squares, each tensor
    to 5e-2 of its largest element (or of 1e-3 of its optimizer's largest,
    where that is larger), the bar of the PSP head's stage conv in the
    one-device parity test.

  Those bars are read from sound runs (1 thread a rank, the moments' norm
  of the four largest): f32 4.74e-4 after one step and 7.6e-3 after two,
  bf16 1.39e-2 and 9.31e-2, Ours-ED 2.8e-6, layout2im 3.03e-3; and from a
  control that moves round-off alone, the one-process step at 1 thread
  against 2: f32 5.08e-4 and 9.96e-3, bf16 0.113 and 0.131, Ours-ED
  5.8e-3; its share of parameter elements beyond 1e-6 after one step:
  f32 up to 0.087%, bf16 6.7%. The gradient all-reduce without its division
  by W reads 1.0 (exp_avg) and 3.0 (exp_avg_sq) in every configuration,
  while the parameters cannot show it (Adam at beta1 = 0 is blind to the
  gradients' scale); a bf16 all-reduce of the BN sums in the mixed step
  reads 4.61e-3 in the BN statistics after the first step (sound 1.73e-4,
  control 9.67e-4). Layout2im's 3.03e-3 is its masked BNs' one-pass
  variance in f32 at 4 layouts: with those sums in float64 the layout
  encoder's gap falls from 4.6e-3 to under 7e-5. After the second step the
  parameters are held only by the Adam bound: the gradients are taken at
  parameters that round-off flips moved apart, and the thread control
  puts 19-38% of f32's elements (90% of bf16's) beyond 1e-6.
"""

import math

import pytest
import torch

import torch_parallel_ranks as ranks

LR, BETA2 = 1e-4, 0.999


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One 2-rank run of ``torch_parallel_ranks.parallel_rank``: the
    reductions, the LostGAN configurations and the special families."""
    out = tmp_path_factory.mktemp("parallel")
    ranks.run_ranks(ranks.parallel_rank, 2, list(ranks.STEP_CONFIGS), str(out), timeout=180)
    return out


@pytest.fixture(scope="module")
def reductions(results):
    return [torch.load(results / f"reductions.{r}.pt") for r in range(2)]


@pytest.mark.parametrize("key", ["mean", "var", "running_mean", "running_var"])
def test_reductions_are_global(reductions, key):
    ref = reductions[0]["ref"][key]
    for r in range(2):
        torch.testing.assert_close(reductions[r]["rank"][key], ref, rtol=1e-5, atol=1e-6)


def test_masked_mean_averages_to_the_global_one(reductions):
    """Each rank's masked mean is W * (its masked sum) / (the global count):
    their mean, which the gradient all-reduce takes, is the global one."""
    got = sum(reductions[r]["rank"]["masked_mean"] for r in range(2)) / 2
    torch.testing.assert_close(got, reductions[0]["ref"]["masked_mean"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("key", ["out", "grad_x", "grad_scores"])
def test_rank_halves_are_the_global_rows(reductions, key):
    ref = reductions[0]["ref"][key]
    got = torch.cat([reductions[r]["rank"][key] for r in range(2)])
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def test_sharded_inception_gathers_the_one_process_features(reductions):
    """``run_inception_batches(mesh=)``: each rank runs its rows of each
    chunk (5 and 3 images, padded up to 2 ranks), and the gathered features
    and probabilities, pad rows cut, are the one-process ones."""
    for r in range(2):
        got = reductions[r]["inception"]
        for sharded, one in zip(got["sharded"], got["one"]):
            assert sharded.shape == one.shape == (8, *one.shape[1:])
            torch.testing.assert_close(sharded, one, rtol=0, atol=1e-6)


def _adam_bound(steps: int) -> float:
    return sum(2 * LR * math.sqrt((1 - BETA2 ** t) / (1 - BETA2)) for t in range(1, steps + 1))


def _hold(got: dict, t: int, bars: dict) -> None:
    """One step's ``compare`` against ``bars`` (a bar of None holds nothing)."""
    assert got["ranks_differ"] is None, f"step {t}: {got['ranks_differ']} differs across ranks"
    assert got["nonfloat_differ"] == [], (t, got["nonfloat_differ"])
    for kind, (err, k) in got["worst"].items():
        assert bars[kind] is None or err <= bars[kind], (t, k, err)
    if bars["share"] is not None:
        assert got["param_share"] < bars["share"], (t, got["param_share"])
    for k, err in got["moments"].items():
        assert err <= bars["moments"], (t, k, err)


@pytest.mark.parametrize("name", list(ranks.STEP_CONFIGS))
def test_two_rank_step_is_the_one_process_step(results, name):
    bf16 = name == "mixed"
    for t, got in enumerate(torch.load(results / f"{name}.pt"), start=1):
        for k, want in got["ref_metrics"].items():
            have = got["metrics"][k]
            if t == 1 and k.startswith("d_loss") and not bf16:
                assert abs(have - want) <= 1e-5 * abs(want), (t, k, have, want)
            bar = 1e-2 * max(1.0, abs(want)) if bf16 else (2e-4 if t == 1 else 1e-3)
            assert abs(have - want) <= bar, (t, k, have, want)
        _hold(got, t, {"param": _adam_bound(t) + 1e-5,
                       "share": None if t > 1 else (0.1 if bf16 else 0.01),
                       "state": 1e-2 if bf16 and t > 1 else 2e-3,
                       "moments": 0.25 if bf16 else (5e-3 if t == 1 else 5e-2),
                       "adam": None if bf16 or t > 1 else 5e-2})


@pytest.mark.parametrize("family", ["bgfg", "layout2im"])
def test_two_rank_special_step_is_the_one_process_step(results, family):
    """Ours-ED and layout2im, one step each on 4 layouts (2 a rank), through
    the ISLA kernels' plain versions with global batch statistics (Ours-ED)
    and the global masked BN counts (layout2im). Layout2im's G gradients
    reach 6.3 and differ by up to 2.1e-2 of a tensor's largest element."""
    (got,) = torch.load(results / f"{family}.pt")
    for k, want in got["ref_metrics"].items():
        have = got["metrics"][k]
        if k == "d_loss":
            assert abs(have - want) <= 1e-5 * abs(want), (k, have, want)
        assert abs(have - want) <= 2e-4, (k, have, want)
    _hold(got, 1, {"param": 2 * LR + 1e-5, "share": 0.01, "state": 2e-3, "moments": 5e-2,
                   "adam": 5e-2})
