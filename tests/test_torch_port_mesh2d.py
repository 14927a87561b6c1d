"""The 2-D (data, model) mesh on the CPU (``layout2img_tpu_torch/parallel/mesh.py``):
gloo ranks started with ``torch.multiprocessing`` (``tests/torch_parallel_ranks.py``),
against the port's one-process computation on the same whole input.

- Units on a 1 x 2 mesh: a conv on row shards with halos (output and both
  gradients); column-parallel SN conv, SN dense and SN embedding (the
  power iteration on the shards: output, weight and input gradients, and
  the new ``weight_u``) and the plain conv, dense, embedding and graph
  convolution; ``batch_stats`` in tensor mode (the data axis) and on row
  shards (every rank); ``isla_norm`` (its plain version, here) on row windows with the
  shards' global statistics: the rows are the whole norm's rows and the
  ranks' gradients of x, the mask and gamma/beta sum to M times the whole
  ones; RoIAlign summed over the ranks' partial crops. Bars 1e-5 of each
  tensor's largest element.
- A window of ``isla_norm_plain`` is the same rows of the whole output, and
  the windows' transposed resizes of dm sum to the whole one (no ranks).
- The LostGAN step (``ours_d_context128`` + ``d128_app`` at ch=4, 64 px, 6
  slots with pads, a global batch of 4, dropout live) on one 2-rank launch
  (1 data group x M = 2): tensor mode in f32 with the EMA for 2 steps and
  with ``remat="gd"`` for 1, spatial mode in f32 with the VGG loss (seeded
  filters) for 2 and in mixed precision for 1; and on one 4-rank launch
  (2 data groups x 2) one step of each mode. Against the one-process step
  on the whole batch at ``test_torch_port_parallel.py``'s bars (losses;
  parameters within the Adam bound and, after one step, under 1% of
  elements beyond 1e-6; BN and SN state 2e-3; each optimizer's moments
  as one vector), with the tensor-mode state gathered whole, whose shapes
  are the one-process ones. After each step the whole tensors are bit-equal
  on every rank and the shards on the ranks of one model index
  (``check_replicated``); in tensor mode every conv, dense and embedding
  weight whose output features divide by 2 is held at 1/2 on each rank,
  with its Adam moments and its EMA, and only the stage masks' alphas (whose
  output axis is 1) lie outside those layers.

Read from sound runs (1 thread a rank): the moments' norms 1.3e-4 (f32)
and 1.4e-2 (mixed) after one step and 1.4e-2 after two; the parameters'
largest gap 4.5e-4 after two steps, within the bound of 4.83e-4.
"""

import pytest
import torch

import torch_parallel_ranks as ranks
from layout2img_tpu_torch.ops.isla import finish_backward_plain, isla_norm_plain
from test_torch_port_parallel import _adam_bound, _hold
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

UNITS = ["halo_conv", "tp_sn_conv", "tp_sn_dense", "tp_sn_embed", "tp_conv", "tp_dense",
         "tp_embed", "tp_gcn", "batch_stats", "isla_rows", "roi_rows"]
CELLS = [(1, name) for name in ranks.MESH2D_CONFIGS] + [(2, name) for name in ranks.MESH2D_2X2]


@pytest.fixture(scope="module")
def one_by_two(tmp_path_factory):
    """One 2-rank launch: the units, then every configuration on 1 x 2."""
    out = tmp_path_factory.mktemp("mesh2d_1x2")
    ranks.run_ranks(ranks.mesh2d_rank, 2, 2, list(ranks.MESH2D_CONFIGS), True, str(out),
                    timeout=240)
    return out


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    """One 4-rank launch: one step of each mode on 2 x 2."""
    out = tmp_path_factory.mktemp("mesh2d_2x2")
    ranks.run_ranks(ranks.mesh2d_rank, 4, 2, list(ranks.MESH2D_2X2), False, str(out),
                    timeout=240)
    return out


@pytest.mark.parametrize("unit", UNITS)
def test_unit_on_the_mesh_is_the_one_process_computation(one_by_two, unit):
    for i, (got, want) in enumerate(torch.load(one_by_two / "units.pt")[unit]):
        assert got.shape == want.shape, (unit, i)
        if want.numel():
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item(),
                                       msg=lambda m: f"{unit}[{i}]: {m}")


@pytest.mark.parametrize("relu", [False, True])
def test_isla_window_is_the_rows_of_the_whole_norm(relu):
    """Rows [3, 7) and [7, 12) of a 12-row image against the whole call, the
    windows' dmask parts against the whole dmask (the finishing kernel's
    plain version on the windows' partial buffers)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 12, 9, generator=g)
    mean, var = torch.randn(5, generator=g), torch.rand(5, generator=g) + 0.5
    mask = torch.rand(2, 3, 7, 4, generator=g)
    gamma, beta = torch.randn(2, 3, 5, generator=g), torch.randn(2, 3, 5, generator=g)
    whole = isla_norm_plain(x, mean, var, 1e-5, mask, gamma, beta, relu)
    dm = torch.randn(1, 2, 3, 12, 9, generator=g)
    parts = torch.zeros(2, 3, 7, 4)
    zeros = (torch.zeros(2, 1, 2, 5), torch.zeros(2, 1, 2, 3, 5))
    for r0, r1 in ((0, 3), (3, 7), (7, 12)):
        got = isla_norm_plain(x[..., r0:r1, :], mean, var, 1e-5, mask, gamma, beta, relu,
                              row0=r0, full_h=12)
        torch.testing.assert_close(got, whole[..., r0:r1, :], rtol=0, atol=1e-6)
        parts += finish_backward_plain(*zeros, dm[..., r0:r1, :], var, 1e-5, (7, 4),
                                       (torch.float32,) * 3, row0=r0, full_h=12)[2]
    want = finish_backward_plain(*zeros, dm, var, 1e-5, (7, 4), (torch.float32,) * 3)[2]
    torch.testing.assert_close(parts, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("groups,name", CELLS)
def test_mesh2d_step_is_the_one_process_step(one_by_two, two_by_two, groups, name):
    out = one_by_two if groups == 1 else two_by_two
    bf16 = name == "spatial_mixed"
    for d in range(groups):
        got = torch.load(out / f"{name}.{d}.pt")
        assert got["ranks_differ"] == [None] * len(got["steps"]), got["ranks_differ"]
        assert got["shapes"] == got["ref_shapes"]
        for t, step in enumerate(got["steps"], start=1):
            for k, want in step["ref_metrics"].items():
                have = step["metrics"][k]
                if t == 1 and k.startswith("d_loss") and not bf16:
                    assert abs(have - want) <= 1e-5 * abs(want), (t, k, have, want)
                bar = 1e-2 * max(1.0, abs(want)) if bf16 else (2e-4 if t == 1 else 1e-3)
                assert abs(have - want) <= bar, (t, k, have, want)
            _hold(step, t, {"param": _adam_bound(t) + 1e-5,
                            "share": None if t > 1 else (0.1 if bf16 else 0.01),
                            "state": 2e-3, "moments": 0.25 if bf16 else (5e-3 if t == 1 else 5e-2),
                            "adam": None if bf16 or t > 1 else 5e-2})


@pytest.mark.parametrize("groups,name", [c for c in CELLS if c[1].startswith("tensor")])
def test_tensor_mode_holds_one_shard_of_each_divisible_weight(one_by_two, two_by_two, groups,
                                                              name):
    out = one_by_two if groups == 1 else two_by_two
    got = torch.load(out / f"{name}.0.pt")
    assert got["layout"]["wrong"] == [] and got["layout"]["moments"] == []
    assert got["layout"]["outside"] == [f"generator.alpha{i}" for i in (1, 2, 3)]
    assert got["n_sharded"] > 100
