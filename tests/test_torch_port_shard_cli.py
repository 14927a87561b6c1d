"""``cli.sample`` and ``cli.evaluate`` sharded over 2 ranks on the CPU (gloo),
started as torchrun starts them (``tests/torch_parallel_ranks.py``, one launch
under its own time limit), against the same calls in one process:

- ``cli.sample`` writes the same JPEGs byte for byte for a LostGAN preset
  (``context_app_v2`` from a ``--weights`` file), ``ours_ed`` and
  ``layout2im`` (from tiny checkpoints) at b=4, over two batches; at b=3
  (padded to 4, the pad row dropped) the 3 real rows are one process's
  images at b=4 on the same layouts (a COCO fixture, whose batches hold
  the same first layouts at either size), and rank 0 alone prints the
  padding;
- the samplers (``sample.py::make_sample_fn``, ``make_bgfg_sample_fn``,
  ``make_layout2im_sample_fn``) draw the latents of the global batch on
  every rank and keep the rank's rows: each rank's images equal its rows of
  one process's at the global batch;
- ``cli.evaluate is`` and ``kid`` print one process's numbers from rank 0,
  ``fid --save_stats`` writes one process's statistics to f32 round-off
  (within 1e-6 of the largest element; the Frechet
  distance is the host's arithmetic on them, one ``sqrtm`` of a 2048x2048
  matrix, 20-45 s on this CPU, so the card's ``shard`` phase of
  ``chip_smoke.py`` compares the printed FID), and ``lpips`` runs on rank 0
  alone while rank 1 prints nothing.

No JAX 2-device comparison is made here: the JAX CLIs shard the same jit
with the same numbers (``layout2img_tpu/cli/sample.py:211-213``), and the
port's one-process sampler and evaluate are held against JAX already
(``tests/test_torch_port_generator.py``, ``tests/test_torch_port_eval_cli*.py``).
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from layout2img_tpu_torch.data.coco import split_fg_bg_batch
from layout2img_tpu_torch.data.synthetic import (synthetic_layouts, write_synthetic_coco,
                                                 write_synthetic_stuff)
from layout2img_tpu_torch.parallel.mesh import DataMesh, use
from layout2img_tpu_torch.sample import global_truncated_normal, make_sample_fn, truncated_normal
from layout2img_tpu_torch.train.checkpoint import CheckpointManager
from layout2img_tpu_torch.train.state import TrainConfig
from layout2img_tpu_torch.train.step_bgfg import create_bgfg_state, make_bgfg_sample_fn
from layout2img_tpu_torch.train.step_layout2im import (Layout2ImConfig, create_layout2im_state,
                                                       make_layout2im_sample_fn)
from layout2img_tpu_torch.utils.convert import (init_bgfg_generator, init_discriminator,
                                                init_generator, init_layout2im_discriminators,
                                                init_layout2im_generator)
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse, 1 BLAS thread)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

CH, NC, L2I_NC = 4, 184, 10
FAMILIES = ("lostgan", "ours_ed", "layout2im")


def _networks():
    """{family: generator} at tiny width, from seeded draws."""
    return {"lostgan": init_generator(0, NC, preset="ours_d_context128", device="cpu", ch=CH,
                                      image_size=64),
            "ours_ed": init_bgfg_generator(0, 91, NC - 91, device="cpu", ch=CH),
            "layout2im": init_layout2im_generator(0, L2I_NC, device="cpu")}


def _calls(root, side: str) -> list:
    """The CLI calls of one side (``one`` process or ``two`` ranks), each
    writing under ``root/side``."""
    out = os.path.join(root, side)
    coco = os.path.join(root, "coco")
    common = ["--num_img", "2", "--device", "cpu"]

    def sample(name, *argv):
        return (name, "sample", [*argv, "--sample_path", os.path.join(out, name), *common])

    def evaluate(mode, *argv, batch_size="5"):
        # the first 6 images of each directory; Inception calls of 3 images on
        # both sides where the numbers are compared exactly (a chunk of 6 on 2
        # ranks, of 3 in one process), since the CPU's convolutions pick their
        # algorithm by batch size
        return (mode, "evaluate", [mode, "--dir", os.path.join(out, "lostgan"), "--limit", "6",
                                   "--batch_size", batch_size if side == "two" else "3",
                                   "--device", "cpu", *argv])

    weights = ["--weights", os.path.join(root, "G.pth")]
    return [
        sample("lostgan", *weights, "--batch_size", "4", "--max_layouts", "8"),
        sample("coco", *weights, "--dataset", "coco", "--coco_image_dir", coco,
               "--coco_instances", os.path.join(coco, "instances.json"), "--coco_stuff",
               os.path.join(coco, "stuff.json"), "--batch_size", "3" if side == "two" else "4",
               "--max_layouts", "3"),
        sample("ours_ed", "--model", "ours_ed", "--ckpt_dir", os.path.join(root, "ed"),
               "--batch_size", "4", "--max_layouts", "8"),
        sample("layout2im", "--model", "layout2im", "--ckpt_dir", os.path.join(root, "l2i"),
               "--batch_size", "4", "--max_layouts", "4"),
        evaluate("is"),
        evaluate("fid", "--save_stats", os.path.join(out, "stats.npz"), batch_size="6"),
        evaluate("kid", "--ref_dir", os.path.join(out, "ours_ed"), "--kid_subset_size", "8",
                 "--kid_subsets", "5", batch_size="6"),
        evaluate("lpips", "--ref_dir", os.path.join(out, "ours_ed")),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The calls on 2 ranks (started first, under a time limit) and in this
    process: the root of both sides' outputs."""
    root = str(tmp_path_factory.mktemp("shard"))
    nets = _networks()
    torch.save(nets["lostgan"].state_dict(), os.path.join(root, "G.pth"))
    disc = init_discriminator(1, NC, preset="d64", device="cpu", ch=CH)
    CheckpointManager(os.path.join(root, "ed")).save(
        create_bgfg_state(nets["ours_ed"], disc, TrainConfig(use_vgg_loss=False)))
    CheckpointManager(os.path.join(root, "l2i")).save(create_layout2im_state(
        nets["layout2im"], *init_layout2im_discriminators(1, L2I_NC, conv_dim=CH, device="cpu"),
        Layout2ImConfig()))
    coco = os.path.join(root, "coco")
    _, inst = write_synthetic_coco(coco, 5, width=96, height=80, seed=3)
    write_synthetic_stuff(coco, inst, seed=4)
    ctx = ranks.start_ranks(ranks.cli_calls_rank, 2, _calls(root, "two"), root)
    try:
        ranks.run_cli_calls(_calls(root, "one"), root, "one")
    finally:
        ranks.wait_ranks(ctx, timeout=240.0)
    return root


def _out(root, name: str, tag) -> list[str]:
    with open(os.path.join(root, f"{name}.{tag}.out")) as f:
        return f.read().splitlines()


def _jpegs(path: str) -> dict[str, bytes]:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_sample_writes_one_process_jpegs(runs, family):
    one, two = (_jpegs(os.path.join(runs, side, family)) for side in ("one", "two"))
    n = 4 if family == "layout2im" else 8
    assert sorted(one) == sorted(f"sample{i}_numb{j}.jpg" for i in range(n) for j in range(2))
    assert sorted(two) == sorted(one)
    assert [k for k in one if one[k] != two[k]] == []
    assert _out(runs, family, 0) == ["sampling data-parallel over 2 ranks",
                                     f"wrote {n} layouts x 2 samples to "
                                     f"{os.path.join(runs, 'two', family)}"]
    assert _out(runs, family, 1) == []


def test_padded_batch_writes_one_process_real_rows(runs):
    """b=3 on 2 ranks runs the batch padded to 4: the 3 real rows are one
    process's images at b=4, and the pad row is written by neither rank."""
    one, two = (_jpegs(os.path.join(runs, side, "coco")) for side in ("one", "two"))
    assert sorted(two) == sorted(f"sample{i}_numb{j}.jpg" for i in range(3) for j in range(2))
    assert len(one) == 8 and [k for k in two if one[k] != two[k]] == []
    assert _out(runs, "coco", 0)[0] == "sampling data-parallel over 2 ranks (batch padded 3 -> 4)"
    assert _out(runs, "coco", 0)[-1].startswith("wrote 3 layouts x 2 samples")
    assert _out(runs, "coco", 1) == []


@pytest.mark.parametrize("mode", ["is", "kid"])
def test_sharded_evaluate_prints_one_process_numbers(runs, mode):
    one, zero, first = (_out(runs, mode, t) for t in ("one", 0, 1))
    note = ["note: --batch_size 5 padded up to a multiple of 2 ranks inside the eval loop"]
    assert zero[:1] == one[:1] and zero[1:-1] == (note if mode == "is" else [])
    if mode == "is":
        assert zero[-1].replace("/two/", "/one/") == one[-1] and "IS: " in one[-1]
    else:
        assert zero[-1] == one[-1] and "KID: " in one[-1]
    assert first == []


def test_sharded_fid_stats_equal_one_process(runs):
    one, zero = (np.load(os.path.join(runs, side, "stats.npz")) for side in ("one", "two"))
    assert sorted(one.files) == sorted(zero.files) == ["mu", "n", "sigma"]
    # to f32 round-off: the CPU's Inception features of a row move in their
    # last bit with its place in a batch (3.7e-09 on mu, 3.5e-10 on sigma)
    for k in one.files:
        np.testing.assert_allclose(zero[k], one[k], rtol=0, atol=1e-6 * np.abs(one[k]).max(),
                                   err_msg=k)
    assert int(one["n"]) == 6
    assert _out(runs, "fid", 0)[-1].replace("/two/", "/one/") == _out(runs, "fid", "one")[-1]
    assert _out(runs, "fid", 1) == []


def test_lpips_runs_on_rank_0_alone(runs):
    one = _out(runs, "lpips", "one")
    assert one[-1].startswith("LPIPS: ") and _out(runs, "lpips", 0) == one
    assert _out(runs, "lpips", 1) == []


def _layouts(family: str, b: int) -> dict:
    layout = synthetic_layouts(np.random.default_rng(5), b, 8, L2I_NC if family == "layout2im"
                               else NC)
    return split_fg_bg_batch(layout) | layout if family == "ours_ed" else layout


def _sampler(family: str, gen):
    if family == "lostgan":
        sample = make_sample_fn(gen, z_dim=gen.z_dim, obj_budget=6)
        return lambda batch, rng: sample(torch.as_tensor(batch["boxes"]),
                                         torch.as_tensor(batch["labels"]), rng)
    return (make_bgfg_sample_fn if family == "ours_ed" else make_layout2im_sample_fn)(gen)


@pytest.mark.parametrize("family", FAMILIES)
def test_samplers_draw_the_padded_global_batch(family):
    """Each rank of a 2-rank mesh, given its rows of a global batch of 4,
    draws the global latents and returns its rows of one process's images
    (the LostGAN sampler with an object budget, which compacts per row),
    to f32 round-off."""
    gen = _networks()[family]
    draw = _sampler(family, gen)
    batch = _layouts(family, 4)
    whole = draw(batch, torch.Generator().manual_seed(7))
    for rank in range(2):
        mesh = DataMesh(rank=rank, world=2)
        mine, first, real = mesh.padded_rows(batch, 4)
        assert (first, real) == (2 * rank, 2)
        with use(mesh):
            got = draw(mine, torch.Generator().manual_seed(7))
        # to f32 round-off: the CPU's convolutions pick their algorithm by batch size
        torch.testing.assert_close(got, whole[2 * rank:2 * rank + 2], rtol=0, atol=1e-6)


def test_global_draw_is_the_one_process_draw():
    """``global_truncated_normal`` on rank r of 2 is rows r of the draw of
    the global shape; in one process it is ``truncated_normal``."""
    want = truncated_normal((6, 3, 5), 2.0, torch.Generator().manual_seed(3), "cpu",
                            torch.float32)
    for rank in range(2):
        with use(DataMesh(rank=rank, world=2)):
            got = global_truncated_normal((3, 3, 5), 2.0, torch.Generator().manual_seed(3),
                                          "cpu", torch.bfloat16)
        assert torch.equal(got, want[3 * rank:3 * rank + 3].to(torch.bfloat16))
    assert torch.equal(global_truncated_normal((6, 3, 5), 2.0, torch.Generator().manual_seed(3),
                                               "cpu", torch.float32), want)


@pytest.mark.parametrize("world,size,n,want", [
    (2, 4, 3, [(0, 2), (2, 1)]),  # b=3 padded to 4
    (2, 4, 1, [(0, 1), (2, 0)]),  # a ragged tail of one layout
    (4, 8, 8, [(0, 2), (2, 2), (4, 2), (6, 2)]),
    (1, 3, 3, [(0, 3)]),
])
def test_padded_rows(world, size, n, want):
    batch = {"labels": np.arange(size), "boxes": torch.arange(size * 4).reshape(size, 4)}
    for rank, (first, real) in enumerate(want):
        mesh = DataMesh(rank=rank, world=world)
        assert mesh.padded(n) in (size, -(-n // world) * world)
        mine, got_first, got_real = mesh.padded_rows(batch, n)
        assert (got_first, got_real) == (first, real)
        np.testing.assert_array_equal(mine["labels"], batch["labels"][first:first + size // world])
    with pytest.raises(ValueError, match="does not split"):
        DataMesh(rank=0, world=2).padded_rows({"labels": np.arange(5)}, 5)
