"""The remaining LostGAN presets through the port's entry points, on the CPU.

- ``cli.train --model X --device cpu`` then ``cli.sample --model X`` on
  the written ``G.pth``, at ch=4, for a v1 experiment (``lostgan``) and for
  ``ours_d_256``; ``BENCH_MODEL`` takes the presets of other sizes and
  parts (the D is ``LayoutDiscriminator(image_size=size, app_head=True)``,
  as the JAX bench builds it).
- Guards: a generator object budget on the v1 trunk (which couples slots
  through its BN) is refused by the step, the sampler, the bench and both
  CLIs; the special families (``ours_ed``, ``layout2im``) resolve and run
  through the CLIs, and the LostGAN factories name their constructors.
- The GCN's dropout runs only when the step is not ``deterministic``, and
  its recompute under remat "g" draws the forward's mask (the remat step
  equals the plain one from the same seed).
- The mixed-precision dtype audit of ``tests/test_torch_port_mixed.py`` on
  the new paths: every convolution and matrix product in bf16 (the GCN's
  adjacency products too), with the one exemption counted per preset: the
  ISLA plain twin's f32 contraction once per norm call of the generator
  forward (8 at 64 px, 12 at 256 px, 30 with 3 parts) and twice per call
  in the backward.
"""

import json
import os

import numpy as np
import pytest
import torch

from layout2img_tpu_torch import bench
from layout2img_tpu_torch.cli import presets
from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import synthetic_batch
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.sample import make_sample_fn
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator
from test_torch_port_mixed import DtypeAudit, audit  # noqa: F401  (fixture)
from test_torch_port_remat import check_same
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

CH, NC, B, O = 4, 10, 2, 8


@pytest.mark.parametrize("model,size", [("lostgan", 128), ("ours_d_256", 256)])
def test_train_then_sample_cli(tmp_path, model, size):
    train_cli.main(["--model", model, "--steps", "1", "--batch_size", "2", "--ch", "4",
                    "--no_vgg", "--device", "cpu", "--out_path", str(tmp_path / "run"),
                    "--log_every", "1"])
    out = tmp_path / "run" / "synthetic" / str(size) / model
    line = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    assert line["step"] == 1 and np.isfinite(line["d_loss"]) and np.isfinite(line["g_loss"])
    exp = presets.EXPERIMENTS[model]
    assert ("d_loss_rapp" in line) == (exp.disc_preset == "d128_app")
    disc = make_discriminator(exp.disc_preset, train_cli.SYNTHETIC_CLASSES, device="cpu", ch=4)
    disc.load_state_dict(torch.load(out / "D.pth", weights_only=True), strict=True)
    sample_cli.main(["--model", model, "--weights", str(out / "G.pth"), "--sample_path",
                     str(tmp_path / "s"), "--num_img", "1", "--batch_size", "2", "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "s"))
    assert len(names) == 2 * sample_cli.SYNTHETIC_BATCHES
    from PIL import Image

    with Image.open(tmp_path / "s" / names[0]) as im:
        assert im.size == (size, size)


@pytest.mark.parametrize("model,size", [("lostgan64", 64), ("context128_part", 128),
                                        ("ours_d_base256", 256)])
def test_bench_takes_the_preset(monkeypatch, model, size):
    cfg = bench.BenchConfig(batch=2, scan=1, scans=1, model=model, ch=CH, vgg=False, mixed=False)
    built = bench.build(cfg, torch.device("cpu"))
    assert built.size == size and built.state.discriminator.image_size == size
    assert built.state.discriminator.app_head
    line = bench.time_steps(built, cfg, torch.device("cpu"))["line"]
    assert line["metric"] == f"gan_train_step_images_per_sec_{size}px" and line["value"] > 0


def _v1_gen():
    return init_generator(0, NC, preset="lostgan128", device="cpu", ch=CH)


def test_v1_budget_refused_by_step_and_sampler():
    gen = _v1_gen()
    disc = init_discriminator(1, NC, preset="d128", device="cpu", ch=CH)
    cfg = TrainConfig(use_vgg_loss=False, g_obj_budget=6)
    with pytest.raises(ValueError, match="v1 mask trunk"):
        make_train_step(create_train_state(gen, disc, cfg), cfg)
    with pytest.raises(ValueError, match="v1 mask trunk"):
        make_sample_fn(gen, obj_budget=6)
    # D's budget is exact on any generator
    cfg = TrainConfig(use_vgg_loss=False, d_obj_budget=6)
    make_train_step(create_train_state(gen, disc, cfg), cfg)


def test_v1_budget_refused_by_bench_and_clis(tmp_path):
    cfg = bench.BenchConfig(batch=2, model="context128", ch=CH, vgg=False, g_obj_budget=8)
    with pytest.raises(SystemExit, match="v1 mask trunk"):
        bench.build(cfg, torch.device("cpu"))
    with pytest.raises(SystemExit, match="--g_obj_budget is not exact for this model: the v1"):
        train_cli.main(["--model", "graph_context_app", "--steps", "1", "--ch", "4",
                        "--g_obj_budget", "8", "--device", "cpu", "--out_path", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
    pth = tmp_path / "G.pth"
    torch.save(_v1_gen().state_dict(), pth)
    with pytest.raises(SystemExit, match="--obj_budget is not exact for this model: the v1"):
        sample_cli.main(["--model", "lostgan", "--weights", str(pth), "--obj_budget", "6",
                         "--sample_path", str(tmp_path / "s"), "--device", "cpu"])


@pytest.mark.parametrize("call", ["experiment", "train_cli", "sample_cli", "make_generator",
                                  "make_discriminator"])
def test_special_families_name_the_roadmap(tmp_path, call):
    """The special families are ported (ROADMAP §1 item 5): the experiments
    resolve, the CLIs run them, and the LostGAN factories name the
    constructors that build their networks."""
    out = str(tmp_path / "o")
    if call == "experiment":
        for name, gen, disc in (("ours_ed", "bgfg64", "d64"), ("layout2im", "layout2im64",
                                                               "layout2im")):
            exp = presets.experiment(name)
            assert exp.special and (exp.gen_preset, exp.disc_preset, exp.image_size) == (
                gen, disc, 64)
    elif call == "train_cli":
        train_cli.main(["--model", "layout2im", "--l2i_fusion", "convlstm", "--steps", "1",
                        "--batch_size", "2", "--ch", "4", "--device", "cpu", "--out_path", out])
        assert os.listdir(os.path.join(out, "synthetic", "64", "layout2im", "ckpt")) == ["1"]
    elif call == "sample_cli":
        train_cli.main(["--model", "ours_ed", "--steps", "1", "--batch_size", "2", "--ch", "4",
                        "--no_vgg", "--device", "cpu", "--out_path", out])
        samples = str(tmp_path / "s")
        sample_cli.main(["--model", "ours_ed", "--ckpt_dir",
                         os.path.join(out, "synthetic", "64", "ours_ed", "ckpt"), "--num_img", "1",
                         "--batch_size", "2", "--max_layouts", "2", "--sample_path", samples,
                         "--device", "cpu"])
        assert len(os.listdir(samples)) == 2
    elif call == "make_generator":
        with pytest.raises(ValueError, match="build it with models.generators.BgFgGenerator"):
            make_generator("bgfg64", NC, device="cpu")
        with pytest.raises(ValueError, match="models.layout2im.Layout2ImGenerator"):
            make_generator("layout2im64", NC, device="cpu")
    else:
        with pytest.raises(ValueError, match="models.layout2im.Layout2ImImageDiscriminator"):
            make_discriminator("layout2im", NC, device="cpu")


def test_every_lostgan_experiment_is_ported():
    lostgan = {k for k, e in presets.EXPERIMENTS.items() if not e.special}
    assert len(lostgan) == 9 and {k for k in presets.EXPERIMENTS if k not in lostgan} == {
        "ours_ed", "layout2im"}
    for name in lostgan:
        exp = presets.experiment(name)
        gen = make_generator(exp.gen_preset, NC, device="cpu", ch=2, num_mask_classes=NC)
        disc = make_discriminator(exp.disc_preset, NC, device="cpu", ch=2)
        assert gen.image_size == disc.image_size == exp.image_size, name
    with pytest.raises(ValueError, match="unknown --model"):
        presets.experiment("no_such")
    assert presets.dataset_spec("vg") == (179, 31)


@pytest.fixture(scope="module")
def graph_inputs():
    rng = np.random.default_rng(31)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(rng, B, 128, O, NC).items()}
    batch["labels"] = batch["labels"].long()
    batch["labels"][:, 1] = batch["labels"][:, 0]  # the GCN's edges
    g = torch.Generator().manual_seed(32)
    return batch, torch.randn(B, O, 128, generator=g), torch.randn(B, 128, generator=g)


def _graph_step(inputs, remat="none", deterministic=False, seed=0):
    from types import SimpleNamespace

    gen = init_generator(0, NC, preset="graph128", device="cpu", ch=CH)
    disc = init_discriminator(1, NC, device="cpu", ch=CH)
    cfg = TrainConfig(use_vgg_loss=False, remat=remat)
    state = create_train_state(gen, disc, cfg)
    step = make_train_step(state, cfg, deterministic=deterministic)
    torch.manual_seed(seed)  # the GCN dropout's draws
    metrics = step.with_latents(*inputs)
    return SimpleNamespace(state=state, metrics={k: v.item() for k, v in metrics.items()})


def test_gcn_dropout_replayed_under_remat(graph_inputs):
    want = _graph_step(graph_inputs, seed=5)
    check_same(_graph_step(graph_inputs, remat="g", seed=5), want)
    other = _graph_step(graph_inputs, seed=6)
    assert abs(other.metrics["g_loss"] - want.metrics["g_loss"]) > 1e-6
    # deterministic: no draws, so the seed does not matter
    check_same(_graph_step(graph_inputs, deterministic=True, seed=5),
               _graph_step(graph_inputs, deterministic=True, seed=6))


@pytest.mark.parametrize("preset,disc_preset,calls", [
    ("graph128", "d128_app", 10), ("context128_part", "d128", 30), ("lostgan64", "d64", 8),
    ("ours_d_base256", "d256", 12)])
def test_mixed_step_runs_every_matmul_in_bf16(audit, preset, disc_preset, calls):
    gen = init_generator(0, NC, preset=preset, device="cpu", ch=CH, num_mask_classes=NC)
    disc = init_discriminator(1, NC, preset=disc_preset, device="cpu", ch=CH)
    assert gen.isla_calls == calls
    rng = np.random.default_rng(33)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(rng, B, gen.image_size, O, NC).items()}
    batch["labels"] = batch["labels"].long()
    cfg = TrainConfig(use_vgg_loss=False, mixed_precision=True)
    step = make_train_step(create_train_state(gen, disc, cfg), cfg, deterministic=True)
    with audit:
        metrics = step(batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert audit.total > 150, f"the audit saw only {audit.total} heavy ops"
    assert not audit.violations, "f32 heavy ops under mixed precision:\n" + "\n".join(
        audit.violations[:10])
    assert (audit.isla_forward, audit.isla_backward) == (calls, 2 * calls)
