"""The PyTorch port stands alone: it imports no JAX, nothing of the JAX
package and no Triton (its kernels are CUDA C++), and its entry points never
fall back to the CPU on their own."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import layout2img_tpu_torch
names = [m.name for m in pkgutil.walk_packages(layout2img_tpu_torch.__path__, "layout2img_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "layout2img_tpu",
                                    "triton"))
lazy = sorted(m for m in sys.modules
              if m.split(".")[0] in ("PIL", "h5py", "tensorboardX", "matplotlib"))
print(json.dumps({"names": names, "bad": bad, "lazy": lazy}))
"""
# modules the walk must reach: the train step's knobs, the bench, the data
# plane, checkpoints, logging, reference weights and every CLI among them
_MODULES = ("bench", "bench_eval", "cli.evaluate", "cli.export", "cli.export_torch",
            "cli.human_study", "cli.prepare_eval_images", "cli.preprocess_vg", "cli.presets",
            "cli.sample", "cli.train", "cli.visualize",
            "data.coco", "data.native", "data.prefetch", "data.synthetic", "data.vg", "eval",
            "eval.inception", "eval.lpips", "eval.metrics", "models.convlstm", "models.layout2im",
            "nn.builders", "nn.gcn", "nn.mask_regress", "nn.remat", "ops.pool", "parallel.mesh",
            "scripts.launch_multihost", "train.checkpoint",
            "train.ema", "train.eval_hook", "train.step", "train.step_bgfg",
            "train.step_layout2im", "utils.casting", "utils.logging", "utils.reference",
            "scripts.train_conditioning_check", "scripts.bench_inference", "scripts.profile_step")


@pytest.fixture(scope="module")
def imported():
    """What importing every module of the port (and chip_smoke.py) pulled in,
    in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(imported):
    seen = imported
    assert len(seen["names"]) >= 20, seen
    assert {f"layout2img_tpu_torch.{m}" for m in _MODULES} <= set(seen["names"]), seen["names"]
    assert seen["bad"] == [], seen["bad"]


def test_port_imports_pil_and_h5py_lazily(imported):
    """The image, HDF5, tensorboard and plotting packages load where a
    function uses them, never at import: the card's machine need not have
    them to import the port."""
    assert imported["lazy"] == [], imported["lazy"]


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["make_generator", "init_generator", "resolve_device", "cli",
                                   "make_discriminator", "init_discriminator", "init_vgg",
                                   "train_cli", "train_cli_knobs", "bench", "sample_cli_ckpt",
                                   "train_cli_coco", "train_cli_eval", "evaluate_cli",
                                   "bench_eval", "train_cli_ours_ed", "train_cli_layout2im",
                                   "sample_cli_special", "init_special", "export_cli",
                                   "export_cli_run", "conditioning_check", "bench_inference",
                                   "profile_step"])
def test_entry_points_without_cuda_raise(monkeypatch, tmp_path, entry):
    _no_cuda(monkeypatch)
    from layout2img_tpu_torch import bench, bench_eval
    from layout2img_tpu_torch.cli import evaluate as evaluate_cli
    from layout2img_tpu_torch.cli import export as export_cli
    from layout2img_tpu_torch.cli import sample as sample_cli
    from layout2img_tpu_torch.cli import train as train_cli
    from layout2img_tpu_torch.device import resolve_device
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.models.generators import make_generator
    from layout2img_tpu_torch.scripts import (bench_inference, profile_step,
                                              train_conditioning_check)
    from layout2img_tpu_torch.utils.convert import (init_bgfg_generator, init_discriminator,
                                                    init_generator, init_layout2im_discriminators,
                                                    init_layout2im_generator, init_vgg)

    calls = {
        "make_generator": lambda: make_generator("ours_d_context128", 10, ch=4, num_mask_classes=10),
        "init_generator": lambda: init_generator(0, 10, ch=4, num_mask_classes=10),
        "resolve_device": lambda: resolve_device(),
        "cli": lambda: sample_cli.main(["--weights", str(tmp_path / "missing.pth"),
                                        "--sample_path", str(tmp_path / "out")]),
        "make_discriminator": lambda: make_discriminator("d128_app", 10, ch=4),
        "init_discriminator": lambda: init_discriminator(0, 10, ch=4),
        "init_vgg": lambda: init_vgg(0),
        "train_cli": lambda: train_cli.main(["--steps", "1", "--batch_size", "2", "--ch", "4",
                                             "--out_path", str(tmp_path / "out")]),
        "train_cli_knobs": lambda: train_cli.main([
            "--steps", "1", "--batch_size", "2", "--ch", "4", "--mixed_precision", "--fused_d",
            "--remat", "gd", "--ema_decay", "0.9", "--out_path", str(tmp_path / "out")]),
        "bench": lambda: bench.main(["--ch", "4", "--no_vgg"]),
        "sample_cli_ckpt": lambda: sample_cli.main(["--ckpt_dir", str(tmp_path / "ckpt"),
                                                    "--sample_path", str(tmp_path / "out")]),
        "train_cli_coco": lambda: train_cli.main(["--dataset", "coco", "--ch", "4",
                                                  "--out_path", str(tmp_path / "out")]),
        "train_cli_eval": lambda: train_cli.main([
            "--steps", "1", "--batch_size", "2", "--ch", "4", "--eval_every", "1", "--eval_n",
            "2", "--out_path", str(tmp_path / "out")]),
        "evaluate_cli": lambda: evaluate_cli.main(["fid", "--dir", str(tmp_path / "missing"),
                                                   "--save_stats", str(tmp_path / "out")]),
        "bench_eval": lambda: bench_eval.main([]),
        "train_cli_ours_ed": lambda: train_cli.main(["--model", "ours_ed", "--steps", "1",
                                                     "--ch", "4", "--out_path", str(tmp_path / "out")]),
        "train_cli_layout2im": lambda: train_cli.main([
            "--model", "layout2im", "--l2i_fusion", "convlstm", "--steps", "1", "--ch", "4",
            "--out_path", str(tmp_path / "out")]),
        "sample_cli_special": lambda: sample_cli.main([
            "--model", "layout2im", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--sample_path", str(tmp_path / "out")]),
        "init_special": lambda: (init_bgfg_generator(0, ch=4), init_layout2im_generator(0, 10),
                                 init_layout2im_discriminators(0, 10, conv_dim=4)),
        "export_cli": lambda: export_cli.main(["--ch", "4", "--out", str(tmp_path / "out")]),
        "export_cli_run": lambda: export_cli.main(["--run", str(tmp_path / "out")]),
        "conditioning_check": lambda: train_conditioning_check.main([
            "--ch", "4", "--image_out", str(tmp_path / "out")]),
        "bench_inference": lambda: bench_inference.main(["--ch", "4"], env={"BENCH_K": "1"}),
        "profile_step": lambda: profile_step.main(["--ch", "4", "--k", "1"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not (tmp_path / "out").exists()


def test_cpu_is_used_only_when_asked(monkeypatch):
    _no_cuda(monkeypatch)
    from layout2img_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")


def test_unported_presets_name_the_roadmap():
    """Every LostGAN preset is ported; the special families' generator
    names are no presets of the factory, which names their constructors."""
    from layout2img_tpu_torch.models.generators import _GENERATOR_PRESETS, make_generator

    assert len(_GENERATOR_PRESETS) == 9
    for preset, ctor in (("bgfg64", "BgFgGenerator"), ("layout2im64", "Layout2ImGenerator")):
        with pytest.raises(ValueError, match=f"build it with models.*{ctor}"):
            make_generator(preset, 10, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        make_generator("no_such_preset", 10, device="cpu")


@pytest.mark.parametrize("knob", [dict(fused_d=True), dict(remat="gd"), dict(mixed_precision=True),
                                  dict(ema_decay=0.999), dict(d_obj_budget=8), dict(g_obj_budget=8)])
def test_unported_train_config_knobs_name_the_roadmap(knob):
    """Every knob of the JAX TrainConfig is ported; what is left unported
    under each, ``mapping_lr_mult`` for a network with a ``mapping``
    parameter, names the ROADMAP."""
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state

    cfg = TrainConfig(**knob)
    assert all(getattr(cfg, k) == v for k, v in knob.items())
    net = torch.nn.Module()
    net.mapping = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_train_state(net, net, cfg)


def test_unported_discriminators_name_the_roadmap():
    """Every LostGAN D preset is ported; the layout2im family's D name is no
    preset of the factory, which names its constructors."""
    from layout2img_tpu_torch.models.discriminators import make_discriminator

    for preset in ("d128", "d64", "d256"):
        assert make_discriminator(preset, 10, device="cpu", ch=2).image_size == int(preset[1:])
    with pytest.raises(ValueError, match="Layout2ImImageDiscriminator and Layout2ImObjectDiscr"):
        make_discriminator("layout2im", 10, device="cpu")
