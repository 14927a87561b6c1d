"""The Ours-ED family (``--model ours_ed``) through the port's CLIs on the
CPU at ch=4, and the special families' refusals.

- ``cli.train`` on synthetic batches: an epoch, then ``--resume`` (the step
  count continues from the checkpoint) with ``--eval_every`` (rel_fid in
  the metric stream); the JAX output layout ``<out>/synthetic/64/ours_ed``
  with checkpoints and no ``.pth`` files; ``cli.sample --ckpt_dir`` in bf16
  and f32 (the same count of JPEGs); ``cli.export_torch --model ours_ed``,
  whose G loads into ``BgFgGenerator`` and whose D (under ``obD.``) loads
  into ``d64``, both strictly.
- ``cli.train`` and ``cli.sample --dataset coco`` on an on-disk COCO-Stuff
  fixture, whose items carry the fg/bg streams.
- The NaN drill (``--fault_inject_nan_at``) exits 3 and saves nothing.
- ``--mixed_precision`` changes nothing for Ours-ED: the same losses and
  the same checkpoint bit for bit, as the JAX step never reads the flag.
- Refused as the JAX CLIs refuse them: the object budgets, ``--img_size``
  other than 64, the LostGAN step's knobs, ``cli.sample`` without
  ``--ckpt_dir`` or with ``--obj_budget``, and ``cli.export_torch --model
  layout2im``.
"""

import json
import os

import numpy as np
import pytest
import torch

from layout2img_tpu_torch.cli import export_torch
from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import write_synthetic_coco, write_synthetic_stuff
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.models.generators import BgFgGenerator
from layout2img_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse, 1 BLAS thread)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

TINY = ["--ch", "4", "--no_vgg", "--batch_size", "2", "--device", "cpu", "--seed", "3",
        "--log_every", "1", "--save_every_epochs", "1"]
SYNTH = ["--dataset", "synthetic", "--steps_per_epoch", "2", *TINY]


def _run(out: str, model: str = "ours_ed", dataset: str = "synthetic") -> str:
    return os.path.join(out, dataset, "64", model)


def _lines(run: str) -> list[dict]:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _steps(run: str) -> list[int]:
    return CheckpointManager(os.path.join(run, "ckpt")).all_steps()


def test_ours_ed_train_resume_eval_sample_export(tmp_path):
    out = str(tmp_path / "o")
    args = ["--model", "ours_ed", *SYNTH, "--out_path", out, "--total_epoch", "1"]
    train_cli.main(args)
    run = _run(out)
    assert _steps(run) == [2]
    assert sorted(os.listdir(run)) == ["ckpt", "images", "log.txt", "metrics.jsonl"]
    train_cli.main([*args, "--resume", "--eval_every", "2", "--eval_n", "2"])
    lines = _lines(run)
    assert [ln["step"] for ln in lines if "d_loss" in ln] == [1, 2, 3, 4]
    assert {"g_loss_fake", "g_loss_obj", "pixel_loss"} <= set(lines[0])
    evals = [ln for ln in lines if "rel_fid" in ln]
    assert [ln["step"] for ln in evals] == [4] and np.isfinite(evals[0]["rel_fid"])
    assert _steps(run) == [2, 4]
    assert not any(name.endswith(".pth") for name in os.listdir(run))

    ckpt = os.path.join(run, "ckpt")
    for bf16 in (True, False):
        samples = str(tmp_path / f"s{int(bf16)}")
        sample_cli.main(["--model", "ours_ed", "--ckpt_dir", ckpt, "--sample_path", samples,
                         "--num_img", "1", "--batch_size", "3", "--max_layouts", "5",
                         "--device", "cpu", *(["--bf16"] if bf16 else [])])
        assert sorted(os.listdir(samples)) == [f"sample{i}_numb0.jpg" for i in range(6)]

    g_path, d_path = str(tmp_path / "G.pth"), str(tmp_path / "D.pth")
    export_torch.main(["--model", "ours_ed", "--ckpt_dir", ckpt, "--out_g", g_path,
                       "--out_d", d_path])
    g_sd = torch.load(g_path, weights_only=True)
    BgFgGenerator(91, 93, ch=4).load_state_dict(g_sd, strict=True)
    assert torch.equal(g_sd["combination.model.2.weight"], g_sd["combination.conv1.weight"])
    d_sd = {k.removeprefix("obD."): v for k, v in torch.load(d_path, weights_only=True).items()}
    make_discriminator("d64", 184, device="cpu", ch=4).load_state_dict(d_sd, strict=True)
    with pytest.raises(SystemExit, match="not a --model context_app_v2 one"):
        export_torch.main(["--ckpt_dir", ckpt, "--out_g", g_path])


def test_ours_ed_on_the_coco_fixture(tmp_path):
    root = str(tmp_path / "coco")
    _, inst = write_synthetic_coco(root, 5, width=96, height=80, seed=3)
    stuff = write_synthetic_stuff(root, inst, seed=4)
    data = ["--dataset", "coco", "--coco_image_dir", root, "--coco_instances", inst,
            "--coco_stuff", stuff]
    out = str(tmp_path / "o")
    train_cli.main(["--model", "ours_ed", *data, *TINY, "--out_path", out, "--total_epoch", "1"])
    run = _run(out, dataset="coco")
    lines = _lines(run)
    assert len(lines) >= 2 and _steps(run) == [len(lines)]  # the images and their flips, b=2
    assert all(np.isfinite(ln["g_loss"]) for ln in lines)
    samples = str(tmp_path / "s")
    sample_cli.main(["--model", "ours_ed", "--ckpt_dir", os.path.join(run, "ckpt"), *data,
                     "--sample_path", samples, "--num_img", "1", "--batch_size", "2",
                     "--device", "cpu"])
    assert len(os.listdir(samples)) == len(lines)  # the val protocol: each image once


def test_ours_ed_nan_drill_exits_3(tmp_path):
    out = str(tmp_path / "o")
    with pytest.raises(SystemExit) as exit_info:
        train_cli.main(["--model", "ours_ed", *SYNTH, "--out_path", out, "--total_epoch", "1",
                        "--fault_inject_nan_at", "2"])
    assert exit_info.value.code == 3
    assert _steps(_run(out)) == []
    assert "non-finite metrics at step 2" in open(os.path.join(_run(out), "log.txt")).read()


def test_ours_ed_mixed_precision_changes_nothing(tmp_path):
    runs = []
    for mixed in (False, True):
        out = str(tmp_path / f"o{int(mixed)}")
        train_cli.main(["--model", "ours_ed", *SYNTH, "--out_path", out, "--total_epoch", "1",
                        *(["--mixed_precision"] if mixed else [])])
        runs.append(_run(out))
    f32, mixed = ([{k: v for k, v in ln.items() if k != "time"} for ln in _lines(r)] for r in runs)
    assert f32 == mixed and len(f32) == 2
    a, b = (CheckpointManager(os.path.join(r, "ckpt")).read() for r in runs)
    for part in ("generator", "discriminator"):
        for k, v in a[part].items():
            assert v.dtype == b[part][k].dtype and torch.equal(v, b[part][k]), (part, k)
    assert "runs in f32" in open(os.path.join(runs[1], "log.txt")).read()


@pytest.mark.parametrize("flags,match", [
    (["--g_obj_budget", "4"], "LostGAN-family flags; --model ours_ed has no object-budget"),
    (["--d_obj_budget", "4"], "LostGAN-family flags; --model ours_ed has no object-budget"),
    (["--img_size", "128"], "64px family; got --img_size 128"),
    (["--ema_decay", "0.9", "--fused_d"], "--ema_decay, --fused_d: LostGAN-step flags"),
    (["--remat", "g"], "--remat: LostGAN-step flags")])
def test_special_train_refusals(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["--model", "ours_ed", *SYNTH, "--out_path", str(tmp_path / "o"), *flags])
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("model", ["ours_ed", "layout2im"])
def test_special_sample_and_export_refusals(tmp_path, model):
    samples = str(tmp_path / "s")
    with pytest.raises(SystemExit, match=f"{model} sampling requires --ckpt_dir"):
        sample_cli.main(["--model", model, "--weights", str(tmp_path / "G.pth"),
                         "--sample_path", samples, "--device", "cpu"])
    with pytest.raises(SystemExit, match="has no object-budget serving path"):
        sample_cli.main(["--model", model, "--ckpt_dir", str(tmp_path / "c"), "--obj_budget", "3",
                         "--sample_path", samples, "--device", "cpu"])
    assert not os.path.exists(samples)
    if model == "layout2im":
        with pytest.raises(SystemExit, match="layout2im has no torch export"):
            export_torch.main(["--model", "layout2im", "--ckpt_dir", str(tmp_path / "c"),
                               "--out_g", str(tmp_path / "G.pth")])
