"""The layout2im family (``--model layout2im``) through the port's CLIs on
the CPU: the generator at the JAX CLI's width (conv_dim 64, whatever
``--ch``), both discriminators at ch=4.

- ``cli.train --l2i_fusion convlstm`` on synthetic batches: an epoch, then
  ``--resume`` (the step count continues) with ``--eval_every`` (rel_fid in
  the metric stream); the JAX output layout ``<out>/synthetic/64/layout2im``
  with checkpoints and no ``.pth`` files; the checkpoint's generator is the
  convlstm one at conv_dim 64, its discriminator the ``img``/``obj`` pair at
  ch=4; ``cli.sample --ckpt_dir --l2i_fusion convlstm`` in f32 and bf16.
- The default fusion (``transformer``) on an on-disk COCO-Stuff fixture,
  then ``cli.sample --dataset coco``.
- The NaN drill exits 3 and saves nothing.
"""

import os

import numpy as np
import pytest

from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import write_synthetic_coco, write_synthetic_stuff
from layout2img_tpu_torch.models.layout2im import (Layout2ImGenerator,
                                                   Layout2ImImageDiscriminator,
                                                   Layout2ImObjectDiscriminator)
from layout2img_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_port_special_cli import SYNTH, TINY, _lines, _run, _steps
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse, 1 BLAS thread)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)


def test_layout2im_train_resume_eval_sample(tmp_path):
    out = str(tmp_path / "o")
    args = ["--model", "layout2im", "--l2i_fusion", "convlstm", *SYNTH, "--steps_per_epoch", "1",
            "--out_path", out, "--total_epoch", "1"]
    train_cli.main(args)
    run = _run(out, model="layout2im")
    assert _steps(run) == [1]
    train_cli.main([*args, "--resume", "--eval_every", "2", "--eval_n", "2"])
    lines = _lines(run)
    assert [ln["step"] for ln in lines if "d_loss" in ln] == [1, 2]
    assert {"img_rec_l1", "kl", "z_rec_l1", "g_adv"} <= set(lines[0])
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    evals = [ln for ln in lines if "rel_fid" in ln]
    assert [ln["step"] for ln in evals] == [2]
    assert _steps(run) == [1, 2]
    assert not any(name.endswith(".pth") for name in os.listdir(run))

    ckpt = os.path.join(run, "ckpt")
    content = CheckpointManager(ckpt).read()
    Layout2ImGenerator(184, fusion="convlstm").load_state_dict(content["generator"], strict=True)
    d = content["discriminator"]
    Layout2ImImageDiscriminator(4).load_state_dict(
        {k.removeprefix("img."): v for k, v in d.items() if k.startswith("img.")}, strict=True)
    Layout2ImObjectDiscriminator(184, 4).load_state_dict(
        {k.removeprefix("obj."): v for k, v in d.items() if k.startswith("obj.")}, strict=True)
    for bf16 in (False, True):
        samples = str(tmp_path / f"s{int(bf16)}")
        sample_cli.main(["--model", "layout2im", "--l2i_fusion", "convlstm", "--ckpt_dir", ckpt,
                         "--sample_path", samples, "--num_img", "2", "--batch_size", "2",
                         "--max_layouts", "2", "--device", "cpu",
                         *(["--bf16"] if bf16 else [])])
        assert sorted(os.listdir(samples)) == [f"sample{i}_numb{j}.jpg"
                                               for i in range(2) for j in range(2)]
    with pytest.raises(RuntimeError, match="state_dict"):  # another fusion than trained
        sample_cli.main(["--model", "layout2im", "--ckpt_dir", ckpt, "--sample_path",
                         str(tmp_path / "x"), "--device", "cpu"])


def test_layout2im_on_the_coco_fixture(tmp_path):
    root = str(tmp_path / "coco")
    _, inst = write_synthetic_coco(root, 3, width=96, height=80, seed=3)
    stuff = write_synthetic_stuff(root, inst, seed=4)
    data = ["--dataset", "coco", "--coco_image_dir", root, "--coco_instances", inst,
            "--coco_stuff", stuff]
    out = str(tmp_path / "o")
    train_cli.main(["--model", "layout2im", *data, *TINY, "--out_path", out, "--total_epoch", "1"])
    run = _run(out, model="layout2im", dataset="coco")
    lines = _lines(run)
    assert len(lines) >= 1 and _steps(run) == [len(lines)]
    assert all(np.isfinite(ln["g_loss"]) for ln in lines)
    samples = str(tmp_path / "s")
    sample_cli.main(["--model", "layout2im", "--ckpt_dir", os.path.join(run, "ckpt"), *data,
                     "--sample_path", samples, "--num_img", "1", "--batch_size", "2",
                     "--device", "cpu"])
    assert len(os.listdir(samples)) == len(lines)


def test_layout2im_nan_drill_exits_3(tmp_path):
    out = str(tmp_path / "o")
    with pytest.raises(SystemExit) as exit_info:
        train_cli.main(["--model", "layout2im", "--l2i_fusion", "convlstm", *SYNTH, "--out_path",
                        out, "--total_epoch", "1", "--fault_inject_nan_at", "1"])
    assert exit_info.value.code == 3
    run = _run(out, model="layout2im")
    assert _steps(run) == []
    assert "non-finite metrics at step 1" in open(os.path.join(run, "log.txt")).read()
    # the metric stream holds no line for the poisoned step
    assert not os.path.exists(os.path.join(run, "metrics.jsonl")) or _lines(run) == []
