"""The port's conditioning check (``layout2img_tpu_torch/scripts/
train_conditioning_check.py``) against the JAX repo's script, on the CPU.

- Its numpy helpers (palette, the LostGAN and the fg/bg tasks' batches, the
  three scores) equal the JAX script's (loaded by path) on the same
  ``default_rng`` draws, bit for bit.
- One tiny run per family (ch=4, b=2, 2 chunks of 2 steps; layout2im, whose
  G is 64 wide at any ``--ch``, 1 chunk of 1 step) trains through the
  port's step, finishes with finite losses and prints its scores; the
  script's gate refuses a run that did not learn, and ``--torch_init`` is
  refused with a message naming the ROADMAP.
"""

import argparse
import importlib.util
import math
import os

import numpy as np
import pytest

from layout2img_tpu_torch.scripts import train_conditioning_check as check
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_check():
    spec = importlib.util.spec_from_file_location(
        "jax_train_conditioning_check", os.path.join(REPO, "scripts", "train_conditioning_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _task(**kw):
    return argparse.Namespace(**{"batch_size": 6, "objects": 5, "img_size": 32, "num_classes": 12,
                                 **kw})


@pytest.mark.parametrize("kind", ["lostgan", "bgfg"])
def test_batches_and_scores_equal_the_jax_script(jax_check, kind):
    a = _task()
    n_colors = a.num_classes + (check.N_BG_CLASSES if kind == "bgfg" else 0)
    palette = check.make_palette(n_colors)
    np.testing.assert_array_equal(palette, jax_check.make_palette(n_colors))
    make = "make_batch_bgfg" if kind == "bgfg" else "make_batch"
    got = getattr(check, make)(np.random.default_rng(4), a, palette)
    want = getattr(jax_check, make)(np.random.default_rng(4), a, palette)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    imgs = np.random.default_rng(5).uniform(-1, 1, got["images"].shape).astype(np.float32)
    imgs[:, :10] = got["images"][:, :10]  # part of each image right, the rest noise
    labels, boxes = ("labels_fg", "boxes_fg") if kind == "bgfg" else ("labels", "boxes")
    scores = [(check.color_score, jax_check.color_score,
               (imgs, got[labels], got[boxes], a.img_size, palette))]
    if kind == "bgfg":
        scores += [(f, getattr(jax_check, f.__name__), (imgs, got, a.img_size, palette,
                                                         a.num_classes))
                   for f in (check.bg_color_score, check.fg_orth_score)]
    for ours, theirs, args in scores:
        s = ours(*args)
        assert math.isfinite(s) and s == theirs(*args), ours.__name__


@pytest.mark.parametrize("preset", ["ours_d_context128", "ours_ed", "layout2im"])
def test_tiny_run_finishes_and_prints_its_scores(preset, tmp_path, capsys, monkeypatch):
    chunks, per_chunk = (1, 1) if preset == "layout2im" else (2, 2)
    monkeypatch.setattr(check, "STEPS_PER_CHUNK", per_chunk)
    argv = ["--preset", preset, "--ch", "4", "--batch_size", "2", "--chunks", str(chunks),
            "--device", "cpu", "--image_out", str(tmp_path / "grid.png")]
    result = check.run_check(check.parse_args(argv))
    out = capsys.readouterr().out
    assert f"[{preset} c=12 o=4] color score before training" in out
    assert "color-conditioning score:" in out and f"wrote {tmp_path / 'grid.png'}" in out
    assert result["steps"] == chunks * per_chunk
    assert result["isla_launches_per_step"] == [0, 0, 0]
    assert math.isfinite(result["score_before"]) and math.isfinite(result["score_after"])
    if preset == "ours_ed":
        assert set(result["extra_after"]) == {"bg", "fg_orth"}
    assert (tmp_path / "grid.png").stat().st_size > 1000
    assert check.learned(result, 0.5) == (result["score_after"] > 0.5
                                          and result["score_after"] > result["score_before"] + 0.3)


def test_gate_and_torch_init(tmp_path, monkeypatch):
    monkeypatch.setattr(check, "STEPS_PER_CHUNK", 1)
    with pytest.raises(SystemExit, match="conditioning did not learn"):
        check.main(["--ch", "4", "--batch_size", "2", "--chunks", "1", "--device", "cpu",
                    "--image_out", ""])
    with pytest.raises(SystemExit, match="ROADMAP.md §1, item 8"):
        check.main(["--torch_init", "--device", "cpu"])
