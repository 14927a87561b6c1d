"""The port's ``cli.human_study`` against the JAX package's (on the CPU): the
same PNG files, pixel for pixel, for the bundled studies and for a
``--json`` study; the same bundled ``DEFAULT_STUDIES``; and a clean non-zero
exit with one line where matplotlib is missing."""

import json
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest

from layout2img_tpu.cli import human_study as jax_human_study
from layout2img_tpu_torch.cli import human_study
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDY = [{"name": "A vs B", "labels": ["A", "B"],
          "results": {"coco": {"P1": 70, "P2": 30, "all": 50.0},
                      "vg": {"P1": 61, "P2": 44, "all": 52.5}}}]


def _pixels(directory) -> dict[str, np.ndarray]:
    return {name: np.asarray(PIL.Image.open(os.path.join(directory, name)))
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("study", ["defaults", "json"])
def test_charts_equal_the_jax_charts(tmp_path, study):
    argv = []
    if study == "json":
        (tmp_path / "study.json").write_text(json.dumps(STUDY))
        argv = ["--json", str(tmp_path / "study.json")]
    jax_human_study.main([*argv, "--out_dir", str(tmp_path / "jax")])
    human_study.main([*argv, "--out_dir", str(tmp_path / "port")])
    want, got = _pixels(tmp_path / "jax"), _pixels(tmp_path / "port")
    names = ["pies_0.png", "pies_1.png"] if study == "defaults" else ["pies_0.png"]
    assert list(got) == list(want) == [*names, "preference_bars.png"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_default_studies_equal_the_jax_ones():
    assert human_study.DEFAULT_STUDIES == jax_human_study.DEFAULT_STUDIES


def test_without_matplotlib_exits_with_one_line(tmp_path):
    code = ("import sys\nsys.modules['matplotlib'] = None\n"
            "from layout2img_tpu_torch.cli import human_study\n"
            f"human_study.main(['--out_dir', {str(tmp_path / 'charts')!r}])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert out.stderr.strip().splitlines() == [
        "cli.human_study draws its charts with matplotlib, which is not installed here"]
    assert not list((tmp_path / "charts").glob("*.png"))
