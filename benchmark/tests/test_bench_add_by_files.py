"""A later change adds a configuration, a traffic mix, a metric and a cell
by adding files and entries only: no file of the benchmark is edited, and
the new cell runs (here on the CPU entry the tests use). The configuration
here names another discriminator preset and turns the VGG loss off, and the
mix names a new kind of traffic, so the reference's network for that preset
and the kind's loop come as new files too."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""Traced steps of the window: a metric added by a file of its own."""


def read(ctx):
    return float(ctx.traced_units) if ctx.kind == "train" else None
'''

KIND = '''"""A kind added by a file of its own: the train loop, announced."""

from benchmark import log
from benchmark.kinds import train

calibrate = train.calibrate


def run(cell, seed, seconds, traced, device, t0, api):
    log("the tiny kind runs")
    return train.run(cell, seed, seconds, traced, device, t0, api)
'''

D128 = '''"""The 128 px layout discriminator without the app head."""

from benchmark.reference import nets


def build(config, dropout_dtype):
    return nets.Discriminator(config["num_classes"], ch=config["ch"], app_head=False)
'''

RUN = """
import json, torch
from benchmark import run, spec
cell = spec.load("tiny.train")
out = {}
for traced in (False, True):
    r = run.run_cell(cell, 2**31 + 9, 0.5, traced, torch.device("cpu"))
    out[traced] = {"correct": r["correct"], "metrics": sorted(r["metrics"])}
print(json.dumps(out))
"""


def _digests(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts
            and ".cache" not in p.parts}


def test_a_cell_added_by_files_runs(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    bench_dir = tmp_path / "benchmark"

    config = json.loads((bench_dir / "configs" / "ours_d_coco128.json").read_text())
    config.update(name="tiny", ch=8, batch=2, slots=4, objects=[1, 3], num_classes=20,
                  precision="f32", discriminator="d128", vgg=False)
    config["train_config"].update(mixed_precision=False, use_vgg_loss=False)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(config))
    (bench_dir / "reference" / "models" / "d128.py").write_text(D128)
    mix = json.loads((bench_dir / "traffic" / "train_resident.json").read_text())
    mix.update(kind="tiny_kind", pool=3, warmup_steps=1, trace_units=2)
    (bench_dir / "traffic" / "tiny_loop.json").write_text(json.dumps(mix))
    (bench_dir / "kinds" / "tiny_kind.py").write_text(KIND)
    (bench_dir / "metrics" / "tiny_steps_traced.py").write_text(READER)
    (bench_dir / "limits" / "tiny.train.json").write_text(
        json.dumps({"grad_gap": 1e-3, "grad_gap_third": 1e-3, "update_gap": 0.05}))

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny.json", "reduced": ["ch"],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny.train", "config": "tiny", "traffic": "tiny_loop",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("tiny.train")
    bench["per_layer"].append({"name": "tiny_steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_img_s", "workloads": ["tiny.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}

    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["false"] == {"correct": True, "metrics": ["setup_s", "train_img_s"]}
    assert got["true"]["correct"] is True
    assert "tiny_steps_traced" in got["true"]["metrics"]
    assert "the tiny kind runs" in out.stderr


def test_a_configuration_the_reference_cannot_check_is_refused():
    from benchmark.reference import step as ref

    config = json.loads((ROOT / "benchmark" / "configs" / "ours_d_coco128.json").read_text())
    ref.supported(config)
    for change in ({"discriminator": "d256"}, {"generator": "no_such_preset"},
                   {"train_config": {**config["train_config"], "g_obj_budget": 12}},
                   {"train_config": {**config["train_config"], "mapping_lr_mult": 0.1}}):
        with pytest.raises(ValueError):
            ref.supported({**config, **change})
