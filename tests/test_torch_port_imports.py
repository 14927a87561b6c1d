"""The PyTorch port stands alone: it imports no JAX, nothing of the JAX
package and no Triton (its kernels are CUDA C++), and its entry points never
fall back to the CPU on their own."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import layout2img_tpu_torch
names = [m.name for m in pkgutil.walk_packages(layout2img_tpu_torch.__path__, "layout2img_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "layout2img_tpu",
                                    "triton"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(maxsplit=1)
    assert int(n) >= 20, out.stdout
    assert bad.strip() == "[]", out.stdout


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["make_generator", "init_generator", "resolve_device", "cli"])
def test_entry_points_without_cuda_raise(monkeypatch, tmp_path, entry):
    _no_cuda(monkeypatch)
    from layout2img_tpu_torch.cli import sample as sample_cli
    from layout2img_tpu_torch.device import resolve_device
    from layout2img_tpu_torch.models.generators import make_generator
    from layout2img_tpu_torch.utils.convert import init_generator

    calls = {
        "make_generator": lambda: make_generator("ours_d_context128", 10, ch=4, num_mask_classes=10),
        "init_generator": lambda: init_generator(0, 10, ch=4, num_mask_classes=10),
        "resolve_device": lambda: resolve_device(),
        "cli": lambda: sample_cli.main(["--weights", str(tmp_path / "missing.pth"),
                                        "--sample_path", str(tmp_path / "out")]),
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
    from layout2img_tpu_torch.models.generators import make_generator

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_generator("lostgan128", 10, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        make_generator("no_such_preset", 10, device="cpu")
