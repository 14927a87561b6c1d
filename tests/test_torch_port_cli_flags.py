"""The JAX CLIs' command lines run against the port's ``cli.sample`` and
``cli.export_torch`` (on the CPU).

- Every option of the JAX parsers (``layout2img_tpu/cli/sample.py``,
  ``cli/export_torch.py``) is an option of the port's, and JAX command lines,
  the repository's verification runbook's ``--ch 4`` sample line among them,
  parse to the same values.
- The port reads the sizes off the weights: a ``--ch`` or ``--img_size``
  that disagrees with them raises, naming both values; the right ones run.
"""

import argparse

import pytest
import torch

from layout2img_tpu.cli import export_torch as jax_export_torch
from layout2img_tpu.cli import sample as jax_sample
from layout2img_tpu_torch.cli import export_torch, sample
from layout2img_tpu_torch.train.checkpoint import CheckpointManager
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

SAMPLE_LINES = [
    # the verification runbook's sample step
    ["--model", "ours_d", "--dataset", "synthetic", "--ckpt_dir", "ckpt", "--sample_path", "s",
     "--num_img", "2", "--img_size", "64", "--ch", "4", "--batch_size", "2", "--max_layouts", "4"],
    ["--model", "context_app_v2", "--dataset", "coco", "--ckpt_dir", "ckpt", "--ch", "64",
     "--img_size", "128", "--obj_budget", "8", "--bf16", "--truncation", "1.5", "--seed", "3"],
    ["--model", "layout2im", "--l2i_fusion", "convlstm", "--dataset", "vg", "--ckpt_dir", "c",
     "--vg_h5", "v.h5", "--vg_vocab", "v.json", "--vg_image_dir", "img"],
]
EXPORT_TORCH_LINES = [
    ["--model", "context_app_v2", "--ckpt_dir", "ckpt", "--out_g", "G.pth", "--out_d", "D.pth"],
    ["--model", "lostgan", "--dataset", "vg", "--ckpt_dir", "ckpt", "--out_g", "G.pth", "--ch",
     "4", "--img_size", "64", "--no_ema", "--module_prefix"],
]


def _options(parse_args, argv) -> set[str]:
    """The option strings of the parser that ``parse_args(argv)`` builds."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.append(self)
        return real(self, args, namespace)

    argparse.ArgumentParser.parse_args = grab
    try:
        parse_args(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return {s for a in seen[0]._actions for s in a.option_strings}


@pytest.mark.parametrize("cli", ["sample", "export_torch"])
def test_port_takes_every_jax_option(cli):
    jax_cli, port_cli, argv = {"sample": (jax_sample, sample, []),
                               "export_torch": (jax_export_torch, export_torch,
                                                ["--ckpt_dir", "c"])}[cli]
    missing = _options(jax_cli.parse_args, argv) - _options(port_cli.parse_args, argv)
    assert not missing, f"the port's cli.{cli} lacks the JAX CLI's {sorted(missing)}"


@pytest.mark.parametrize("cli,argv", [("sample", a) for a in SAMPLE_LINES]
                         + [("export_torch", a) for a in EXPORT_TORCH_LINES])
def test_jax_command_lines_parse_alike(cli, argv):
    jax_cli, port_cli = {"sample": (jax_sample, sample),
                         "export_torch": (jax_export_torch, export_torch)}[cli]
    want, got = vars(jax_cli.parse_args(argv)), vars(port_cli.parse_args(argv))
    given = {a.lstrip("-") for a in argv if a.startswith("--")}
    assert {k: got[k] for k in given} == {k: want[k] for k in given}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A ch=4 64-px ``context_app_v2`` generator as a ``.pth`` and in a
    ``cli.train`` checkpoint."""
    root = tmp_path_factory.mktemp("flags")
    gen = init_generator(0, 184, device="cpu", ch=4, image_size=64)
    torch.save(gen.state_dict(), root / "G.pth")
    disc = init_discriminator(0, 184, device="cpu", ch=4, image_size=64)
    CheckpointManager(str(root / "ckpt")).save(create_train_state(gen, disc, TrainConfig()))
    return root


@pytest.mark.parametrize("flag,value,actual", [("--ch", "8", "4"), ("--img_size", "128", "64"),
                                               ("--img_size", "256", "64")])
def test_sample_refuses_sizes_that_disagree(weights, flag, value, actual):
    with pytest.raises(SystemExit, match=f"{flag} {value} disagrees .* is {actual}"):
        sample.main(["--weights", str(weights / "G.pth"), flag, value, "--device", "cpu",
                     "--sample_path", str(weights / "never")])
    assert not (weights / "never").exists()


@pytest.mark.parametrize("flag,value,actual", [("--ch", "64", "4"), ("--img_size", "128", "64")])
def test_export_torch_refuses_sizes_that_disagree(weights, flag, value, actual):
    with pytest.raises(SystemExit, match=f"{flag} {value} disagrees .* is {actual}"):
        export_torch.main(["--ckpt_dir", str(weights / "ckpt"), "--out_g",
                           str(weights / "never.pth"), flag, value])
    assert not (weights / "never.pth").exists()


def test_sizes_that_agree_run(weights, capsys):
    out = weights / "samples"
    sample.main(["--weights", str(weights / "G.pth"), "--ch", "4", "--img_size", "64",
                 "--dataset", "synthetic", "--device", "cpu", "--num_img", "1",
                 "--batch_size", "2", "--max_layouts", "2", "--sample_path", str(out)])
    assert sorted(p.name for p in out.iterdir()) == ["sample0_numb0.jpg", "sample1_numb0.jpg"]
    export_torch.main(["--ckpt_dir", str(weights / "ckpt"), "--dataset", "coco", "--ch", "4",
                       "--img_size", "64", "--out_g", str(weights / "G_out.pth")])
    exported = torch.load(weights / "G_out.pth", weights_only=True)
    assert sample.generator_sizes(exported) == {"ch": 4, "image_size": 64}
