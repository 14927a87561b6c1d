"""``cli.export`` against the JAX CLI's behaviour, and ``latents_from_seed``
(on the CPU; ``lostgan`` at 64 px, ch=8, b=2).

- ``--bf16`` round-trips: the bf16 artifact equals the eager bf16 generator
  on bf16 latents at 1e-2 (the kernels' bf16 bar; on the CPU both run the
  same plain ops) and ``--run`` runs it;
- the sidecar has the JAX CLI's keys and values;
- ``--run`` draws the JAX CLI's batch: JAX's ``main(["--run", ...])``, on the
  port's sidecar with JAX's deserializer stubbed, hands its artifact the
  boxes and labels that the port's ``run_layouts`` gives;
- ``--ckpt_dir`` with an EMA serves the EMA, not the raw weights;
- the special families are refused, as JAX's ``make_generator`` builds
  neither;
- ``latents_from_seed`` is deterministic, lies in [-t, t], and over 10^5
  draws has mean 0 and the truncated normal's std to 2e-2.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.cli import export as jax_export
from layout2img_tpu.cli.presets import dataset_spec as jax_dataset_spec
from layout2img_tpu_torch.cli import export as export_cli
from layout2img_tpu_torch.sample import latents_from_seed
from layout2img_tpu_torch.train.checkpoint import CheckpointManager
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.utils.casting import cast_floating
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

CH, SIZE, B, O, NC = 8, 64, 2, 8, 184
ARGS = ["--model", "lostgan", "--dataset", "synthetic", "--img_size", str(SIZE), "--ch", str(CH),
        "--batch_size", str(B), "--device", "cpu"]


def _gen():
    return init_generator(0, NC, preset="lostgan128", device="cpu", ch=CH, image_size=SIZE).eval()


@pytest.fixture(scope="module")
def bf16_artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bf16") / "G16.pt2")
    export_cli.main([*ARGS, "--bf16", "--out", path])
    return path


def test_bf16_round_trips(bf16_artifact, capsys):
    imgs = export_cli.run_artifact(bf16_artifact, torch.device("cpu"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"ran exported artifact: ({B}, 3, {SIZE}, {SIZE}) range")
    assert imgs.dtype == torch.bfloat16 and torch.isfinite(imgs.float()).all()
    gen = cast_floating(_gen(), torch.bfloat16)
    boxes, labels = export_cli.run_layouts(B, O, NC)
    z, z_im = latents_from_seed(torch.tensor([0]), B, O, dtype=torch.bfloat16)
    with torch.no_grad():
        want = gen(z, torch.from_numpy(boxes), torch.from_numpy(labels).long(), z_im)
    assert (imgs.float() - want.float()).abs().max().item() <= 1e-2


def test_sidecar_has_the_jax_keys(bf16_artifact):
    with open(bf16_artifact + ".json") as f:
        meta = json.load(f)
    num_classes, num_objects = jax_dataset_spec("synthetic")
    assert meta == {"batch_size": B, "num_objects": num_objects, "num_classes": num_classes,
                    "img_size": SIZE, "model": "lostgan"}


def test_run_draws_the_jax_batch(bf16_artifact, monkeypatch):
    seen = {}

    class Recorder:
        def call(self, boxes, labels, seed):
            seen.update(boxes=np.asarray(boxes), labels=np.asarray(labels), seed=np.asarray(seed))
            return jax.numpy.zeros((B, SIZE, SIZE, 3))

    monkeypatch.setattr(jax.export, "deserialize", lambda data: Recorder())
    jax_export.main(["--run", bf16_artifact])
    boxes, labels = export_cli.run_layouts(B, O, NC)
    np.testing.assert_array_equal(seen["boxes"], boxes)
    np.testing.assert_array_equal(seen["labels"], labels)
    assert seen["seed"].tolist() == [0]


def test_ckpt_dir_serves_the_ema(tmp_path):
    gen = _gen()
    state = create_train_state(gen, init_discriminator(0, NC, preset="d128", device="cpu", ch=CH,
                                                       image_size=SIZE),
                               TrainConfig(ema_decay=0.999))
    g = torch.Generator().manual_seed(1)
    for v in state.ema.values():
        v.add_(torch.randn(v.shape, generator=g) * 0.05 * v.abs().mean())
    CheckpointManager(str(tmp_path / "ckpt")).save(state)
    path = str(tmp_path / "G.pt2")
    export_cli.main([*ARGS, "--ckpt_dir", str(tmp_path / "ckpt"), "--out", path])
    ema = _gen()
    ema.load_state_dict({**gen.state_dict(), **state.ema})
    boxes, labels = (torch.from_numpy(a) for a in export_cli.run_layouts(B, O, NC))
    seed = torch.tensor([5])
    z, z_im = latents_from_seed(seed, B, O)
    with torch.no_grad():
        got = torch.export.load(path).module()(boxes, labels.long(), seed)
        want, raw = (net(z, boxes, labels.long(), z_im) for net in (ema, gen))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert (got - raw).abs().max().item() > 1e-3


@pytest.mark.parametrize("model", ["ours_ed", "layout2im"])
def test_special_families_are_refused(model, tmp_path):
    with pytest.raises(SystemExit, match="special family"):
        export_cli.main(["--model", model, "--device", "cpu", "--out", str(tmp_path / "x.pt2")])
    assert not (tmp_path / "x.pt2").exists()


@pytest.mark.parametrize("truncation", [2.0, 1.0])
def test_latents_from_seed(truncation):
    z, z_im = latents_from_seed(torch.tensor([7]), 1000, 1, 100, truncation)
    again, _ = latents_from_seed(torch.tensor([7 + 2**32]), 1000, 1, 100, truncation)
    other, _ = latents_from_seed(torch.tensor([8]), 1000, 1, 100, truncation)
    assert z.shape == (1000, 1, 100) and z_im.shape == (1000, 100)
    assert torch.equal(z, again)  # only the seed's low 32 bits count
    assert (z != other).float().mean().item() > 0.99
    assert (z != z_im[:, None, :1]).any()
    assert z.abs().max().item() <= truncation
    t = truncation
    mass = math.erf(t / math.sqrt(2.0))
    std = math.sqrt(1.0 - 2.0 * t * math.exp(-t * t / 2) / math.sqrt(2 * math.pi) / mass)
    assert abs(z.mean().item()) <= 2e-2
    assert abs(z.std().item() - std) <= 2e-2
    bf16 = latents_from_seed(torch.tensor([7]), 1000, 1, 100, truncation, torch.bfloat16)[0]
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, z.to(torch.bfloat16))
