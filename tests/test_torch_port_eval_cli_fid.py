"""One FID through both evaluate CLIs on one test-written
``--inception_weights`` file: the JAX CLI from two directories, the port's
from the same input and the reference statistics its ``--save_stats`` wrote.

Bar: 1e-4 relative (measured on an Intel Xeon CPU: 56.3547 against
56.3545 as printed to four decimals, 3.5e-6 relative; four images per side
give covariances of rank 3, whose matrix square root amplifies the
features' 2e-6 relative differences)."""

import contextlib
import io

import numpy as np
import PIL.Image
import torch

from layout2img_tpu.cli import evaluate as jax_cli
from layout2img_tpu_torch.cli import evaluate as port_cli
from layout2img_tpu_torch.eval.inception import random_inception_state_dict
from layout2img_tpu_torch.eval.metrics import load_feature_stats
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)


def _run(cli, argv) -> str:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(argv)
    return out.getvalue()


def _fid(out: str) -> float:
    return float([ln for ln in out.splitlines() if ln.startswith("FID: ")][0].split()[1])


def test_fid_agrees_across_the_clis(tmp_path):
    rng = np.random.default_rng(0)
    for name, shift in (("samples", 0), ("real", 60)):
        (tmp_path / name).mkdir()
        for i in range(4):
            img = np.clip(rng.integers(0, 196, (64, 64, 3)) + shift, 0, 255).astype(np.uint8)
            PIL.Image.fromarray(img).save(tmp_path / name / f"img{i}.png")
    weights = str(tmp_path / "inception_v3.pth")
    torch.save(random_inception_state_dict(2), weights)
    stats = str(tmp_path / "real.npz")
    common = ["--batch_size", "4", "--inception_weights", weights]

    out = _run(port_cli, ["fid", "--dir", str(tmp_path / "real"), "--save_stats", stats,
                          *common, "--device", "cpu"])
    assert f"saved stats for 4 images -> {stats}" in out and "FID:" not in out
    assert load_feature_stats(stats)[2] == 4
    want = _fid(_run(jax_cli, ["fid", "--dir", str(tmp_path / "samples"),
                               "--ref_dir", str(tmp_path / "real"), *common]))
    out = _run(port_cli, ["fid", "--dir", str(tmp_path / "samples"), "--ref_stats", stats,
                          *common, "--device", "cpu"])
    assert f"(ref: {stats}, n=4)" in out and "WARNING" not in out
    got = _fid(out)
    assert got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4)
