"""The port's dress rehearsal of ``scripts/eval_pipeline.py``: train ->
checkpoint -> sample (the reference's ``sample{i}_numb{j}.jpg`` names) ->
IS on the directory and on an ``.npy`` of it (float range detected) -> FID
against a real directory, through the port's CLIs on the CPU with
random-filter Inception: a plumbing check, not comparable numbers."""

import contextlib
import glob
import io
import os

import numpy as np
import PIL.Image

from layout2img_tpu_torch.cli import evaluate as evaluate_cli
from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.cli import train as train_cli
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)


def _eval(argv) -> str:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        evaluate_cli.main([*argv, "--device", "cpu"])
    return out.getvalue()


def test_train_sample_is_fid(tmp_path):
    out_path, sample_path, real_path = (str(tmp_path / n) for n in ("train_out", "samples", "real"))
    train_cli.main(["--model", "lostgan", "--dataset", "synthetic", "--batch_size", "4",
                    "--img_size", "64", "--ch", "4", "--total_epoch", "1", "--steps_per_epoch",
                    "2", "--no_vgg", "--save_every_epochs", "1", "--log_every", "1",
                    "--out_path", out_path, "--device", "cpu"])
    ckpt_dir = os.path.join(out_path, "synthetic", "64", "lostgan", "ckpt")
    assert os.path.isdir(ckpt_dir)

    sample_cli.main(["--model", "lostgan", "--dataset", "synthetic", "--ckpt_dir", ckpt_dir,
                     "--img_size", "64", "--num_img", "2", "--batch_size", "4",
                     "--max_layouts", "4", "--sample_path", sample_path, "--device", "cpu"])
    files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(sample_path, "*.jpg")))
    assert files == sorted(f"sample{i}_numb{j}.jpg" for i in range(4) for j in range(2))

    os.makedirs(real_path)
    rng = np.random.default_rng(0)
    for i in range(8):
        PIL.Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8), "RGB").save(
            os.path.join(real_path, f"real{i}.jpg"))

    out_is = _eval(["is", "--dir", sample_path, "--batch_size", "4", "--splits", "3"])
    assert f"{sample_path}: IS: " in out_is and "(n=8, splits=3)" in out_is

    arr = np.stack([np.asarray(PIL.Image.open(os.path.join(sample_path, f)), np.float32) / 255.0
                    for f in files])  # [0, 1] floats, the common save format
    npy_path = str(tmp_path / "samples.npy")
    np.save(npy_path, arr)
    out_npy = _eval(["is", "--npy", npy_path, "--batch_size", "4"])
    assert "treating as 'unit'" in out_npy and "(n=8, splits=3)" in out_npy
    is_of = [float(o.split("IS: ")[1].split()[0]) for o in (out_is, out_npy)]
    np.testing.assert_allclose(is_of[0], is_of[1], rtol=1e-4)  # the same pixels, two inputs

    out_fid = _eval(["fid", "--dir", sample_path, "--ref_dir", real_path, "--batch_size", "4"])
    fid = float([ln for ln in out_fid.splitlines() if ln.startswith("FID: ")][0].split()[1])
    assert np.isfinite(fid) and fid > 0
