"""The port's ``cli.evaluate`` against the JAX package's: the same decoded
batches in every input mode and ``--npy_range``, the same error for every
misuse the JAX CLI refuses, and the output lines a script parses (IS per
source, KID and LPIPS of a directory against itself)."""

import argparse
import contextlib
import io
import json

import numpy as np
import PIL.Image
import pytest

import layout2img_tpu.eval.inception as jax_inception
from layout2img_tpu.cli import evaluate as jax_cli
from layout2img_tpu_torch.cli import evaluate as port_cli
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A flat dir of 5 PNGs at 64 px (AlexNet's last pool needs about 60), a
    superdir with two result*/images dirs and a decoy, a dir list, and .npy
    arrays in uint8 and each float range."""
    root = tmp_path_factory.mktemp("eval_inputs")
    rng = np.random.default_rng(0)

    def write(d, n, side=64):
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            PIL.Image.fromarray(rng.integers(0, 255, (side, side, 3), np.uint8)).save(d / f"img{i}.png")

    write(root / "flat", 5)
    for r in ("result_a", "result_b"):
        write(root / "super" / r / "images", 3)
    (root / "super" / "not_result" / "images").mkdir(parents=True)
    (root / "dirs.txt").write_text(f"{root / 'flat'}\n\n{root / 'super' / 'result_a' / 'images'}\n")
    u8 = rng.integers(0, 255, (5, 16, 16, 3), np.uint8)
    np.save(root / "u8.npy", u8)
    unit = u8.astype(np.float32) / 255.0
    np.save(root / "unit.npy", unit)
    np.save(root / "pm1.npy", unit * 2 - 1)
    np.save(root / "255.npy", u8.astype(np.float32))
    np.save(root / "pos_pm1.npy", unit * 0.5)  # nonnegative [-1, 1] data: auto misreads it
    return root


def _args(**kw):
    base = dict(dir="", npy="", dir_list="", superdir="", batch_size=2, limit=0, resize=0,
                npy_range="auto")
    base.update(kw)
    return argparse.Namespace(**base)


def _sources(cli, args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = [(name, [b.copy() for b in batches]) for name, batches in cli.resolve_sources(args)]
    return got, out.getvalue()


@pytest.mark.parametrize("mode", ["dir", "dir_limit_resize", "npy_u8", "npy_unit", "npy_pm1",
                                  "npy_255", "npy_pinned_pm1", "npy_pinned_unit", "dir_list",
                                  "superdir"])
def test_input_modes_decode_as_jax(tree, mode):
    kw = {"dir": dict(dir=str(tree / "flat")),
          "dir_limit_resize": dict(dir=str(tree / "flat"), limit=3, resize=8, batch_size=2),
          "npy_u8": dict(npy=str(tree / "u8.npy")),
          "npy_unit": dict(npy=str(tree / "unit.npy")),
          "npy_pm1": dict(npy=str(tree / "pm1.npy")),
          "npy_255": dict(npy=str(tree / "255.npy"), batch_size=4),
          "npy_pinned_pm1": dict(npy=str(tree / "pos_pm1.npy"), npy_range="pm1"),
          "npy_pinned_unit": dict(npy=str(tree / "pm1.npy"), npy_range="unit"),
          "dir_list": dict(dir_list=str(tree / "dirs.txt")),
          "superdir": dict(superdir=str(tree / "super"))}[mode]
    got, got_out = _sources(port_cli, _args(**kw))
    want, want_out = _sources(jax_cli, _args(**kw))
    assert got_out == want_out
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert [b.shape for b in g] == [b.shape for b in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.float32
            assert mode == "npy_pinned_unit" or (a.min() >= -1 and a.max() <= 1)
    if mode in ("npy_unit", "npy_pm1", "npy_255"):
        assert f"treating as '{mode[4:]}'" in got_out
    if mode == "superdir":
        assert len(got) == 2 and all(n.endswith("images") for n, _ in got)
    if mode == "dir_limit_resize":
        assert [b.shape for b in got[0][1]] == [(2, 8, 8, 3), (1, 8, 8, 3)]


def _run(cli, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(argv)
    return out.getvalue()


@pytest.mark.parametrize("case", ["no_input", "two_inputs", "kid_sources", "kid_ref", "fid_sources",
                                  "fid_both_refs", "fid_no_ref", "lpips_sources", "lpips_ref",
                                  "missing_dir", "empty_superdir"])
def test_misuse_raises_as_jax(tree, monkeypatch, case):
    flat, lst = str(tree / "flat"), str(tree / "dirs.txt")
    argv = {"no_input": ["is"], "two_inputs": ["is", "--dir", flat, "--npy", str(tree / "u8.npy")],
            "kid_sources": ["kid", "--dir_list", lst, "--ref_dir", flat],
            "kid_ref": ["kid", "--dir", flat],
            "fid_sources": ["fid", "--superdir", str(tree / "super"), "--ref_dir", flat],
            "fid_both_refs": ["fid", "--dir", flat, "--ref_dir", flat, "--ref_stats", "s.npz"],
            "fid_no_ref": ["fid", "--dir", flat],
            "lpips_sources": ["lpips", "--dir_list", lst, "--ref_dir", flat],
            "lpips_ref": ["lpips", "--dir", flat],
            "missing_dir": ["is", "--dir", str(tree / "nowhere")],
            "empty_superdir": ["is", "--superdir", flat]}[case]
    # the JAX CLI builds its Inception variables before these checks; the
    # checks do not read them, so a stub spares the compile
    monkeypatch.setattr(jax_inception, "random_inception_variables", lambda seed=0: None)
    errors = []
    for cli, extra in ((jax_cli, []), (port_cli, ["--device", "cpu"])):
        with pytest.raises((SystemExit, FileNotFoundError)) as info:
            _run(cli, argv + extra)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_is_kid_and_lpips_output_lines(tree):
    flat = str(tree / "flat")
    out = _run(port_cli, ["is", "--superdir", str(tree / "super"), "--batch_size", "2",
                          "--device", "cpu"])
    lines = [ln for ln in out.splitlines() if ": IS: " in ln]
    assert len(lines) == 2 and all(ln.endswith("(n=3, splits=3)") for ln in lines)
    assert "WARNING: no --inception_weights; random filters (numbers not comparable)" in out
    assert abs(float(lines[0].split("IS: ")[1].split()[0]) - 1.0) < 1e-3  # random filters: ~1

    out = _run(port_cli, ["is", "--npy", str(tree / "unit.npy"), "--splits", "1", "--device", "cpu"])
    assert "treating as 'unit'" in out and "(n=5, splits=1)" in out

    out = _run(port_cli, ["kid", "--dir", flat, "--ref_dir", flat, "--batch_size", "2",
                          "--kid_subsets", "5", "--device", "cpu"])
    line = [ln for ln in out.splitlines() if ln.startswith("KID: ")][0]
    assert abs(float(line.split()[1])) < 50.0 and line.endswith("(n=5 vs 5, subset=5x5)")

    out = _run(port_cli, ["lpips", "--dir", flat, "--ref_dir", flat, "--batch_size", "3",
                          "--device", "cpu"])
    assert out.strip().splitlines()[-1] == "LPIPS: 0.0000 +/- 0.0000  (n=5)"


def test_bench_eval_knobs_and_json_line(monkeypatch, capsys):
    """``bench_eval`` reads ``scripts/bench_eval.py``'s knobs with its
    defaults and prints its JSON line (timed by the host's clock on the
    CPU)."""
    from layout2img_tpu_torch import bench_eval

    assert bench_eval.config_from_env({}) == bench_eval.EvalBenchConfig(256, 20, 3, 128)
    env = {"BENCH_BATCH": "2", "BENCH_SCAN": "1", "BENCH_SCANS": "2", "BENCH_SIZE": "64"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bench_eval.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "inception_eval_images_per_sec" and line["unit"] == "img/s/chip"
    assert (line["batch_size"], line["input_px"]) == (2, 64) and line["value"] > 0
