"""``cli.train --eval_every/--eval_n/--inception_weights`` at a tiny width on
the CPU: rel-FID lines at the eval steps, the frozen pool, and a generator
that trains to the same bits with the eval on or off."""

import json
import os

import numpy as np
import pytest
import torch

from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import SyntheticLayoutDataset
from test_torch_port_eval_metrics import _eval_threads  # noqa: F401  (autouse)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

TINY = ["--dataset", "synthetic", "--img_size", "64", "--ch", "4", "--no_vgg", "--batch_size",
        "2", "--device", "cpu", "--seed", "3", "--steps", "4", "--log_every", "2"]


def _run(out) -> str:
    return os.path.join(out, "synthetic", "64", "context_app_v2")


def _lines(out) -> list[dict]:
    with open(os.path.join(_run(out), "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_eval_every_logs_rel_fid_and_trains_the_same_generator(tmp_path):
    """rel_fid at steps 2 and 4, finite and >= 0, no IS with the random
    filters, the warning in log.txt; G.pth equal bit for bit to a run
    without eval (the hook draws from generators of its own and runs G in
    eval mode)."""
    with_eval, without = str(tmp_path / "eval"), str(tmp_path / "plain")
    train_cli.main([*TINY, "--out_path", with_eval, "--eval_every", "2", "--eval_n", "2"])
    train_cli.main([*TINY, "--out_path", without])
    evals = [ln for ln in _lines(with_eval) if "rel_fid" in ln]
    assert [ln["step"] for ln in evals] == [2, 4]
    assert all(np.isfinite(ln["rel_fid"]) and ln["rel_fid"] >= 0 for ln in evals)
    assert all("is_mean" not in ln for ln in evals)
    assert not any("rel_fid" in ln for ln in _lines(without))
    with open(os.path.join(_run(with_eval), "log.txt")) as f:
        log = f.read()
    assert "rel_fid uses fixed-seed random filters" in log
    assert "periodic eval: 2 real images every 2 steps" in log and "eval step 4:" in log
    a = torch.load(os.path.join(_run(with_eval), "G.pth"))
    b = torch.load(os.path.join(_run(without), "G.pth"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # the train metrics too: the eval moved nothing the steps read
    plain = [ln for ln in _lines(with_eval) if "d_loss" in ln]
    assert [ln["d_loss"] for ln in plain] == [ln["d_loss"] for ln in _lines(without)]


def test_eval_flags_parse_with_the_jax_defaults():
    """The three flags are ported: defaults as in the JAX CLI (``--eval_n``
    64), and ``refuse_later_slices`` accepts them set."""
    args = train_cli.parse_args([])
    assert (args.eval_every, args.eval_n, args.inception_weights) == (0, 64, "")
    args = train_cli.parse_args(["--eval_every", "5", "--eval_n", "8",
                                 "--inception_weights", "i.pth"])
    assert (args.eval_every, args.eval_n, args.inception_weights) == (5, 8, "i.pth")
    train_cli.refuse_later_slices(args)


@pytest.mark.parametrize("eval_n,want_batches", [(1, 1), (3, 2), (4, 2)])
def test_eval_pool_is_the_first_whole_loader_batches(eval_n, want_batches):
    """``--eval_n`` rounds up to whole batches of the loader's first pass."""
    import logging

    args = train_cli.parse_args(["--eval_every", "2", "--eval_n", str(eval_n), "--batch_size", "2"])
    loader = SyntheticLayoutDataset(2, 64, 8, seed=7, steps=5)
    sample = lambda params, boxes, labels, rng: torch.zeros(len(labels), 3, 64, 64)  # noqa: E731
    hook = train_cli.build_evaluator(args, sample, loader, torch.device("cpu"),
                                     logging.getLogger("test"))
    assert hook.n_images == 2 * want_batches
    first = list(loader)[:want_batches]
    assert len(hook._layouts) == want_batches
    for (boxes, labels), batch in zip(hook._layouts, first):
        assert np.array_equal(boxes.numpy(), batch["boxes"])
        assert np.array_equal(labels.numpy(), batch["labels"])
