"""``cli.train`` under 2 ranks on the CPU (gloo, synthetic data, ch=4, 64 px,
2 images per rank, VGG off), started with ``torch.multiprocessing`` as
torchrun starts them (``tests/torch_parallel_ranks.py``), each run under a
time limit of its own:

- a run of 2 steps writes one checkpoint, one metrics stream and one
  ``G.pth``, all from rank 0; ``--resume`` continues from its step on both
  ranks (the ranks check that they restored the same step) and saves the
  next epoch's;
- a SIGTERM to rank 1 alone stops both ranks at the same step: each exits
  0, and rank 0 saves that step (``--preempt_sync_every 1``);
- ``--fault_inject_nan_at``, in that resumed run, stops both ranks, each
  with exit code 3, and the last good checkpoint stays the newest;
- ``--model_parallel`` and ``--mp_mode`` still raise, naming ROADMAP §1 item 6;
- the launcher maps SLURM's variables and its own flags onto torchrun's,
  and a process group that does not form raises.
"""

import argparse
import json
import os
import signal
import time

import pytest
import torch

import torch_parallel_ranks as ranks
from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.parallel import mesh
from layout2img_tpu_torch.scripts.launch_multihost import rank_environment

ARGS = ["--model", "context_app_v2", "--dataset", "synthetic", "--img_size", "64", "--ch", "4",
        "--no_vgg", "--batch_size", "2", "--device", "cpu", "--log_every", "1",
        "--save_every_epochs", "1"]


def _run(tmp_path, extra, timeout=90.0, kill_rank1_after_lines=None):
    """Run cli.train on 2 ranks; returns the ranks' exit codes and the run dir."""
    argv = ARGS + ["--out_path", str(tmp_path)] + extra
    run_dir = tmp_path / "synthetic" / "64" / "context_app_v2"
    if kill_rank1_after_lines is None:
        ranks.run_ranks(ranks.cli_rank, 2, argv, str(tmp_path), timeout=timeout)
    else:
        ctx = ranks.start_ranks(ranks.cli_rank, 2, argv, str(tmp_path))
        deadline = time.monotonic() + timeout
        metrics = run_dir / "metrics.jsonl"
        while not (metrics.exists() and len(metrics.read_text().splitlines())
                   >= kill_rank1_after_lines):
            assert time.monotonic() < deadline, "the run did not reach its steps"
            time.sleep(0.2)
        os.kill(ctx.processes[1].pid, signal.SIGTERM)
        ranks.wait_ranks(ctx, deadline - time.monotonic())
    codes = [int((tmp_path / f"exit.{r}").read_text()) for r in range(2)]
    return codes, run_dir


def _steps(run_dir):
    return sorted(int(d) for d in os.listdir(run_dir / "ckpt") if d.isdigit())


def _metric_steps(run_dir):
    return [json.loads(line)["step"] for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A run of 2 steps, then ``--resume`` for 2 more steps and a NaN
    injected at step 5: the exit codes, checkpoint steps and metrics steps
    after each, and the run dir."""
    tmp = tmp_path_factory.mktemp("resumed")
    codes, run_dir = _run(tmp, ["--steps_per_epoch", "2", "--total_epoch", "1"])
    first = {"codes": codes, "ckpt": _steps(run_dir), "metrics": _metric_steps(run_dir),
             "g_pth": (run_dir / "G.pth").exists()}
    codes, run_dir = _run(tmp, ["--steps_per_epoch", "2", "--total_epoch", "2", "--resume",
                                "--fault_inject_nan_at", "5"])
    second = {"codes": codes, "ckpt": _steps(run_dir), "metrics": _metric_steps(run_dir)}
    return first, second, (run_dir / "log.txt").read_text()


def test_checkpoint_and_resume(resumed):
    first, second, log = resumed
    assert first["codes"] == [0, 0]
    assert first["ckpt"] == [2]
    assert first["metrics"] == [1, 2]  # rank 0's lines only
    assert first["g_pth"]
    assert "resumed from step 2" in log
    assert second["ckpt"] == [2, 4]
    assert second["metrics"] == [1, 2, 3, 4]


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    codes, run_dir = _run(tmp_path, ["--steps_per_epoch", "200", "--total_epoch", "1",
                                     "--preempt_sync_every", "1"], kill_rank1_after_lines=2)
    assert codes == [0, 0]
    (stopped,) = _steps(run_dir)
    assert 2 <= stopped < 200
    assert f"SIGTERM: saving checkpoint at step {stopped}" in (run_dir / "log.txt").read_text()
    assert _metric_steps(run_dir)[-1] == stopped


def test_nan_guard_stops_every_rank(resumed):
    """The resumed run's NaN at step 5: both ranks exit 3, and the
    checkpoint of step 4 stays the newest."""
    _, second, log = resumed
    assert second["codes"] == [3, 3]
    assert second["ckpt"] == [2, 4]
    assert "non-finite metrics at step 5" in log


@pytest.mark.parametrize("flag", [["--model_parallel", "2"], ["--mp_mode", "tensor"]])
def test_model_parallel_flags_name_their_roadmap_item(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 'Slices still to port', item 6"):
        train_cli.main(ARGS + flag)


def test_launcher_maps_slurm_and_its_flags():
    ns = argparse.Namespace(coordinator_address="node0:1234", num_processes=None, process_id=None)
    env = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
           "SLURM_NTASKS_PER_NODE": "4(x2)"}
    assert rank_environment(ns, env) == {"MASTER_ADDR": "node0", "MASTER_PORT": "1234",
                                         "RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
                                         "LOCAL_WORLD_SIZE": "4"}
    ns = argparse.Namespace(coordinator_address=None, num_processes=2, process_id=1)
    assert rank_environment(ns, {"RANK": "0", "WORLD_SIZE": "4"}) == {
        "MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "RANK": "1", "WORLD_SIZE": "2",
        "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}
    with pytest.raises(SystemExit, match="no rank"):
        rank_environment(argparse.Namespace(coordinator_address=None, num_processes=None,
                                            process_id=None), {})


def test_a_group_that_does_not_form_raises(monkeypatch):
    """Rank 0 of 2 with no rank 1: ``initialize`` raises, it never falls back
    to one process; without the launcher's variables it raises too."""
    for k in mesh.LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        mesh.initialize("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(ranks.free_port()))
    with pytest.raises(Exception):
        mesh.initialize("cpu", timeout_s=1.0)
    assert mesh.current().world == 1 and not torch.distributed.is_initialized()
