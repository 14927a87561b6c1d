"""The check fails what it should: each fault a cell can have, planted in
the timed path underneath a whole run (the harness's look for a chip
skipped: the CPU at a small width), and the control (the reference with
fp8 operands in the program's place). A sound run passes the same limits.
"""

import pytest
import torch

from benchmark import check, program, run, spec
from benchmark.kinds import ddp, sample, train
from benchmark.tests.small import small_cell

SEED = 2**31 + 2024
CPU = torch.device("cpu")


class Planted:
    """The program's entries with one fault planted in what they return."""

    def __init__(self, fault: str | None):
        self.fault = fault

    def init_ranks(self, device, timeout_s):
        program.init_ranks(device, timeout_s)

    def shutdown_ranks(self):
        program.shutdown_ranks()

    def build_train(self, config, weights, device):
        if self.fault == "no_exchange":  # each rank steps on its own gradients
            from layout2img_tpu_torch.parallel.mesh import DataMesh

            DataMesh.all_reduce_grads = lambda mesh, grads, params: grads
        prog = program.build_train(config, weights, device)
        real, params = prog.step, list(prog.params().values())

        def unchanged(batch, rng):
            saved = [p.detach().clone() for p in params]
            metrics = real(batch, rng)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return metrics

        def half_batch(batch, rng):
            return real({k: v[: len(v) // 2] for k, v in batch.items()}, rng)

        prog.step = {None: real, "unchanged": unchanged, "half_batch": half_batch,
                     "no_exchange": real}[self.fault]
        return prog

    def build_sampler(self, config, weights, device):
        prog = program.build_sampler(config, weights, device)
        real, last = prog.sample, []

        def altered(boxes, labels, rng):
            x = real(boxes, labels, rng)
            return torch.cat([x[1:2], x[1:]])

        def half_batch(boxes, labels, rng):
            x = real(boxes, labels, rng).clone()
            x[len(x) // 2:] = -1.0
            return x

        def stale(boxes, labels, rng):
            x = real(boxes, labels, rng)
            out = last[0] if last else x
            last[:] = [x]
            return out

        prog.sample = {None: real, "altered": altered, "half_batch": half_batch,
                       "stale": stale}[self.fault]
        return prog


def _run(name: str, fault: str | None) -> dict:
    return run.run_cell(small_cell(name), SEED, 0.5, False, CPU, api=Planted(fault))


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train_check(fault):
    result = _run("coco128.train_b256", fault)
    assert result["correct"] is (fault is None), result["lines"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "no_exchange"])
def test_data_parallel_check(fault):
    """The four-chip cell's ranks as gloo processes on the CPU."""
    result = _run("coco128.train_ddp4_b512", fault)
    assert result["correct"] is (fault is None), result["lines"]


@pytest.mark.parametrize("fault", [None, "altered", "half_batch", "stale"])
def test_sample_check(fault):
    result = _run("coco128.sample_b128", fault)
    assert result["correct"] is (fault is None), result["lines"]


def test_train_control_fails_the_limits():
    cell = small_cell("coco128.train_b256")
    want = train.reference_train(cell, SEED, CPU)
    control = train.reference_train(cell, SEED, CPU, precision="fp8")
    correct, lines = check.judge(check.train_numbers(control, want), cell.limits)
    assert not correct, lines


def test_data_parallel_reference_as_ranks_is_one_process_at_the_global_batch():
    """The reference run as ranks (global BN statistics, summed gradients)
    steps as one process does on the ranks' rows together."""
    cell = small_cell("coco128.train_ddp4_b512")
    rows = {}
    ddp.calibrate(cell, [SEED], set(), set(), CPU,
                  lambda seed, side, numbers, extra: rows.setdefault(side, (numbers, extra)))
    one = spec.Cell(cell.name, 1, {**cell.config, "batch": cell.config["batch"] * cell.chips},
                    cell.traffic, cell.limits, cell.end_to_end, cell.per_layer)
    want = train.reference_train(one, SEED, CPU)
    numbers = check.train_numbers(rows["reference"][1]["detail"], want)
    assert max(numbers["grad_gap"], numbers["grad_gap_third"]) < 1e-4, numbers
    # Adam moves a parameter with a near-zero gradient by the sign of its round-off
    assert numbers["update_gap"] < 1e-2, numbers
    assert rows["program"][0]["grad_gap"] < 1e-4, rows["program"][0]


def test_sample_control_fails_the_limits():
    cell = small_cell("coco128.sample_b128")
    want = sample.reference_images(cell, SEED, CPU, [1, 2])
    control = sample.reference_images(cell, SEED, CPU, [1, 2], precision="fp8")
    numbers = check.image_numbers(torch.cat(list(control.values())), torch.cat(list(want.values())))
    correct, lines = check.judge(numbers, cell.limits)
    assert not correct, lines
