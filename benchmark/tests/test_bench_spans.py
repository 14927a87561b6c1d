"""The readers of the program's spans (``benchmark/program_spans.py`` and the
metrics that read it), on the CPU at the small sizes: traced train and
sample units report every span metric of their cells, the train step's
parts come to no more than its root's device time, a span's busy time
leaves out the card's wait for its dispatch, the sampler's idle share on a
hand-made trace, the data-parallel readers over gloo ranks, and every
reader reads None where the program recorded nothing."""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import cells, program_spans, run, spec, trace
from benchmark.kinds import sample, train
from benchmark.tests.small import small_cell
from benchmark.yardstick import Event, HostOp

SEED = 2**31 + 4242
CPU = torch.device("cpu")
TRAIN = ["g_fwd_ms_per_step.train", "d_fwd_ms_per_step.train", "d_obj_ms_per_step.train",
         "vgg_fwd_ms_per_step.train", "bwd_ms_per_step.train", "opt_ms_per_step.train",
         "cast_ms_per_step.train"]
SAMPLE = ["dispatch_ms_per_batch.sample", "idle_in_sampler_pct.sample"]
DDP = ["bn_sum_ms_per_step.ddp", "grad_allreduce_ms_per_step.ddp", "collectives_per_step.ddp"]


def _ctx(kind: str, tr, cell, chips: int = 1):
    return cells.trace_ctx(kind, tr, cell.traffic, int(cell.traffic["trace_units"]), 0.0, 1.0,
                           [], cell.config, None, chips=chips)


def _read(names, ctx) -> dict:
    return {n: spec.reader(n)(ctx) for n in names}


@pytest.fixture(scope="module")
def traced_train():
    """Two traced mixed steps of the small COCO train cell: (ctx, metrics)."""
    cell = small_cell("coco128.train_b256", "bf16")
    _, unit, _ = train.program_train(cell, SEED, CPU)
    k0 = int(cell.traffic["check_steps"])
    tr = trace.capture(lambda i: unit(k0 + i), int(cell.traffic["trace_units"]), CPU)
    ctx = _ctx("train", tr, cell)
    return ctx, _read(TRAIN, ctx)


def test_traced_train_steps_report_every_span_metric(traced_train):
    _, got = traced_train
    assert all(v is not None and v > 0 for v in got.values()), got


def test_the_steps_parts_come_to_no_more_than_its_root(traced_train):
    ctx, got = traced_train
    root = program_spans.ms_per_unit(ctx, "train.step")
    parts = sum(v for k, v in got.items() if k != "d_obj_ms_per_step.train")  # inside D's
    assert 0 < parts <= root
    assert got["d_obj_ms_per_step.train"] < got["d_fwd_ms_per_step.train"]


def test_traced_sample_batches_report_every_span_metric():
    cell = small_cell("coco128.sample_b128")
    unit = sample.sampler_unit(cell, SEED, CPU)
    unit(0)
    tr = trace.capture(lambda i: unit(1 + i), int(cell.traffic["trace_units"]), CPU)
    got = _read(SAMPLE, _ctx("sample", tr, cell))
    assert got["dispatch_ms_per_batch.sample"] > 0
    assert 0 <= got["idle_in_sampler_pct.sample"] <= 100


class _DoneAt:
    """A CUDA event the stream reached at ``t`` (seconds on the trace's clock)."""

    def __init__(self, t: float):
        self.t = t

    def elapsed_time(self, other) -> float:
        return 1e3 * (other.t - self.t)


def test_a_spans_busy_time_leaves_out_the_wait_for_its_dispatch(monkeypatch):
    from layout2img_tpu_torch.utils.tracing import Record

    ctx = SimpleNamespace(kind="train", traced_s=1.0, host=[HostOp("loop", 0.9, 1.0)],
                          events=[Event("k", 1.0, 0.2), Event("k", 1.5, 0.3)])
    # the root's start event lags its host start by 50 ms: the anchor must not
    # take it at its word; G's opens on the idle stream (device 1.4 s = host)
    spans = [Record("train.step", {}, int(0.9e9), int(1.7e9), (_DoneAt(0.95), _DoneAt(1.8))),
             Record("train.g_forward", {}, int(1.4e9), int(1.6e9), (_DoneAt(1.4), _DoneAt(1.8)))]
    monkeypatch.setattr(program_spans, "records", lambda ctx: spans)
    placed = [t for interval in program_spans.device_intervals(spans) for t in interval]
    assert placed == pytest.approx([0.95, 1.8, 1.4, 1.8])
    assert spec.reader("g_fwd_ms_per_step.train")(ctx) == pytest.approx(300.0)  # not 400
    assert program_spans.ms_per_unit(ctx, "train.step") == pytest.approx(500.0)  # not 850


def test_idle_in_the_sampler_counts_the_gaps_inside_its_spans(monkeypatch):
    from layout2img_tpu_torch.utils.tracing import Record

    ctx = SimpleNamespace(kind="sample", traced_s=4.0, host=[HostOp("loop", 0.0, 4.0)],
                          events=[Event("k", 0.0, 1.0), Event("k", 2.0, 1.0),
                                  Event("k", 3.5, 0.5)])
    spans = [Record("sample", {}, int(0.9e9), int(2.2e9)),  # holds the gap 1-2 s
             Record("sample", {}, int(3.6e9), int(3.9e9))]  # no gap inside
    monkeypatch.setattr(program_spans, "records", lambda ctx: spans)
    assert spec.reader("idle_in_sampler_pct.sample")(ctx) == pytest.approx(25.0)


def test_data_parallel_readers_read_rank_0s_collectives():
    got = run.run_cell(small_cell("coco128.train_ddp4_b512"), SEED, 0.5, True, CPU)["metrics"]
    values = {n: got[n]["value"] for n in DDP}
    assert all(v > 0 for v in values.values()), values
    assert values["collectives_per_step.ddp"] == int(values["collectives_per_step.ddp"])


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("name", TRAIN + SAMPLE + DDP)
def test_every_reader_reads_none_without_records(monkeypatch, name, missing):
    from layout2img_tpu_torch.utils import tracing

    tracing.clear()
    if missing:  # a program without the tracing module
        monkeypatch.setitem(sys.modules, "layout2img_tpu_torch.utils.tracing", None)
    for kind, chips in (("train", 1), ("train", 4), ("sample", 1)):
        ctx = SimpleNamespace(kind=kind, chips=chips, traced_s=1.0, traced_units=2,
                              host=[HostOp("op", 0.0, 1.0)], events=[Event("k", 0.0, 0.5)])
        assert spec.reader(name)(ctx) is None
