"""The port's spans (``layout2img_tpu_torch/utils/tracing.py``), on the CPU
at a small width (Ours-D G against ``d128_app`` at 64 px, ch 4).

- Off (no profiler, or ``enable(False)`` under one): ``span`` is a shared
  null context, enters no ``record_function`` and records nothing.
- A profiled mixed train step (EMA on, a stand-in VGG loss) records the
  tree of spans: one ``train.step`` root holding every other span, D's
  roles in order, ``d.objects`` inside each D forward; each
  span starts within 1 ms of its own ``record_function`` annotation in the
  profiler's events (one clock); the step's metrics are the bits of the
  same step with tracing off.
- The sampler's span, ``device_prefetch``'s ``data.wait``.
- ``mesh.all_reduce``'s spans per kind on 2 gloo ranks.
- ``torch.export`` and ``torch.compile`` of a module whose forward opens a
  span see no span: no profiler op in the graph, no record.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parallel_ranks as ranks
from layout2img_tpu_torch.data.prefetch import device_prefetch
from layout2img_tpu_torch.sample import make_sample_fn
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils import tracing
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator

NC, O, IMG, CH, B = 10, 6, 64, 4, 2
STEP_SPANS = {  # name -> (attribute, its values in the order the spans open)
    "train.step": (None, [None]),
    "train.cast": ("net", ["g", "d", "d"]),
    "train.g_forward": (None, [None]),
    "train.d_forward": ("role", ["real", "fake", "for_g"]),
    "d.objects": (None, [None] * 3),
    "train.vgg": (None, [None]),
    "train.backward": ("net", ["d", "g"]),
    "train.adam": ("net", ["d", "g"]),
    "train.ema": (None, [None]),
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_ring():
    tracing.clear()
    yield
    tracing.enable(None)
    tracing.clear()


def _step_metrics(profiled: bool):
    """One mixed step from seeded networks: (metrics, records, the profiler's
    annotations as (name, start ns) or None)."""
    gen = init_generator(0, NC, device="cpu", ch=CH, image_size=IMG)
    disc = init_discriminator(1, NC, device="cpu", ch=CH, image_size=IMG)
    cfg = TrainConfig(mixed_precision=True, ema_decay=0.9)
    step = make_train_step(create_train_state(gen, disc, cfg), cfg,
                           vgg_loss=lambda fake, real, dtype=None: (fake - real).abs().mean())
    torch.manual_seed(11)
    tracing.clear()
    if not profiled:
        return step(ranks.global_batch(b=B), torch.Generator().manual_seed(5)), [], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = step(ranks.global_batch(b=B), torch.Generator().manual_seed(5))
    notes = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return metrics, tracing.records(), notes


@pytest.fixture(scope="module")
def steps():
    return {"off": _step_metrics(False), "on": _step_metrics(True)}


class _Counting:
    """``torch.profiler.record_function`` that counts its entries."""

    entered = 0

    def __init__(self, name):
        pass

    def __enter__(self):
        _Counting.entered += 1

    def __exit__(self, *exc):
        pass


@pytest.mark.parametrize("forced, profiled, on", [(None, False, False), (False, True, False),
                                                  (True, False, True), (None, True, True)])
def test_spans_record_only_when_on(monkeypatch, forced, profiled, on):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    tracing.enable(forced)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        s = tracing.span("x", kind="a")
        with s:
            pass
    assert (s is tracing.span("y")) is not on  # off: one shared null context
    assert _Counting.entered == int(on)
    got = [(r.name, r.attrs) for r in tracing.records()]
    assert got == ([("x", {"kind": "a"})] if on else [])
    for r in tracing.records():  # off CUDA a span's device time is its host time
        assert tracing.device_ms(r) == (r.end_ns - r.start_ns) * 1e-6 > 0


def test_metrics_are_the_bits_of_the_untraced_step(steps):
    off, on = steps["off"][0], steps["on"][0]
    assert steps["off"][1] == [] and sorted(off) == sorted(on)
    assert all(torch.equal(off[k], on[k]) for k in off)


@pytest.mark.parametrize("name", sorted(STEP_SPANS))
def test_a_profiled_step_records_the_span_tree(steps, name):
    recs = sorted(steps["on"][1], key=lambda r: r.start_ns)
    assert {r.name for r in recs} == set(STEP_SPANS)
    mine = [r for r in recs if r.name == name]
    attr, values = STEP_SPANS[name]
    assert [r.attrs.get(attr) for r in mine] == values
    for r in mine:  # the innermost span around each: its parent
        around = [p for p in recs if p is not r
                  and p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns]
        parent = min(around, key=lambda p: p.end_ns - p.start_ns) if around else None
        want = {"train.step": None, "d.objects": "train.d_forward"}.get(name, "train.step")
        assert (parent and parent.name) == want


def test_spans_start_at_their_profiler_annotations(steps):
    _, recs, notes = steps["on"]
    for name in STEP_SPANS:
        mine = sorted(r.start_ns for r in recs if r.name == name)
        theirs = sorted(t for n, t in notes if n == name)
        assert len(mine) == len(theirs)
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1e6, name


def test_the_sampler_records_its_span():
    gen = init_generator(0, NC, device="cpu", ch=CH, image_size=IMG)
    batch = ranks.global_batch(b=B)
    tracing.enable(True)
    sample = make_sample_fn(gen)
    for seed in (2, 3):
        sample(batch["boxes"], batch["labels"], torch.Generator().manual_seed(seed))
    assert [r.name for r in tracing.records()] == ["sample", "sample"]


def test_prefetch_records_the_consumers_wait():
    host = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    tracing.enable(True)
    assert len(list(device_prefetch(iter(host), "cpu", size=1))) == 3
    waits = [r for r in tracing.records() if r.name == "data.wait"]
    assert len(waits) == 4  # 3 batches, then the end


def test_all_reduce_spans_per_kind(tmp_path):
    ranks.run_ranks(ranks.tracing_rank, 2, str(tmp_path), timeout=120)
    got = [json.loads((tmp_path / f"{r}.json").read_text()) for r in (0, 1)]
    assert got[0] == got[1]
    assert set(got[0]) == {"grads", "bn_sum", "metrics", "other"}
    assert got[0]["grads"] == 2 and got[0]["metrics"] == 1  # one buffer a network
    assert got[0]["bn_sum"] >= 2 and got[0]["bn_sum"] % 2 == 0  # forward, backward


class _Spanned(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x):
        with tracing.span("probe", kind="a"):
            return self.lin(x).relu()


def _traced_graph(how: str) -> str:
    """The graph that ``how`` (export, compile) traces from ``_Spanned``."""
    module, x = _Spanned(), torch.randn(2, 4)
    if how == "export":
        return str(torch.export.export(module, (x,)).graph)
    graphs = []

    def backend(gm, inputs):
        graphs.append(str(gm.graph))
        return gm.forward

    torch._dynamo.reset()
    torch.compile(module, backend=backend, fullgraph=True)(x)
    return graphs[0]


@pytest.mark.parametrize("how", ["export", "compile"])
def test_export_and_compile_see_no_span(how):
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]):
        graph = _traced_graph(how)
    assert "profiler" not in graph and "record_function" not in graph
    assert tracing.records() == []
    tracing.enable(None)
    assert _traced_graph(how) == graph
