"""The yardstick's arithmetic on synthetic traces."""

from types import SimpleNamespace

import pytest

from benchmark import check, spec, yardstick
from benchmark.yardstick import Event, HostOp


def _trace():
    # two steps of a device: kernels 0-1, 0.5-2 (overlap), 3-4; a memcpy 5-5.5
    return [Event("void cudnn::xmma_fprop(...)", 0.0, 1.0),
            Event("cutlass_80_tensorop_bf16_gemm", 0.5, 1.5),
            Event("isla_norm_kernel(Params)", 3.0, 0.5),
            Event("isla_norm_bwd_kernel(Params)", 3.5, 0.25),
            Event("isla_norm_bwd_finish_kernel(FinishParams)", 3.75, 0.25),
            Event("void at::native::elementwise_kernel<...>", 4.0, 0.0),
            Event("Memcpy DtoH (Device -> Pageable)", 5.0, 0.5, kernel=False)]


def test_kernel_classes_first_match_wins():
    assert yardstick.kernel_class("void cudnn::xmma_fprop(...)") == "convolutions (cuDNN)"
    assert yardstick.kernel_class("isla_norm_kernel") == "ISLA"
    assert yardstick.kernel_class("nchwToNhwcKernel") == "cuDNN layout transposes"
    assert yardstick.kernel_class("mystery") == "other"
    sums = yardstick.class_seconds(_trace())
    assert sums == pytest.approx({"convolutions (cuDNN)": 1.0, "GEMMs (cuBLAS)": 1.5, "ISLA": 1.0,
                                  "elementwise and copies": 0.0})


def test_busy_time_is_the_union_of_intervals():
    assert yardstick.busy_intervals(_trace()) == [(0.0, 2.0), (3.0, 4.0), (5.0, 5.5)]
    assert yardstick.busy_seconds(_trace()) == pytest.approx(3.5)


def test_idle_gaps_are_named_by_the_innermost_host_op():
    host = [HostOp("step", 0.0, 6.0), HostOp("cudaStreamSynchronize", 2.1, 0.8),
            HostOp("python: pool", 4.2, 0.1)]
    gaps = yardstick.idle_gaps(_trace(), host, 0.0, 6.0)
    assert gaps == [("cudaStreamSynchronize", pytest.approx(1.0)), ("step", pytest.approx(1.0)),
                    ("step", pytest.approx(0.5))]


def test_isla_bytes_count_each_tensor_once():
    x, m = (2, 4, 8, 8), (2, 3, 16, 16)
    numel, mask, gb = 2 * 4 * 64, 2 * 3 * 256, 2 * 3 * 4
    assert yardstick.isla_forward_bytes(x, m, 2) == 2 * (2 * numel + mask + 2 * gb) + 8 * 4
    assert yardstick.isla_backward_bytes(x, m, 4) == 4 * (3 * numel + 2 * mask + 4 * gb) + 16 * 4


def test_a_share_over_100_percent_raises():
    assert yardstick.share_pct(1.0, 4.0) == 25.0
    with pytest.raises(yardstick.ShareError):
        yardstick.share_pct(1.0, 0.99)
    with pytest.raises(yardstick.ShareError):
        yardstick.share_pct(1.0, 0.0)


def _ctx(**kw):
    base = dict(kind="train", events=_trace(), host=[], traced_s=8.0, traced_units=2,
                rest_units=10, rest_s=10.0, flops_per_unit=100e12, itemsize=2,
                latencies=[0.05 + 0.001 * i for i in range(40)],
                isla_calls=[((128, 64, 128, 128), (128, 8, 64, 64))], peak_window_bytes=2**31,
                chips=1)
    return SimpleNamespace(**{**base, **kw})


def test_readers():
    ctx = _ctx()
    assert spec.reader("launches_per_step.train")(ctx) == 3.0
    assert spec.reader("conv_ms_per_step.train")(ctx) == pytest.approx(500.0)  # 1 s over 2 steps
    assert spec.reader("transpose_ms_per_step.train")(ctx) is None
    assert spec.reader("device_idle_pct.train")(ctx) == pytest.approx(100 * (1 - 3.5 / 8))
    assert spec.reader("peak_mem_gib.train")(ctx) == 2.0
    assert spec.reader("launches_per_batch.sample")(ctx) is None
    # nearest rank: the 38th of 40
    assert spec.reader("sample_batch_ms_p95")(_ctx(kind="sample")) == pytest.approx(87.0)
    # 100 TFLOP a step, 10 steps in 10 s: 100 TFLOP/s of 989
    assert spec.reader("mfu.train")(ctx) == pytest.approx(100 * 100e12 / 989e12)
    nbytes = yardstick.isla_forward_bytes((128, 64, 128, 128), (128, 8, 64, 64), 2)
    want = 100 * (nbytes / 3.35e12) / (0.5 / 2)
    assert spec.reader("isla_fwd_roofline.train")(ctx) == pytest.approx(want)
    nbytes = yardstick.isla_backward_bytes((128, 64, 128, 128), (128, 8, 64, 64), 2)
    assert spec.reader("isla_bwd_roofline.train")(ctx) == pytest.approx(
        100 * (nbytes / 3.35e12) / (0.5 / 2))


def test_data_parallel_readers():
    nccl = [Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)", 5.0, 0.25),
            Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)", 6.0, 0.15)]
    ctx = _ctx(events=_trace() + nccl, chips=4, flops_per_unit=4 * 100e12)
    assert spec.reader("nccl_ms_per_step.train")(ctx) == pytest.approx(200.0)  # 0.4 s, 2 steps
    # every rank's FLOPs against every chip's peak: each rank's share
    assert spec.reader("mfu.train")(ctx) == pytest.approx(100 * 100e12 / 989e12)
    assert spec.reader("mfu.ddp")(ctx) == spec.reader("mfu.train")(ctx)
    # the first NCCL kernel lies inside the memcpy at 5-5.5: the union grows by 0.15 s
    assert spec.reader("device_idle_pct.ddp")(ctx) == pytest.approx(100 * (1 - 3.65 / 8))
    for name in ("nccl_ms_per_step.train", "mfu.ddp", "device_idle_pct.ddp"):
        assert spec.reader(name)(_ctx(events=_trace() + nccl)) is None, name
    assert spec.reader("nccl_ms_per_step.train")(_ctx(chips=4)) is None


def test_readers_find_nothing_and_return_nothing():
    ctx = _ctx(events=[], rest_units=0)
    for name in ("launches_per_step.train", "conv_ms_per_step.train", "isla_fwd_roofline.train",
                 "isla_bwd_roofline.train", "device_idle_pct.train", "mfu.train"):
        assert spec.reader(name)(ctx) is None, name


def test_an_mfu_over_100_percent_raises():
    with pytest.raises(yardstick.ShareError):
        spec.reader("mfu.train")(_ctx(flops_per_unit=1000e12))


def test_flops_per_step_and_batch_are_counted_from_the_reference():
    from benchmark import flops
    from benchmark.tests.small import small_cell

    cell = small_cell("coco128.train_b256")
    step, calls = flops.train_work(cell.config)
    batch, calls_s = flops.sample_work(cell.config)
    assert len(calls) == len(calls_s) == 10  # two ISLA norms in each of 5 blocks
    assert calls[0] == ((2, 128, 4, 4), (2, 4, 64, 64))
    # a step: G forward + backward, three D forwards, VGG: many times G's forward
    assert 3 * batch < step < 100 * batch
    doubled, _ = flops.train_work({**cell.config, "batch": 4})
    assert doubled == pytest.approx(2 * step, rel=0.01)


def test_grad_gap_d_reads_the_discriminator_alone():
    """A gate-sized gap on G's parameters moves ``grad_gap`` and leaves
    ``grad_gap_d`` at D's own gaps."""
    ref = {"losses": [[1.0, 1.0]],
           "grad": {**{f"G.p{i}": 1.0 for i in range(20)}, **{f"D.p{i}": 1.0 for i in range(20)}}}
    ref["delta"] = dict(ref["grad"])
    side = {"losses": [[1.0, 1.0]], "delta": dict(ref["delta"]),
            "grad": {**{f"G.p{i}": 1.5 for i in range(20)}, **{f"D.p{i}": 1.01 for i in range(20)}}}
    numbers = check.train_numbers(side, ref)
    assert numbers["grad_gap"] == pytest.approx(0.5)
    assert numbers["grad_gap_d"] == pytest.approx(0.01)


def test_an_optional_number_is_judged_only_where_the_limits_name_it():
    numbers = {"grad_gap": 0.01, "grad_gap_d": 0.5}
    ok, lines = check.judge(numbers, {"grad_gap": 0.02})
    assert ok and len(lines) == 1, lines
    assert not check.judge(numbers, {"grad_gap": 0.02, "grad_gap_d": 0.1})[0]
    # any other number without a limit still fails
    assert not check.judge({**numbers, "update_gap": 0.0}, {"grad_gap": 0.02})[0]
