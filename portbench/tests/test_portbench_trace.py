"""Reading a profiler trace: unions, the window, idle gaps and
the B1 roofline reader, on made-up events and on a CPU profile."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import arith, core, trace
from portbench.core import MetricContext, Request, Window

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, s, t, dev=CPU, shapes=(), scalars=(), dtypes=(), dev_us=0.0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=s, end=t),
        device_type=dev, input_shapes=list(shapes),
        concrete_inputs=list(scalars), input_dtypes=list(dtypes),
        device_time_total=dev_us, is_user_annotation=False)


def test_union_seconds():
    assert trace.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert trace.union_seconds([]) == 0


def events():
    # a 1 s window (microseconds); two kernels, a span with a child span
    return [
        ev(trace.WINDOW, 0, 1_000_000),
        ev("daggregate.device_key_ids", 100_000, 500_000),
        ev("executor.convert", 200_000, 300_000),
        ev("tft::segment_sum", 600_000, 610_000,
           shapes=[[1_000_000, 1], [1_000_000], []],
           scalars=[None, None, 1000], dtypes=["double", "int", "int"],
           dev_us=200.0),
        ev("segment_kernel", 600_500, 600_700, dev=CUDA),
        ev("Memcpy HtoD", 900_000, 950_000, dev=CUDA),
        ev("outside", 2_000_000, 3_000_000, dev=CUDA),
    ]


def test_view():
    v = trace.TraceView(events(), op_names=["tft::segment_sum"])
    assert v.window_s == pytest.approx(1.0)
    assert v.busy_s() == pytest.approx(0.0502)
    assert v.span_seconds(["daggregate.device_key_ids"]) == pytest.approx(0.4)
    (call,) = v.op_calls("tft::segment_sum")
    assert call.device_s == pytest.approx(2e-4)
    assert [n for n, _ in v.device_ops()] == ["Memcpy HtoD", "segment_kernel"]
    gaps = dict(v.idle_gaps())
    assert gaps["daggregate.device_key_ids"] == pytest.approx(0.6005, abs=1e-3)
    assert sum(gaps.values()) == pytest.approx(1.0 - 0.0502)


def ctx(view, cfg=None, images=None):
    w = Window(0.0, 1.0, [Request(0.0, 1.0, {"images": images or 0})])
    return MetricContext({}, cfg or {"precision": "float64"}, w, 1.0, view)


def test_keyed_sum_roofline_reader():
    view = trace.TraceView(events(), op_names=["tft::segment_sum"])
    got = core.load_metric("keyed_sum_roofline").read(ctx(view))
    want = 100 * arith.segment_sum_bytes(1_000_000, 1, 1000, 8) \
        / arith.HBM_BYTES_PER_S / 2e-4
    assert got == pytest.approx(want)


def test_share_readers():
    view = trace.TraceView(events(), op_names=["tft::segment_sum"])
    c = ctx(view)
    assert core.load_metric("idle_share.analytics").read(c) == \
        pytest.approx(100 * (1 - 0.0502))
    for name in ("convert_share.inference", "convert_share.inference.b32"):
        assert core.load_metric(name).read(c) == pytest.approx(10)
    assert core.load_metric("idle_share.inference.b32").read(c) == \
        pytest.approx(100 * (1 - 0.0502))
    assert core.load_metric("dop_wall_ms").read(c) == pytest.approx(400)


def test_readers_find_nothing_on_a_trace_without_them():
    view = trace.TraceView([ev(trace.WINDOW, 0, 1000)])
    c = ctx(view)
    for name in ("keyed_sum_roofline", "idle_share.analytics",
                 "convert_share.inference", "idle_share.inference.b32",
                 "dop_wall_ms"):
        assert core.load_metric(name).read(c) is None, name


def test_mfu_reader():
    cfg = {"stages": [[3, 64], [4, 128], [6, 256], [3, 512]],
           "expansion": 4, "stem_width": 64, "channels": 3,
           "image_size": 224, "num_classes": 1000}
    for name in ("mfu.resnet50", "mfu.resnet50.b32"):
        got = core.load_metric(name).read(ctx(None, cfg, images=1000))
        assert got == pytest.approx(100 * 1000 * arith.resnet_flops(cfg)
                                    / 67e12)


def test_window_range_of_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        with record_function(trace.WINDOW):
            with record_function("executor.convert"):
                torch.ones(1000).sum()
    v = trace.TraceView(p.events())
    assert 0 < v.span_seconds(["executor.convert"]) <= v.window_s
    assert v.busy_s() == 0
