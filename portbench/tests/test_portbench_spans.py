"""The readers of the port's spans ``daggregate.keyed_sum``,
``computation.capture`` and ``executor.stage_out`` on made-up events: what
they read, ``None`` where nothing was recorded, and the division by the
queries completed in the window."""

import pytest

from portbench import core, trace
from portbench.core import MetricContext, Request, Window
from portbench.tests.test_portbench_trace import CUDA, ev

STAGE_OUT = ("stage_out_share.inference", "stage_out_share.inference.b32")


def events():
    # a 1 s window (microseconds): two keyed sums with their kernels, two
    # captures that overlap, two stagings, and a keyed sum past the window
    return [
        ev(trace.WINDOW, 0, 1_000_000),
        ev("daggregate.keyed_sum", 100_000, 200_000, dev_us=30_000.0),
        ev("daggregate.keyed_sum", 500_000, 600_000, dev_us=10_000.0),
        ev("daggregate.keyed_sum", 1_200_000, 1_300_000, dev_us=99_000.0),
        ev("index_kernel", 110_000, 140_000, dev=CUDA),
        ev("computation.capture", 300_000, 320_000),
        ev("computation.capture", 310_000, 340_000),
        ev("executor.stage_out", 700_000, 750_000),
        ev("executor.stage_out", 800_000, 850_000),
    ]


def ctx(view, queries):
    reqs = [Request(0.0, 0.5, {"rows": 1.0}) for _ in range(queries)]
    reqs.append(Request(0.0, 0.5, {"rows": 1.0}, failed=True))
    return MetricContext({}, {"precision": "float64"},
                         Window(0.0, 1.0, reqs), 1.0, view)


def view(evs=None):
    return trace.TraceView(evs or events(),
                           op_names=core.load_metric("keyed_sum_ms").OPS)


@pytest.mark.parametrize("queries", [1, 4])
def test_keyed_sum_ms_is_the_kernels_under_the_span_a_query(queries):
    got = core.load_metric("keyed_sum_ms").read(ctx(view(), queries))
    assert got == pytest.approx(40.0 / queries)


@pytest.mark.parametrize("queries", [1, 4])
def test_capture_ms_is_the_union_of_captures_a_query(queries):
    got = core.load_metric("capture_ms").read(ctx(view(), queries))
    assert got == pytest.approx(40.0 / queries)


@pytest.mark.parametrize("name", STAGE_OUT)
def test_stage_out_share_is_the_window_share_of_the_span(name):
    assert core.load_metric(name).read(ctx(view(), 3)) == pytest.approx(10)


@pytest.mark.parametrize("name", ("keyed_sum_ms", "capture_ms") + STAGE_OUT)
def test_span_readers_read_nothing_where_no_span_was_recorded(name):
    bare = view([ev(trace.WINDOW, 0, 1_000_000),
                 ev("daggregate.dispatch", 0, 500_000)])
    assert core.load_metric(name).read(ctx(bare, 2)) is None
    assert core.load_metric(name).read(ctx(None, 2)) is None


@pytest.mark.parametrize("name", ("keyed_sum_ms", "capture_ms"))
def test_per_query_readers_read_nothing_without_a_completed_query(name):
    assert core.load_metric(name).read(ctx(view(), 0)) is None


def test_keyed_sum_ms_reads_nothing_where_no_kernel_ran_under_the_span():
    # a CPU run: the span is there, the device time is not
    cpu = view([ev(trace.WINDOW, 0, 1_000_000),
                ev("daggregate.keyed_sum", 100_000, 200_000)])
    assert core.load_metric("keyed_sum_ms").read(ctx(cpu, 2)) is None
