"""The port's spans where a traced run's host and device time sit:
``daggregate.keyed_sum`` (every shard's table of a mesh aggregate),
``computation.capture`` (a new program's probes), ``executor.stage_out``
(opened only for a card's outputs; its case is in
``tests/test_torch_cuda.py``), the shared null span while tracing is off,
and a traced mesh dispatch that never waits for the card's shard events.
CPU only."""

from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tensorframes_tpu_torch as ttf
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch.observability import events
from tensorframes_tpu_torch.parallel import distributed, elastic
from tensorframes_tpu_torch.utils import tracing

NEW_SPANS = ("daggregate.keyed_sum", "computation.capture")


@pytest.fixture(autouse=True)
def _cpu_and_clean_timings():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    tracing.timings.reset()
    yield
    tracing.disable()
    tracing.timings.reset()
    ttf.set_default_device(prev)


def _dist(rows=1000):
    rng = np.random.default_rng(25)
    df = ttf.frame({"k": rng.integers(0, 4, rows), "x": rng.random(rows),
                    "n": np.ones(rows, np.int64)}, num_partitions=2)
    return tpar.distribute(df, tpar.local_mesh(1))


def _aggregate(dist):
    out = tpar.daggregate({"x": "sum", "n": "sum"}, dist, "k", max_groups=8)
    return out.blocks()[0].columns


def _run_queries():
    """One keyed aggregate and two maps, each with a new lambda."""
    df = ttf.frame({"x": np.arange(16.0)})
    _aggregate(_dist())
    for _ in range(2):
        ttf.map_blocks(lambda x: {"z": x + 1}, df).blocks()


def _within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_keyed_sum_span_holds_the_tables_inside_the_dispatch():
    dist = _dist()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cols = _aggregate(dist)
    tracing.disable()
    assert int(np.sum(cols["n"])) == 1000
    evs = prof.events()
    (dispatch,) = [e for e in evs if e.name == "daggregate.dispatch"]
    (keyed,) = [e for e in evs if e.name == "daggregate.keyed_sum"]
    assert _within(keyed, dispatch)
    # the integer count's plain sum runs under the span
    adds = [e for e in evs if e.name == "aten::index_add_"]
    assert adds and any(_within(a, keyed) for a in adds)


@pytest.mark.parametrize("same_lambda,captures", [(False, 2), (True, 1)])
def test_capture_span_opens_once_per_new_program(same_lambda, captures):
    df = ttf.frame({"x": np.arange(16.0)})
    shared = lambda x: {"z": x * 3}  # noqa: E731
    tracing.enable()
    for _ in range(2):
        fn = shared if same_lambda else (lambda x: {"z": x * 3})
        out = ttf.map_blocks(fn, df).blocks()[0].columns["z"]
        np.testing.assert_array_equal(np.asarray(out), np.arange(16.0) * 3)
    got = tracing.timings.snapshot()["computation.capture"]
    assert got["count"] == captures and got["total_s"] > 0


def test_snapshot_holds_the_new_spans_and_none_on_the_cpu_stage_out():
    tracing.enable()
    _run_queries()
    snap = tracing.timings.snapshot()
    for name in NEW_SPANS:
        assert snap[name]["count"] >= 1, name
    # outputs that never left the host are not staged
    assert "executor.stage_out" not in snap


def test_no_new_span_is_recorded_with_tracing_off():
    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_queries()
    assert tracing.timings.snapshot() == {}
    names = {e.name for e in prof.events()}
    assert not names & set(NEW_SPANS + ("executor.stage_out",))


def test_off_span_is_one_shared_null_context():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        pass
    tracing.enable()
    assert tracing.span("a") is not tracing.span("a")
    with tracing.span("a"):
        pass
    assert tracing.timings.snapshot()["a"]["count"] == 1


# -- the card's shard clock, driven with fakes --------------------------------

class _Card:
    type = "cuda"


class _FakeEvent:
    """A ``torch.cuda.Event`` stand-in: records a tick, reports done once
    the test says so, and counts host waits."""

    done = False
    syncs = 0
    ticks = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _FakeEvent.ticks += 1
        self.t = float(_FakeEvent.ticks)

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        _FakeEvent.syncs += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _Mesh:
    is_cluster = False

    def __init__(self, devices):
        self._devices = devices

    def local_shard_devices(self):
        return self._devices


@pytest.fixture
def fake_card(monkeypatch):
    _FakeEvent.done, _FakeEvent.syncs, _FakeEvent.ticks = False, 0, 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    monkeypatch.setattr(distributed, "_pending", deque(maxlen=256))
    noted = []
    monkeypatch.setattr(elastic, "note_dispatch",
                        lambda m, op, times: noted.append((op, list(times))))
    cards = [_Card(), _Card()]
    return _Mesh([cards[0], cards[0], cards[1]]), noted


def _dispatch(mesh, trace, op):
    clock = distributed._ShardClock(trace, mesh)
    assert clock.cuda
    for _ in range(3):
        clock.mark()
    distributed._trace_done(trace, op, clock, mesh)


def test_traced_card_dispatch_never_waits_and_times_appear_once_done(
        fake_card):
    mesh, noted = fake_card
    trace = events.QueryTrace("dmap_blocks")
    _dispatch(mesh, trace, "dmap_blocks")
    assert _FakeEvent.syncs == 0
    assert trace.count("mesh_dispatch") == 1
    assert trace.count("shard_compute") == 0 and noted == []
    _FakeEvent.done = True
    s = trace.summary()
    assert _FakeEvent.syncs == 0
    comp = [ev for ev in trace.events if ev.etype == "shard_compute"]
    # starts tick 1 (card 0) and 2 (card 1); marks 3, 4 on card 0, 5 on 1
    assert [ev.dur for ev in comp] == [2.0, 2.0, 3.0]
    assert [ev.args["device"] for ev in comp] == [0, 1, 2]
    assert noted == [("dmap_blocks", [2.0, 2.0, 3.0])]
    assert s["mesh"]["devices"][2]["time_s"] == 3.0
    trace.summary()
    assert len(noted) == 1  # recorded once


def test_pending_shard_times_settle_at_the_next_traced_dispatch(fake_card):
    mesh, noted = fake_card
    first = events.QueryTrace("dmap_blocks")
    _dispatch(mesh, first, "dmap_blocks")
    first.settle()  # the query ends before its shards do
    assert not [ev for ev in first.events if ev.etype == "shard_compute"]
    _FakeEvent.done = True
    second = events.QueryTrace("daggregate")
    _dispatch(mesh, second, "daggregate")
    assert [op for op, _ in noted] == ["dmap_blocks", "daggregate"]
    assert len([ev for ev in first.events
                if ev.etype == "shard_compute"]) == 3
    assert not distributed._pending
    assert _FakeEvent.syncs == 0
