"""The durable query history and crash post-mortems of the port, held
against the JAX package (``tests/test_history.py``).

Each case runs the same calls through both packages' ``history`` modules,
each in a directory of its own, and compares what they return; the
framing cases also have each package read the other's segments. The
restart drill SIGKILLs a child interpreter that serves queries through
the port's scheduler on the CPU, then reads its archive back in this
process through both packages.
"""

import json
import os
import signal
import struct
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from conftest import timing_margin
from tensorframes_tpu.observability import decisions as jdecisions
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.observability import history as jhist
from tensorframes_tpu.observability import metrics as jmetrics
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu_torch.observability import decisions as tdecisions
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.observability import history as thist
from tensorframes_tpu_torch.observability import metrics as tmetrics
from tensorframes_tpu_torch.resilience import faults as tfaults
from tensorframes_tpu_torch.utils.tracing import counters as tcounters

J = types.SimpleNamespace(name="jax", top=jtf, hist=jhist, flight=jflight,
                          faults=jfaults, decisions=jdecisions,
                          health=jtf.health, metrics=jmetrics,
                          doctor_name="tft.postmortem()")
T = types.SimpleNamespace(name="torch", top=ttf, hist=thist,
                          flight=tflight, faults=tfaults,
                          decisions=tdecisions, health=ttf.health,
                          metrics=tmetrics, doctor_name="ttf.postmortem()")
BOTH = [J, T]
IDS = ["jax", "torch"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("TFT_HISTORY", "TFT_HISTORY_MAX_BYTES",
                "TFT_HISTORY_RETENTION", "TFT_HISTORY_DECISIONS",
                "TFT_FLIGHT", "TFT_FLIGHT_DUMP", "TFT_FLIGHT_DUMP_KEEP",
                "TFT_SLOW_QUERY_MS", "TFT_PERSIST_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TFT_HISTORY_DIR", str(tmp_path / "hist"))
    ttf.set_default_device("cpu")
    for p in BOTH:
        p.faults.reset()
        p.flight.clear()
        p.hist.clear()
    yield
    for p in BOTH:
        p.faults.reset()
        p.flight.clear()
        p.hist.clear()


def _in_dir(monkeypatch, tmp_path, p):
    """Point TFT_HISTORY_DIR at a directory of ``p``'s own."""
    d = str(tmp_path / f"hist-{p.name}")
    monkeypatch.setenv("TFT_HISTORY_DIR", d)
    p.hist.clear()
    return d


def _seg_paths(p):
    d = p.hist.active_dir()
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.startswith("seg-") and n.endswith(".hist"))


def _strip_ts(recs):
    return [{k: v for k, v in r.items() if k not in ("ts", "ts_first")}
            for r in recs]


def _both(monkeypatch, tmp_path, fn):
    """``fn(p)`` in each package's own directory; returns the results."""
    out = []
    for p in BOTH:
        _in_dir(monkeypatch, tmp_path, p)
        out.append(fn(p))
    return out


# ---------------------------------------------------------------------------
# framing, and each package reading the other's segments
# ---------------------------------------------------------------------------

class TestFraming:
    def test_round_trip_preserves_the_record(self, monkeypatch, tmp_path):
        def run(p):
            assert p.hist.record_finish(
                "q-rt", tenant="acme", fingerprint="fp-abc123",
                outcome="completed", worker="w0",
                cost={"compute_s": 0.5, "bytes_out": 1024},
                queued_s=0.01, run_s=0.5, total_s=0.51,
                est_rows=100, est_bytes=800, source="serve",
                summary="round trip")
            return p.top.history()

        j, t = _both(monkeypatch, tmp_path, run)
        assert len(t) == 1 and t[0]["cost"] == {"compute_s": 0.5,
                                                "bytes_out": 1024}
        assert t[0]["total_s"] == pytest.approx(0.51)
        assert _strip_ts(t) == _strip_ts(j)

    @pytest.mark.parametrize("writer,reader", [(T, J), (J, T)],
                             ids=["torch-writes", "jax-writes"])
    def test_each_package_reads_the_others_segments(self, writer, reader):
        decs = [{"kind": "serve.start", "ts": 1.0, "seq": 1,
                 "query": "q-x", "tenant": "t"},
                {"kind": "serve.finish", "ts": 2.0, "seq": 2,
                 "query": "q-x", "outcome": "completed"}]
        for i in range(3):
            writer.hist.record_finish(
                f"q-x{i}", tenant="t", fingerprint=f"fp{i}",
                outcome="completed", cost={"latency_s": 0.1 * i},
                run_s=0.1 * i, total_s=0.2 * i, decisions=decs)
        written = writer.hist.history()
        reader.hist.clear()
        assert reader.hist.history() == written
        assert len(written) == 3

    def test_on_disk_frame_is_magic_length_sha(self):
        import hashlib
        thist.record_finish("q-frame", outcome="ok")
        (path,) = _seg_paths(T)
        with open(path, "rb") as f:
            data = f.read()
        assert data.startswith(b"TFTH\x01")
        (plen,) = struct.unpack(">I", data[5:9])
        digest, payload = data[9:41], data[41:41 + plen]
        assert len(payload) == plen and not data[41 + plen:]
        assert hashlib.sha256(payload).digest() == digest
        assert json.loads(payload)["query"] == "q-frame"

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_bypass_env_records_nothing(self, monkeypatch, p):
        monkeypatch.setenv("TFT_HISTORY", "0")
        assert p.hist.record_finish("q-off", outcome="ok") is False
        monkeypatch.delenv("TFT_HISTORY")
        assert p.top.history() == []

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_no_dir_no_persist_is_off(self, monkeypatch, p):
        monkeypatch.delenv("TFT_HISTORY_DIR")
        p.hist.clear()
        assert p.hist.active_dir() is None
        assert p.hist.record_finish("q-nodir", outcome="ok") is False
        assert p.hist.stats()["enabled"] is False

    def test_persist_root_supplies_the_dir(self, monkeypatch, tmp_path):
        monkeypatch.delenv("TFT_HISTORY_DIR")
        monkeypatch.setenv("TFT_PERSIST_DIR", str(tmp_path / "persist"))
        from tensorframes_tpu.memory import persist as jpersist
        from tensorframes_tpu_torch.memory import persist as tpersist
        got = [os.path.relpath(p.hist.active_dir(), tmp_path)
               for p in BOTH]
        assert jpersist.root() == tpersist.root()
        assert got[0] == got[1] == os.path.join("persist", "history")

    def test_decision_digest_is_bounded(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TFT_HISTORY_DECISIONS", "2")
        decs = [{"kind": f"serve.k{i % 3}", "ts": float(i), "seq": i}
                for i in range(5)]

        def run(p):
            p.hist.record_finish("q-digest", outcome="ok", decisions=decs)
            return p.top.history()

        j, t = _both(monkeypatch, tmp_path, run)
        (r,) = t
        assert len(r["decisions"]) == 2 and r["decisions"][-1]["seq"] == 4
        assert sum(r["decision_kinds"].values()) == 5
        assert r["decisions_dropped"] == 3
        assert _strip_ts(t) == _strip_ts(j)


# ---------------------------------------------------------------------------
# rotation and retention
# ---------------------------------------------------------------------------

class TestRotationRetention:
    def test_rotation_at_max_bytes(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TFT_HISTORY_MAX_BYTES", "1")

        def run(p):
            for i in range(4):
                p.hist.record_finish(f"q-rot{i}", outcome="ok")
            return len(_seg_paths(p)), [r["query"]
                                        for r in p.top.history()]

        j, t = _both(monkeypatch, tmp_path, run)
        assert t == j == (4, [f"q-rot{i}" for i in range(4)])

    def test_retention_evicts_oldest(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TFT_HISTORY_MAX_BYTES", "1")
        monkeypatch.setenv("TFT_HISTORY_RETENTION", "3")

        def run(p):
            ev0 = p.hist.stats()["evictions"]
            for i in range(8):
                p.hist.record_finish(f"q-ret{i}", outcome="ok")
            return (len(_seg_paths(p)), p.hist.stats()["evictions"] - ev0,
                    [r["query"] for r in p.top.history()])

        j, t = _both(monkeypatch, tmp_path, run)
        assert t == j
        assert t[0] <= 3 and t[1] >= 5 and "q-ret7" in t[2]


# ---------------------------------------------------------------------------
# cold, never wrong
# ---------------------------------------------------------------------------

def _two_segments(monkeypatch, p):
    monkeypatch.setenv("TFT_HISTORY_MAX_BYTES", "1")
    p.hist.record_finish("q-old", outcome="ok")
    p.hist.record_finish("q-new", outcome="ok")
    paths = _seg_paths(p)
    assert len(paths) == 2
    return paths


class TestColdNeverWrong:
    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_bit_rot_sends_segment_cold_earlier_readable(
            self, monkeypatch, p):
        _, new_seg = _two_segments(monkeypatch, p)
        c0 = p.hist.stats()["corrupt_segments"]
        with open(new_seg, "rb") as f:
            data = bytearray(f.read())
        data[-1] ^= 0x01
        with open(new_seg, "wb") as f:
            f.write(bytes(data))
        assert [r["query"] for r in p.top.history()] == ["q-old"]
        assert p.hist.stats()["corrupt_segments"] - c0 == 1
        assert not os.path.exists(new_seg)
        recs = p.flight.recent(kind="history.segment_corrupt")
        assert recs and "sha256" in recs[-1]["why"]

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_kill_mid_append_prior_segments_readable(self, monkeypatch, p):
        old_seg, new_seg = _two_segments(monkeypatch, p)
        with open(old_seg, "rb") as f:
            frame = f.read()
        with open(new_seg, "ab") as f:
            f.write(frame[:len(frame) // 2])  # a torn half-record
        assert [r["query"] for r in p.top.history()] == ["q-old"]
        assert not os.path.exists(new_seg)

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_garbage_header_cold(self, monkeypatch, p):
        _, new_seg = _two_segments(monkeypatch, p)
        with open(new_seg, "wb") as f:
            f.write(b"not a framed segment")
        assert [r["query"] for r in p.top.history()] == ["q-old"]

    def test_disk_fault_corruption_mode(self):
        thist.record_finish("q-chaos", outcome="ok")
        c0 = thist.stats()["corrupt_segments"]
        with tfaults.inject("disk", message="injected corrupt segment"):
            assert ttf.history() == []
        assert thist.stats()["corrupt_segments"] - c0 == 1
        assert _seg_paths(T) == []
        assert tcounters.get("history.segments_corrupt") >= 1

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_write_failure_degrades_never_raises(self, monkeypatch, p):
        monkeypatch.setenv("TFT_HISTORY_DIR", "/proc/nonexistent/hist")
        p.hist.clear()
        e0 = p.hist.stats()["write_errors"]
        assert p.hist.record_finish("q-nowrite", outcome="ok") is False
        assert p.hist.stats()["write_errors"] - e0 in (0, 1)


# ---------------------------------------------------------------------------
# stitching and filters
# ---------------------------------------------------------------------------

class TestStitchingAndFilters:
    def test_migrated_query_reads_as_one_record(self, monkeypatch,
                                                tmp_path):
        def run(p):
            p.hist.record_finish("q-mig", tenant="t", outcome="migrated",
                                 worker="w0", source="fabric")
            p.hist.record_finish("q-mig", tenant="t",
                                 outcome="completed", worker="w1",
                                 total_s=1.5)
            return p.top.history()

        j, t = _both(monkeypatch, tmp_path, run)
        (r,) = t
        assert r["outcome"] == "completed" and r["migrations"] == 1
        assert r["workers"] == ["w0", "w1"]
        assert _strip_ts(t) == _strip_ts(j)

    def test_filters(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "1000")

        def run(p):
            p.hist.record_finish("q-a", tenant="a", fingerprint="fp-aaa",
                                 outcome="completed", total_s=0.1)
            p.hist.record_finish("q-b", tenant="b", fingerprint="fp-bbb",
                                 outcome="failed", total_s=2.0)
            h = p.top.history
            last = max(r["ts"] for r in h())
            return ([r["query"] for r in h(tenant="a")],
                    [r["query"] for r in h(fingerprint="fp-b")],
                    [r["query"] for r in h(outcome="failed")],
                    [r["query"] for r in h(slow_only=True)],
                    [r["query"] for r in h(since=last)],
                    len(h(limit=1)))

        j, t = _both(monkeypatch, tmp_path, run)
        assert t == j == (["q-a"], ["q-b"], ["q-b"], ["q-b"], ["q-b"], 1)


# ---------------------------------------------------------------------------
# the scheduler's fold point
# ---------------------------------------------------------------------------

class TestServeFold:
    def test_completed_queries_archive_with_cost_and_decisions(self):
        keys = {}
        for p, serve in ((J, jtf.serve), (T, ttf.serve)):
            with serve.QueryScheduler(
                    quotas={"t": serve.TenantQuota()}, workers=1,
                    name="histserve") as s:
                fr = p.top.frame({"x": np.arange(16.0)}, num_partitions=2)
                futs = [s.submit(fr, lambda x: {"z": x + 1.0}, tenant="t")
                        for _ in range(3)]
                for f in futs:
                    f.result(timeout=timing_margin(30))
            recs = p.top.history(outcome="completed")
            assert len(recs) == 3
            for r in recs:
                assert r["tenant"] == "t" and r["source"] == "serve"
                assert "serve.finish" in r.get("decision_kinds", {})
            keys[p.name] = (sorted(recs[0]), sorted(recs[0]["cost"]),
                            sorted(recs[0]["decision_kinds"]))
            p.hist.clear()
            for path in _seg_paths(p):
                os.unlink(path)
        assert keys["torch"] == keys["jax"]


# ---------------------------------------------------------------------------
# why()'s fall-through to the archive
# ---------------------------------------------------------------------------

def _mask(text):
    import re
    return re.sub(r"[-+]\s*\d+\.\d+s", "<t>", text)


class TestWhyFallthrough:
    def test_why_reads_archive_after_ring_rotation(self, monkeypatch,
                                                   tmp_path):
        def run(p):
            with p.flight.scope("q-why"):
                p.flight.record("serve.start", query="q-why", tenant="t",
                                queue_wait_s=0.0)
                p.flight.record("serve.finish", query="q-why",
                                outcome="ok", latency_s=0.2)
            p.hist.record_finish("q-why", tenant="t", outcome="completed",
                                 total_s=0.2, worker="w0",
                                 decisions=p.flight.for_query("q-why"))
            p.flight.clear()  # the ring forgets; the archive must not
            return p.top.why("q-why")

        j, t = _both(monkeypatch, tmp_path, run)
        assert "durable history" in t and "w0" in t
        assert "archived decision" in t and "serve.finish" in t
        assert _mask(t) == _mask(j)

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_why_unknown_query_names_all_sources(self, p):
        assert "durable history" in p.top.why("q-never-ran")

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_ring_still_wins_when_live(self, p):
        p.flight.record("serve.start", query="q-live", tenant="t",
                        queue_wait_s=0.0)
        assert "flight ring" in p.top.why("q-live")


# ---------------------------------------------------------------------------
# unclean shutdown and the post-mortem
# ---------------------------------------------------------------------------

def _dead_pid():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


class TestUncleanShutdown:
    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_stale_marker_of_dead_pid_is_detected(self, p):
        d = p.hist.active_dir()
        os.makedirs(d, exist_ok=True)
        pid = _dead_pid()
        with open(os.path.join(d, f"running-{pid}.marker"), "w") as f:
            f.write(json.dumps({"pid": pid, "started_ts": 123.0,
                                "worker": "w9"}))
        u0 = p.hist.stats()["unclean_shutdowns"]
        p.hist.clear()
        info = p.hist.unclean_shutdown()
        assert info is not None and info["pid"] == pid
        assert info["worker"] == "w9"
        assert p.hist.stats()["unclean_shutdowns"] - u0 == 1
        assert p.flight.recent(kind="history.unclean_shutdown")
        assert not os.path.exists(os.path.join(d, f"running-{pid}.marker"))
        pm = p.top.postmortem()
        assert "UNCLEAN SHUTDOWN" in pm and str(pid) in pm
        assert any("UNCLEAN" in w.upper() for w in p.health()["warnings"])
        assert p.doctor_name in p.decisions.doctor()

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_own_marker_is_not_unclean(self, p):
        p.hist.record_finish("q-own", outcome="ok")
        p.hist.clear()
        assert p.hist.unclean_shutdown() is None
        assert "no unclean shutdown" in p.top.postmortem()

    def test_postmortem_renders_history_tail(self, monkeypatch, tmp_path):
        def run(p):
            p.hist.record_finish("q-pm", tenant="t", outcome="completed",
                                 total_s=0.3, worker="w0")
            return [ln for ln in p.top.postmortem().splitlines()
                    if "q-pm" in ln]

        j, t = _both(monkeypatch, tmp_path, run)
        assert t == j and "completed" in t[0]


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

class TestSurfaces:
    def test_metrics_provider_renders(self, monkeypatch, tmp_path):
        def run(p):
            p.hist.record_finish("q-met", outcome="ok")
            return sorted(ln.split()[0].split("{")[0]
                          for ln in p.metrics.metrics_text().splitlines()
                          if ln.startswith("tft_history_"))

        j, t = _both(monkeypatch, tmp_path, run)
        assert "tft_history_records_total" in t and t == j

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_health_section(self, p):
        p.hist.record_finish("q-health", outcome="ok")
        hs = p.health()["history"]
        assert hs["enabled"] and hs["segments"] >= 1

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_doctor_names_the_archive(self, p):
        p.hist.record_finish("q-doc", outcome="ok")
        assert "history  :" in p.decisions.doctor()


# ---------------------------------------------------------------------------
# the restart drill: SIGKILL a serving child, read it back
# ---------------------------------------------------------------------------

class TestRestartDrill:
    def test_sigkill_then_postmortem_history_why(self, tmp_path,
                                                 monkeypatch):
        d = str(tmp_path / "drill-hist")
        child = textwrap.dedent("""
            import os, signal, time
            import numpy as np
            import tensorframes_tpu_torch as ttf
            from tensorframes_tpu_torch.serve import (QueryScheduler,
                                                      TenantQuota)

            ttf.set_default_device("cpu")
            sched = QueryScheduler(quotas={"a": TenantQuota(),
                                           "b": TenantQuota()},
                                   workers=2, name="drill")
            futs = []
            for i in range(6):
                fr = ttf.frame({"x": np.arange(64.0) + i},
                               num_partitions=2)
                futs.append(sched.submit(
                    fr, lambda x: {"z": x + 1.0},
                    tenant="a" if i % 2 else "b"))
            for f in futs:
                f.result(timeout=60)
            # the future resolves just before _finish's archive append
            for _ in range(200):
                if len(ttf.history(outcome="completed")) >= 6:
                    break
                time.sleep(0.05)
            print("DRILL-DONE", os.getpid(), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        """)
        env = dict(os.environ)
        env.update({"TFT_HISTORY_DIR": d})
        env.pop("TFT_HISTORY", None)
        proc = subprocess.run([sys.executable, "-c", child], env=env,
                              capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))),
                              timeout=timing_margin(300))
        assert "DRILL-DONE" in proc.stdout, proc.stderr[-2000:]
        assert proc.returncode == -signal.SIGKILL
        pid = int(proc.stdout.split("DRILL-DONE")[1].split()[0])

        monkeypatch.setenv("TFT_HISTORY_DIR", d)
        thist.clear()
        tflight.clear()
        # the JAX reader sees the same six records first (it leaves the
        # dead pid's marker for the port's reader when it runs second:
        # a marker is consumed by the first scan, so read with the port
        # first and the JAX package's reader after)
        pm = ttf.postmortem()
        assert "UNCLEAN SHUTDOWN" in pm and str(pid) in pm
        assert thist.unclean_shutdown()["pid"] == pid
        recs = ttf.history(outcome="completed")
        assert len(recs) == 6
        for r in recs:
            assert r["outcome"] == "completed" and "cost" in r
            assert r["tenant"] in ("a", "b") and r["fingerprint"]
            assert r["run_s"] <= r["total_s"]
        jhist.clear()
        assert jhist.history(outcome="completed") == recs
        out = ttf.why(recs[0]["query"])
        assert "durable history" in out
        assert "archived decision" in out and "serve.finish" in out
