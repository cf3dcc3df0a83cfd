"""The port's seeded chaos schedules (``resilience/chaos.py``), its fault
site table and the invariants an active schedule makes strict, held
against the JAX package: ``tests/test_chaos.py``'s ``TestChaosSchedule``,
``TestFaultSites``, ``TestInvariants`` (the cases that need a schedule, a
scheduler or the fabric: ``tests/test_torch_invariants.py`` holds the
rest) and ``TestConformance``, and the bounded drill of the port's
``tools/chaos_soak.py`` at a small size. ``TestQuarantine`` is mirrored in
``tests/test_torch_serve.py``, ``TestPersistChecksums`` in
``tests/test_torch_memory.py``.

Parity: ``ChaosSchedule.consult`` decides the same way in both packages
for every site both have, step for step, and ``parse`` reads the same
specs the same way. The steps a workload reaches differ between the
packages (their blocks and dispatches differ), so replay is checked
within the port.
"""

import os
import re
import time

import numpy as np
import pytest

import tensorframes_tpu_torch as ttf
from tensorframes_tpu.resilience import chaos as jchaos
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch import serve
from tensorframes_tpu_torch.engine import pipeline as engine_pipeline
from tensorframes_tpu_torch.observability import flight as obs_flight
from tensorframes_tpu_torch.resilience import (chaos, error_kind, faults,
                                               invariants)
from tensorframes_tpu_torch.resilience.classify import (InvariantViolation,
                                                        is_transient)
from tensorframes_tpu_torch.resilience.faults import InjectedFault
from tensorframes_tpu_torch.serve import QueryScheduler, ServeFabric
from tensorframes_tpu_torch.tools import chaos_soak
from tensorframes_tpu_torch.utils import tracing

pytestmark = pytest.mark.chaos

# the literal twin of faults.sites(): the conformance test greps test
# sources for quoted site names, and test_site_table_matches_literals pins
# this list to the real table
PORT_SITES = ("batch", "cluster_init", "compile", "device", "disk",
              "dispatch", "dmap", "drain", "oom", "perf", "preempt",
              "worker")


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.delenv("TFT_CHAOS", raising=False)
    monkeypatch.delenv("TFT_FAULTS", raising=False)
    ttf.set_default_device("cpu")
    for c, f in ((chaos, faults), (jchaos, jfaults)):
        c.stop()
        f.reset()
    tracing.counters.reset()
    obs.clear_ring()
    yield
    serve.shutdown_default_scheduler()
    for c, f in ((chaos, faults), (jchaos, jfaults)):
        c.stop()
        f.reset()
    tracing.counters.reset()
    obs.clear_ring()
    assert engine_pipeline.current_slot_pool() is None


# -- chaos schedules -------------------------------------------------------

class TestChaosSchedule:
    def test_same_seed_fires_identically(self):
        a = chaos.ChaosSchedule(5, 0.2, ["compile"])
        b = chaos.ChaosSchedule(5, 0.2, ["compile"])
        c = chaos.ChaosSchedule(6, 0.2, ["compile"])
        for _ in range(300):
            a.consult("compile")
            b.consult("compile")
            c.consult("compile")
        faults.reset()  # consult() arms one-shot budgets as it fires
        assert a.firings() == b.firings()
        assert a.firings(), "rate 0.2 over 300 consults never fired"
        assert a.firings() != c.firings()
        assert a.fingerprint() == b.fingerprint()

    def test_check_integration_replays(self):
        spec = "seed:5,rate:0.2,sites:compile"
        raised = []
        for _ in range(2):
            hits = []
            with chaos.inject(spec) as sched:
                for i in range(200):
                    try:
                        faults.check("compile")
                    except InjectedFault:
                        hits.append(i)
                assert len(sched.firings()) == len(hits)
            raised.append(hits)
        assert raised[0], "chaos schedule never fired through check()"
        assert raised[0] == raised[1]

    def test_parse_spec(self):
        s = chaos.parse("seed:42,rate:0.5,sites:preempt|worker|disk")
        assert (s.seed, s.rate) == (42, 0.5)
        assert s.sites == ("preempt", "worker", "disk")
        # defaults: seed 0, rate 0.05
        d = chaos.parse("sites:compile")
        assert (d.seed, d.rate) == (0, 0.05)
        with pytest.raises(ValueError, match="malformed"):
            chaos.parse("seed=42,sites:compile")
        with pytest.raises(ValueError, match="unknown TFT_CHAOS key"):
            chaos.parse("sede:42,sites:compile")
        with pytest.raises(ValueError, match="unknown fault site"):
            chaos.parse("sites:compile|tyop")
        with pytest.raises(ValueError, match="at least one site"):
            chaos.parse("seed:1,rate:0.5")
        with pytest.raises(ValueError, match="rate"):
            chaos.ChaosSchedule(1, 1.5, ["compile"])
        with pytest.raises(ValueError, match="rate"):
            chaos.ChaosSchedule(1, 0.0, ["compile"])

    def test_firings_shaped_for_classifiers(self):
        # a chaos fault must be indistinguishable from a scripted one: the
        # firing arms the site's shaped message, so that the classifier
        # sees the kind the site's recovery path keys on
        for site, kind in (("oom", "oom"), ("worker", "worker_lost"),
                           ("disk", "permanent")):
            with chaos.inject(chaos.ChaosSchedule(1, 1.0, [site])):
                with pytest.raises(InjectedFault) as ei:
                    faults.check(site)
            assert error_kind(ei.value) == kind, site
            with jchaos.inject(jchaos.ChaosSchedule(1, 1.0, [site])):
                with pytest.raises(jfaults.InjectedFault) as ej:
                    jfaults.check(site)
            assert str(ei.value) == str(ej.value), site

    def test_stop_disarms_pending_firings(self):
        sched = chaos.start(chaos.ChaosSchedule(1, 1.0, ["dispatch"]))
        assert sched.consult("dispatch")  # fires: arms a one-shot budget
        assert faults.active("dispatch") == 1
        chaos.stop()
        assert faults.active("dispatch") == 0, (
            "stop() must disarm fired-but-unconsumed budgets")
        assert chaos.active() is None

    def test_env_knob(self, monkeypatch):
        monkeypatch.setattr(chaos, "_env_armed", False)
        monkeypatch.setenv("TFT_CHAOS", "seed:9,rate:0.5,sites:compile")
        chaos.maybe_start_from_env()
        try:
            sched = chaos.active()
            assert sched is not None
            assert (sched.seed, sched.rate) == (9, 0.5)
            assert sched.sites == ("compile",)
        finally:
            chaos.stop()
        # memoized: a second call with the schedule stopped stays off
        chaos.maybe_start_from_env()
        assert chaos.active() is None

    def test_env_knob_arms_through_the_first_check(self, monkeypatch):
        """``TFT_CHAOS`` arms a schedule at the first fault-site check
        instead of raising; a site the port lacks raises the JAX
        package's ``ValueError`` (the known-site list is each package's
        own)."""
        monkeypatch.setattr(chaos, "_env_armed", False)
        monkeypatch.setattr(faults._state, "_armed_env", False)
        monkeypatch.setenv("TFT_CHAOS",
                           "seed:11,rate:0.3,sites:worker|preempt|disk")
        try:
            faults.check("dispatch")
            sched = chaos.active()
            assert sched is not None and sched.seed == 11
            assert sched.sites == ("worker", "preempt", "disk")
            assert faults.may_fire("worker")
        finally:
            chaos.stop()
        spec = "seed:11,rate:0.3,sites:worker|pjrt_execute"
        monkeypatch.setattr(chaos, "_env_armed", False)
        monkeypatch.setattr(faults._state, "_armed_env", False)
        monkeypatch.setenv("TFT_CHAOS", spec)
        with pytest.raises(ValueError) as ei:
            faults.check("dispatch")
        assert chaos.active() is None
        with pytest.raises(ValueError) as ej:
            jchaos.ChaosSchedule(11, 0.3, ["worker", "no_such_site"])
        known = re.compile(r"known sites: \[.*?\]")
        assert known.sub("", str(ei.value)).replace("'pjrt_execute'",
                                                    "X") == \
            known.sub("", str(ej.value)).replace("'no_such_site'", "X")

    def test_firings_flight_recorded(self):
        with chaos.inject(chaos.ChaosSchedule(1, 1.0, ["compile"])):
            with pytest.raises(InjectedFault):
                faults.check("compile")
        recs = obs_flight.recent(kind="chaos.fire")
        assert recs, "chaos firing was not flight-recorded"
        assert recs[-1]["site"] == "compile"
        assert recs[-1]["seed"] == 1
        assert recs[-1]["step"] >= 1
        assert tracing.counters.get("chaos.fired") >= 1
        assert tracing.counters.get("chaos.compile.fired") >= 1

    def test_may_fire(self):
        assert not faults.may_fire("compile")
        faults.arm("compile", 1)
        assert faults.may_fire("compile")
        faults.reset("compile")
        assert not faults.may_fire("compile")
        with chaos.inject(chaos.ChaosSchedule(1, 0.01, ["compile"])):
            # named by the schedule: COULD fire, even at a tiny rate
            assert faults.may_fire("compile")
            assert not faults.may_fire("dispatch")
        assert not faults.may_fire("compile")

    def test_health_and_doctor_show_the_schedule(self):
        with chaos.inject(chaos.ChaosSchedule(3, 0.25, ["worker", "oom"])):
            inv = ttf.health()["invariants"]
            assert inv["strict"] and inv["chaos"]["seed"] == 3
            assert "chaos seed 3 rate 0.25" in ttf.doctor()
        assert ttf.health()["invariants"]["chaos"] is None


# -- parity with the JAX package's schedules --------------------------------

COMMON = sorted(set(faults.sites()) & set(jfaults.sites()))


class TestParity:
    @pytest.mark.parametrize("seed,rate", [(0, 0.05), (11, 0.3), (42, 0.5),
                                           (7, 1.0)])
    def test_consult_decisions_agree_with_the_jax_package(self, seed, rate):
        t = chaos.ChaosSchedule(seed, rate, COMMON)
        j = jchaos.ChaosSchedule(seed, rate, COMMON)
        for _ in range(2_000):
            for site in COMMON:
                assert t.consult(site) == j.consult(site), site
            faults.reset()
            jfaults.reset()
        assert t.firings() == j.firings()
        assert t.stats() == j.stats()
        assert len(t.firings()) > 0

    @pytest.mark.parametrize("spec", [
        "sites:compile", "seed:42,rate:0.5,sites:preempt|worker|disk",
        " rate:0.125 , seed:-3 ,sites:oom|oom|batch ",
        "seed:11,rate:0.3,sites:worker|preempt|disk|oom",
        "seed=42,sites:compile", "sede:42,sites:compile",
        "seed:1,rate:0.5", "seed:1,rate:1.5,sites:perf",
        "seed:1,rate:0,sites:perf", "sites:compile|tyop"])
    def test_parse_agrees_with_the_jax_package(self, spec):
        def read(pkg):
            try:
                s = pkg.parse(spec)
            except ValueError as e:
                return re.sub(r"known sites: \[.*?\]", "", str(e))
            return (s.seed, s.rate, s.sites)

        assert read(chaos) == read(jchaos)

    def test_port_sites_are_the_jax_packages(self):
        assert set(faults.sites()) <= set(jfaults.sites())
        assert set(jfaults.sites()) - set(faults.sites()) == {
            "pad_compile", "pjrt_execute"}


# -- the fault-site table --------------------------------------------------

class TestFaultSites:
    def test_site_table_matches_literals(self):
        assert tuple(sorted(faults.sites())) == PORT_SITES

    def test_sites_returns_copy(self):
        got = faults.sites()
        got["bogus"] = "nope"
        assert "bogus" not in faults.sites()

    def test_unknown_site_warns_loudly(self):
        before = tracing.counters.get("faults.unknown_sites")
        faults.arm("tyop", 1)
        try:
            assert tracing.counters.get("faults.unknown_sites") == \
                before + 1
        finally:
            faults.reset("tyop")

    @pytest.mark.parametrize("site", [s for s in PORT_SITES if s != "perf"])
    def test_every_site_arms_and_raises(self, site):
        with faults.inject(site):
            with pytest.raises(InjectedFault) as ei:
                faults.check(site)
        kind = error_kind(ei.value)
        expect = {"oom": "oom", "worker": "worker_lost", "disk": "permanent",
                  "device": "device_lost"}
        assert kind == expect.get(site, "transient"), site
        # non-transient sites must never reach the retry loop
        if site in ("oom", "worker", "disk", "device"):
            assert not is_transient(ei.value)
        assert faults.active(site) == 0
        with jfaults.inject(site):
            with pytest.raises(jfaults.InjectedFault) as ej:
                jfaults.check(site)
        assert str(ei.value) == str(ej.value)

    def test_perf_site_sleeps_never_raises(self, monkeypatch):
        monkeypatch.setenv("TFT_FAULT_PERF_S", "0.001")
        with faults.inject("perf"):
            assert faults.slowdown("perf") >= 0.001
            assert faults.slowdown("perf") == 0.0  # budget spent
        with chaos.inject(chaos.ChaosSchedule(1, 1.0, ["perf"])):
            assert faults.slowdown("perf") >= 0.001


# -- invariant auditors that need a schedule, a scheduler or the fabric ----

class TestInvariants:
    pytestmark = pytest.mark.invariants

    def test_chaos_schedule_implies_strict(self):
        assert not invariants.strict_mode()
        with chaos.inject(chaos.ChaosSchedule(1, 0.01, ["compile"])):
            assert invariants.strict_mode()
        assert not invariants.strict_mode()

    def test_scheduler_quiesce_audit_clean(self):
        with QueryScheduler(workers=1, name="inv-clean") as sched:
            df = ttf.frame({"x": np.arange(16.0)}, num_partitions=2)
            fut = sched.submit(df, lambda x: {"z": x * 2.0}, tenant="t")
            fut.result(timeout=60)
            with invariants.strict():
                assert invariants.audit("test.quiesce") == []
        with invariants.strict():
            assert invariants.audit("test.close") == []
        assert tracing.counters.get("invariants.violations") == 0

    def test_fabric_auditor(self, tmp_path):
        with ServeFabric(workers=2, monitor=False, probe=False,
                         persist_dir=str(tmp_path), name="inv") as fab:
            df = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
            fab.submit(df, lambda x: {"z": x + 1.0},
                       tenant="t").result(timeout=60)
            with invariants.strict():
                assert invariants.audit("test.fabric") == []
            # a placement onto a worker the fabric does not have
            fab._placement["ghost"] = 7
            found = invariants.audit("test.fabric")
            assert any("[fabric]" in f and "ghost" in f for f in found)
            with chaos.inject(chaos.ChaosSchedule(1, 0.01, ["compile"])):
                with pytest.raises(InvariantViolation):
                    invariants.audit("test.fabric")
            del fab._placement["ghost"]
        assert tracing.counters.get("invariants.fabric.violations") == 2


# -- conformance -----------------------------------------------------------

def _classified_kinds():
    from tensorframes_tpu_torch.resilience import classify
    kinds = {"worker_lost", "oom", "transient", "permanent"}
    for obj in vars(classify).values():
        if isinstance(obj, type) and issubclass(obj, BaseException):
            kind = getattr(obj, "kind", None)
            if kind:
                kinds.add(kind)
    return kinds


class TestConformance:
    DOCS = os.path.join(os.path.dirname(__file__), "..", "docs",
                        "resilience.md")

    def test_every_error_kind_documented(self):
        with open(self.DOCS) as f:
            text = f.read()
        missing = [k for k in sorted(_classified_kinds())
                   if f"`{k}`" not in text]
        assert not missing, missing

    def test_every_site_documented(self):
        with open(self.DOCS) as f:
            text = f.read()
        missing = [s for s in sorted(faults.sites()) if s not in text]
        assert not missing, missing

    def test_every_site_driven_by_a_port_test(self):
        tests_dir = os.path.dirname(__file__)
        corpus = ""
        for name in os.listdir(tests_dir):
            if name.startswith("test_torch_") and name.endswith(".py") \
                    and name != os.path.basename(__file__):
                with open(os.path.join(tests_dir, name)) as f:
                    corpus += f.read()
        undriven = [s for s in sorted(faults.sites())
                    if f'"{s}"' not in corpus and f"'{s}'" not in corpus]
        assert not undriven, undriven


# -- the bounded drill ------------------------------------------------------

@pytest.mark.invariants
def test_chaos_acceptance_drill(tmp_path):
    """The mixed workload under the JAX drill's 4-site default schedule:
    bit-identity with the fault-free run, zero leaks, every failure
    classified, exact per-site replay of the seed. seed 11 at rate 0.3
    fires the device (a shard of the fused mesh plan lost and
    re-admitted), worker, preempt and disk sites within two rounds (the
    drill asserts the rest of the contract and raises on any breach)."""
    t0 = time.perf_counter()
    report = chaos_soak.run_drill(seed=11, rate=0.3, rounds=2,
                                  persist_dir=str(tmp_path))
    fired_sites = {site for site, _ in report["firings"]}
    assert {"device", "worker", "preempt", "disk"} <= fired_sites, \
        sorted(fired_sites)
    assert report["sites"] == ["device", "worker", "preempt", "disk"]
    assert report["fired"] >= 3
    assert tracing.counters.get("chaos.fired") >= report["fired"]
    assert all(kind != "permanent" for kind, _ in report["failures"])
    # the prefix both runs reached fired the same steps
    assert chaos_soak.check_prefix_replay(
        report["firings"], report["consults"], report["replay_firings"],
        report["replay_consults"]) == []
    assert time.perf_counter() - t0 < 120
