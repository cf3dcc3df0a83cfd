"""Chaos soak: the mixed workload under a seeded multi-site schedule.

The port's counterpart of ``tools/chaos_soak.py``. Every recovery path
has a test that arms ONE fault site and asserts one contract. This
tool is the composed version: the ``resilience/chaos.py`` schedule
fires device losses, worker crashes, preemptions, OOMs and rotten
persist artifacts *into each other* while a mixed workload runs
(multi-tenant serving of map chains, a filter chain and keyed aggregates
through the segment_sum kernel, a broadcast join, the fused distributed
plan over an 8-shard mesh, the durable tier, a bounded stream, park and
resume), and asserts the global contract the per-site tests each assert
locally:

- **never wrong**: every result bit-identical to the fault-free run
  (zero lost rows, zero duplicated rows);
- **never leaked**: zero slot-pool leases, zero ledger reservations, no
  worker threads left behind, and (on the card) the caching allocator's
  bytes in use back at their value before the drill;
- **never unclassified**: every surfaced failure has a
  ``resilience.error_kind`` other than the permanent fallback;
- **replayable**: the firing schedule is a pure function of
  ``(seed, site, step)``; per site, two runs agree on every firing up to
  their common consult count.

Usage (standalone soak; on the default device, ``--device cpu`` for a
host without a GPU):

    python -m tensorframes_tpu_torch.tools.chaos_soak --seed 42 \\
        --rate 0.08 --sites device,worker,preempt,disk --rounds 20

``tests/test_torch_chaos.py`` imports :func:`run_drill` with small
parameters; ``chip_smoke.py`` runs it on the card. The default sites are
the JAX drill's, ``device|worker|preempt|disk``: the ``device`` site fires
in the fused distributed plan's stage, the elastic layer shrinks the mesh
and the lost shard is re-admitted after each round. ``oom`` stays
selectable with ``--sites``. The ``batch`` site is not in the mix: a
fault inside a stream batch is *skipped and counted* by contract, correct
but lossy by design. An ``oom`` inside a stream batch would be skipped the
same way, so the stream's step is a ``map_rows``, whose OOM splits the
batch instead.
"""

import argparse
import sys
import threading
import time

import numpy as np

DEFAULT_SITES = ("device", "worker", "preempt", "disk")


def _host(v) -> np.ndarray:
    """A column's values on the host, whatever device holds them."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _digest(forced) -> tuple:
    """A TensorFrame's values as a hashable per-column identity:
    bit-exact over the row sequence, so two runs compare equal iff every
    value matches; blind to block boundaries."""
    cols = {}
    for b in forced.blocks():
        for name in sorted(b.columns):
            cols.setdefault(name, []).append(_host(b.columns[name]))
    return tuple(
        (name, np.concatenate(parts).tobytes() if parts else b"")
        for name, parts in sorted(cols.items()))


def _submit_with_retries(sched, frame, fetches, tenant, failures,
                         attempts=8):
    """Submit until success, recording every surfaced failure's
    classified kind. Chaos budgets are one-shot, so a failed attempt's
    fault is consumed and the resubmission makes progress."""
    from ..resilience import error_kind
    last = None
    for _ in range(attempts):
        fut = sched.submit(frame, fetches, tenant=tenant)
        try:
            return fut.result(timeout=120)
        except Exception as e:  # noqa: BLE001 - recorded, re-raised below
            failures.append((error_kind(e), f"{type(e).__name__}: {e}"))
            last = e
    raise last


def _double_plus_one(x):
    return {"z": x * 2.0 + 1.0}


def _plus_half(x):
    return {"z": x + 0.5}


def _twice(x):
    return {"z": x + x}


def _three_x_less_one(x):
    return {"z": x * 3.0 - 1.0}


def run_workload(rounds, failures, persist_dir=None):
    """One pass of the mixed workload. Returns ``{key: digest}`` over
    every query result: the bit-identity record.

    Deterministic by construction (fixed data, fixed programs) so the
    fault-free and chaos passes are comparable; every surfaced failure
    lands in ``failures`` as ``(kind, repr)``."""
    from .. import api as _api
    from .. import parallel as _par
    from .. import relational as rel
    from .. import stream
    from ..device import default_device
    from ..parallel import elastic as _elastic
    from ..memory import persist as _persist
    from ..plan import adaptive as _adaptive
    from ..serve import QueryScheduler, TenantQuota

    prev_persist = _persist.configure(persist_dir)
    # a shared result cache would let the chaos pass serve the reference
    # pass's blocks without executing anything: the drill must re-earn
    # every result
    _adaptive.invalidate_results()
    results = {}
    quotas = {"etl": TenantQuota(weight=2.0, max_inflight=2),
              "adhoc": TenantQuota(weight=1.0, max_inflight=2)}
    # the keyed aggregate's data: 4,096 rows into 64 keys, 4 blocks
    rng = np.random.default_rng(5)
    agg_key = rng.integers(0, 64, 4_096)
    agg_x = rng.random(4_096)
    try:
        with QueryScheduler(quotas=quotas, workers=2,
                            name="chaos-drill") as sched:
            for r in range(rounds):
                # multi-tenant serve: map chains, plus a filter chain
                # that drives the row-conservation ledger
                for k in range(3):
                    df = _api.frame(
                        {"x": np.arange(48.0) + 16 * r + k},
                        num_partitions=3)
                    results[("etl", r, k)] = _digest(
                        _submit_with_retries(
                            sched, df, _double_plus_one, "etl", failures))
                fdf = _api.frame({"x": np.arange(64.0) + r},
                                 num_partitions=4)
                results[("filter", r)] = _digest(
                    _submit_with_retries(
                        sched, fdf.filter(lambda x: x % 3.0 == 0.0),
                        _plus_half, "adhoc", failures))
                # a keyed aggregate served whole on a worker: the
                # segment_sum kernel on the card, parked and resumed
                # under the worker and preempt sites
                src = _api.frame({"key": agg_key, "x": agg_x + r},
                                 num_partitions=4)
                grouped = src.map_blocks(_twice).select(
                    ["key", "z"]).group_by("key")
                results[("aggregate", r)] = _digest(
                    _submit_with_retries(sched, grouped, {"z": "sum"},
                                         "etl", failures))

                # broadcast join (forced inline: the relational layer
                # rides the same executor fault sites)
                left = _api.frame(
                    {"k": np.arange(24.0) % 6, "v": np.arange(24.0) + r})
                right = _api.frame(
                    {"k": np.arange(6.0), "w": np.arange(6.0) * 10})
                results[("join", r)] = _digest(
                    rel.broadcast_join(left, right, on="k"))

                # the fused distributed plan over 8 shards of the default
                # device: the device site fires in its stage and the
                # elastic layer shrinks the mesh; re-admit after, so the
                # next round starts on all 8 shards again
                dev = default_device()
                mesh = _par.DeviceMesh(np.array([dev] * 8, dtype=object))
                dist = _par.distribute(
                    _api.frame({"x": np.arange(32.0) + r}), mesh)
                out = _par.dmap_blocks(_three_x_less_one, dist.lazy())
                results[("dist", r)] = _digest(out.collect_frame())
                if _elastic.lost_pool():
                    _par.admit_devices(mesh)

                # the durable tier under rot: write one artifact and read
                # it back a few times. Under chaos the disk site fails or
                # corrupts reads and the tier must go COLD (None):
                # returning different bytes would be the silent wrong
                # data the checksums exist to prevent
                if persist_dir is not None:
                    saved = [{"x": np.arange(16.0) + r}]
                    _persist.save_result(f"soak-probe-{r}", saved)
                    for _ in range(3):
                        got = _persist.load_result(f"soak-probe-{r}")
                        assert got is None or np.array_equal(
                            _host(got[0]["x"]), saved[0]["x"]), \
                            "persist tier returned wrong data"

                # a bounded stream (no chaos `batch` site in the mix, and
                # its map_rows splits on an OOM, so nothing is skipped
                # and the digest is exact)
                def batches(base):
                    for i in range(4):
                        yield {"x": np.arange(8.0) + base + i}
                handle = (stream.from_source(
                              stream.GeneratorSource(batches(100 * r)))
                          .map_rows(lambda x: {"z": x - 2.0})
                          .start(name=f"soak-{r}"))
                handle.run(timeout_s=60)
                updates = handle.collect_updates()
                results[("stream", r)] = tuple(
                    _digest(f) for f in updates)
    finally:
        _persist.configure(prev_persist)
    return results


def check_prefix_replay(fp_a, consults_a, fp_b, consults_b):
    """Per-site replay check: over the consult counts BOTH runs reached,
    the firing steps must agree exactly (the schedule is a pure function
    of ``(seed, site, step)``; recovery work may change how MANY
    consults a site sees, never which steps fire)."""
    mismatches = []
    sites = set(consults_a) | set(consults_b)
    for site in sites:
        common = min(consults_a.get(site, 0), consults_b.get(site, 0))
        a = [s for (x, s) in fp_a if x == site and s <= common]
        b = [s for (x, s) in fp_b if x == site and s <= common]
        if a != b:
            mismatches.append((site, a, b))
    return mismatches


def _device_bytes():
    """The caching allocator's bytes in use on the default device with
    the in-memory result cache dropped, or ``None`` off the card."""
    import gc

    import torch

    from ..device import default_device
    from ..plan import adaptive as _adaptive
    dev = torch.device(default_device())
    if dev.type != "cuda":
        return None
    _adaptive.invalidate_results()
    gc.collect()
    torch.cuda.synchronize(dev)
    return int(torch.cuda.memory_allocated(dev))


def run_drill(seed=42, rate=0.08, sites=DEFAULT_SITES, rounds=1,
              persist_dir=None, thread_grace_s=15.0):
    """The bounded chaos acceptance drill. Returns a report dict; raises
    ``AssertionError`` on any broken contract."""
    from .. import memory as _memory
    from ..engine import pipeline as _pipeline
    from ..resilience import chaos, invariants

    baseline_threads = threading.active_count()

    # fault-free reference
    ref_failures = []
    reference = run_workload(rounds, ref_failures)
    assert not ref_failures, f"fault-free run failed: {ref_failures}"
    bytes0 = _device_bytes()

    # the same workload under chaos
    failures = []
    with chaos.inject(chaos.ChaosSchedule(seed, rate, list(sites))) as sc:
        chaotic = run_workload(rounds, failures, persist_dir=persist_dir)
        stats = sc.stats()
        fp = sc.fingerprint()

    # bit-identity: zero lost rows, zero duplicated rows, zero wrong
    # values: the chaos run earned exactly the reference's answers
    assert set(chaotic) == set(reference), (
        f"result set drifted: {set(chaotic) ^ set(reference)}")
    wrong = [k for k in reference if chaotic[k] != reference[k]]
    assert not wrong, f"results not bit-identical under chaos: {wrong}"

    # every surfaced failure classified (the permanent fallback means the
    # classifier did NOT recognize it: a chaos fault must never surface
    # unrecognized)
    unclassified = [f for f in failures if f[0] == "permanent"]
    assert not unclassified, f"unclassified failures: {unclassified}"

    # zero leaks: no slot pool installed, no ledger reservations, the
    # worker and stream threads wound down, the card's bytes back
    assert _pipeline.current_slot_pool() is None, "slot pool leaked"
    mgr = _memory.active()
    if mgr is not None:
        assert not mgr.audit(), f"ledger audit failed: {mgr.audit()}"
    deadline = time.monotonic() + thread_grace_s
    while (threading.active_count() > baseline_threads
           and time.monotonic() < deadline):
        time.sleep(0.05)
    leaked = threading.active_count() - baseline_threads
    assert leaked <= 0, (
        f"{leaked} thread(s) leaked: "
        f"{sorted(t.name for t in threading.enumerate())}")
    bytes1 = _device_bytes()
    assert bytes1 == bytes0, (
        f"device bytes in use {bytes1} after the chaos pass, {bytes0} "
        f"before it")

    # the cross-cutting auditors agree, loudly
    with invariants.strict():
        invariants.audit("chaos.soak")

    # replay: same seed + same workload => same per-site firing steps
    replay_failures = []
    with chaos.inject(chaos.ChaosSchedule(seed, rate, list(sites))) as sc2:
        run_workload(rounds, replay_failures, persist_dir=persist_dir)
        stats2 = sc2.stats()
        fp2 = sc2.fingerprint()
    mismatches = check_prefix_replay(fp, stats["consults"],
                                     fp2, stats2["consults"])
    assert not mismatches, f"schedule did not replay: {mismatches}"

    return {"seed": seed, "rate": rate, "sites": list(sites),
            "rounds": rounds, "fired": stats["fired"],
            "consults": stats["consults"], "firings": list(fp),
            "failures": failures, "replay_fired": stats2["fired"],
            "replay_firings": list(fp2),
            "replay_consults": stats2["consults"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rate", type=float, default=0.08)
    ap.add_argument("--sites", default=",".join(DEFAULT_SITES),
                    help="comma- or |-separated fault sites")
    ap.add_argument("--rounds", type=int, default=20,
                    help="workload rounds per pass (3 passes run: "
                         "reference, chaos, replay)")
    ap.add_argument("--device", default=None,
                    help="the package's default device (default: cuda)")
    ap.add_argument("--persist-dir", default=None,
                    help="durable-tier dir for the chaos passes "
                         "(default: a fresh temp dir, so the disk site "
                         "has artifacts to rot)")
    args = ap.parse_args(argv)
    if args.device is not None:
        from ..device import set_default_device
        set_default_device(args.device)
    sites = [s for s in args.sites.replace("|", ",").split(",") if s]
    persist_dir = args.persist_dir
    if persist_dir is None:
        import tempfile
        persist_dir = tempfile.mkdtemp(prefix="tft-chaos-soak-")
    t0 = time.monotonic()
    report = run_drill(seed=args.seed, rate=args.rate, sites=sites,
                       rounds=args.rounds, persist_dir=persist_dir)
    dt = time.monotonic() - t0
    print(f"chaos soak PASSED in {dt:.1f}s: seed {report['seed']} "
          f"rate {report['rate']:g} over {report['rounds']} round(s)")
    print(f"  consults: {report['consults']}")
    print(f"  fired {report['fired']} fault(s): {report['firings']}")
    print(f"  surfaced failures (all classified, all recovered by "
          f"resubmission): {report['failures'] or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
