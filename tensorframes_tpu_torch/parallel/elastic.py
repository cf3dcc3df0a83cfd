"""Elastic meshes: device-loss tolerance and skew-adaptive repartitioning.

The port's counterpart of ``tensorframes_tpu/parallel/elastic.py``. One
dead shard of a mesh would otherwise kill every query on it, though the
resilience layer already classifies the error and the mesh observability
already measures per-shard stragglers. This module closes both loops at
the one place every mesh op passes through, the dispatch boundary of
``dmap_blocks`` / ``dfilter`` / ``dsort`` / ``dreduce_blocks`` /
``daggregate`` / ``dexchange`` and the fused stages of ``plan/dist.py``:

- **Device-loss tolerance** (:func:`elastic_call`): a failure classified
  ``device_lost`` (:func:`~..resilience.is_device_lost`: a real
  ``DEVICE_LOST`` status, or the deterministic ``device`` fault site)
  rebuilds a shrunken :class:`~.mesh.DeviceMesh` over the surviving
  shards, re-shards the frame through the host (the rows that lived on
  the lost shard are the ones that have to move, counted in
  ``mesh.reshard_rows``) and re-runs the op on the survivors. Recovery
  shrinks onto the mesh's own remaining devices: on 8 logical shards of
  one card, onto 7 shards of the same card, never onto the CPU. Only
  data-only meshes (every non-data axis of size 1) can shrink
  rectangularly; anything else re-raises.

  The re-shard reads the frame's shards back through the host. Under
  fault injection every shard is still readable; on real hardware the
  lost device's shard may not be, in which case the re-shard itself
  raises and the caller must rebuild from its host-side source.

- **Skew-adaptive repartitioning** (:func:`note_dispatch` ->
  ``_maybe_rebalance``): the per-shard times the d-ops record while a
  trace is active (CUDA events on a card, the host clock on the CPU, in
  the JAX package's cumulative form) feed a per-mesh tracker; when the
  straggler ratio (max/median shard time) stays above ``TFT_SKEW_WARN``
  for ``TFT_SKEW_REBALANCE_AFTER`` consecutive dispatches, the next op on
  that mesh re-partitions the frame's rows in proportion to observed
  per-shard throughput (slow shards get fewer valid rows; the padded
  layout stays equal-shard, per-shard validity carries the imbalance).
  The before/after balance is recorded on the frame (``explain()``) and
  as a ``rebalance`` trace event.

- **Elastic growth** (:func:`admit_devices`, the inverse of shrink):
  recovered or newly arrived devices rejoin a mesh after passing a probe
  and a warm-up dispatch (:func:`probe_device`, bounded by
  ``TFT_ADMIT_PROBE_TIMEOUT_S``); the frame re-shards onto the grown mesh
  in order (bit-identical for row-local ops), and an old->grown upgrade
  registry migrates every OTHER frame still on the old mesh at its next
  dispatch boundary, which is how stream pumps and the serve scheduler
  pick up a grown mesh without restarting. Skew penalties recorded
  against the returning layout are cleared.

- **Hot-key salting** (:func:`plan_key_salt` / :func:`fold_salted`):
  ``daggregate``'s monoid host-key path splits any key holding more than
  ``TFT_HOT_KEY_FRACTION`` of the rows across ``num_data_shards`` salt
  slots and folds the per-salt partials back on the host.

Devices are known by the mesh's logical ids (``DeviceMesh.ids``, the
port's ``jax.Device.id``) together with the ``torch.device`` each slot
runs on (:class:`~.mesh.LogicalDevice`): the lost pool holds those, so
the lost shards of the one card can be admitted again though the card
enumerates one device. Every explicit mesh numbers its slots from 0, so
an id alone does not name a device across meshes: the lost pool and the
skew tracker are keyed by the pair, and a mesh grows only by devices of
its own type (a card mesh never takes back a lost CPU slot).

Counters (always on): ``mesh.devices_lost``, ``mesh.shrinks``,
``mesh.reshard_rows``, ``mesh.rebalances``, ``mesh.salted_keys``,
``mesh.grows``, ``mesh.devices_admitted``, ``mesh.admit_probe_failures``,
``mesh.grow_migrations``, also exported as ``tft_mesh_*`` series on the
metrics endpoint. Trace events (when a query trace is active):
``mesh_shrink`` (one per lost device, carrying its index), ``rebalance``,
``key_salt``, ``mesh_grow``, ``mesh_grow_pickup``,
``admit_probe_failed``. Flight records ``mesh.shrink``,
``mesh.rebalance``, ``mesh.grow``, ``mesh.salt``.

When healthy, :func:`elastic_call` adds one fault-site check and two
dict truthiness checks per op (``chip_smoke.py``'s ``elastic_20M`` phase
prints the layer's cost against :func:`bypass` on the card).
``TFT_ELASTIC=0`` disables recovery (a device loss raises); :func:`bypass`
strips the layer entirely, the baseline for measuring its cost.
"""

from __future__ import annotations

import contextlib
import re
import statistics
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import events as _obs
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..resilience import faults as _faults
from ..resilience.classify import is_device_lost
from ..utils.env import env_bool, env_float, env_int
from ..utils.logging import get_logger
from ..utils.tracing import counters, gauge
from . import mesh as _mesh_mod
from .mesh import DeviceMesh, LogicalDevice, refuse_cluster

__all__ = ["elastic_call", "enabled", "bypass", "lost_device_ids",
           "lost_pool", "shrink_mesh", "reshard", "note_dispatch",
           "salt_fraction", "plan_key_salt", "fold_salted",
           "probe_device", "grow_mesh", "admit_devices"]

_log = get_logger("parallel.elastic")

_bypassed = False


def enabled() -> bool:
    """Device-loss recovery armed? (``TFT_ELASTIC``, default on.)"""
    return not _bypassed and env_bool("TFT_ELASTIC", True)


@contextlib.contextmanager
def bypass():
    """Strip the elastic layer entirely (no fault-site check, no skew
    tracker, no recovery): the baseline for measuring what the
    enabled-but-idle layer costs on a healthy mesh."""
    global _bypassed
    was = _bypassed
    _bypassed = True
    try:
        yield
    finally:
        _bypassed = was


# ---------------------------------------------------------------------------
# the dispatch boundary
# ---------------------------------------------------------------------------

def elastic_call(op: str, dist, run: Callable):
    """Run ``run(dist)`` with skew-adaptive repartitioning and device-loss
    recovery.

    ``run`` must be re-runnable against a replacement frame: it receives
    the (possibly re-sharded) :class:`~.distributed.DistributedFrame` and
    performs the whole op, including its own transient-retry policy. On a
    ``device_lost`` failure the mesh shrinks by the lost device(s) and
    ``run`` re-runs on the re-sharded frame; up to S-1 successive losses
    are survivable, a loss on a 1-shard mesh re-raises.
    """
    if _bypassed:
        return run(dist)
    if dist.mesh.is_cluster:
        # no recovery, growth or rebalance across processes: a loss on
        # one process cannot reshard another's rows
        try:
            _faults.check("device")
            return run(dist)
        except Exception as e:  # noqa: BLE001 - reclassified below
            if is_device_lost(e) and enabled():
                raise NotImplementedError(
                    f"{op}: elastic recovery on a cluster mesh is not "
                    f"supported (ROADMAP.md section C): {e}") from e
            raise
    dist = _maybe_grow(op, dist)
    dist = _maybe_rebalance(op, dist)
    rebalance = getattr(dist, "_rebalance", None)
    result = None
    last: Optional[BaseException] = None
    for _ in range(max(dist.mesh.num_data_shards, 1)):
        try:
            _faults.check("device")
            result = run(dist)
            break
        except Exception as e:  # noqa: BLE001 - reclassified below
            if not is_device_lost(e) or not enabled():
                raise
            if dist.mesh.num_data_shards <= 1:
                _log.error(
                    "%s: device lost on a single-shard mesh — nothing "
                    "to shrink to; re-raising", op)
                raise
            last = e
            dist = _recover(e, dist, op)
            # recovery re-sharded with an even prefix layout: any
            # rebalanced per-shard placement from this call is gone, and
            # reporting it on the result would be a lie
            rebalance = None
    else:
        raise last if last is not None else RuntimeError(
            f"{op}: elastic recovery exhausted")  # pragma: no cover
    if rebalance is not None and hasattr(result, "mesh") \
            and hasattr(result, "schema"):
        # surface the rebalance on the frame the CALLER holds (the op's
        # output derives from the rebalanced input): explain() renders it
        result._rebalance = rebalance
    return result


def _liveness(dev: torch.device) -> None:
    """A tiny transfer to ``dev`` and a synchronize on it: raises when the
    device cannot take bytes."""
    x = torch.zeros(1, dtype=torch.int8).to(dev)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def lost_device_ids(exc: BaseException, mesh: DeviceMesh) -> List[int]:
    """Which flat device indices of ``mesh`` died, best-effort.

    The error message is the primary evidence (``device <i>``: device
    statuses and the injected ``device`` fault both name the index);
    failing that, each slot's device is probed with a tiny transfer and a
    synchronize, and the unresponsive ones are reported. When neither
    identifies a device (an anonymous ``DEVICE_LOST`` on a healthy-looking
    mesh), device 0 is dropped: documented, deterministic, and safe,
    since dropping a healthy device only shrinks capacity.
    """
    n = mesh.num_devices
    ids = sorted({int(m) for m in
                  re.findall(r"device[\s_#]*(\d+)", str(exc),
                             re.IGNORECASE)
                  if 0 <= int(m) < n})
    if ids and len(ids) < n:
        return ids
    lost = []
    for i, d in enumerate(mesh.devices.reshape(-1)):
        try:
            _liveness(d)
        except Exception as probe_err:  # noqa: BLE001 - probing for death
            _log.warning("device %d failed its liveness probe: %s",
                         i, probe_err)
            lost.append(i)
    if lost and len(lost) < n:
        return lost
    _log.warning("could not identify the lost device from %r; dropping "
                 "device 0 (set TFT_FAULT_DEVICE / name the device in "
                 "the error to steer this)", str(exc)[:200])
    return [0]


def _data_mesh(mesh: DeviceMesh, devices: Sequence[LogicalDevice],
               action: str) -> DeviceMesh:
    """A new mesh with ``mesh``'s axis layout over ``devices`` on the DATA
    axis, wherever it sits: every other axis must be size 1 (the shared
    data-only guard of shrink and grow). The slots keep their ids."""
    if mesh.num_devices != mesh.num_data_shards:
        raise ValueError(
            f"elastic {action} needs a data-only mesh (non-data axes "
            f"all size 1); {mesh!r} has {mesh.num_devices} devices "
            f"over {mesh.num_data_shards} data shards")
    data_pos = mesh.axis_names.index(mesh.data_axis)
    shape = tuple(len(devices) if i == data_pos else 1
                  for i in range(len(mesh.axis_names)))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [d.device for d in devices]
    ids = np.array([d.id for d in devices], np.int64)
    return DeviceMesh(arr.reshape(shape), mesh.axis_names,
                      data_axis=mesh.data_axis, ids=ids.reshape(shape))


def shrink_mesh(mesh: DeviceMesh, lost: Sequence[int]) -> DeviceMesh:
    """A new data mesh over ``mesh``'s devices minus ``lost`` (flat
    indices). Only data-only meshes (every non-data axis of size 1) can
    shrink rectangularly; others raise."""
    gone = set(lost)
    survivors = [d for i, d in enumerate(mesh.logical_devices())
                 if i not in gone]
    if not survivors:
        raise ValueError(f"all {mesh.num_devices} devices of {mesh!r} "
                         f"reported lost; nothing to shrink to")
    return _data_mesh(mesh, survivors, "shrink")


def reshard(dist, mesh: DeviceMesh,
            shard_rows: Optional[np.ndarray] = None):
    """Rebuild ``dist``'s columns over ``mesh`` through the host.

    ``shard_rows`` (len ``mesh.num_data_shards``) places each shard's
    valid-row count explicitly (the skew-rebalance layout; per-shard
    validity carries the imbalance); ``None`` lays the valid rows out as
    an even prefix (the ``distribute()`` layout). Global row order is
    preserved either way, so row-local results collect bit-identically.
    Every device column becomes a ``ShardedArray`` on the new mesh's
    shard devices; host (string) columns stay numpy object arrays.
    """
    from .. import dtypes as _dt
    from .distributed import DistributedFrame, _place

    S = mesh.num_data_shards
    n = dist.num_rows
    mask = dist.valid_row_mask()
    if shard_rows is None:
        padded = ((n + S - 1) // S) * S if n else S
        rows_per = padded // S
        shard_valid_out = None
        offsets = None
    else:
        shard_rows = np.asarray(shard_rows, np.int64)
        if shard_rows.shape != (S,) or int(shard_rows.sum()) != n:
            raise ValueError(
                f"shard_rows {shard_rows} does not distribute {n} rows "
                f"over {S} shards")
        rows_per = max(1, int(shard_rows.max()))
        padded = rows_per * S
        shard_valid_out = shard_rows
        offsets = np.concatenate([[0], np.cumsum(shard_rows)[:-1]])

    def place(valid: np.ndarray, fill) -> np.ndarray:
        out = np.full((padded,) + valid.shape[1:], fill, valid.dtype)
        if shard_rows is None:
            out[:n] = valid
        else:
            for i in range(S):
                k = int(shard_rows[i])
                out[i * rows_per: i * rows_per + k] = \
                    valid[offsets[i]: offsets[i] + k]
        return out

    cols: Dict[str, object] = {}
    for f in dist.schema:
        a = dist.host_read_padded(f.name)
        a = a[mask] if dist.shard_valid is not None else a[:n]
        if not f.dtype.tensor:
            cols[f.name] = place(np.asarray(a, object), None)
            continue
        out = place(a, 0)
        cols[f.name] = _place(mesh, out, [rows_per] * S,
                              _dt.device_dtype(f.dtype))
    return DistributedFrame(mesh, dist.schema, cols, n,
                            shard_valid=shard_valid_out)


def _recover(exc: BaseException, dist, op: str):
    """Shrink and re-shard after a classified device loss; returns the
    replacement frame (same rows, smaller mesh)."""
    mesh = dist.mesh
    lost = lost_device_ids(exc, mesh)
    new_mesh = shrink_mesh(mesh, lost)  # raises for non-data meshes
    slots = mesh.logical_devices()
    lost_devs = {slots[i] for i in lost}
    # a grow upgrade that would re-admit the just-lost device(s) must die
    # with them, or the next op would migrate straight back onto a dead
    # device and loop shrink->grow->shrink against it
    _forget_upgrades_containing(lost_devs)
    # ...and they join the lost pool: admit_devices' default candidate
    # set, so recovery-driven growth targets genuinely lost devices first
    _lost_pool.update(lost_devs)
    # 1-axis data mesh: flat device index == data shard index, so the
    # lost shards' valid rows are exactly the data that must round-trip
    per_shard = dist.per_shard_valid()
    moved = int(sum(per_shard[i] for i in lost
                    if i < mesh.num_data_shards))
    new_dist = reshard(dist, new_mesh)
    counters.inc("mesh.devices_lost", len(lost))
    counters.inc("mesh.shrinks")
    counters.inc("mesh.reshard_rows", moved)
    gauge("mesh.active_devices", new_mesh.num_devices)
    for d in lost:
        _obs.add_event("mesh_shrink", name=op, device=int(d),
                       devices_before=mesh.num_devices,
                       devices_after=new_mesh.num_devices,
                       reshard_rows=moved)
        _flight.record("mesh.shrink", op=op, device=int(d),
                       devices_before=mesh.num_devices,
                       devices_after=new_mesh.num_devices,
                       reshard_rows=moved)
    # a device loss is one of the flight recorder's auto-dump triggers:
    # the ring right now holds the decisions that led here
    _flight.maybe_dump("device_lost")
    _log.warning(
        "%s: device loss (%s); lost device(s) %s — mesh shrunk "
        "%d -> %d shards, %d row(s) re-sharded through the host; "
        "re-running the op on the surviving devices",
        op, type(exc).__name__, lost, mesh.num_data_shards,
        new_mesh.num_data_shards, moved)
    return new_dist


# ---------------------------------------------------------------------------
# elastic mesh GROWTH (the inverse of shrink: re-admit recovered devices)
# ---------------------------------------------------------------------------

# old DeviceMesh INSTANCE (by id, held weakly) -> the grown DeviceMesh every
# frame still living on that mesh object should migrate to. Checked at the
# elastic_call dispatch boundary (_maybe_grow), which is how stream pumps
# and the serve scheduler pick up a grown mesh at their next batch/query
# boundary without holding a mesh reference themselves. Keyed by object
# identity, NOT by device set: a fresh mesh a user later builds over the
# same devices (deliberately excluding the admitted ones) must never be
# captured by an old upgrade.
_upgrade_lock = threading.Lock()
_upgrades: Dict[int, Tuple["weakref.ref", DeviceMesh]] = {}
# LogicalDevices (id AND torch.device: two meshes' slot 0 are different
# devices) dropped by elastic shrinks and not yet re-admitted: the default
# candidate set of admit_devices (the recovered-device case), so growth
# never grabs another live mesh's healthy devices while genuinely lost
# ones exist
_lost_pool: set = set()


def lost_pool() -> List[int]:
    """Logical ids of devices dropped by elastic shrinks and not yet
    re-admitted (``health()``'s mesh section reads this): non-empty means
    meshes are running shrunken and ``admit_devices`` has recovery
    candidates waiting."""
    return sorted({d.id for d in _lost_pool})


def _forget_upgrades_containing(devices: set) -> None:
    """Drop grow upgrades whose TARGET mesh includes any of these
    (just-lost) devices."""
    if not _upgrades:
        return
    with _upgrade_lock:
        for k, (ref, m) in list(_upgrades.items()):
            if ref() is None or devices & set(_mesh_key(m)):
                _upgrades.pop(k, None)


def _same_type(mesh: DeviceMesh, d) -> bool:
    """Is ``d`` a :class:`~.mesh.LogicalDevice` of the device type
    ``mesh`` runs on? Growth never mixes types: a card mesh that took a
    CPU slot would move that shard's work off the card."""
    return isinstance(d, LogicalDevice) and d.device.type in {
        x.type for x in mesh.shard_devices()}


def _probe_transfer(dev: torch.device) -> torch.Tensor:
    """The probe's tiny transfer: four int32 values onto ``dev``, the copy
    complete when this returns."""
    x = torch.arange(4, dtype=torch.int32).to(dev)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


def _start_probe(dev):
    """Launch one device probe (a tiny transfer and a warm-up ``a + 1`` on
    the device) on a daemon thread; returns ``(thread, result_dict)``. A
    probe wedged inside an unkillable transfer leaks its daemon thread:
    the price of never wedging admission itself."""
    result: Dict[str, object] = {}

    def _probe():
        try:
            target = dev.device if isinstance(dev, LogicalDevice) else dev
            x = _probe_transfer(torch.device(target))
            y = x + 1  # the warm-up dispatch on the candidate
            if y.device.type == "cuda":
                torch.cuda.synchronize(y.device)
            result["ok"] = bool(int(y[0].item()) == 1)
        except Exception as e:  # noqa: BLE001 - probing for health
            result["err"] = e

    th = threading.Thread(target=_probe, daemon=True,
                          name="tft-admit-probe")
    th.start()
    return th, result


def _probe_verdict(dev, th, result, timeout_s: float) -> bool:
    """Judge a launched probe AFTER its join: alive = hung, error =
    unhealthy, else the computed check."""
    if th.is_alive():
        _log.warning("admit probe of %r timed out after %.1fs; not "
                     "admitting it", dev, timeout_s)
        return False
    err = result.get("err")
    if err is not None:
        _log.warning("admit probe of %r failed (%s: %s); not admitting "
                     "it", dev, type(err).__name__, err)
        return False
    return bool(result.get("ok"))


def probe_device(dev, timeout_s: Optional[float] = None) -> bool:
    """The trust gate before re-admission: a tiny transfer AND a warm-up
    dispatch must complete within ``TFT_ADMIT_PROBE_TIMEOUT_S`` (default
    5 s). A device that can hold bytes but not compute must not rejoin;
    neither may one that hangs (the probe runs on a daemon thread so a
    wedged transfer cannot wedge admission: a hung probe's thread leaks
    until the process exits). ``dev`` is a :class:`~.mesh.LogicalDevice`
    or anything ``torch.device`` takes; any other object fails the probe
    (it does not raise)."""
    if timeout_s is None:
        timeout_s = env_float("TFT_ADMIT_PROBE_TIMEOUT_S", 5.0)
    th, result = _start_probe(dev)
    th.join(timeout=max(float(timeout_s), 0.0))
    return _probe_verdict(dev, th, result, timeout_s)


def grow_mesh(mesh: DeviceMesh, devices: Sequence[LogicalDevice]
              ) -> DeviceMesh:
    """The inverse of :func:`shrink_mesh`: a new data mesh over ``mesh``'s
    devices plus ``devices`` (:class:`~.mesh.LogicalDevice` objects,
    appended on the data axis; ids already in the mesh are ignored). Only
    data-only meshes grow rectangularly, and only by devices of the type
    they run on; others raise."""
    refuse_cluster(mesh, "grow_mesh")
    current = mesh.logical_devices()
    ids = {d.id for d in current}
    fresh = []
    for d in devices:
        if not isinstance(d, LogicalDevice):
            raise TypeError(
                f"grow_mesh takes LogicalDevice objects (a mesh slot's id "
                f"and device), got {d!r}")
        if not _same_type(mesh, d):
            raise ValueError(
                f"grow_mesh: {d!r} is not of the device type {mesh!r} "
                f"runs on")
        if d.id not in ids:
            ids.add(d.id)
            fresh.append(d)
    if not fresh:
        return mesh
    return _data_mesh(mesh, current + fresh, "grow")


def admit_devices(target, devices: Optional[Sequence] = None,
                  probe: bool = True):
    """Re-admit recovered (or newly arrived) devices into a mesh.

    ``target`` is a :class:`~.distributed.DistributedFrame` (returns the
    frame re-sharded over the grown mesh, in order, so row-local results
    stay bit-identical) or a :class:`~.mesh.DeviceMesh` (returns the grown
    mesh). ``devices`` defaults to the devices this process LOST to
    elastic shrinks and has not re-admitted (the recovered-device case);
    with none recorded, it widens to every visible non-member (with an
    advisory log: in a multi-mesh process pass ``devices=`` explicitly
    so another mesh's devices are not absorbed). Candidates of another
    device type than the mesh's are dropped, so a card frame's shards
    never move to the CPU. Each candidate must pass
    :func:`probe_device` (transfer and warm-up dispatch) before it is
    trusted; failures are skipped and counted
    (``mesh.admit_probe_failures``), never fatal.

    Side effects beyond the returned value:

    - the old->grown mapping is registered so every OTHER frame still on
      the old mesh migrates at its next op (``elastic_call``);
    - persistent-skew penalties recorded against the returning layout are
      cleared;
    - ``mesh.grows`` / ``mesh.devices_admitted`` count it, a ``mesh_grow``
      event lands in the active query trace, and ``mesh.active_devices``
      updates.

    No candidates (or none passing the probe) returns ``target``
    unchanged.
    """
    dist = None
    mesh = target
    refuse_cluster(getattr(target, "mesh", target), "admit_devices")
    if not isinstance(target, DeviceMesh):
        dist, mesh = target, target.mesh
    current_ids = set(mesh.flat_ids())
    if devices is None:
        # prefer devices this process actually LOST (the recovered-device
        # case): when any exist, never grab another live mesh's healthy
        # devices by default; pass devices= explicitly to widen
        devices = [d for d in sorted(_lost_pool,
                                    key=lambda d: (d.id, str(d.device)))
                   if d.id not in current_ids and _same_type(mesh, d)]
        if not devices:
            devices = [d for d in _mesh_mod.visible_logical_devices()
                       if d.id not in current_ids and _same_type(mesh, d)]
            if devices:
                _log.info(
                    "admit_devices: no recorded lost devices; defaulting "
                    "to every visible non-member (%d candidate(s)) — in a "
                    "multi-mesh process pass devices= explicitly so "
                    "another mesh's devices are not absorbed",
                    len(devices))
    else:
        other = [d for d in devices if isinstance(d, LogicalDevice)
                 and not _same_type(mesh, d)]
        if other:
            _log.warning("admit_devices: %s not of the device type %r "
                         "runs on; not admitting them", other, mesh)
        devices = [d for d in devices
                   if not (isinstance(d, LogicalDevice)
                           and (d.id in current_ids or d in other))]
    if probe and devices:
        # probes are independent: launch them all, judge them against ONE
        # shared deadline (N half-recovered candidates cost one timeout,
        # not N stacked ones)
        timeout_s = env_float("TFT_ADMIT_PROBE_TIMEOUT_S", 5.0)
        launched = [(d, *_start_probe(d)) for d in devices]
        give_up = time.monotonic() + max(float(timeout_s), 0.0)
        admitted = []
        for d, th, result in launched:
            th.join(timeout=max(0.0, give_up - time.monotonic()))
            if _probe_verdict(d, th, result, timeout_s):
                admitted.append(d)
            else:
                counters.inc("mesh.admit_probe_failures")
                _obs.add_event("admit_probe_failed",
                               device=int(getattr(d, "id", -1)))
    else:
        admitted = list(devices)
    if not admitted:
        if devices:
            _log.warning("admit_devices: none of the %d candidate "
                         "device(s) passed the probe; mesh unchanged",
                         len(devices))
        return target
    new_mesh = grow_mesh(mesh, admitted)
    added = [d for d in new_mesh.logical_devices()
             if d.id not in current_ids]
    with _tracker_lock:
        # un-do persistent-skew penalties for the returning layout: a
        # streak recorded before the device left must not trigger a
        # rebalance against data it no longer describes
        _tracker.pop(_mesh_key(mesh), None)
        _tracker.pop(_mesh_key(new_mesh), None)
    with _upgrade_lock:
        # compress chains: anything already upgrading TO this mesh OBJECT
        # now points at the grown one; prune dead refs while here
        for k, (ref, m) in list(_upgrades.items()):
            if ref() is None:
                _upgrades.pop(k, None)
            elif m is mesh:
                _upgrades[k] = (ref, new_mesh)
        _upgrades[id(mesh)] = (weakref.ref(mesh), new_mesh)
    _lost_pool.difference_update(added)
    ids = [d.id for d in added]
    counters.inc("mesh.grows")
    counters.inc("mesh.devices_admitted", len(added))
    gauge("mesh.active_devices", new_mesh.num_devices)
    _obs.add_event("mesh_grow", devices=ids,
                   devices_before=mesh.num_devices,
                   devices_after=new_mesh.num_devices)
    _flight.record("mesh.grow", devices=ids,
                   devices_before=mesh.num_devices,
                   devices_after=new_mesh.num_devices)
    _log.info("mesh grown %d -> %d device(s): admitted %s (probe + "
              "warm-up passed); frames on the old mesh migrate at their "
              "next dispatch", mesh.num_devices, new_mesh.num_devices, ids)
    if dist is None:
        return new_mesh
    return reshard(dist, new_mesh)


def _maybe_grow(op: str, dist):
    """Migrate a frame whose mesh OBJECT has a registered grow upgrade onto
    the grown mesh (an order-preserving reshard) before the op
    dispatches. Identity-keyed: only frames sharing the upgraded mesh
    instance migrate. The healthy-path cost is one dict truthiness
    check."""
    if not _upgrades:
        return dist
    with _upgrade_lock:
        ent = _upgrades.get(id(dist.mesh))
        new_mesh = ent[1] if ent is not None \
            and ent[0]() is dist.mesh else None
    if new_mesh is None:
        return dist
    try:
        out = reshard(dist, new_mesh)
    except Exception as e:  # noqa: BLE001 - growth is opportunistic
        _log.warning(
            "%s: could not migrate the frame onto the grown mesh (%s: "
            "%s); running on %r", op, type(e).__name__, e, dist.mesh)
        return dist
    counters.inc("mesh.grow_migrations")
    _obs.add_event("mesh_grow_pickup", name=op,
                   devices_after=new_mesh.num_devices)
    _log.info("%s: frame migrated onto the grown %d-device mesh at its "
              "dispatch boundary", op, new_mesh.num_devices)
    return out


# ---------------------------------------------------------------------------
# skew-adaptive repartitioning
# ---------------------------------------------------------------------------

_tracker_lock = threading.Lock()
# mesh identity (its slots' LogicalDevices, in flat order: ids alone
# repeat across meshes) -> {"hits": consecutive above-threshold
# dispatches, "times": last per-shard cost estimates}
_tracker: Dict[tuple, dict] = {}


def _mesh_key(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.logical_devices())


def _rebalance_after() -> int:
    """Consecutive skewed dispatches before acting (0 disables)."""
    return env_int("TFT_SKEW_REBALANCE_AFTER", 3)


def note_dispatch(mesh: DeviceMesh, op: str,
                  times: Sequence[float]) -> None:
    """Feed one traced dispatch's per-shard durations to the skew tracker
    (called from the d-ops' trace instrumentation: per-shard times exist
    only while tracing is on, like the skew report they power).

    ``times`` are CUMULATIVE: the duration until shard i AND every earlier
    one were done (on a card, CUDA events after each shard's work measured
    from one start event; on the CPU, the host clock; shards that share a
    device give the running maximum of their own times, as
    ``distributed._ShardClock`` says). Detection uses
    their max/median ratio, the skew report's straggler signal, with the
    same blind spot (a shard-0 straggler inflates every cumulative time
    equally; only late-shard stragglers cross the threshold). The
    REBALANCE weights must not inherit it: ``1/cumulative`` is monotone
    toward shard 0 by construction, so per-shard cost is estimated from
    the marginal increments (the extra time each shard added beyond its
    predecessor), floored at 10% of the largest increment: a shard that
    added nothing is "fast", but never more than 10x faster than the
    straggler.
    """
    n = _rebalance_after()
    if n <= 0 or len(times) < 2:
        return
    med = statistics.median(times)
    ratio = (max(times) / med) if med > 0 else 0.0
    from ..observability.report import _skew_threshold
    key = _mesh_key(mesh)
    with _tracker_lock:
        if ratio > _skew_threshold():
            incs = [float(times[0])] + [
                max(float(t) - float(p), 0.0)
                for p, t in zip(times, times[1:])]
            floor = 0.1 * max(incs)
            st = _tracker.setdefault(key, {"hits": 0, "times": None})
            st["hits"] += 1
            st["times"] = [max(i, floor) for i in incs]
            st["ratio"] = ratio
        else:  # a balanced dispatch resets the streak; dropping the entry
            # keeps the tracker EMPTY on healthy meshes, which is what
            # keeps _maybe_rebalance's fast path one dict probe
            _tracker.pop(key, None)


def _maybe_rebalance(op: str, dist):
    """Re-partition ``dist`` in proportion to observed per-shard
    throughput once the tracker says the skew is persistent."""
    if not _tracker:
        # fast path: no skew recorded on ANY mesh (one dict truthiness
        # check, no lock, no env read, no mesh key)
        return dist
    n = _rebalance_after()
    if n <= 0:
        return dist
    key = _mesh_key(dist.mesh)
    with _tracker_lock:
        st = _tracker.get(key)
        if st is None or st["hits"] < n or st["times"] is None:
            return dist
        times = st["times"]
        ratio = st.get("ratio", 0.0)
        _tracker.pop(key)  # act once per streak
    S = dist.mesh.num_data_shards
    if len(times) != S or dist.num_rows < S:
        return dist
    try:
        before = dist.per_shard_valid()
    except ValueError:
        return dist  # non-tiling global-result frames keep their layout
    # rows proportional to throughput (1/time), exact total by largest
    # remainders
    speed = np.array([1.0 / max(t, 1e-9) for t in times])
    want = speed / speed.sum() * dist.num_rows
    after = np.floor(want).astype(np.int64)
    rem = dist.num_rows - int(after.sum())
    if rem > 0:
        order = np.argsort(-(want - after))
        after[order[:rem]] += 1
    if np.array_equal(before, after):
        return dist
    new_dist = reshard(dist, dist.mesh, shard_rows=after)
    counters.inc("mesh.rebalances")
    _obs.add_event("rebalance", name=op, ratio=round(ratio, 3),
                   before=[int(v) for v in before],
                   after=[int(v) for v in after])
    from ..observability.report import _skew_threshold
    _flight.record("mesh.rebalance", op=op, ratio=round(ratio, 3),
                   threshold=_skew_threshold(), streak=n,
                   before=[int(v) for v in before],
                   after=[int(v) for v in after])
    new_dist._rebalance = {"op": op, "ratio": ratio,
                           "before": [int(v) for v in before],
                           "after": [int(v) for v in after]}
    _log.info(
        "%s: straggler ratio %.2f persisted %d dispatch(es); rows "
        "re-partitioned by observed throughput %s -> %s", op, ratio, n,
        [int(v) for v in before], [int(v) for v in after])
    return new_dist


# ---------------------------------------------------------------------------
# hot-key salting (daggregate's monoid host-key path)
# ---------------------------------------------------------------------------

def salt_fraction() -> Optional[float]:
    """The hot-key frequency threshold, or None when salting is off
    (``TFT_SALT_HOT_KEYS``, default on; ``TFT_HOT_KEY_FRACTION``,
    default 0.5 — a key is hot above HALF the rows)."""
    if not env_bool("TFT_SALT_HOT_KEYS", True):
        return None
    frac = env_float("TFT_HOT_KEY_FRACTION", 0.5)
    if frac is None or not 0.0 < frac < 1.0:
        return None
    return frac


def plan_key_salt(dist, ids_host: np.ndarray, num_groups: int,
                  n_shards: int):
    """Salt hot groups across ``n_shards`` slots.

    ``ids_host`` are the frame's padded group ids on the host (``-1`` for
    pad rows). Returns ``(salted_ids, effective_groups, (hot, K),
    fractions)`` with ``salted_ids`` on the host — or None when no group
    crosses the threshold (or the frame is too small for salting to
    matter). Row ``r`` of a hot group lands in salt slot ``r % K``; slot 0
    keeps the original group id, slots 1..K-1 map to appended table rows
    that :func:`fold_salted` folds back, so cold groups and output order
    are untouched.
    """
    frac = salt_fraction()
    if frac is None or n_shards <= 1 or num_groups <= 0:
        return None
    n = dist.num_rows
    if n < 4 * n_shards:
        return None
    valid = ids_host >= 0
    counts = np.bincount(ids_host[valid], minlength=num_groups)
    hot = np.flatnonzero(counts > frac * n)
    if hot.size == 0:
        return None
    K = n_shards
    G = num_groups
    hot_rank = np.full(G, -1, np.int64)
    hot_rank[hot] = np.arange(hot.size)
    j = np.arange(ids_host.shape[0]) % K  # even spread within each shard
    salted = ids_host.astype(np.int64, copy=True)
    m = valid & (hot_rank[np.clip(ids_host, 0, G - 1)] >= 0) & (j > 0)
    salted[m] = G + hot_rank[ids_host[m]] * (K - 1) + (j[m] - 1)
    salted = salted.astype(np.int32)
    eff = G + int(hot.size) * (K - 1)
    counters.inc("mesh.salted_keys", int(hot.size))
    _obs.add_event("key_salt", name="daggregate", count=int(hot.size),
                   salt=K, groups=[int(g) for g in hot[:16]])
    _flight.record("mesh.salt", count=int(hot.size), fraction=frac,
                   slots=K, rows=n, groups=[int(g) for g in hot[:16]])
    _log.info("daggregate: %d hot key group(s) (> %.0f%% of %d rows) "
              "salted across %d slots", hot.size, frac * 100, n, K)
    # 4th element: each hot group's observed row fraction, the hot-key
    # observation frame.hot_keys() returns
    return salted, eff, (hot, K), counts[hot] / max(n, 1)


_SALT_FOLD = {"sum": np.add, "min": np.minimum, "max": np.maximum,
              "prod": np.multiply}


def fold_salted(table, salt_map: Tuple[np.ndarray, int],
                cname: str) -> np.ndarray:
    """Fold a ``[effective_groups, ...]`` salted partial table back to
    ``[num_groups, ...]`` with the combiner's numpy twin."""
    hot, K = salt_map
    t = np.asarray(table)
    G = t.shape[0] - hot.size * (K - 1)
    base = t[:G].copy()
    if hot.size:
        extras = t[G:].reshape((hot.size, K - 1) + t.shape[1:])
        stack = np.concatenate([base[hot][:, None], extras], axis=1)
        base[hot] = _SALT_FOLD[cname].reduce(stack, axis=1)
    return base


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

_MESH_FAMILIES = (
    ("mesh.devices_lost", "tft_mesh_devices_lost_total",
     "Mesh devices lost and recovered from (elastic shrink)."),
    ("mesh.shrinks", "tft_mesh_shrinks_total",
     "Mesh shrink events (one per loss incident, any device count)."),
    ("mesh.reshard_rows", "tft_mesh_reshard_rows_total",
     "Rows re-sharded through the host by elastic recovery."),
    ("mesh.rebalances", "tft_mesh_rebalances_total",
     "Skew-adaptive repartitions applied."),
    ("mesh.salted_keys", "tft_mesh_salted_keys_total",
     "Hot key groups salted across shards by daggregate."),
    ("mesh.grows", "tft_mesh_grows_total",
     "Mesh grow events (recovered/new devices re-admitted after probe "
     "+ warm-up — the inverse of shrink)."),
    ("mesh.devices_admitted", "tft_mesh_devices_admitted_total",
     "Devices re-admitted into meshes by elastic growth."),
    ("mesh.admit_probe_failures", "tft_mesh_admit_probe_failures_total",
     "Candidate devices that failed the admission probe (transfer + "
     "warm-up dispatch) and were NOT admitted."),
    ("mesh.grow_migrations", "tft_mesh_grow_migrations_total",
     "Frames migrated onto a grown mesh at their next dispatch "
     "boundary."),
    ("mesh.dispatches", "tft_mesh_dispatches_total",
     "Mesh-op dispatches (a fused distributed plan counts ONE for its "
     "whole chain)."),
    ("mesh.interstage_host_bytes", "tft_mesh_interstage_host_bytes_total",
     "Bytes crossing device->host BETWEEN chained mesh ops (dfilter "
     "survivor counts / keep masks); zero on fused chains."),
    ("dplan.fused_forcings", "tft_dplan_fused_forcings_total",
     "Lazy distributed chains forced as one fused stage program."),
    ("dplan.fallbacks", "tft_dplan_fallbacks_total",
     "Fused mesh programs that fell back to the per-op replay."),
    ("mesh.exchange_dispatches", "tft_mesh_exchange_dispatches_total",
     "Hash-repartition exchanges dispatched (parallel/exchange.py)."),
    ("mesh.exchange_rows", "tft_mesh_exchange_rows_total",
     "Rows routed through the shuffle exchange."),
    ("mesh.exchange_bytes", "tft_mesh_exchange_bytes_total",
     "Device bytes admitted for exchange send+receive buffers."),
    ("mesh.exchange_skew_events", "tft_mesh_exchange_skew_events_total",
     "Exchanges whose partition-size imbalance crossed TFT_SKEW_WARN "
     "(flight-recorded as mesh.exchange_skew)."),
    ("mesh.shuffle_daggregates", "tft_mesh_shuffle_daggregates_total",
     "Shuffle-partitioned aggregations run."),
    ("mesh.shuffle_agg_routes", "tft_mesh_shuffle_agg_routes_total",
     "daggregate calls auto-routed to the shuffle path by the "
     "TFT_SHUFFLE_AGG_GROUPS threshold."),
)


def _render_metrics() -> List[str]:
    snap = counters.snapshot()
    lines: List[str] = []
    for key, fam, help_text in _MESH_FAMILIES:
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {snap.get(key, 0)}")
    return lines


_metrics.register_metrics_provider("mesh", _render_metrics)
