"""Block executor: run a computation on one block's columns on the device.

The port's counterpart of ``tensorframes_tpu/engine/executor.py``. One call
copies the block's input columns host->device, casts each to its device
dtype on the device (``bfloat16`` columns are f32 on the host), calls the
computation eagerly, copies the outputs device->host and casts them back to
their columns' storage dtypes.

The JAX package pads the row dim to power-of-two buckets only to bound XLA
recompiles of a program per block size. Eager PyTorch compiles nothing per
shape, so the port never pads, and :func:`default_padding_executor` is the
default executor. What the JAX package's padding contract also carried is
kept as one per-call flag: ``run(..., row_local=True)`` says that the
program is ROW-LOCAL (each output row depends on its input row only), the
property that makes padding legal there (``pad_rows and pad_ok``) and
halving legal here. ``map_rows`` and the plan's map_rows-only first stage
pass it; only such a dispatch, with at least one row, may split.

Recovery (the JAX package's, ``docs/resilience.md`` there):

- a dispatch retries transient failures under
  :func:`~..resilience.default_policy` (``retry.executor.dispatch.*``).
  Only the call of the program is retried, never the host->device copy
  of an input already enqueued;
- an out-of-memory failure (:func:`~..resilience.is_oom`: a real
  ``torch.cuda.OutOfMemoryError`` on the card) of a ``row_local`` dispatch
  re-runs the block as two halves, recursively (``oom_split.dispatches``;
  ``TFT_OOM_SPLIT=0`` disables). Anything else lets it propagate. The
  failed attempt is released first: its traceback's frames are cleared
  (an eager program's locals can be tens of GB on the card) and its
  device inputs dropped, and after a CUDA OOM the allocator's cached
  segments are freed (``torch.cuda.empty_cache()``), so the halves start
  from the memory the block started from. The halves run on the same device; with
  ``keep_device`` their device outputs are joined with ``torch.cat``, so
  a recovered block still hands back device tensors;
- :meth:`BlockExecutor.submit` never raises: a failure is recorded on the
  :class:`PendingBlock`, whose ``drain()`` re-runs the block through
  :meth:`BlockExecutor.run` (``pipeline.sync_fallbacks``), or raises a
  permanent error there. In eager PyTorch an OOM surfaces at the
  allocation, inside ``submit`` itself; a real ``torch.cuda.OutOfMemoryError``
  of a row-local submit goes straight to the split at the drain, since
  the whole block would fail again at the same size.

Fault sites: ``compile`` and ``dispatch`` and ``oom`` before each call of
the program, ``drain`` at the readback. A kernel that fails to build or
launch (:class:`~..resilience.KernelError`) is permanent: not retried, not
split, and never replaced by its plain version.

``keep_device=True`` returns the outputs as device tensors (the logical
plan chains its stages on them), and a ``torch.Tensor`` passed as an input
is used where it lies: no copy to the host and no second H2D copy.

Memory admission (``memory/manager.py``), under an active device budget
only (with none it is one global read per dispatch):

- every dispatch reserves its estimate, ``2 x`` its inputs' bytes in their
  device dtypes (outputs assumed input-sized), taken from the host arrays
  BEFORE they are copied to the device, so that a block that will split
  never holds its whole device copy while its halves run. The JAX package
  estimates after its host->device conversion and scales by its padding
  (``pad_to / n_rows``); the port never pads, so the two agree whenever a
  row-local block's rows are a power of two of at least 8;
- ``run`` reserves with the bounded wait (spill cold residents, wait for
  in-flight work, then admit over budget, loudly); a ``row_local`` block
  whose estimate alone exceeds the whole budget splits in two BEFORE
  dispatch, recursively (``memory.proactive_splits``, span
  ``executor.proactive_split``), counted apart from the reactive OOM
  split it makes unnecessary;
- ``submit`` only tries: under pressure it runs the block synchronously
  through the admitted ``run`` (``memory.sync_dispatches``) rather than
  block a stream that holds its own window. An admitted pending block
  becomes a resident ledger entry until its drain: the ledger may spill
  it, which for a block copying to pinned host buffers means waiting on
  its event and letting its device tensors go, and for a ``keep_device``
  block copying its outputs to the host and letting them go.

Not in this package yet: the compile-cache interner (``ROADMAP.md`` A3).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import traceback
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .. import dtypes as _dt
from .. import memory as _memory
from ..computation import Computation
from ..device import resolve_device
from ..observability import flight as _flight
from ..observability.events import add_event as _obs_event
from ..observability.events import current_trace as _obs_current_trace
from ..resilience import (default_policy, env_bool, faults, is_oom,
                          is_permanent)
from ..utils.logging import get_logger
from ..utils.tracing import counters, span

__all__ = ["BlockExecutor", "PendingBlock", "default_executor",
           "default_padding_executor", "to_storage_dtype", "to_device",
           "to_host"]

_log = get_logger("engine.executor")


def to_storage_dtype(a: np.ndarray, dtype: _dt.DType) -> np.ndarray:
    """Cast one host output array to its column storage dtype."""
    storage = dtype.np_storage
    if a.dtype != storage:
        return a.astype(storage)
    return a


def to_device(a, dtype: torch.dtype, device: torch.device,
              pin: bool = False) -> torch.Tensor:
    """One host column as a tensor of ``dtype`` on ``device``. The dtype
    cast runs on the device, after the copy. ``pin`` stages the copy
    through pinned host memory so that it is asynchronous. A tensor
    already on ``device`` is only cast."""
    if isinstance(a, torch.Tensor):
        t = a if a.device == device else a.to(device)
        return t if t.dtype == dtype else t.to(dtype)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a) if a.flags.writeable else a.copy()
    t = torch.from_numpy(a)
    if device.type == "cuda" and pin:
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if t.dtype == dtype else t.to(dtype)


def _host_view(t: torch.Tensor) -> torch.Tensor:
    """A device output in a dtype numpy can hold (bf16 -> f32)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (synchronous)."""
    return _host_view(t).cpu().numpy()


def _check_outputs(comp: Computation, out: Mapping) -> None:
    for spec in comp.outputs:
        v = out.get(spec.name)
        if not isinstance(v, torch.Tensor):
            raise TypeError(
                f"Computation output {spec.name!r} is "
                f"{type(v).__name__}, not a torch.Tensor")


def _row_dim(spec) -> bool:
    return spec.shape.ndim > 0 and spec.shape.head == -1


def _row_count(comp: Computation, arrays: Mapping) -> Optional[int]:
    """Leading row count of the first row-dimensioned input, if any."""
    for spec in comp.inputs:
        if _row_dim(spec):
            return int(arrays[spec.name].shape[0])
    return None


def _oom_split_enabled() -> bool:
    return env_bool("TFT_OOM_SPLIT", True)


def _released(exc: BaseException) -> BaseException:
    """``exc`` with the locals of its traceback's finished frames cleared:
    an eager program's intermediates (tens of GB on the card) would
    otherwise stay alive for as long as the exception does."""
    traceback.clear_frames(exc.__traceback__)
    return exc


def _split_rows(comp: Computation, arrays: Mapping, n_rows: int):
    """Halve the row dimension: two input mappings whose row-dimensioned
    inputs are the top / bottom halves (non-row inputs ride whole)."""
    half = n_rows // 2
    first, second = {}, {}
    for spec in comp.inputs:
        a = arrays[spec.name]
        if _row_dim(spec):
            first[spec.name] = a[:half]
            second[spec.name] = a[half:]
        else:
            first[spec.name] = a
            second[spec.name] = a
    return first, second


def _concat_outputs(comp: Computation, a: Mapping, b: Mapping):
    """Stitch two half-block results back together: host arrays with
    ``np.concatenate``, device tensors with ``torch.cat`` (on the device
    they lie on). Every output must be row-dimensioned (the row-local
    contract the split requires)."""
    out = {}
    for spec in comp.outputs:
        if not _row_dim(spec):
            raise ValueError(
                f"output {spec.name!r} has no row dimension; the OOM "
                f"split path only serves row-local computations")
        x, y = a[spec.name], b[spec.name]
        out[spec.name] = (torch.cat([x, y]) if isinstance(x, torch.Tensor)
                          else np.concatenate([x, y]))
    return out


def _oom_split_run(executor, comp: Computation, arrays: Mapping,
                   n_rows: Optional[int], cause: BaseException,
                   keep_device: bool):
    """Re-dispatch an OOM'd row-local block as two halves (recursively:
    a half that still OOMs halves again through the same path).

    The caller established row-locality and released the failed attempt
    before calling. Returns the stitched outputs, or re-raises ``cause``
    when splitting is impossible (no rows / a single row / non-row
    outputs / ``TFT_OOM_SPLIT=0``)."""
    if (not _oom_split_enabled() or not n_rows or n_rows < 2
            or any(not _row_dim(s) for s in comp.outputs)):
        raise cause
    counters.inc("oom_split.dispatches")
    # OOM forensics: the watermark of the executor's card at the moment
    # the split fired, read only while a trace listens (the untraced path
    # never reads the allocator's statistics)
    hbm: Dict = {}
    if _obs_current_trace() is not None:
        try:
            from ..observability import device as _obs_device
            wm = _obs_device.watermark(executor.resolve())
            if wm is not None:
                hbm = {"hbm_live_bytes": wm["live_bytes"],
                       "hbm_peak_bytes": wm["peak_bytes"]}
        except Exception as e:
            _log.debug("OOM watermark sample failed: %s", e)
    error = type(cause).__name__
    _obs_event("oom_split", rows=n_rows, error=error, **hbm)
    _flight.record("engine.oom_split", rows=n_rows, error=error, **hbm)
    _log.warning(
        "block dispatch ran out of memory (%s); re-dispatching as two "
        "%d/%d-row halves", (str(cause).splitlines() or [error])[0],
        n_rows // 2, n_rows - n_rows // 2)
    cuda = isinstance(cause, torch.cuda.OutOfMemoryError)
    first, second = _split_rows(comp, arrays, n_rows)
    with span("executor.oom_split"):
        out_a = _run_half(executor, comp, first, n_rows // 2, keep_device,
                          cuda)
        out_b = _run_half(executor, comp, second, n_rows - n_rows // 2,
                          keep_device, cuda)
    return _concat_outputs(comp, out_a, out_b)


def _run_half(executor, comp: Computation, arrays: Mapping, n_rows: int,
              keep_device: bool, cuda: bool):
    """One half of a split, recursing into a further split when the half
    itself still OOMs (the half's own ``run`` is not ``row_local``, so the
    split happens here, after the failed half is released).

    After a CUDA OOM (``cuda``) the allocator's cached segments are freed
    before the half copies its inputs: freed tensors stay
    cached in segments sized for the failed attempt, and a half's input
    placed inside one pins it, so the half's own tensors no longer fit
    under a memory cap (measured on the card: one more split a level)."""
    if cuda:
        torch.cuda.empty_cache()
    try:
        return executor.run(comp, arrays, keep_device=keep_device)
    except Exception as e:
        if not is_oom(e):
            raise
        cause = _released(e)
    return _oom_split_run(executor, comp, arrays, n_rows, cause,
                          keep_device)


def _dispatch_estimate(comp: Computation, arrays: Mapping) -> int:
    """Admission estimate of one dispatch's device footprint: its inputs'
    bytes in their device dtypes plus outputs assumed input-sized, 2x the
    inputs. Read from what the caller passed (host arrays or device
    tensors), before any host->device copy."""
    total = 0
    for spec in comp.inputs:
        a = arrays[spec.name]
        n = a.numel() if isinstance(a, torch.Tensor) else np.size(a)
        total += int(n) * _dt.device_dtype(spec.dtype).itemsize
    return 2 * total


def _splittable(comp: Computation, row_local: bool, n_rows) -> bool:
    """Whether the proactive pre-dispatch split is legal: the row-locality
    contract of the reactive OOM split (every output row-dimensioned, at
    least 2 rows to halve)."""
    return bool(row_local and n_rows and n_rows >= 2
                and all(_row_dim(s) for s in comp.outputs))


def _proactive_split_run(executor, comp: Computation, arrays: Mapping,
                         n_rows: int, est: int, keep_device: bool):
    """Split a block BEFORE dispatch when its admission estimate alone
    exceeds the whole device budget (the reactive ``oom_split`` would
    wait for the allocator to fail first). Counted apart
    (``memory.proactive_splits``); each half re-enters
    :meth:`BlockExecutor.run` and splits again if still over."""
    counters.inc("memory.proactive_splits")
    _obs_event("proactive_split", rows=n_rows, est_bytes=est)
    mgr = _memory.active()
    _flight.record("memory.proactive_split", rows=n_rows, bytes=est,
                   limit=mgr.limit if mgr is not None else None)
    _log.info("block of %d rows (~%d B estimated) exceeds the device "
              "budget; splitting before dispatch", n_rows, est)
    first, second = _split_rows(comp, arrays, n_rows)
    with span("executor.proactive_split"):
        out_a = executor.run(comp, first, row_local=True,
                             keep_device=keep_device)
        out_b = executor.run(comp, second, row_local=True,
                             keep_device=keep_device)
    return _concat_outputs(comp, out_a, out_b)


class PendingBlock:
    """One in-flight block: launched on the device, its outputs copying
    to pinned host buffers behind a CUDA event, or the failure its
    ``submit`` recorded.

    ``drain()`` waits on the event and returns host arrays in storage
    dtypes (or, for a ``keep_device`` submit, the device outputs, with no
    wait: the stream orders later work on them). The device inputs and
    outputs are held until then. (Pinned staging buffers come from
    PyTorch's caching host allocator, which does not hand a buffer out
    again before the copies queued on it have run.)

    The async fast path has no retry loop: a failure recorded at submit,
    or one at the readback, re-runs the block synchronously through
    :meth:`BlockExecutor.run`, and so through the retry and the OOM split
    (``pipeline.sync_fallbacks``). A real ``torch.cuda.OutOfMemoryError``
    of a row-local block skips that re-run, which would fail again at the
    same size, and splits at once (the counters are the same). A permanent
    error is raised at the drain instead, attributed to its block by the
    FIFO drain order, without a second run.

    Under a device budget an admitted pending block is a ledger entry
    (``mem_*``, the protocol of :class:`~..memory.manager.MemoryManager`)
    holding its estimate until the drain, which unregisters it first.
    A spill lets its device tensors go early and takes the drain result
    then: a block copying to pinned host buffers waits on its event,
    which it already owns, so nothing is copied twice; a ``keep_device``
    block copies its outputs to the host in their storage dtypes, and its
    drain returns those host arrays, which every consumer of a
    ``keep_device`` drain accepts. A spilled block's drain passes no
    ``drain`` fault site, as in the JAX package.
    """

    __slots__ = ("_executor", "_comp", "_arrays", "_row_local",
                 "_keep_device", "_held", "_host", "_event", "_device_out",
                 "_error", "_mem_mgr", "_mem_bytes", "_early",
                 "__weakref__")

    def __init__(self, executor, comp: Computation, arrays, row_local: bool,
                 keep_device: bool = False, held=None,
                 host: Optional[Dict[str, torch.Tensor]] = None,
                 event: Optional[torch.cuda.Event] = None,
                 device_out: Optional[Dict[str, torch.Tensor]] = None,
                 error: Optional[BaseException] = None):
        self._executor = executor
        self._comp = comp
        self._arrays = arrays
        self._row_local = row_local
        self._keep_device = keep_device
        self._held = held
        self._host = host
        self._event = event
        self._device_out = device_out
        self._error = error
        self._mem_mgr = None
        self._mem_bytes = 0
        self._early = None  # a spilled block's drain result, host arrays

    # -- memory-ledger entry protocol --------------------------------------
    def mem_name(self) -> str:
        return f"pending-block-{id(self):x}"

    def mem_is_spilled(self) -> bool:
        return self._held is None

    def mem_device_bytes(self) -> int:
        return self._mem_bytes if self._held is not None else 0

    def mem_host_bytes(self) -> int:
        return 0  # a spilled pending IS its drain result; never faults

    def mem_fault(self) -> int:
        return 0

    def mem_spill(self) -> int:
        """Let the device tensors go before the drain (called under the
        ledger lock, so it cannot race :meth:`drain`, which unregisters
        first): the block's drain result is taken now, in host arrays. A
        failure is recorded for the drain's recovery."""
        if self._held is None or self._error is not None:
            return 0
        try:
            if self._keep_device:
                self._early = {
                    s.name: to_storage_dtype(to_host(self._device_out[s.name]),
                                             s.dtype)
                    for s in self._comp.outputs}
            else:
                if self._event is not None:
                    self._event.synchronize()
                self._early = {
                    s.name: to_storage_dtype(self._host[s.name].numpy(),
                                             s.dtype)
                    for s in self._comp.outputs}
        except Exception as e:
            self._error = _released(e)
        self._held = self._device_out = self._event = None
        freed, self._mem_bytes = self._mem_bytes, 0
        return freed

    def _drop(self) -> None:
        self._held = self._host = self._event = self._device_out = None
        self._early = None

    def _result(self) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
        if self._early is not None:
            return self._early  # spilled: the drain result is in hand
        faults.check("drain")
        if self._keep_device:
            return self._device_out
        if self._event is not None:
            self._event.synchronize()
        return {spec.name: to_storage_dtype(self._host[spec.name].numpy(),
                                            spec.dtype)
                for spec in self._comp.outputs}

    def drain(self) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
        m = self._mem_mgr
        if m is not None:
            # unregister FIRST (under the ledger lock): after this no
            # concurrent spill can touch the block's buffers
            self._mem_mgr = None
            m.drop(self)
        if self._error is None:
            try:
                out = self._result()
            except Exception as e:
                self._error = _released(e)
            else:
                self._drop()
                return out
        self._drop()  # the failed attempt's device buffers go first
        error, self._error = self._error, None
        if is_permanent(error):
            # a deterministic failure re-runs identically: raise it here
            # (serial semantics) instead of paying a duplicate run and a
            # bogus recovery count
            raise error
        counters.inc("pipeline.sync_fallbacks")
        _obs_event("sync_fallback", error=type(error).__name__,
                   padded=False)
        _flight.record("pipeline.sync_fallback",
                       error=type(error).__name__, padded=False)
        _log.warning(
            "async fast path failed for a block (%s); re-running it "
            "synchronously through the resilient path", type(error).__name__)
        if self._row_local and isinstance(error, torch.cuda.OutOfMemoryError):
            return _oom_split_run(self._executor, self._comp, self._arrays,
                                  _row_count(self._comp, self._arrays),
                                  error, self._keep_device)
        return self._executor.run(self._comp, self._arrays,
                                  row_local=self._row_local,
                                  keep_device=self._keep_device)


class BlockExecutor:
    """Executes :class:`Computation`\\ s on columnar blocks on one device.

    ``device``: ``"cuda"``, ``"cuda:N"`` or ``"cpu"``; ``None`` follows the
    package default (:func:`~tensorframes_tpu_torch.set_default_device`),
    which is ``cuda``. Without a GPU a CUDA device raises at the first
    dispatch.

    A call's ``row_local`` says that its program is row-local, so that an
    OOM'd dispatch may split (see the module docstring).
    """

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = device

    def resolve(self) -> torch.device:
        return resolve_device(self.device)

    def _inputs(self, comp: Computation, arrays: Mapping, device,
                pin: bool) -> Dict[str, torch.Tensor]:
        # the convert span times host->device work; inputs that are all
        # device tensors already (a later plan stage) open none
        resident = all(isinstance(arrays[s.name], torch.Tensor)
                       for s in comp.inputs)
        with contextlib.nullcontext() if resident \
                else span("executor.convert"):
            return {s.name: to_device(arrays[s.name],
                                      _dt.device_dtype(s.dtype), device,
                                      pin=pin)
                    for s in comp.inputs}

    def _call(self, comp: Computation, dev: Mapping) -> Dict[str, torch.Tensor]:
        faults.check("compile")
        faults.check("dispatch")
        faults.check("oom")
        with span("executor.dispatch"), torch.no_grad():
            out = comp.fn(dev)
        _check_outputs(comp, out)
        return out

    def _dispatch(self, comp: Computation,
                  dev: Mapping) -> Dict[str, torch.Tensor]:
        """One call of the program, transient failures retried under the
        process policy (the inputs are already on the device). A
        ``partial``, not a closure: a traceback's frame keeps its function,
        and a closure's cell would keep ``dev`` past ``_released``."""
        return default_policy().call(functools.partial(self._call, comp, dev),
                                     op="executor.dispatch")

    def run(self, comp: Computation, arrays: Mapping[str, np.ndarray],
            row_local: bool = False, keep_device: bool = False
            ) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
        """Run a computation on host arrays (or device tensors); returns
        host arrays in the outputs' storage dtypes, or with
        ``keep_device`` the device outputs. Transient failures retry; an
        OOM of a ``row_local`` dispatch splits the block in two. Under a
        device budget the dispatch is admitted first, and a ``row_local``
        block over the whole budget splits before it dispatches."""
        device = self.resolve()
        mgr = _memory.active()
        mem_tok = 0
        if mgr is not None:
            est = _dispatch_estimate(comp, arrays)
            n_rows = _row_count(comp, arrays)
            if mgr.would_overflow(est) and _splittable(comp, row_local,
                                                       n_rows):
                return _proactive_split_run(self, comp, arrays, n_rows, est,
                                            keep_device)
            mem_tok = mgr.reserve(est, op="executor.run")
        try:
            dev = self._inputs(comp, arrays, device, pin=False)
            n_rows = _row_count(comp, dev)
            try:
                out = self._dispatch(comp, dev)
            except Exception as e:
                if not (row_local and n_rows and is_oom(e)):
                    raise
                cause = _released(e)
            else:
                if keep_device:
                    return {s.name: out[s.name] for s in comp.outputs}
                with span("executor.convert_back"):
                    return {s.name: to_storage_dtype(to_host(out[s.name]),
                                                     s.dtype)
                            for s in comp.outputs}
            dev = None  # the halves copy their own rows
            return _oom_split_run(self, comp, arrays, n_rows, cause,
                                  keep_device)
        finally:
            if mem_tok:
                mgr.release(mem_tok)

    def submit(self, comp: Computation, arrays: Mapping[str, np.ndarray],
               row_local: bool = False, keep_device: bool = False):
        """Asynchronous half of :meth:`run`: pinned non-blocking H2D
        copies, the launch, and non-blocking D2H copies into pinned
        buffers, with no host wait and no retry loop. With ``keep_device``
        the outputs stay on the device and ``drain()`` returns them. On
        the CPU it runs synchronously.

        Never raises: a failure (a fault, a device OOM at an allocation)
        is recorded on the returned :class:`PendingBlock`, released of its
        frames so that it pins no device memory until the drain, whose
        ``drain()`` recovers it through :meth:`run`.

        Under a device budget the block is admitted without waiting: when
        the ledger cannot make room it runs synchronously through the
        admitted :meth:`run` instead (``memory.sync_dispatches``) and
        comes back as a finished ``ReadyResult``."""
        try:
            return self._submit(comp, arrays, row_local, keep_device)
        except Exception as e:
            error = e
        # outside the handler: the frames below this one have finished and
        # their locals (the failed attempt's tensors) are cleared
        return PendingBlock(self, comp, arrays, row_local, keep_device,
                            error=_released(error))

    def _submit(self, comp: Computation, arrays: Mapping, row_local: bool,
                keep_device: bool):
        device = self.resolve()
        mgr = _memory.active()
        if mgr is None:
            return self._launch(comp, arrays, row_local, keep_device, device)
        est = _dispatch_estimate(comp, arrays)
        tok = mgr.try_reserve(est, op="executor.submit")
        if tok is None:
            # pressure: the async fast path never blocks (a stream waiting
            # here while holding its own window could deadlock the
            # budget); the admitted run may wait, spill or split
            counters.inc("memory.sync_dispatches")
            _obs_event("mem_sync_dispatch", rows=_row_count(comp, arrays),
                       est_bytes=est)
            from .pipeline import ReadyResult
            return ReadyResult(self.run(comp, arrays, row_local=row_local,
                                        keep_device=keep_device))
        try:
            pending = self._launch(comp, arrays, row_local, keep_device,
                                   device)
        except BaseException:
            mgr.release(tok)
            raise
        # the reservation becomes a resident ledger entry: while the block
        # sits in the window its device buffers are a spill candidate
        pending._mem_mgr = mgr
        pending._mem_bytes = est
        mgr.convert_reservation(tok, pending)
        return pending

    def _launch(self, comp: Computation, arrays: Mapping, row_local: bool,
                keep_device: bool, device: torch.device) -> PendingBlock:
        cuda = device.type == "cuda"
        dev = self._inputs(comp, arrays, device, pin=cuda)
        out = self._call(comp, dev)
        if keep_device:
            return PendingBlock(self, comp, arrays, row_local, True,
                                held=dev,
                                device_out={s.name: out[s.name]
                                            for s in comp.outputs})
        host = {}
        for spec in comp.outputs:
            t = _host_view(out[spec.name])
            if cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t
            host[spec.name] = h
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return PendingBlock(self, comp, arrays, row_local, False,
                            held=(dev, out), host=host, event=event)


_default: Optional[BlockExecutor] = None
_default_lock = threading.Lock()


def default_executor() -> BlockExecutor:
    """The process-default executor, on the package default device."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = BlockExecutor()
    return _default


def default_padding_executor() -> BlockExecutor:
    """The executor ``map_rows`` uses. The JAX package pads rows to
    power-of-two buckets here to bound XLA recompiles; eager PyTorch needs
    no buckets, so this is the plain default executor (``map_rows`` says
    its dispatches are row-local per call, ``row_local=True``)."""
    return default_executor()
