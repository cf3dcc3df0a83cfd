"""Computation capture: named-tensor programs with inferred output specs.

The port's counterpart of ``tensorframes_tpu/computation.py``. A user
computation is a plain PyTorch function over named tensors that returns a
dict of named tensors (or one tensor, named after the function). Capture
infers each output's dtype and shape **without running it on data**:

- the callable is evaluated twice on ``device="meta"`` tensors, once with
  every Unknown input dim set to one probe size and once to another (61 and
  67 for the shared row dim). An output dim that changes between the two
  probes is ``Unknown``; one that stays put is static, so a static dim that
  happens to equal a probe size is not misread;
- a third, small probe sets every Unknown dim to 2. A dim clamped by the
  row count (``v[:61]`` is ``min(rows, 61)``) is the same at 61 and 67
  rows but not at 2, so it is ``Unknown`` too, as the JAX package's
  symbolic shapes have it. A program that cannot run at that size, or
  changes rank there, leaves the two large probes to decide;
- when a meta probe fails (an op with no meta kernel, or a program that
  mixes its inputs with tensors it closes over, such as a model's weights
  on the GPU), the same probes run on fake tensors
  (``FakeTensorMode(allow_non_fake_inputs=True)``): closed-over tensors
  become fake too and nothing runs. Fake inputs lie on the CPU first and
  then, when the package's default device is a CUDA device, on that
  device, since an op such as ``mm`` refuses to mix a CPU input with a
  closed-over CUDA tensor even when both are fake;
- when an output shape depends on the data (``x[x > 0]``), or an op has no
  fake kernel either, capture falls back to the same probes run for real
  on small CPU tensors of ones.

Outputs are sorted by name, the engine's output-column ordering contract.

Serialization (:meth:`Computation.serialize`) is the port's counterpart of
the JAX package's StableHLO blob: a header of specs and a ``torch.export``
archive of the program traced with one symbolic row dim (``Dim("_n")``)
shared by every input's leading Unknown dim. The archive is traced on the
CPU and holds its constants there; a deserialized program is placed on the
device of the tensors it is called with (``move_to_device_pass`` over a
fresh load of the archive), one placed module per device, cached on the
program, so one blob runs on the CPU and on the card whichever device it
was made on. ``deserialize`` loads the archive once and raises
``ValueError`` on a corrupt one; a call checks each input's rank, dtype
and fixed dims against the header's specs and raises the JAX package's
``ValueError`` (``Rank mismatch for args[0]: ...``). The JAX package's
blob raises at 0 rows; the port's runs there (the engine never calls a
program on an empty block in either).
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import struct
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from . import dtypes as _dt
from .shape import Shape, Unknown
from .utils.tracing import histograms, span

__all__ = [
    "TensorSpec",
    "GraphNodeSummary",
    "Computation",
    "analyze_graph",
]

# the port's blob starts with its own magic; the JAX package's blob (a
# StableHLO module) starts with ``_JAX_MAGIC`` and is refused by name
_MAGIC = b"TFTORCH1\x00"
_JAX_MAGIC = b"TFTPU1\x00"
# a bare ``torch.export.save`` archive (a zip file)
ARCHIVE_MAGIC = b"PK\x03\x04"

# probe sizes for Unknown dims: (first probe, second probe). The shared row
# dim takes the first pair, every other Unknown dim the next free pair.
_PROBES = ((61, 67), (71, 73), (79, 83), (89, 97), (101, 103), (107, 109))
# the small probe's size for every Unknown dim
_SMALL_PROBE = 2


@dataclass(frozen=True)
class TensorSpec:
    """Name + dtype + (possibly unknown) shape of a computation input/output."""

    name: str
    dtype: _dt.DType
    shape: Shape

    def __repr__(self):
        return f"{self.name}:{self.dtype.name}{self.shape!r}"

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype.name,
                "shape": list(self.shape.dims)}

    @staticmethod
    def from_json(d: dict) -> "TensorSpec":
        return TensorSpec(d["name"], _dt.by_name(d["dtype"]),
                          Shape(tuple(d["shape"])))


@dataclass(frozen=True)
class GraphNodeSummary:
    """Summary of one computation endpoint."""

    name: str
    is_input: bool
    is_output: bool
    dtype: _dt.DType
    shape: Shape

    def __repr__(self):
        kind = "input" if self.is_input else "output"
        return f"[{kind}] {self.name} {self.dtype.name}{self.shape!r}"


def _output_framework_dtype(dtype: torch.dtype,
                            input_specs: Sequence[TensorSpec]) -> _dt.DType:
    """Map an output's device dtype back to a framework dtype: if some
    input's device dtype equals the output's, the output inherits the
    widest such input's framework dtype; otherwise the direct mapping
    applies (the JAX package's rule)."""
    cand = None
    for s in input_specs:
        if _dt.device_dtype(s.dtype) == dtype:
            if cand is None or s.dtype.priority > cand.priority:
                cand = s.dtype
    if cand is not None:
        return cand
    dt = _dt.from_torch(dtype)
    if not dt.tensor:
        raise ValueError(
            f"Computation outputs must be numeric tensors, got {dt.name}")
    return dt


class Computation:
    """A captured tensor program: ordered named inputs -> named outputs.

    Outputs are canonically **sorted by name**.
    """

    # the deserialized programs this computation calls (its own for a
    # deserialized computation; a wrapper's are those of what it wraps):
    # the executor places each on its device before the first dispatch
    _tft_programs: Tuple["_Program", ...] = ()

    def __init__(self, fn: Callable, inputs: Sequence[TensorSpec],
                 outputs: Sequence[TensorSpec]):
        self._fn = fn  # dict[str, Tensor] -> dict[str, Tensor]
        self.inputs: Tuple[TensorSpec, ...] = tuple(inputs)
        self.outputs: Tuple[TensorSpec, ...] = tuple(
            sorted(outputs, key=lambda s: s.name))
        self._input_index = {s.name: s for s in self.inputs}
        self._output_index = {s.name: s for s in self.outputs}

    # -- access ------------------------------------------------------------
    @property
    def input_names(self) -> List[str]:
        return [s.name for s in self.inputs]

    @property
    def output_names(self) -> List[str]:
        return [s.name for s in self.outputs]

    def input(self, name: str) -> TensorSpec:
        return self._input_index[name]

    def output(self, name: str) -> TensorSpec:
        return self._output_index[name]

    def __call__(self, arrays: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        missing = [n for n in self.input_names if n not in arrays]
        if missing:
            raise ValueError(f"Missing computation inputs: {missing}")
        return dict(self._fn({n: arrays[n] for n in self.input_names}))

    @property
    def fn(self) -> Callable:
        """The raw dict->dict callable over tensors."""
        return self._fn

    def __repr__(self):
        ins = ", ".join(map(repr, self.inputs))
        outs = ", ".join(map(repr, self.outputs))
        return f"Computation({ins} -> {outs})"

    # -- construction ------------------------------------------------------
    @staticmethod
    def trace(fn: Callable,
              input_specs: Mapping[str, Tuple[_dt.DType, Shape]] | Sequence[TensorSpec],
              output_shapes: Optional[Mapping[str, Shape]] = None,
              share_lead_symbol: bool = True,
              takes_dict: Optional[bool] = None) -> "Computation":
        """Capture a Python function as a Computation.

        ``fn`` takes named tensors (one kw/positional arg per input, in
        signature order, or a single dict argument) and returns a dict of
        named outputs (a single tensor return is named after the function).
        Output specs are inferred by probing (see the module docstring);
        ``output_shapes`` are optional hints used where probing leaves a
        dim Unknown.
        """
        if isinstance(input_specs, Mapping):
            specs = [TensorSpec(n, dt, sh) for n, (dt, sh) in input_specs.items()]
        else:
            specs = list(input_specs)

        if takes_dict is None:
            takes_dict = _fn_takes_dict(fn, len(specs))
        kw_only = _keyword_only_names(fn)

        def dict_fn(d: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            if takes_dict:
                out = fn(dict(d))
            else:
                args = [d[s.name] for s in specs if s.name not in kw_only]
                kwargs = {s.name: d[s.name] for s in specs
                          if s.name in kw_only}
                out = fn(*args, **kwargs)
            if not isinstance(out, Mapping):
                name = getattr(fn, "__name__", "output")
                if name == "<lambda>":
                    name = "output"
                out = {name: out}
            device = next((v.device for v in d.values()
                           if isinstance(v, torch.Tensor)), None)
            return {k: v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(v, device=device)
                    for k, v in out.items()}

        t0 = time.perf_counter()
        with span("computation.capture"):
            out_specs = _infer_outputs(dict_fn, specs, share_lead_symbol,
                                       output_shapes)
        # what the port pays for a new program: capture's probes (the
        # performance sentinel's compile_s component reads this family)
        histograms.observe("compile_seconds", time.perf_counter() - t0,
                           engine="torch")
        return Computation(dict_fn, specs, out_specs)

    # -- serialization (torch.export) ---------------------------------------
    def serialize(self) -> bytes:
        """Serialize to bytes any host can run without the Python that
        wrote the program: the magic, a little-endian u32 header length, a
        JSON header (``inputs``/``outputs`` as :meth:`TensorSpec.to_json`
        gives them, and a ``torch`` section with the torch version, the
        traced argument dtypes and the row dim's range) and the
        ``torch.export.save`` archive of the program traced with one
        symbolic row dim. A deserialized computation returns its own
        bytes."""
        blob = getattr(self, "_tft_blob", None)
        if blob is not None:
            return blob
        ep = export_program(self)
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        archive = buf.getvalue()
        header = json.dumps({
            "inputs": [s.to_json() for s in self.inputs],
            "outputs": [s.to_json() for s in self.outputs],
            "torch": {
                "version": torch.__version__,
                "arg_dtypes": [str(_dt.device_dtype(s.dtype)).split(".")[-1]
                               for s in self.inputs],
                "rows": _row_range(ep),
                "archive_len": len(archive),
            },
        }).encode("utf-8")
        return _MAGIC + struct.pack("<I", len(header)) + header + archive

    @staticmethod
    def deserialize(data: bytes) -> "Computation":
        """The computation :meth:`serialize` wrote. Output specs come from
        the header; the program is placed on a device at its first call
        there."""
        data = bytes(data)
        if data.startswith(_JAX_MAGIC):
            raise ValueError(
                "This blob was serialized by the JAX package (tensorframes_"
                "tpu): it holds a StableHLO module, which this package "
                "cannot run; serialize the program with tensorframes_tpu_"
                "torch's Computation.serialize")
        if not data.startswith(_MAGIC):
            raise ValueError("Not a serialized tensorframes-tpu computation")
        off = len(_MAGIC)
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        header = json.loads(data[off:off + hlen].decode("utf-8"))
        inputs = [TensorSpec.from_json(d) for d in header["inputs"]]
        outputs = [TensorSpec.from_json(d) for d in header["outputs"]]
        prog = _Program(data[off + hlen:], inputs, outputs)
        try:
            prog.exported
        except Exception as e:  # noqa: BLE001 - any parse failure is a bad blob
            raise ValueError(
                f"Corrupt serialized computation: its torch.export archive "
                f"does not load ({type(e).__name__}: {e})") from e
        comp = prog.computation()
        comp._tft_blob = data
        return comp

    @staticmethod
    def from_stablehlo(module, inputs: Sequence[TensorSpec],
                       outputs: Optional[Sequence[TensorSpec]] = None,
                       platforms: Optional[Sequence[str]] = None
                       ) -> "Computation":
        """The JAX package's door for a bare StableHLO module, which this
        package cannot run."""
        raise NotImplementedError(
            "A StableHLO module cannot run in tensorframes_tpu_torch; import "
            "a program exported by torch.export with "
            "Computation.from_exported")

    @staticmethod
    def from_exported(ep, inputs: Sequence[TensorSpec],
                      outputs: Optional[Sequence[TensorSpec]] = None
                      ) -> "Computation":
        """Import a program exported by other means: an
        ``ExportedProgram`` or the bytes of its ``torch.export.save``
        archive, called with the inputs positionally in ``inputs`` order.
        ``outputs=None`` reads the output specs from the graph's output
        metadata: named by the keys of a dict result, else ``out_0``,
        ``out_1``, ... in result order."""
        if isinstance(ep, (bytes, bytearray, memoryview)):
            archive = bytes(ep)
            ep = _load_archive(archive)
        else:
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            archive = buf.getvalue()
        inputs = list(inputs)
        if outputs is None:
            outputs = _exported_outputs(ep, inputs)
        return _Program(archive, inputs, list(outputs)).computation()


def _keyword_only_names(fn: Callable) -> frozenset:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return frozenset()
    return frozenset(p.name for p in sig.parameters.values()
                     if p.kind == p.KEYWORD_ONLY)


def _fn_takes_dict(fn: Callable, n_inputs: int) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = [p for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    has_varargs = any(p.kind == p.VAR_POSITIONAL
                      for p in sig.parameters.values())
    if has_varargs:
        return False
    return len(params) == 1 and n_inputs != 1


def _probe_dims(specs: Sequence[TensorSpec], share_lead_symbol: bool
                ) -> Tuple[List[Tuple[int, ...]], ...]:
    """Concrete input shapes for the three probes: every Unknown dim takes
    a probe pair (all leading Unknown dims share the first pair when
    ``share_lead_symbol``: the rows of one block are one quantity) and
    ``_SMALL_PROBE`` in the third probe."""
    fresh = 1 if share_lead_symbol else 0
    first, second, small = [], [], []
    for spec in specs:
        a, b = [], []
        for i, d in enumerate(spec.shape.dims):
            if d != Unknown:
                a.append(d)
                b.append(d)
                continue
            if i == 0 and share_lead_symbol:
                pa, pb = _PROBES[0]
            else:
                pa, pb = _PROBES[fresh % len(_PROBES)]
                fresh += 1
            a.append(pa)
            b.append(pb)
        first.append(tuple(a))
        second.append(tuple(b))
        small.append(tuple(_SMALL_PROBE if d == Unknown else d
                           for d in spec.shape.dims))
    return first, second, small


def _sym_shapes(specs: Sequence[TensorSpec], share_lead_symbol: bool):
    """Example input shapes and ``torch.export`` dynamic shapes for the
    input specs, the counterpart of the JAX package's ``_sym_avals``: every
    Unknown leading dim shares one ``Dim("_n")`` when ``share_lead_symbol``
    (the rows of one block are one quantity), every other Unknown dim gets
    a fresh ``Dim``. The examples are the first probe's sizes
    (:func:`_probe_dims`), none of them 0 or 1, which export would
    specialize."""
    examples = _probe_dims(specs, share_lead_symbol)[0]
    lead = None
    fresh = 0
    dynamic = []
    for spec in specs:
        dims = {}
        for i, d in enumerate(spec.shape.dims):
            if d != Unknown:
                continue
            if i == 0 and share_lead_symbol:
                if lead is None:
                    lead = torch.export.Dim("_n")
                dims[i] = lead
            else:
                dims[i] = torch.export.Dim(f"_d{fresh}")
                fresh += 1
        dynamic.append(dims or None)
    return examples, dynamic


class _Flat(torch.nn.Module):
    """A dict-in, dict-out program as a module whose ``forward`` takes the
    inputs positionally, in ``names`` order."""

    def __init__(self, fn: Callable, names: Sequence[str]):
        super().__init__()
        self.fn = fn
        self.names = tuple(names)

    def forward(self, *args):
        return self.fn(dict(zip(self.names, args)))


# torch.fx's tracing state is process-wide (its patcher,
# ``torch.fx._symbolic_trace.CURRENT_PATCHER``): two traces from two
# threads at once (the serving scheduler's workers interning programs or
# extracting a filter's atoms, a submit taking a fingerprint) fail each
# other, so every ``torch.export`` and ``make_fx`` runs under this lock
_EXPORT_LOCK = threading.RLock()


def export_program(comp: Computation):
    """``torch.export`` of ``comp`` under :func:`_sym_shapes`, traced with
    fake tensors on the CPU. A program that closes over tensors on the
    package's CUDA device is traced there instead and its constants moved
    to the CPU, so that the archive never names a card. One export at a
    time in the process (``_EXPORT_LOCK``)."""
    with _EXPORT_LOCK:
        return _export_program(comp)


def _export_program(comp: Computation):
    examples, dynamic = _sym_shapes(comp.inputs, share_lead_symbol=True)

    def trace(where):
        args = tuple(torch.zeros(sh, dtype=_dt.device_dtype(s.dtype),
                                 device=where)
                     for s, sh in zip(comp.inputs, examples))
        dyn = (tuple(dynamic),) if any(d is not None for d in dynamic) \
            else None
        with torch.no_grad():
            return torch.export.export(_Flat(comp.fn, comp.input_names),
                                       args, dynamic_shapes=dyn,
                                       strict=False)

    try:
        return trace("cpu")
    except Exception:
        from .device import default_device
        where = default_device()
        if where.type != "cuda":
            raise
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(trace(where), "cpu")


def _row_range(ep) -> Optional[List[Optional[int]]]:
    """``[lo, hi]`` of the exported program's row dim (``hi`` ``None`` when
    unbounded), or ``None`` when no input has a symbolic leading dim."""
    users = set(ep.graph_signature.user_inputs)
    for node in ep.graph.nodes:
        val = node.meta.get("val")
        if node.op != "placeholder" or node.name not in users \
                or val is None or val.ndim == 0 \
                or not isinstance(val.shape[0], torch.SymInt):
            continue
        vr = ep.range_constraints.get(val.shape[0].node.expr)
        if vr is None:
            return None
        hi = vr.upper
        return [int(vr.lower), int(hi) if hi.is_Integer else None]
    return None


def _exported_outputs(ep, inputs: Sequence[TensorSpec]) -> List[TensorSpec]:
    """Output specs read from an exported graph's output metadata, as the
    JAX package reads a bare module's results."""
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    vals = [a.meta.get("val") for a in out_node.args[0]]
    n_user = len(ep.graph_signature.user_outputs)
    vals = vals[len(vals) - n_user:]
    spec = ep.call_spec.out_spec
    if spec is not None and spec.type is dict and \
            len(spec.context) == len(vals):
        names = [str(k) for k in spec.context]
    else:
        names = [f"out_{i}" for i in range(len(vals))]
    out = []
    for name, v in zip(names, vals):
        if not isinstance(v, torch.Tensor):
            raise ValueError(
                f"exported result {name!r} is not a tensor; pass explicit "
                f"output specs to from_exported")
        shape = Shape(tuple(d if isinstance(d, int) else Unknown
                            for d in v.shape))
        out.append(TensorSpec(name, _output_framework_dtype(v.dtype, inputs),
                              shape))
    return out


def _load_archive(archive: bytes):
    """``torch.export.load`` of an archive's bytes. Its tensors are read
    through ``torch.frombuffer`` over immutable bytes; an exported graph
    is functional and never writes them, so the warning that they are
    not writable is dropped."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="The given buffer is not writable")
        return torch.export.load(io.BytesIO(archive))


class _Program:
    """A ``torch.export`` archive and its placed modules, one per device.

    Placing loads the archive afresh and moves the copy's constants and
    the devices its graph names to the device (``move_to_device_pass``
    moves a program in place), so every placement starts from the bytes.
    A program that cannot be placed on a device raises."""

    def __init__(self, archive: bytes, inputs: Sequence[TensorSpec],
                 outputs: Sequence[TensorSpec]):
        self.archive = archive
        self.input_names = [s.name for s in inputs]
        self.output_names = [s.name for s in outputs]
        self.inputs, self.outputs = list(inputs), list(outputs)
        self._placed: Dict[str, torch.nn.Module] = {}
        self._lock = threading.Lock()
        self._ep = None

    @property
    def exported(self):
        """The archive's program as loaded (its constants on the CPU)."""
        if self._ep is None:
            self._ep = _load_archive(self.archive)
        return self._ep

    def place(self, device) -> torch.nn.Module:
        key = str(torch.device(device))
        mod = self._placed.get(key)
        if mod is None:
            with self._lock:
                mod = self._placed.get(key)
                if mod is None:
                    from torch.export.passes import move_to_device_pass
                    mod = move_to_device_pass(_load_archive(self.archive),
                                              key).module()
                    self._placed[key] = mod
        return mod

    def _check_args(self, args: Sequence[torch.Tensor]) -> None:
        """Each argument's rank, dtype and fixed dims against the program's
        signature, in the JAX package's order and wording (a placed
        ``ExportedProgram`` module checks neither dtype nor rank)."""
        fresh = 0
        for i, (spec, a) in enumerate(zip(self.inputs, args)):
            names = []
            for j, d in enumerate(spec.shape.dims):
                if d != Unknown:
                    names.append(str(d))
                elif j == 0:
                    names.append("_n")
                else:
                    names.append(f"_d{fresh}")
                    fresh += 1
            expected = "(" + ", ".join(names) + \
                ("," if len(names) == 1 else "") + ")"
            got = tuple(a.shape)
            if a.ndim != len(names):
                raise ValueError(
                    f"Rank mismatch for args[{i}]: expected {expected} and "
                    f"called with {got}")
            want = _dt.device_dtype(spec.dtype)
            if a.dtype != want:
                raise ValueError(
                    f"Dtype mismatch for args[{i}]: expected "
                    f"{str(want).split('.')[-1]} and called with "
                    f"{str(a.dtype).split('.')[-1]}")
            for j, d in enumerate(spec.shape.dims):
                if d != Unknown and got[j] != d:
                    raise ValueError(
                        f"Shape mismatch for args[{i}].shape[{j}] (expected "
                        f"same constant): expected {expected} and called "
                        f"with {got}")

    def __call__(self, d: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        args = [v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                for v in (d[n] for n in self.input_names)]
        self._check_args(args)
        device = args[0].device if args else torch.device("cpu")
        res = self.place(device)(*args)
        if isinstance(res, Mapping):
            return dict(res)
        if isinstance(res, (list, tuple)):
            return dict(zip(self.output_names, res))
        return {self.output_names[0]: res}

    def computation(self) -> Computation:
        comp = Computation(self, self.inputs, self.outputs)
        comp._tft_programs = (self,)
        return comp


def _run_probe(dict_fn: Callable, specs: Sequence[TensorSpec],
               shapes: Sequence[Tuple[int, ...]], device: str
               ) -> Dict[str, torch.Tensor]:
    """One probe on ``meta``, ``fake`` (CPU fake tensors), ``fake:<device>``
    (fake tensors on that device) or real ``cpu`` tensors of ones."""
    fake = device.startswith("fake")
    make = torch.ones if device == "cpu" else torch.empty
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    where = (device.partition(":")[2] or "cpu") if fake else device
    with mode, torch.no_grad():
        feeds = {s.name: make(sh, dtype=_dt.device_dtype(s.dtype),
                              device=where)
                 for s, sh in zip(specs, shapes)}
        return dict_fn(feeds)


def _run_probes(dict_fn: Callable, specs: Sequence[TensorSpec],
                probes: Sequence[Sequence[Tuple[int, ...]]], device: str
                ) -> List[Dict[str, torch.Tensor]]:
    return [_run_probe(dict_fn, specs, shapes, device) for shapes in probes]


def _infer_outputs(dict_fn: Callable, specs: Sequence[TensorSpec],
                   share_lead_symbol: bool,
                   output_shapes: Optional[Mapping[str, Shape]]) -> List[TensorSpec]:
    """Output specs from the probes on meta tensors, else on fake tensors,
    else on small real CPU tensors (see the module docstring). A failure
    of a large real probe is an error of the computation; a failure of the
    small one only drops it."""
    first, second, small = _probe_dims(specs, share_lead_symbol)
    from .device import default_device
    kinds = ["meta", "fake"]
    if default_device().type == "cuda":
        kinds.append(f"fake:{default_device()}")
    for device in kinds + ["cpu"]:
        try:
            out_a, out_b = _run_probes(dict_fn, specs, (first, second),
                                       device)
            break
        except Exception:  # noqa: BLE001 - the next kind of probe decides
            if device == "cpu":
                raise
    try:
        out_s = _run_probe(dict_fn, specs, small, device)
    except Exception:  # noqa: BLE001 - a program may need more rows than 2
        out_s = {}
    out_specs = []
    for name in sorted(out_a):
        ta, tb = out_a[name], out_b[name]
        if ta.ndim != tb.ndim:
            raise ValueError(
                f"Output {name!r}: rank depends on the input sizes "
                f"({tuple(ta.shape)} vs {tuple(tb.shape)})")
        ts = out_s.get(name)
        sizes = [ta.shape, tb.shape]
        if isinstance(ts, torch.Tensor) and ts.ndim == ta.ndim:
            sizes.append(ts.shape)
        sh = Shape(tuple(dims[0] if len(set(dims)) == 1 else Unknown
                         for dims in zip(*sizes)))
        if output_shapes and name in output_shapes:
            hinted = output_shapes[name]
            if not sh.is_more_precise_than(hinted) and \
                    not hinted.is_more_precise_than(sh):
                raise ValueError(
                    f"Output {name!r}: hint {hinted} incompatible with "
                    f"inferred shape {sh}")
            sh = hinted if hinted.is_more_precise_than(sh) else sh
        out_specs.append(TensorSpec(
            name, _output_framework_dtype(ta.dtype, specs), sh))
    return out_specs


def analyze_graph(comp: Computation,
                  shape_hints: Optional[Mapping[str, Shape]] = None,
                  fetches: Optional[Sequence[str]] = None) -> List[GraphNodeSummary]:
    """Validate a computation and summarize its endpoints without running it.

    Inputs are the computation's placeholders; outputs are the requested
    fetches (default: all outputs). Shape hints must be consistent with the
    captured specs; fetches must exist.
    """
    shape_hints = dict(shape_hints or {})
    fetch_names = list(fetches) if fetches is not None else comp.output_names
    summaries: List[GraphNodeSummary] = []
    for spec in comp.inputs:
        sh = spec.shape
        hint = shape_hints.get(spec.name)
        if hint is not None:
            if not hint.is_more_precise_than(sh) and \
                    not sh.is_more_precise_than(hint):
                raise ValueError(
                    f"Input {spec.name!r}: hint {hint} incompatible with "
                    f"declared shape {sh}")
            sh = hint if hint.is_more_precise_than(sh) else sh
        summaries.append(GraphNodeSummary(spec.name, True, False,
                                          spec.dtype, sh))
    for name in fetch_names:
        if name not in comp.output_names:
            raise ValueError(
                f"Fetch {name!r} not produced by computation; outputs: "
                f"{comp.output_names}")
        spec = comp.output(name)
        sh = spec.shape
        hint = shape_hints.get(name)
        if hint is not None and hint.is_more_precise_than(sh):
            sh = hint
        summaries.append(GraphNodeSummary(name, False, True, spec.dtype, sh))
    return summaries
