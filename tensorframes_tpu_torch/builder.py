"""Op builder: run SERIALIZED computations against frames.

The port's counterpart of ``tensorframes_tpu/builder.py``, the reference's
``PythonOpBuilder`` contract (``PythonInterface.scala:83-139``): an op's
builder takes the serialized program with ``.graph(bytes)``, optional
output shapes with ``.shape(...)`` and a fetch subset with
``.fetches(...)``, and ``build()`` dispatches into the six-op engine. The
bytes are a serialized :class:`~tensorframes_tpu_torch.computation.
Computation` (a spec header and a ``torch.export`` archive,
self-describing), or a bare ``torch.export.save`` archive made by any
exporter, whose signature ``.signature(...)`` declares. It is how a
program written in another process or on another host enters this one.

``save_computation`` / ``load_computation`` keep computations as files.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

from .computation import ARCHIVE_MAGIC, Computation, TensorSpec
from .engine import ops as _ops
from .frame import GroupedFrame, TensorFrame
from .shape import Shape

__all__ = ["OpBuilder", "load_computation", "save_computation",
           "map_blocks_builder", "map_rows_builder",
           "reduce_blocks_builder", "reduce_rows_builder",
           "aggregate_builder"]


def save_computation(comp: Computation, path: str) -> None:
    with open(path, "wb") as f:
        f.write(comp.serialize())


def load_computation(path: str) -> Computation:
    with open(path, "rb") as f:
        return Computation.deserialize(f.read())


class OpBuilder:
    """Builder for one op invocation from a serialized computation::

        out = (map_blocks_builder(df, trim=True)
               .graph(blob)              # serialized Computation bytes
               .fetches(["z"])           # optional output subset
               .build())
    """

    def __init__(self, op: str, df: TensorFrame,
                 grouped: Optional[GroupedFrame] = None, trim: bool = False):
        self._op = op
        self._df = df
        self._grouped = grouped
        self._trim = trim
        self._comp: Optional[Computation] = None
        self._archive: Optional[bytes] = None
        self._sig_inputs: Optional[Sequence[TensorSpec]] = None
        self._sig_outputs: Optional[Sequence[TensorSpec]] = None
        self._fetches: Optional[Sequence[str]] = None
        self._shapes: Dict[str, Shape] = {}

    # -- configuration -----------------------------------------------------
    def graph(self, data: bytes) -> "OpBuilder":
        """Attach the serialized computation (the ``.graph(bytes)`` leg):
        this package's blob (self-describing), or a bare
        ``torch.export.save`` archive, which carries no signature: call
        :meth:`signature` before :meth:`build`. Anything else raises
        :meth:`Computation.deserialize`'s error."""
        data = data.encode() if isinstance(data, str) else bytes(data)
        if data.startswith(ARCHIVE_MAGIC):
            self._archive = data
            self._comp = None
        else:
            # the port's magic, or deserialize's canonical error
            self._comp = Computation.deserialize(data)
            self._archive = None
        return self

    def signature(self, inputs: Sequence[TensorSpec],
                  outputs: Optional[Sequence[TensorSpec]] = None
                  ) -> "OpBuilder":
        """Declare a bare archive's signature. Outputs may be omitted:
        they are then read from the exported graph's results."""
        self._sig_inputs = list(inputs)
        self._sig_outputs = list(outputs) if outputs is not None else None
        return self

    def computation(self, comp: Computation) -> "OpBuilder":
        """Attach a live computation (same slot, no round-trip)."""
        self._comp = comp
        return self

    def shape(self, shapes: Mapping[str, Shape]) -> "OpBuilder":
        """Override output shapes (normally unnecessary: serialized
        computations are self-describing)."""
        self._shapes.update(
            {n: s if isinstance(s, Shape) else Shape(s)
             for n, s in shapes.items()})
        return self

    def fetches(self, names: Sequence[str]) -> "OpBuilder":
        """Restrict the outputs to ``names`` (the requested-fetch list)."""
        self._fetches = list(names)
        return self

    # -- build -------------------------------------------------------------
    def _resolved(self) -> Computation:
        if self._comp is None and self._archive is not None:
            if self._sig_inputs is None:
                raise ValueError(
                    "A bare torch.export archive carries no signature; call "
                    ".signature(inputs=[TensorSpec...]) before .build()")
            self._comp = Computation.from_exported(
                self._archive, self._sig_inputs, self._sig_outputs)
        if self._comp is None:
            raise ValueError("No computation attached; call .graph(bytes) "
                             "or .computation(comp) first")
        comp = self._comp
        if self._shapes:
            outs = [TensorSpec(s.name, s.dtype,
                               self._shapes.get(s.name, s.shape))
                    for s in comp.outputs]
            comp = _wrapped(comp, comp.fn, outs)
        if self._fetches is not None:
            missing = [f for f in self._fetches
                       if f not in comp.output_names]
            if missing:
                raise ValueError(
                    f"Requested fetches {missing} not among computation "
                    f"outputs {comp.output_names}")
            keep = set(self._fetches)
            inner = comp.fn
            outs = [s for s in comp.outputs if s.name in keep]

            def filtered(d):
                return {k: v for k, v in inner(d).items() if k in keep}

            comp = _wrapped(comp, filtered, outs)
        return comp

    def build(self):
        """Dispatch. Frame-shaped ops return a TensorFrame (``buildDF``);
        reduces return the one-row result (``buildRow``)."""
        comp = self._resolved()
        if self._op == "map_blocks":
            return _ops.map_blocks(comp, self._df, trim=self._trim)
        if self._op == "map_rows":
            return _ops.map_rows(comp, self._df)
        if self._op == "reduce_blocks":
            return _ops.reduce_blocks(comp, self._df)
        if self._op == "reduce_rows":
            return _ops.reduce_rows(comp, self._df)
        if self._op == "aggregate":
            return _ops.aggregate(comp, self._grouped)
        raise AssertionError(f"unknown op {self._op}")


def _wrapped(comp: Computation, fn, outputs) -> Computation:
    """A computation over ``comp``'s inputs that calls the programs
    ``comp`` calls."""
    out = Computation(fn, list(comp.inputs), outputs)
    out._tft_programs = comp._tft_programs
    return out


def map_blocks_builder(df: TensorFrame, trim: bool = False) -> OpBuilder:
    return OpBuilder("map_blocks", df, trim=trim)


def map_rows_builder(df: TensorFrame) -> OpBuilder:
    return OpBuilder("map_rows", df)


def reduce_blocks_builder(df: TensorFrame) -> OpBuilder:
    return OpBuilder("reduce_blocks", df)


def reduce_rows_builder(df: TensorFrame) -> OpBuilder:
    return OpBuilder("reduce_rows", df)


def aggregate_builder(grouped: GroupedFrame) -> OpBuilder:
    return OpBuilder("aggregate", grouped.frame, grouped=grouped)
