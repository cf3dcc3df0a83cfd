"""Filter-predicate atom extraction for parquet row-group pushdown.

The port's counterpart of ``tensorframes_tpu/plan/predicates.py``. A
filter computation is an opaque PyTorch program; this module recognizes
the narrow, useful shape — conjunctions of single-column comparisons
against literals (``lambda x: x > 3``, ``lambda x, y: (x > 3) & (y <=
0)``) — by walking the ATen graph that
``torch.fx.experimental.proxy_tensor.make_fx`` traces from the predicate
over fake inputs (where the JAX package walks a jaxpr). The rules are the
JAX package's: a comparison of a column with a literal, on either side;
``and`` of atoms; a cast keeps a column's identity only when it is
value-preserving; anything else yields no atoms, and the scan reads
everything (pushdown is an optimization, never a semantics change).

A comparison traces as ``aten.ge.Scalar(col, 3)`` or, when the literal is
a tensor, as ``aten.ge.Tensor(col, c)`` with ``c`` a lifted 0-d constant;
both forms are read.

Refutation (:func:`refutes`) is evaluated against row-group footer
min/max statistics in the dtype the DEVICE compares in: casting is
monotone but can round a host value ONTO the literal, so strict and
non-strict comparisons use different boundary rules — a skipped row
group must be one where the predicate is false for EVERY row as the
device would evaluate it. Each atom carries the dtype torch compares in
(its type promotion of the column and the literal): an integer column
against a float literal compares in torch's default float dtype
(float32), where the JAX package with x64 compares in float64, and
:func:`refutes` follows torch. Rows whose value is NaN compare false
under every supported operator, so float stats (which exclude NaN) stay
sound.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..utils.logging import get_logger

__all__ = ["Atom", "extract_atoms", "refutes"]

_log = get_logger("plan.predicates")

_FLIP = {"gt": "lt", "lt": "gt", "ge": "le", "le": "ge", "eq": "eq"}

_aten = torch.ops.aten
# comparison overloads -> op name (the Scalar and the Tensor form)
_CMP = {}
for _name in _FLIP:
    _packet = getattr(_aten, _name)
    _CMP[_packet.Scalar] = _name
    _CMP[_packet.Tensor] = _name
_AND = (_aten.bitwise_and.Tensor, _aten.logical_and.default)
# ops that pass their input through unchanged (value and dtype)
_PASS = (_aten.lift_fresh_copy.default, _aten.clone.default,
         _aten.alias.default, _aten.detach.default)
# dtype casts: identity-preserving only when value-preserving
_CASTS = (_aten._to_copy.default,)


class Atom(NamedTuple):
    """One conjunct: ``column <op> value`` (op in gt/lt/ge/le/eq),
    compared in ``dtype`` (a ``torch.dtype``; ``None``: the column's
    device dtype)."""

    column: str
    op: str
    value: float
    dtype: Optional[torch.dtype] = None


def _np_dtype(dt) -> Optional[np.dtype]:
    if isinstance(dt, torch.dtype):
        try:
            return torch.empty((), dtype=dt).numpy().dtype
        except TypeError:  # bfloat16 has no numpy dtype
            return None
    try:
        return np.dtype(dt)
    except TypeError:
        return None


def _value_preserving(src_dt, dst_dt) -> bool:
    """True when casting ``src_dt -> dst_dt`` provably changes no value
    the refutation could see: bool widening, same-kind int widening,
    f32->f64, small-int->f32, and any-int->f64 (``refutes`` bails
    beyond 2**53 for integer columns, inside which f64 is exact)."""
    s, d = _np_dtype(src_dt), _np_dtype(dst_dt)
    if s is None or d is None:
        return False
    if s == d:
        return True
    if s.kind == "b":
        return d.kind in "biuf"
    if s.kind in "iu" and d.kind in "iu":
        return d.kind == s.kind and d.itemsize >= s.itemsize
    if s.kind in "iu" and d.kind == "f":
        if d.itemsize >= 8:
            return True  # exact under the 2**53 bail in refutes()
        return s.itemsize <= 2  # i8/i16/u8/u16 fit f32's mantissa
    if s.kind == "f" and d.kind == "f":
        return d.itemsize >= s.itemsize
    return False


def _literal(v):
    """A comparison literal as torch promotes it: a Python number or a
    real 0-d tensor; ``None`` otherwise."""
    if isinstance(v, torch.Tensor):
        return v if v.ndim == 0 and not v.is_meta else None
    if isinstance(v, (bool, int, float)):
        return v
    return None


def extract_atoms(comp) -> List[Atom]:
    """Conjunctive ``column <op> literal`` atoms of a filter predicate,
    ``[]`` when the shape is not provably that (cached on the comp)."""
    cached = getattr(comp, "_tft_pred_atoms", None)
    if cached is not None:
        return list(cached)
    try:
        atoms = _extract(comp)
    except Exception as e:  # noqa: BLE001 - unextractable means unpushed
        _log.debug("predicate extraction failed (%s: %s); no pushdown",
                   type(e).__name__, e)
        atoms = []
    try:
        comp._tft_pred_atoms = tuple(atoms)
    except AttributeError as e:
        _log.debug("could not cache atoms on %r: %s", comp, e)
    return atoms


def _extract(comp) -> List[Atom]:
    from torch.fx.experimental.proxy_tensor import make_fx

    from .. import dtypes as _dt

    names = sorted(s.name for s in comp.inputs)
    specs = {s.name: s for s in comp.inputs}

    def traced(*args):
        out = comp.fn(dict(zip(names, args)))
        return [out[n] for n in comp.output_names]

    args = [torch.empty(tuple(2 if d == -1 else d
                              for d in specs[n].shape.dims),
                        dtype=_dt.device_dtype(specs[n].dtype))
            for n in names]
    from ..computation import _EXPORT_LOCK
    with _EXPORT_LOCK:  # one torch.fx trace at a time in the process
        gm = make_fx(traced, tracing_mode="fake")(*args)
    src = {}     # fx node -> ("col", name) | ("lit", value)
    bools = {}   # fx node -> the atoms it provably equals (a bool vector)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, name in zip(placeholders, names):
        src[node] = ("col", name)

    def resolve(a):
        if isinstance(a, torch.fx.Node):
            return src.get(a)
        lit = _literal(a)
        return ("lit", lit) if lit is not None else None

    def dtype_of(a):
        val = a.meta.get("val") if isinstance(a, torch.fx.Node) else None
        return getattr(val, "dtype", None)

    def atom(column, op, col_arg, lit):
        # the dtype torch compares in: its promotion of the compared
        # operand and the literal
        cmp = torch.result_type(torch.empty((), dtype=dtype_of(col_arg)),
                                lit)
        return Atom(column, op, float(lit), cmp)

    out_node = None
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            lit = _literal(getattr(gm, node.target))
            if lit is not None:
                src[node] = ("lit", lit)
            continue
        if node.op == "output":
            out_node = node
            continue
        if node.op != "call_function":
            continue
        fn = node.target
        if fn in _PASS or fn in _CASTS:
            s = resolve(node.args[0])
            if s is not None and (
                    fn in _PASS or s[0] == "col"
                    and _value_preserving(dtype_of(node.args[0]),
                                         dtype_of(node))):
                # only VALUE-PRESERVING casts keep column identity: a
                # truncating/narrowing cast (float->int, f64->f32)
                # changes what the device compares
                src[node] = s
            if node.args[0] in bools:
                bools[node] = bools[node.args[0]]
            continue
        if fn in _CMP:
            op = _CMP[fn]
            a, b = resolve(node.args[0]), resolve(node.args[1])
            if a and b and a[0] == "col" and b[0] == "lit":
                bools[node] = [atom(a[1], op, node.args[0], b[1])]
            elif a and b and a[0] == "lit" and b[0] == "col":
                bools[node] = [atom(b[1], _FLIP[op], node.args[1], a[1])]
            continue
        if fn in _AND:
            a = bools.get(node.args[0])
            b = bools.get(node.args[1])
            if a is not None and b is not None:
                bools[node] = a + b
            continue
        # any other op producing the eventual output breaks the proof
        # chain for its result; harmless intermediates are fine
    outs = out_node.args[0] if out_node is not None else ()
    if len(outs) != 1:
        return []
    return list(bools.get(outs[0], []))


def refutes(atom: Atom, vmin, vmax, device_dtype) -> bool:
    """True when ``column <op> value`` is FALSE for every row of a
    group whose column spans ``[vmin, vmax]`` — as the DEVICE would
    evaluate it. Conservative: unknown stats never refute.

    The comparison dtype is the atom's (else ``device_dtype``).
    Integer/bool comparisons are exact: evaluated in float64 for both
    sides below 2**53 (beyond that, never refute). Float comparisons run
    after the (monotone) cast of the bounds and the literal to that
    dtype, with strict/non-strict boundary rules that survive a host
    value rounding ONTO the literal; integer bounds past 2**53 would
    round twice on the way there, so they never refute either."""
    if vmin is None or vmax is None:
        return False
    dd = _np_dtype(atom.dtype if atom.dtype is not None else device_dtype)
    if dd is None:
        return False
    exact = float(2 ** 53)
    try:
        if any(isinstance(b, (int, np.integer)) and abs(int(b)) > exact
               for b in (vmin, vmax)):
            return False
        if dd.kind in "iub":
            lo = float(vmin)
            hi = float(vmax)
            v = float(atom.value)
            if abs(lo) > exact or abs(hi) > exact or abs(v) > exact:
                return False
        else:
            lo = np.asarray(vmin, np.float64).astype(dd)
            hi = np.asarray(vmax, np.float64).astype(dd)
            v = np.asarray(atom.value, np.float64).astype(dd)
    except (TypeError, ValueError, OverflowError):
        return False
    # monotone cast: x <= vmax  =>  cast(x) <= hi, etc. Strict device
    # comparisons survive equality at the bound; non-strict need a
    # strict host bound.
    if atom.op == "gt":   # all false iff every cast(x) <= v
        return bool(hi <= v)
    if atom.op == "ge":
        return bool(hi < v)
    if atom.op == "lt":
        return bool(lo >= v)
    if atom.op == "le":
        return bool(lo > v)
    if atom.op == "eq":
        return bool(v < lo or v > hi)
    return False
