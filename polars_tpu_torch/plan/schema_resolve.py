"""dsl -> ir machinery for the ported queries: the supertype lattice,
expression dtype resolution (functions through ``engine/registry.py``) and
node schema resolution.

The port of ``polars_tpu/plan/schema_resolve.py`` (reference:
polars-plan/src/plans/conversion/). :func:`expand_exprs` expands wildcards
and selectors into one expression per matched column and resolves the
``name`` wrappers into aliases, as the JAX package's ``expand_expr`` does;
the LazyFrame methods call it when an expression enters a plan, so the
optimizer and the engine see plain columns and aliases only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.errors import (
    ColumnNotFoundError,
    DuplicateError,
    InvalidOperationError,
    SchemaError,
)
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L

# ---------------------------------------------------------------------------
# supertype lattice (reference: polars-core/src/utils/supertype.rs)
# ---------------------------------------------------------------------------

_INT_ORDER = ["Int8", "Int16", "Int32", "Int64"]
_UINT_ORDER = ["UInt8", "UInt16", "UInt32", "UInt64"]
_INT_BITS = {"Int8": 8, "Int16": 16, "Int32": 32, "Int64": 64,
             "UInt8": 8, "UInt16": 16, "UInt32": 32, "UInt64": 64}


def supertype(a: dt.DataType, b: dt.DataType) -> dt.DataType:
    if a == b:
        return a
    an, bn = type(a).__name__, type(b).__name__
    if an == "Null":
        return b
    if bn == "Null":
        return a
    if an == "Unknown":
        return b
    if bn == "Unknown":
        return a
    # bool promotes to any numeric
    if an == "Boolean" and b.is_numeric():
        return b
    if bn == "Boolean" and a.is_numeric():
        return a
    if an == "Struct" and bn == "Struct":
        # same field names in order -> struct of field supertypes
        a_names = [f.name for f in a.fields]
        if a_names == [f.name for f in b.fields]:
            return dt.Struct(
                [
                    (fa.name, supertype(fa.dtype, fb.dtype))
                    for fa, fb in zip(a.fields, b.fields)
                ]
            )
    if an == "Decimal" and bn == "Decimal":
        # reference: decimal arithmetic unifies to max scale at max precision
        # (polars-core arithmetic/decimal.rs: scale = left_s.max(right_s))
        prec = None if (a.precision is None or b.precision is None) else max(a.precision, b.precision)
        return dt.Decimal(prec, max(a.scale, b.scale))
    if an == "Decimal" and b.is_numeric():
        return a if b.is_integer() else dt.Float64()
    if bn == "Decimal" and a.is_numeric():
        return b if a.is_integer() else dt.Float64()
    if a.is_numeric() and b.is_numeric():
        if a.is_float() or b.is_float():
            if an == "Float32" and bn == "Float32":
                return dt.Float32()
            if {an, bn} <= {"Float32", "Int8", "Int16", "UInt8", "UInt16"}:
                return dt.Float32()
            return dt.Float64()
        a_signed, b_signed = a.is_signed_integer(), b.is_signed_integer()
        ab, bb = _INT_BITS[an], _INT_BITS[bn]
        if a_signed == b_signed:
            order = _INT_ORDER if a_signed else _UINT_ORDER
            winner = order[max(order.index(an), order.index(bn))]
            return getattr(dt, winner)()
        # mixed sign: need signed type one step wider than the unsigned one
        unsigned_bits = bb if a_signed else ab
        signed_bits = ab if a_signed else bb
        need = max(signed_bits, unsigned_bits * 2)
        if need > 64:
            return dt.Float64()
        return {8: dt.Int8(), 16: dt.Int16(), 32: dt.Int32(), 64: dt.Int64()}[need]
    if {an, bn} == {"Date", "Datetime"}:
        d = a if an == "Datetime" else b
        return d
    if an == "Datetime" and bn == "Datetime":
        units = {"ms": 0, "us": 1, "ns": 2}
        finer = a if units[a.time_unit] >= units[b.time_unit] else b
        return dt.Datetime(finer.time_unit, datetime_zone(a, b))
    if an == "Duration" and bn == "Duration":
        units = {"ms": 0, "us": 1, "ns": 2}
        return a if units[a.time_unit] >= units[b.time_unit] else b
    if {an, bn} <= {"String", "Categorical", "Enum"}:
        return dt.String()
    if (an == "Date" and b.is_integer()) or (bn == "Date" and a.is_integer()):
        return dt.Int32()
    if (an in ("Datetime", "Duration", "Time") and b.is_integer()) or (
        bn in ("Datetime", "Duration", "Time") and a.is_integer()
    ):
        return dt.Int64()
    if a.is_numeric() and bn == "String":
        return dt.String()
    if b.is_numeric() and an == "String":
        return dt.String()
    raise SchemaError(f"no supertype of {a!r} and {b!r}")

def datetime_zone(a: dt.Datetime, b: dt.Datetime) -> str | None:
    """The time zone of the supertype of two Datetimes: their zone where they
    share it or one of them is naive (its values read as UTC instants), and
    UTC between two zones. Either way they meet on UTC instants, which is
    what a compare or a difference reads."""
    if a.time_zone == b.time_zone or b.time_zone is None:
        return a.time_zone
    return b.time_zone if a.time_zone is None else "UTC"


# ---------------------------------------------------------------------------
# expansion
# ---------------------------------------------------------------------------


def selector_columns(node: E.ENode, schema: Schema) -> list[str]:
    """The columns a wildcard, dtype or selector node matches, in schema
    order (the JAX package's ``selector_columns``)."""
    names = schema.names()
    if isinstance(node, E.EColumns):
        if not node.names:
            return names
        missing = [n for n in node.names if n not in schema]
        if missing:
            raise ColumnNotFoundError(f"{missing[0]!r} not found; available: {names}")
        return list(node.names)
    if isinstance(node, E.EDtypeColumns):
        return [n for n in names if any(schema[n] == d for d in node.dtypes)]
    if isinstance(node, E.ESelector):
        return _selector_match(node, schema)
    raise InvalidOperationError(f"not a selector: {node!r}")


_SELECTOR_KINDS = {
    "numeric": lambda d: d.is_numeric(),
    "integer": lambda d: d.is_integer(),
    "signed_integer": lambda d: d.is_signed_integer(),
    "unsigned_integer": lambda d: d.is_unsigned_integer(),
    "float": lambda d: d.is_float(),
    "string": lambda d: isinstance(d, dt.String),
    "boolean": lambda d: isinstance(d, dt.Boolean),
    "temporal": lambda d: d.is_temporal(),
    "date": lambda d: isinstance(d, dt.Date),
    "datetime": lambda d: isinstance(d, dt.Datetime),
    "duration": lambda d: isinstance(d, dt.Duration),
    "time": lambda d: isinstance(d, dt.Time),
    "categorical": lambda d: isinstance(d, dt.Categorical),
    "binary": lambda d: isinstance(d, dt.Binary),
    "decimal": lambda d: isinstance(d, dt.Decimal),
    "enum": lambda d: isinstance(d, dt.Enum),
    "list": lambda d: isinstance(d, dt.List),
    "array": lambda d: isinstance(d, dt.Array),
    "struct": lambda d: isinstance(d, dt.Struct),
    "nested": lambda d: isinstance(d, (dt.List, dt.Array, dt.Struct)),
}


def _selector_match(sel: E.ESelector, schema: Schema) -> list[str]:
    names = schema.names()
    k = sel.kind
    if k == "set":
        left = set(selector_columns(sel.left, schema)) if sel.left is not None else set()
        right = set(selector_columns(sel.right, schema)) if sel.right is not None else set()
        keep = {"union": lambda: left | right, "difference": lambda: left - right,
                "intersection": lambda: left & right, "complement": lambda: set(names) - left}.get(sel.op)
        if keep is None:
            raise InvalidOperationError(f"unknown selector op {sel.op!r}")
        kept = keep()
        return [n for n in names if n in kept]
    if k == "all":
        return names
    if k == "none":
        return []
    if k == "by_name":
        return [n for n in names if n in set(sel.args)]
    if k == "nth":
        return [names[i if i >= 0 else len(names) + i] for i in sel.args if -len(names) <= i < len(names)]
    if k == "matches":
        pat = re.compile(sel.args[0])
        return [n for n in names if pat.search(n)]
    if k == "starts_with":
        return [n for n in names if any(n.startswith(p) for p in sel.args)]
    if k == "ends_with":
        return [n for n in names if any(n.endswith(p) for p in sel.args)]
    if k == "contains":
        return [n for n in names if any(p in n for p in sel.args)]
    if k == "by_dtype":
        targets = [dt.parse_into_dtype(d) for d in sel.args]
        return [n for n in names if any(schema[n] == d for d in targets)]
    if k in _SELECTOR_KINDS:
        return [n for n in names if _SELECTOR_KINDS[k](schema[n])]
    raise InvalidOperationError(f"unknown selector kind {k!r}")


_SELECTOR_NODES = (E.EColumns, E.EDtypeColumns, E.ESelector)
_NAME_NODES = (E.EKeepName, E.ERenameFn)


def _selector_roots(node: E.ENode) -> list[E.ENode]:
    """The outermost selector nodes of ``node`` (a set selector's operands
    are its own)."""
    if isinstance(node, _SELECTOR_NODES):
        return [node]
    return [r for c in node.children() for r in _selector_roots(c)]


def _substitute(node: E.ENode, target: E.ENode, replacement: E.ENode) -> E.ENode:
    if node == target:
        return replacement
    kids = node.children()
    new = tuple(_substitute(k, target, replacement) for k in kids)
    return node if new == kids else _rebuild_expr(node, new)


def _resolve_names(node: E.ENode) -> E.ENode:
    """``node`` with each ``name`` wrapper replaced by an alias to the name
    it gives."""
    kids = node.children()
    new = tuple(_resolve_names(k) for k in kids)
    out = node if new == kids else _rebuild_expr(node, new)
    if isinstance(out, _NAME_NODES):
        name = E.output_name(out)
        if name is None:
            raise InvalidOperationError(f"{type(node).__name__} over an expression without a name")
        return E.EAlias(out.input, name)
    return out


_HORIZONTAL_FNS = frozenset({"sum_horizontal", "mean_horizontal", "min_horizontal", "max_horizontal",
                             "any_horizontal", "all_horizontal", "coalesce", "fold", "reduce"})


def splice_horizontal(node: E.ENode, schema: Schema) -> E.ENode:
    """``node`` with each selector among a horizontal function's inputs
    expanded into those inputs (one function over every matched column, not
    one copy of the function per column: Polars'
    ``INPUT_WILDCARD_EXPANSION``), and each ``fold``/``reduce`` composed
    from its function over its inputs, so that no callable reaches the plan
    (the JAX package's ``_splice_horizontal``)."""
    if not any(isinstance(n, E.EFunction) and n.name in _HORIZONTAL_FNS for n in E.walk(node)):
        return node
    kids = node.children()
    new = tuple(splice_horizontal(k, schema) for k in kids)
    if new != kids:
        node = _rebuild_expr(node, new)
    if not (isinstance(node, E.EFunction) and node.name in _HORIZONTAL_FNS):
        return node
    inputs: list[E.ENode] = []
    for i in node.inputs:
        inputs.extend(expand_expr(i, schema) if _selector_roots(i) else [i])
    if node.name in ("fold", "reduce"):
        from polars_tpu_torch.expr.expr import Expr

        fn = node.opt("function")
        acc = inputs[0]
        for x in inputs[1:]:
            acc = fn(Expr(acc), Expr(x))._node
        return acc
    return dataclasses.replace(node, inputs=tuple(inputs))


def needs_expansion(node: E.ENode) -> bool:
    """True if ``node`` holds a wildcard, a selector, a name wrapper, a
    struct's fields as columns (``struct.field("*")``, ``struct.unnest``) or
    a cast to a DataTypeExpr."""
    return any(isinstance(n, _SELECTOR_NODES + _NAME_NODES) or (isinstance(n, E.EFunction)
                                                                 and n.name == "struct.multifield")
               or (isinstance(n, E.ECast) and isinstance(n.dtype, dt.DataTypeExpr)) for n in E.walk(node))


def _resolve_dtype_exprs(node: E.ENode, schema: Schema) -> E.ENode:
    """Each cast to a DataTypeExpr as a cast to the dtype it names."""
    kids = node.children()
    new = tuple(_resolve_dtype_exprs(k, schema) for k in kids)
    if new != kids:
        node = _rebuild_expr(node, new)
    if isinstance(node, E.ECast) and isinstance(node.dtype, dt.DataTypeExpr):
        target = node.dtype.resolve(schema, expr_dtype(node.input, schema))
        node = dataclasses.replace(node, dtype=target)
    return node


def expand_expr(node: E.ENode, schema: Schema) -> list[E.ENode]:
    """One expression per column the selectors of ``node`` match (all of
    its selectors must match as many), each with its name wrappers
    resolved; every column it reads must exist. Selectors among a
    horizontal function's inputs splice in first (:func:`splice_horizontal`)."""
    node = splice_horizontal(node, schema)
    if not needs_expansion(node):
        out = [node]
    else:
        uniq: list[E.ENode] = []
        for r in _selector_roots(node):
            if r not in uniq:
                uniq.append(r)
        if not uniq:
            out = [node]
        else:
            matches = [selector_columns(r, schema) for r in uniq]
            if len({len(m) for m in matches}) > 1:
                raise InvalidOperationError("selectors in one expression matched differing column counts")
            out = []
            for i in range(len(matches[0])):
                e = node
                for r, m in zip(uniq, matches):
                    e = _substitute(e, r, E.EColumn(m[i]))
                out.append(e)
        out = [_resolve_dtype_exprs(_resolve_names(e), schema) for e in out]
    out = [x for e in out for x in _struct_fields(e, schema)]
    for e in out:
        for sub in E.walk(e):
            if isinstance(sub, E.EColumn) and sub.name not in schema:
                raise ColumnNotFoundError(f"{sub.name!r} not found; available: {schema.names()}")
    return out


def _struct_fields(node: E.ENode, schema: Schema) -> list[E.ENode]:
    """``struct.field(*names)`` or ``struct.unnest()``: one ``struct.field``
    per named field (``"*"`` every field, in the struct's order)."""
    if not (isinstance(node, E.EFunction) and node.name == "struct.multifield"):
        return [node]
    d = expr_dtype(node.inputs[0], schema)
    if not isinstance(d, dt.Struct):
        raise InvalidOperationError(f"struct.field needs a Struct, got {d!r}")
    names: list[str] = []
    for n in node.opt("names"):
        names.extend(f.name for f in d.fields) if n == "*" else names.append(n)
    return [E.EAlias(E.EFunction("struct.field", node.inputs, (("name", n),)), n) for n in names]


def expand_exprs(nodes: tuple[E.ENode, ...], schema: Schema) -> tuple[E.ENode, ...]:
    """Every expression of ``nodes`` expanded (:func:`expand_expr`)."""
    return tuple(x for n in nodes for x in expand_expr(n, schema))


def _rebuild_expr(node: E.ENode, kids: tuple[E.ENode, ...]) -> E.ENode:
    """``node`` over the children ``kids`` (in ``children()`` order)."""
    if isinstance(node, E.EBinary):
        return dataclasses.replace(node, left=kids[0], right=kids[1])
    if isinstance(node, (E.ECast, E.EAlias, E.EAgg, E.EKeepName, E.ERenameFn, E.ESort, E.ESlice)):
        return dataclasses.replace(node, input=kids[0])
    if isinstance(node, E.ESortBy):
        return dataclasses.replace(node, input=kids[0], by=kids[1:])
    if isinstance(node, E.EFilter):
        return dataclasses.replace(node, input=kids[0], by=kids[1])
    if isinstance(node, E.EGather):
        return dataclasses.replace(node, input=kids[0], indices=kids[1])
    if isinstance(node, E.EWindow):
        np_ = len(node.partition_by)
        return dataclasses.replace(node, function=kids[0], partition_by=kids[1:1 + np_], order_by=kids[1 + np_:])
    if isinstance(node, E.ESelector):
        return node
    if isinstance(node, E.ETernary):
        return dataclasses.replace(node, predicate=kids[0], truthy=kids[1], falsy=kids[2])
    if isinstance(node, E.EFunction):
        return dataclasses.replace(node, inputs=kids)
    if isinstance(node, E.EAnonymous):
        return dataclasses.replace(node, input=kids)
    raise InvalidOperationError(f"cannot rebuild {type(node).__name__}")


# ---------------------------------------------------------------------------
# expression dtype resolution
# ---------------------------------------------------------------------------

_CMP = {"==", "!=", "<", "<=", ">", ">=", "eq_missing", "ne_missing"}
_BOOLOPS = {"&", "|", "^"}


def expr_dtype(node: E.ENode, schema: Schema) -> dt.DataType:
    if isinstance(node, E.EColumn):
        return schema[node.name]
    if isinstance(node, E.ELiteral):
        if node.dtype is not None:
            return dt.parse_into_dtype(node.dtype)
        return _literal_dtype(node.value)
    if isinstance(node, E.ESeriesLit):
        return node.column.dtype
    if isinstance(node, E.EAlias):
        return expr_dtype(node.input, schema)
    if isinstance(node, E.ECast):
        return dt.parse_into_dtype(node.dtype)
    if isinstance(node, E.EBinary):
        lt = expr_dtype(node.left, schema)
        rt = expr_dtype(node.right, schema)
        lt, rt = adapt_dyn_literal_dtypes((node.left, node.right), [lt, rt])
        return binary_dtype(node.op, lt, rt)
    if isinstance(node, E.ETernary):
        tt = expr_dtype(node.truthy, schema)
        ft = expr_dtype(node.falsy, schema)
        tt, ft = adapt_dyn_literal_dtypes((node.truthy, node.falsy), [tt, ft])
        return supertype(tt, ft)
    if isinstance(node, E.EAgg):
        return agg_dtype(node, schema)
    if isinstance(node, E.ELen):
        return dt.UInt32()
    if isinstance(node, E.EFunction):
        from polars_tpu_torch.engine.registry import get_spec, refuse_nested_input

        in_dts = [expr_dtype(i, schema) for i in node.inputs]
        in_dts = adapt_dyn_literal_dtypes(node.inputs, in_dts)
        refuse_nested_input(node.name, in_dts)
        return get_spec(node.name).dtype_rule(in_dts, dict(node.options))
    if isinstance(node, (E.ESort, E.ESortBy, E.EFilter, E.ESlice, E.EGather)):
        return expr_dtype(node.input, schema)
    if isinstance(node, E.EWindow):
        d = expr_dtype(node.function, schema)
        return dt.List(d) if node.mapping_strategy == "join" else d
    if isinstance(node, E.EAnonymous):  # a user's function: its declared dtype, else its input's
        if node.return_dtype is not None:
            return node.return_dtype
        return expr_dtype(node.input[0], schema) if node.input else dt.Null()
    raise InvalidOperationError(f"cannot resolve dtype of {type(node).__name__}")


def dyn_literal_value(node: E.ENode):
    """The python value of an UNTYPED numeric literal (the reference's
    Unknown(UnknownKind::Int/Float) dynamic literal), else None."""
    n = node
    while isinstance(n, E.EAlias):
        n = n.input
    if (
        isinstance(n, E.ELiteral)
        and n.dtype is None
        and not isinstance(n.value, bool)
        and isinstance(n.value, (int, float))
    ):
        return n.value
    return None


def fit_dyn_dtype(value, target: dt.DataType) -> dt.DataType | None:
    """Unify a dynamic numeric literal with a concrete numeric dtype
    (reference: get_supertype Unknown(Int(v)) arm, supertype.rs:514-536 —
    supertype(target, smallest dtype fitting v))."""
    import numpy as np

    if isinstance(value, float):
        return target if target.is_float() else None
    if not isinstance(value, int):
        return None
    if target.is_float():
        return target
    if not target.is_integer():
        return None
    if target.is_unsigned_integer() and value >= 0:
        ladder = [dt.UInt8(), dt.UInt16(), dt.UInt32(), dt.UInt64()]
    else:
        ladder = [dt.Int8(), dt.Int16(), dt.Int32(), dt.Int64()]
    smallest = None
    for d in ladder:
        info = np.iinfo(dt.dtype_to_numpy(d))
        if info.min <= value <= info.max:
            smallest = d
            break
    if smallest is None:
        return None
    return supertype(target, smallest)


def adapt_dyn_literal_dtypes(nodes, dts: list) -> list:
    """Adapt untyped numeric literals to the first concrete numeric operand's
    dtype (col_i8 + 1 stays Int8; fill_null(0) keeps the column dtype)."""
    target = None
    for n, d in zip(nodes, dts):
        if dyn_literal_value(n) is None and d.is_numeric():
            target = d
            break
    if target is None:
        return list(dts)
    out = list(dts)
    for i, n in enumerate(nodes):
        v = dyn_literal_value(n)
        if v is None:
            continue
        nd = fit_dyn_dtype(v, target)
        if nd is not None:
            out[i] = nd
    return out


def _literal_dtype(value: Any) -> dt.DataType:
    if value is None:
        return dt.Null()
    if isinstance(value, bool):
        return dt.Boolean()
    if isinstance(value, int):
        return dt.Int32() if -(2**31) <= value < 2**31 else dt.Int64()
    if isinstance(value, float):
        return dt.Float64()
    if isinstance(value, str):
        return dt.String()
    if isinstance(value, bytes):
        return dt.Binary()
    import decimal as _decimal

    if isinstance(value, _decimal.Decimal):
        exp = value.as_tuple().exponent
        return dt.Decimal(38, -exp if isinstance(exp, int) and exp < 0 else 0)
    raise InvalidOperationError(f"unsupported literal {value!r}")



def binary_dtype(op: str, lt: dt.DataType, rt: dt.DataType) -> dt.DataType:
    if op in _CMP:
        return dt.Boolean()
    if op in _BOOLOPS:
        if isinstance(lt, dt.Boolean) and isinstance(rt, dt.Boolean):
            return dt.Boolean()
        if lt.is_integer() and rt.is_integer():
            return supertype(lt, rt)
        if isinstance(lt, dt.Null) or isinstance(rt, dt.Null):
            return dt.Boolean()
        raise SchemaError(f"cannot apply {op!r} to {lt!r} and {rt!r}")
    ln, rn = type(lt).__name__, type(rt).__name__
    # temporal arithmetic
    if op == "-":
        if ln == "Date" and rn == "Date":
            return dt.Duration("ms")
        if ln == "Datetime" and rn == "Datetime":
            return dt.Duration(supertype(lt, rt).time_unit)
        if ln == "Datetime" and rn == "Duration":
            return lt
        if ln == "Date" and rn == "Duration":
            return dt.Datetime(rt.time_unit) if rt.time_unit != "ms" else dt.Date()
        if ln == "Duration" and rn == "Duration":
            return supertype(lt, rt)
        if ln == "Time" and rn == "Time":
            return dt.Duration("ns")
    if op == "+":
        if {ln, rn} == {"Date", "Duration"}:
            return lt if ln == "Date" else rt
        if "Datetime" in (ln, rn) and "Duration" in (ln, rn):
            return lt if ln == "Datetime" else rt
        if ln == "Duration" and rn == "Duration":
            return supertype(lt, rt)
        if ln == "String" and rn == "String":
            return dt.String()
        if ln == "Binary" and rn == "Binary":
            return dt.Binary()
    if op == "/":
        if ln == "Duration" and rt.is_numeric():
            return lt
        if ln == "Decimal" and (rn == "Decimal" or rt.is_integer()):
            return supertype(lt, rt if rn == "Decimal" else dt.Decimal(None, 0))
        if rn == "Decimal" and lt.is_integer():
            return supertype(dt.Decimal(None, 0), rt)
        if lt.is_numeric() or rt.is_numeric():
            st = supertype(lt, rt)
            return dt.Float32() if isinstance(st, dt.Float32) else dt.Float64()
    if op == "//":
        st = supertype(lt, rt)
        return st
    if op == "**":
        if lt.is_integer() and rt.is_integer():
            return lt
        st = supertype(lt, rt)
        return dt.Float32() if isinstance(st, dt.Float32) else dt.Float64()
    if op in ("*",):
        if ln == "Duration" and rt.is_numeric():
            return lt
        if rn == "Duration" and lt.is_numeric():
            return rt
    return supertype(lt, rt)

_SMALL_INTS = ("Int8", "Int16", "UInt8", "UInt16")


# the aggregations that take a whole List, Array or Struct value (those
# that order or compare one, by its content: ``kernels/nested_keys.py``)
_NESTED_AGGS = frozenset({"first", "last", "item", "count", "len", "null_count", "implode", "agg_groups",
                          "min", "max", "arg_min", "arg_max", "n_unique", "mode", "is_sorted"})


def agg_dtype(node: E.EAgg, schema: Schema) -> dt.DataType:
    in_dt = expr_dtype(node.input, schema)
    k = node.kind
    if in_dt.is_nested() and k not in _NESTED_AGGS:
        raise InvalidOperationError(f"`{k}` operation not supported for dtype `{in_dt!r}`")
    name = type(in_dt).__name__
    if k == "sum":
        if isinstance(in_dt, dt.Boolean):
            return dt.UInt32()
        if name in _SMALL_INTS:
            return dt.Int64()
        return in_dt
    if k == "mean":
        if in_dt.is_temporal():
            return in_dt if name != "Date" else dt.Datetime("ms")
        return dt.Float32() if name == "Float32" else dt.Float64()
    if k == "product":
        return dt.Int64() if in_dt.is_integer() or isinstance(in_dt, dt.Boolean) else in_dt
    if k == "median" and in_dt.is_temporal():
        return in_dt if name != "Date" else dt.Datetime("ms")
    if k in ("median", "quantile", "std", "var"):
        if not (in_dt.is_numeric() or isinstance(in_dt, (dt.Boolean, dt.Null))):
            raise InvalidOperationError(f"{k} is not defined for {in_dt!r}")
        return dt.Float32() if name == "Float32" else dt.Float64()
    if k in ("min", "max", "first", "last", "item"):
        return in_dt
    if k in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        if not (in_dt.is_integer() or isinstance(in_dt, dt.Boolean)):
            raise InvalidOperationError(f"{k} expects an integer or Boolean input, got {in_dt!r}")
        return in_dt
    if k in ("skew", "kurtosis", "entropy"):
        return dt.Float32() if name == "Float32" else dt.Float64()
    if k in ("corr", "cov"):
        return dt.Float64()
    if k in ("count", "len", "n_unique", "null_count", "arg_min", "arg_max"):
        return dt.UInt32()
    if k == "str_concat":
        return dt.String()
    if k in ("implode", "mode"):
        return dt.List(in_dt)
    if k == "is_sorted":
        return dt.Boolean()
    if k == "agg_groups":
        return dt.List(dt.UInt32())
    if k in ("any", "all"):
        if not isinstance(in_dt, (dt.Boolean, dt.Null)):
            raise InvalidOperationError(f"{k} expects a Boolean input, got {in_dt!r}")
        return dt.Boolean()
    raise InvalidOperationError(f"aggregation {k!r} is not ported yet (port queue: expression breadth)")


# ---------------------------------------------------------------------------
# node schema resolution
# ---------------------------------------------------------------------------


def exprs_schema(nodes: tuple[E.ENode, ...], schema: Schema) -> Schema:
    out = Schema()
    for n in nodes:
        name = E.output_name(n) or "literal"
        if name in out:
            raise DuplicateError(f"the name {name!r} is duplicate")
        out[name] = expr_dtype(n, schema)
    return out


_SCHEMA_MEMOS: list[dict] = []


@contextlib.contextmanager
def schema_memo():
    """Remember each node's schema, by node identity, while the block runs
    (the optimizer's passes ask for the schema of each node many times). The
    memo holds its nodes, and through them their frames, only until the block
    ends; outside such a block every call resolves afresh."""
    _SCHEMA_MEMOS.append({})
    try:
        yield
    finally:
        _SCHEMA_MEMOS.pop()


def node_schema(node: L.LNode) -> Schema:
    """Output schema of a plan node (recomputed per call outside
    :func:`schema_memo`: nodes hold their frames, and a lasting cache keyed
    on nodes would keep device memory alive)."""
    if not _SCHEMA_MEMOS:
        return _node_schema(node)
    memo = _SCHEMA_MEMOS[-1]
    hit = memo.get(id(node))
    if hit is None:
        hit = memo[id(node)] = (node, _node_schema(node))
    return hit[1].copy()


def _node_schema(node: L.LNode) -> Schema:
    if isinstance(node, L.LCache):
        return node_schema(node.input)
    if isinstance(node, L.LDataFrameScan):
        s = node.df.schema
        if node.projection is not None:
            return Schema([(n, s[n]) for n in node.projection])
        return s
    if isinstance(node, L.LScan):
        from polars_tpu_torch.io.scan_schema import scan_schema

        s = scan_schema(node)
        if node.projection is not None:
            s = Schema([(n, s[n]) for n in node.projection if n in s])
        if node.row_index is not None:
            s = Schema([(node.row_index[0], dt.UInt32()), *s.items()])
        return s
    if isinstance(node, L.LSelect):
        in_s = node_schema(node.input)
        return exprs_schema(expand_exprs(node.expressions, in_s), in_s)
    if isinstance(node, L.LWithColumns):
        in_s = node_schema(node.input)
        out = in_s.copy()
        for n in expand_exprs(node.expressions, in_s):
            out[E.output_name(n) or "literal"] = expr_dtype(n, in_s)
        return out
    if isinstance(node, (L.LFilter, L.LSort, L.LSlice, L.LDistinct)):
        in_s = node_schema(node.input)
        if isinstance(node, L.LDistinct):
            missing = [n for n in node.subset or () if n not in in_s]
            if missing:
                raise ColumnNotFoundError(f"{missing[0]!r} not found; available: {in_s.names()}")
        if isinstance(node, L.LSort):
            for e in expand_exprs(node.by, in_s):
                expr_dtype(e, in_s)
        return in_s
    if isinstance(node, L.LUnion):
        schemas = [node_schema(i) for i in node.inputs_]
        out = schemas[0].copy()
        for s in schemas[1:]:
            if s.names() != out.names():
                raise SchemaError(f"column name mismatch in vertical concat: {out.names()} vs {s.names()}")
            for n, d in s.items():
                out[n] = supertype(out[n], d)
        return out
    if isinstance(node, L.LHConcat):
        out = Schema()
        for i in node.inputs_:
            for n, d in node_schema(i).items():
                if n in out:
                    raise DuplicateError(f"the name {n!r} is duplicate in a horizontal concat")
                out[n] = d
        return out
    if isinstance(node, L.LRename):
        in_s = node_schema(node.input)
        mapping = dict(node.mapping)
        if node.strict:
            missing = set(mapping) - set(in_s.names())
            if missing:
                raise ColumnNotFoundError(f"{sorted(missing)} not found")
        out = Schema([(mapping.get(n, n), d) for n, d in in_s.items()])
        if len(out) != len(in_s):
            raise DuplicateError("rename would create duplicate columns")
        return out
    if isinstance(node, L.LDrop):
        in_s = node_schema(node.input)
        if node.strict:
            missing = set(node.columns) - set(in_s.names())
            if missing:
                raise ColumnNotFoundError(f"{sorted(missing)} not found")
        return Schema([(n, d) for n, d in in_s.items() if n not in set(node.columns)])
    if isinstance(node, L.LWithRowIndex):
        out = Schema([(node.name, dt.UInt32())])
        for n, d in node_schema(node.input).items():
            out[n] = d
        return out
    if isinstance(node, L.LJoin):
        for side, keys in ((node.input_left, node.left_on), (node.input_right, node.right_on)):
            side_s = node_schema(side)
            for e in keys:
                d = expr_dtype(e, side_s)
                if d.is_nested():  # as Polars and the JAX package
                    raise InvalidOperationError(f"cannot join on dtype {d!r}")
        return _join_schema(node)
    if isinstance(node, (L.LJoinWhere, L.LAsofJoin)):
        # every left column, then the right ones (an asof join drops the
        # right ``on`` and ``by`` keys); a name the left has takes ``suffix``
        out = node_schema(node.input_left).copy()
        skip = set()
        if isinstance(node, L.LAsofJoin):
            skip = {E.output_name(node.right_on), *(E.output_name(e) for e in node.by_right)}
        for n, d in node_schema(node.input_right).items():
            if n not in skip:
                out[n + node.suffix if n in out else n] = d
        return out
    if isinstance(node, L.LExplode):
        out = node_schema(node.input).copy()
        for c in node.columns:
            if c not in out:
                raise ColumnNotFoundError(f"{c!r} not found; available: {out.names()}")
            if not isinstance(out[c], (dt.List, dt.Array)):
                raise InvalidOperationError(f"explode needs a List or Array column, {c!r} is {out[c]!r}")
            out[c] = out[c].inner
        return out
    if isinstance(node, L.LGroupBy):
        in_s = node_schema(node.input)
        out = Schema()
        for k in expand_exprs(node.keys, in_s):
            out[E.output_name(k) or "literal"] = expr_dtype(k, in_s)
        for a in expand_exprs(node.aggs, in_s):
            name = E.output_name(a) or "literal"
            if name in out:
                raise DuplicateError(f"the name {name!r} is duplicate")
            # a non-reducing expression (a bare column, a rank, x - x.mean())
            # implodes to a List per group (the reference's
            # AggState::AggregatedList)
            d = expr_dtype(a, in_s)
            out[name] = d if E.reduces_in_agg(a) else dt.List(d)
        return out
    if isinstance(node, L.LUnpivot):
        in_s = node_schema(node.input)
        on, index = unpivot_columns(node, in_s)
        out = Schema([(n, in_s[n]) for n in index])
        value_dt = None
        for c in on:
            value_dt = in_s[c] if value_dt is None else supertype(value_dt, in_s[c])
        out[node.variable_name] = dt.String()
        out[node.value_name] = value_dt if value_dt is not None else dt.Null()
        return out
    if isinstance(node, L.LMapFunction):
        in_s = node_schema(node.input)
        return in_s if node.schema_fn is None else node.schema_fn(in_s)
    raise NotImplementedError(f"{type(node).__name__} is not ported yet")


def unpivot_columns(node: L.LUnpivot, in_s: Schema) -> tuple[list[str], list[str]]:
    """(on, index) of an unpivot: ``on`` every column but the index ones
    when None."""
    missing = [n for n in (*node.index, *(node.on or ())) if n not in in_s]
    if missing:
        raise ColumnNotFoundError(f"{missing[0]!r} not found; available: {in_s.names()}")
    on = list(node.on) if node.on is not None else [n for n in in_s.names() if n not in set(node.index)]
    return on, list(node.index)


def _join_schema(node: L.LJoin) -> Schema:
    """Left columns, then right columns, as Polars lays them out: a coalesced
    right key folds into its left key (inner, left and full joins), a
    coalesced right join keeps the right keys and drops the left ones, a
    cross join has no keys, and a right name the output already has takes
    ``suffix``. ``coalesce=None`` means True for inner, left and right
    joins and False for full joins."""
    ls = node_schema(node.input_left)
    rs = node_schema(node.input_right)
    out = ls.copy()
    if node.how in ("semi", "anti"):
        return out
    coalesce = node.coalesce
    if coalesce is None:
        coalesce = node.how in ("inner", "left", "right")
    right_keys = [E.output_name(e) for e in node.right_on]
    left_keys = [E.output_name(e) for e in node.left_on]
    if node.how == "right" and coalesce:
        out = Schema([(n, d) for n, d in ls.items() if n not in set(left_keys)])
    for n, d in rs.items():
        if coalesce and node.how != "right" and n in right_keys and left_keys[right_keys.index(n)] in out:
            continue
        if n in out:
            if n + node.suffix in out:
                raise DuplicateError(
                    f"column with name {n + node.suffix!r} already exists; pass a different `suffix`"
                )
            out[n + node.suffix] = d
        else:
            out[n] = d
    return out
