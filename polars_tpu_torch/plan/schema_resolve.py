"""dsl -> ir machinery for the ported queries: the supertype lattice,
expression dtype resolution (functions through ``engine/registry.py``) and
node schema resolution.

The port of ``polars_tpu/plan/schema_resolve.py`` (reference:
polars-plan/src/plans/conversion/). The slice has no selectors, so
:func:`expand_exprs` passes expressions through after checking their columns.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def expand_exprs(nodes: tuple[E.ENode, ...], schema: Schema) -> tuple[E.ENode, ...]:
    """The expressions, one output column each, after checking that every
    referenced column exists."""
    for n in nodes:
        for sub in E.walk(n):
            if isinstance(sub, E.EColumn) and sub.name not in schema:
                raise ColumnNotFoundError(f"{sub.name!r} not found; available: {schema.names()}")
    return tuple(nodes)


def _rebuild_expr(node: E.ENode, kids: tuple[E.ENode, ...]) -> E.ENode:
    """``node`` over the children ``kids`` (in ``children()`` order)."""
    if isinstance(node, E.EBinary):
        return dataclasses.replace(node, left=kids[0], right=kids[1])
    if isinstance(node, (E.ECast, E.EAlias, E.EAgg)):
        return dataclasses.replace(node, input=kids[0])
    if isinstance(node, E.ETernary):
        return dataclasses.replace(node, predicate=kids[0], truthy=kids[1], falsy=kids[2])
    if isinstance(node, E.EFunction):
        return dataclasses.replace(node, inputs=kids)
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
        from polars_tpu_torch.engine.registry import get_spec

        in_dts = [expr_dtype(i, schema) for i in node.inputs]
        in_dts = adapt_dyn_literal_dtypes(node.inputs, in_dts)
        return get_spec(node.name).dtype_rule(in_dts, dict(node.options))
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


def agg_dtype(node: E.EAgg, schema: Schema) -> dt.DataType:
    in_dt = expr_dtype(node.input, schema)
    k = node.kind
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
    if k in ("min", "max", "first", "last"):
        return in_dt
    if k in ("count", "len", "n_unique"):
        return dt.UInt32()
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
        if isinstance(node, L.LDistinct) and node.subset is not None:
            in_s = node_schema(node.input)
            missing = [n for n in node.subset if n not in in_s]
            if missing:
                raise ColumnNotFoundError(f"{missing[0]!r} not found; available: {in_s.names()}")
            return in_s
        return node_schema(node.input)
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
    if isinstance(node, L.LGroupBy):
        in_s = node_schema(node.input)
        out = Schema()
        for k in expand_exprs(node.keys, in_s):
            out[E.output_name(k) or "literal"] = expr_dtype(k, in_s)
        for a in expand_exprs(node.aggs, in_s):
            name = E.output_name(a) or "literal"
            if name in out:
                raise DuplicateError(f"the name {name!r} is duplicate")
            if not E.reduces_in_agg(a):
                raise NotImplementedError(
                    f"non-reducing aggregation {name!r} (implode to List) is not ported yet "
                    "(port queue: expression breadth)"
                )
            out[name] = expr_dtype(a, in_s)
        return out
    raise NotImplementedError(f"{type(node).__name__} is not ported yet")


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
