"""Expression simplification: constant folding and boolean and arithmetic
identities (the port of ``polars_tpu/plan/optimizer/simplify.py``;
reference: plans/optimizer/simplify_expr/).

An identity drops an operand only where the expression keeps its dtype, its
output name and its length: ``col(int) * 1.0`` is Float64 and stays as
written, ``x & True`` drops ``True`` only for a Boolean ``x`` and a literal
that is a bool (``1 == True`` in Python), and ``x & False`` does not become
a bare literal. ``polars_tpu`` matches the literal by ``==`` alone and
rewrites all of these.
"""

from __future__ import annotations

import dataclasses
import functools

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import _rebuild_expr, expr_dtype, node_schema


def simplify_exprs(node: L.LNode) -> L.LNode:
    inputs = node.inputs()
    new_inputs = tuple(simplify_exprs(i) for i in inputs)
    # the schema the node's expressions read, resolved only when an identity
    # matches (the rewrites leave every schema as it was, so the input as
    # written serves); a join's keys read two schemas and keep their
    # identities
    in_schema = functools.cache(lambda: node_schema(inputs[0]) if len(inputs) == 1 else None)
    node = L.rebuild(node, new_inputs) if new_inputs else node
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, E.ENode):
            s = _simplify(v, in_schema)
            if s is not v:
                changes[f.name] = s
        elif isinstance(v, tuple) and v and isinstance(v[0], E.ENode):
            s = tuple(_simplify(x, in_schema) for x in v)
            if any(a is not b for a, b in zip(s, v)):
                changes[f.name] = s
    if changes:
        node = dataclasses.replace(node, **changes)
    return node


def _is_lit(n: E.ENode, value) -> bool:
    return isinstance(n, E.ELiteral) and n.value == value


def _is_bool_lit(n: E.ENode, value: bool) -> bool:
    return isinstance(n, E.ELiteral) and n.value is value


def _identity(node: E.EBinary) -> E.ENode | None:
    """What a boolean or arithmetic identity leaves of ``node``, or None."""
    a, b, op = node.left, node.right, node.op
    if op == "&":
        if _is_bool_lit(a, True):
            return b
        if _is_bool_lit(b, True):
            return a
        if _is_bool_lit(a, False) or _is_bool_lit(b, False):
            return E.ELiteral(False)
    if op == "|":
        if _is_bool_lit(a, False):
            return b
        if _is_bool_lit(b, False):
            return a
        if _is_bool_lit(a, True) or _is_bool_lit(b, True):
            return E.ELiteral(True)
    if op in ("+", "-") and _is_lit(b, 0):
        return a
    if op == "+" and _is_lit(a, 0):
        return b
    if op in ("*", "/") and _is_lit(b, 1):
        return a
    if op == "*" and _is_lit(a, 1):
        return b
    return None


def _same_column(old: E.ENode, new: E.ENode, in_schema) -> bool:
    """Whether ``new`` gives what ``old`` gives: the same dtype, output name
    and length (a bare literal is one row where ``old`` reads columns)."""
    schema = in_schema()
    if schema is None or E.output_name(new) != E.output_name(old):
        return False
    if bool(E.root_column_names(new)) != bool(E.root_column_names(old)):
        return False
    return expr_dtype(new, schema) == expr_dtype(old, schema)


def _simplify(node: E.ENode, in_schema) -> E.ENode:
    kids = node.children()
    if kids:
        new_kids = tuple(_simplify(k, in_schema) for k in kids)
        if any(a is not b for a, b in zip(new_kids, kids)):
            node = _rebuild_expr(node, new_kids)

    if isinstance(node, E.EBinary):
        a, b = node.left, node.right
        # constant folding of untyped literals
        if isinstance(a, E.ELiteral) and isinstance(b, E.ELiteral) and a.dtype is None and b.dtype is None:
            if a.value is not None and b.value is not None:
                out = _fold(node.op, a.value, b.value)
                if out is not NotImplemented:
                    return E.ELiteral(out)
        out = _identity(node)
        if out is not None and _same_column(node, out, in_schema):
            return out

    if isinstance(node, E.ECast):
        # a cast of a cast to the same dtype collapses
        if isinstance(node.input, E.ECast) and node.input.dtype == node.dtype:
            return node.input

    if isinstance(node, E.EFunction) and node.name == "not":
        inner = node.inputs[0]
        if isinstance(inner, E.EFunction) and inner.name == "not":
            return inner.inputs[0]

    return node


_FOLD = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "//": lambda a, b: a // b,
    "%": lambda a, b: a % b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _fold(op: str, a, b):
    if op not in _FOLD or (op in ("/", "//", "%") and b == 0):
        return NotImplemented
    try:
        return _FOLD[op](a, b)
    except TypeError:
        return NotImplemented
