"""Expression AST nodes (the port of ``polars_tpu/plan/exprs.py``, trimmed to
the node kinds the ported queries evaluate).

Nodes are immutable, hashable dataclasses, so structurally equal subtrees
compare equal and evaluate once per context (the compiler's memo).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Any


@dataclass(frozen=True)
class ENode:
    """Base expression node."""

    def children(self) -> tuple[ENode, ...]:
        return ()


@dataclass(frozen=True)
class EColumn(ENode):
    name: str


@dataclass(frozen=True, eq=False)
class ELiteral(ENode):
    value: Any  # hashable python scalar (or None)
    dtype: Any = None  # optional DataType

    # equal only with a value of the same Python type: True == 1 == 1.0, but
    # the literals have three dtypes (the compiler's memo keys on equality)
    def __eq__(self, other: object) -> bool:
        return (type(other) is ELiteral and type(self.value) is type(other.value)
                and (self.value is other.value or self.value == other.value) and self.dtype == other.dtype)

    def __hash__(self) -> int:
        return hash(("ELiteral", type(self.value), self.value, self.dtype))


@dataclass(frozen=True)
class ESeriesLit(ENode):
    """A literal Series (identity-hashed; a small column of its own, never
    padded to the frame's rows)."""

    column: Any = field(hash=False, compare=False)
    ident: int = 0  # process-unique token of the column

    def __hash__(self) -> int:
        return hash(("ESeriesLit", self.ident))


@dataclass(frozen=True)
class EBinary(ENode):
    left: ENode
    op: str  # "+", "-", "*", "/", "//", "%", "==", "!=", "<", "<=", ">", ">=", "&", "|"
    right: ENode

    def children(self) -> tuple[ENode, ...]:
        return (self.left, self.right)


@dataclass(frozen=True)
class ECast(ENode):
    input: ENode
    dtype: Any
    strict: bool = True

    def children(self) -> tuple[ENode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class EAlias(ENode):
    input: ENode
    name: str

    def children(self) -> tuple[ENode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class EAgg(ENode):
    """Aggregation (reference: Expr::Agg, dsl/expr/mod.rs AggExpr)."""

    input: ENode
    kind: str  # sum|mean|min|max|count|len
    options: tuple[tuple[str, Any], ...] = ()

    def children(self) -> tuple[ENode, ...]:
        return (self.input,)

    def opt(self, key: str, default: Any = None) -> Any:
        for k, v in self.options:
            if k == key:
                return v
        return default


@dataclass(frozen=True)
class ELen(ENode):
    """Row count (pl.len())."""


@dataclass(frozen=True)
class ETernary(ENode):
    predicate: ENode
    truthy: ENode
    falsy: ENode

    def children(self) -> tuple[ENode, ...]:
        return (self.predicate, self.truthy, self.falsy)


@dataclass(frozen=True)
class EFunction(ENode):
    """Catch-all op with a string opcode (reference: FunctionExpr), typed and
    evaluated through ``engine/registry.py``."""

    name: str
    inputs: tuple[ENode, ...]
    options: tuple[tuple[str, Any], ...] = ()

    def children(self) -> tuple[ENode, ...]:
        return self.inputs

    def opt(self, key: str, default: Any = None) -> Any:
        for k, v in self.options:
            if k == key:
                return v
        return default


def walk(node: ENode):
    """Depth-first pre-order traversal."""
    yield node
    for c in node.children():
        yield from walk(c)


def output_name(node: ENode) -> str | None:
    """Output column name (reference: expr_output_name)."""
    if isinstance(node, EAlias):
        return node.name
    if isinstance(node, EColumn):
        return node.name
    if isinstance(node, ELen):
        return "len"
    if isinstance(node, ELiteral):
        return "literal"
    if isinstance(node, ESeriesLit):
        return node.column.name or "literal"
    for c in node.children():
        n = output_name(c)
        if n is not None:
            return n
    return None


def root_column_names(node: ENode) -> list[str]:
    """Every input column the expression reads, in first-use order (what
    projection and predicate pushdown keep alive)."""
    out: list[str] = []
    for n in walk(node):
        if isinstance(n, EColumn) and n.name not in out:
            out.append(n.name)
    return out


def reduces_in_agg(node: ENode) -> bool:
    """True when the expr yields ONE value per group: an aggregation root, or
    elementwise combinations of aggregations and literals."""
    while isinstance(node, (EAlias, ECast)):
        node = node.input
    if isinstance(node, (EAgg, ELen, ELiteral, ESeriesLit)):
        return True
    if isinstance(node, (EBinary, ETernary, EFunction)):
        return all(reduces_in_agg(c) for c in node.children())
    return False


# functions that run on the host between segments (``engine/hostops.py``)
HOST_FNS = frozenset({"dt.to_string"})


def needs_host(node: ENode) -> bool:
    """True if the expr calls a host function."""
    return any(isinstance(n, EFunction) and n.name in HOST_FNS for n in walk(node))


def is_elementwise(node: ENode) -> bool:
    """True if the expr maps rows independently inside a segment: no
    aggregation, and no host function (which runs between segments, so no
    predicate moves past it, as the JAX package's ``elementwise=False``)."""
    return not any(isinstance(n, (EAgg, ELen)) or (isinstance(n, EFunction) and n.name in HOST_FNS)
                   for n in walk(node))


def map_columns(node: ENode, fn) -> ENode:
    """``node`` with every column reference ``c`` replaced by ``fn(c)``."""
    if isinstance(node, EColumn):
        return fn(node)
    changes = {}
    for f in fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ENode):
            changes[f.name] = map_columns(v, fn)
        elif isinstance(v, tuple) and v and all(isinstance(x, ENode) for x in v):
            changes[f.name] = tuple(map_columns(x, fn) for x in v)
    return replace(node, **changes) if changes else node
