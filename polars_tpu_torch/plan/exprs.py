"""Expression AST nodes (the port of ``polars_tpu/plan/exprs.py``, trimmed to
the node kinds this slice evaluates).

Nodes are immutable, hashable dataclasses, so structurally equal subtrees
compare equal and evaluate once per context (the compiler's memo).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ENode:
    """Base expression node."""

    def children(self) -> tuple[ENode, ...]:
        return ()


@dataclass(frozen=True)
class EColumn(ENode):
    name: str


@dataclass(frozen=True)
class ELiteral(ENode):
    value: Any  # hashable python scalar (or None)
    dtype: Any = None  # optional DataType


@dataclass(frozen=True)
class EBinary(ENode):
    left: ENode
    op: str  # "+", "-", "*", "/", "//", "%", "==", "!=", "<", "<=", ">", ">=", "&", "|"
    right: ENode

    def children(self) -> tuple[ENode, ...]:
        return (self.left, self.right)


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
    for c in node.children():
        n = output_name(c)
        if n is not None:
            return n
    return None


def reduces_in_agg(node: ENode) -> bool:
    """True when the expr yields ONE value per group: an aggregation root, or
    elementwise combinations of aggregations and literals."""
    while isinstance(node, EAlias):
        node = node.input
    if isinstance(node, (EAgg, ELen, ELiteral)):
        return True
    if isinstance(node, EBinary):
        return reduces_in_agg(node.left) and reduces_in_agg(node.right)
    return False


def is_elementwise(node: ENode) -> bool:
    """True if the expr maps rows independently."""
    return not any(isinstance(n, (EAgg, ELen)) for n in walk(node))
