"""Logical plan nodes (the port of ``polars_tpu/plan/logical.py``, trimmed to
the node kinds this slice executes)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from polars_tpu_torch.plan.exprs import ENode


@dataclass(frozen=True)
class LNode:
    def inputs(self) -> tuple[LNode, ...]:
        return ()

    def exprs(self) -> tuple[ENode, ...]:
        return ()


@dataclass(frozen=True)
class LDataFrameScan(LNode):
    """In-memory table source (reference: DslPlan::DataFrameScan)."""

    df: Any = field(hash=False, compare=False)
    ident: int = 0
    projection: tuple[str, ...] | None = None

    def __hash__(self) -> int:
        return hash(("LDataFrameScan", self.ident, self.projection))


@dataclass(frozen=True)
class LSelect(LNode):
    input: LNode
    expressions: tuple[ENode, ...]

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)

    def exprs(self) -> tuple[ENode, ...]:
        return self.expressions


@dataclass(frozen=True)
class LWithColumns(LNode):
    input: LNode
    expressions: tuple[ENode, ...]

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)

    def exprs(self) -> tuple[ENode, ...]:
        return self.expressions


@dataclass(frozen=True)
class LFilter(LNode):
    input: LNode
    predicate: ENode

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)

    def exprs(self) -> tuple[ENode, ...]:
        return (self.predicate,)


@dataclass(frozen=True)
class LGroupBy(LNode):
    input: LNode
    keys: tuple[ENode, ...]
    aggs: tuple[ENode, ...]
    maintain_order: bool = False

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)

    def exprs(self) -> tuple[ENode, ...]:
        return (*self.keys, *self.aggs)


@dataclass(frozen=True)
class LSort(LNode):
    input: LNode
    by: tuple[ENode, ...]
    descending: tuple[bool, ...]
    nulls_last: tuple[bool, ...]
    maintain_order: bool = False

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)

    def exprs(self) -> tuple[ENode, ...]:
        return self.by
