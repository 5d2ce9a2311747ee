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
    limit: int | None = None  # fused top-k; only the optimizer's top-k fusion (not ported yet) sets it

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)

    def exprs(self) -> tuple[ENode, ...]:
        return self.by


@dataclass(frozen=True)
class LJoin(LNode):
    input_left: LNode
    input_right: LNode
    left_on: tuple[ENode, ...]
    right_on: tuple[ENode, ...]
    how: str = "inner"  # inner|left|semi|anti in this slice
    suffix: str = "_right"
    nulls_equal: bool = False
    coalesce: bool | None = None
    maintain_order: str = "none"
    validate: str = "m:m"  # m:1/1:1 (and inner 1:m) unlock the fused join

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input_left, self.input_right)

    def exprs(self) -> tuple[ENode, ...]:
        return (*self.left_on, *self.right_on)


@dataclass(frozen=True)
class LSlice(LNode):
    input: LNode
    offset: int
    length: int | None

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)
