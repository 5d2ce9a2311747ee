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


@dataclass(frozen=True)
class LJoinWhere(LNode):
    """A join on predicates (``join_where``): equalities become an inner
    join, the first inequality between the sides a range join, the rest a
    filter of its output."""

    input_left: LNode
    input_right: LNode
    predicates: tuple[ENode, ...]
    suffix: str = "_right"

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input_left, self.input_right)

    def exprs(self) -> tuple[ENode, ...]:
        return self.predicates


@dataclass(frozen=True)
class LAsofJoin(LNode):
    """Each left row with the right row nearest in ``on`` (backward,
    forward or nearest), within ``tolerance``, among rows of equal ``by``."""

    input_left: LNode
    input_right: LNode
    left_on: ENode
    right_on: ENode
    by_left: tuple[ENode, ...] = ()
    by_right: tuple[ENode, ...] = ()
    strategy: str = "backward"
    tolerance: Any = None
    suffix: str = "_right"

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input_left, self.input_right)
