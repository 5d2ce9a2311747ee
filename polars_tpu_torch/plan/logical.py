"""Logical plan nodes (the port of ``polars_tpu/plan/logical.py``, trimmed to
the node kinds the port executes; sinks come with a later slice)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
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
class LScan(LNode):
    """File scan (reference: DslPlan::Scan + UnifiedScanArgs,
    dsl/file_scan/mod.rs:517): the predicate, projection and row limit the
    optimizer pushes into it go to the reader (``io/scan_exec.py``)."""

    sources: tuple[str, ...]
    fmt: str  # "parquet" | "csv" | "ipc" | "ndjson" | "pyarrow_dataset"
    options: tuple[tuple[str, Any], ...] = ()
    projection: tuple[str, ...] | None = None
    predicate: ENode | None = None  # pushed-down scan predicate
    n_rows: int | None = None
    row_index: tuple[str, int] | None = None

    def opt(self, key: str, default: Any = None) -> Any:
        for k, v in self.options:
            if k == key:
                return v
        return default

    def exprs(self) -> tuple[ENode, ...]:
        return (self.predicate,) if self.predicate is not None else ()


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
    limit: int | None = None  # fused top-k; slice pushdown sets it

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
    how: str = "inner"  # inner|left|right|full|semi|anti|cross
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


@dataclass(frozen=True)
class LDistinct(LNode):
    """``unique``: one row per distinct ``subset`` (every column when None);
    ``keep`` any, first, last or none."""

    input: LNode
    subset: tuple[str, ...] | None
    keep: str = "any"
    maintain_order: bool = False

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class LUnion(LNode):
    """Vertical concat: the inputs' rows one after another, each column in
    the supertype of its pieces."""

    inputs_: tuple[LNode, ...]

    def inputs(self) -> tuple[LNode, ...]:
        return self.inputs_


@dataclass(frozen=True)
class LHConcat(LNode):
    """Horizontal concat: the inputs' columns side by side, row by row."""

    inputs_: tuple[LNode, ...]

    def inputs(self) -> tuple[LNode, ...]:
        return self.inputs_


@dataclass(frozen=True)
class LRename(LNode):
    input: LNode
    mapping: tuple[tuple[str, str], ...]
    strict: bool = True

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class LDrop(LNode):
    input: LNode
    columns: tuple[str, ...]
    strict: bool = True

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class LWithRowIndex(LNode):
    input: LNode
    name: str = "index"
    offset: int = 0

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class LExplode(LNode):
    """Each row repeated once per element of its lists in ``columns`` (the
    lists of one row have one length), those columns holding the elements;
    a null or empty list gives one row with a null, as in Polars."""

    input: LNode
    columns: tuple[str, ...]

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class LUnpivot(LNode):
    """Wide to long: the ``index`` columns repeated once per ``on`` column
    (every other column when None), ``variable_name`` naming that column
    and ``value_name`` holding its values in their supertype; all rows of
    the first ``on`` column, then the second, as in Polars."""

    input: LNode
    on: tuple[str, ...] | None
    index: tuple[str, ...]
    variable_name: str = "variable"
    value_name: str = "value"

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class LMapFunction(LNode):
    """A user's function of the whole frame (``LazyFrame.map_batches``): a
    barrier no predicate, projection or slice crosses; ``schema_fn`` gives
    its output schema from the input's (the input's own when None), which
    the output must match when ``validate``."""

    input: LNode
    function: Any = field(hash=False, compare=False)
    ident: int = 0
    schema_fn: Any = field(default=None, hash=False, compare=False)
    validate: bool = True

    def __hash__(self) -> int:
        return hash(("LMapFunction", self.ident, self.input))

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class LCache(LNode):
    """A subplan that appears more than once in the query (common-subplan
    elimination wraps each occurrence in the same node): it runs once per
    collect, and every consumer reads that frame (``engine/run.py``)."""

    input: LNode
    ident: int = 0

    def inputs(self) -> tuple[LNode, ...]:
        return (self.input,)


def rebuild(node: LNode, new_inputs: tuple[LNode, ...]) -> LNode:
    """``node`` over ``new_inputs``, everything else kept."""
    if node.inputs() == new_inputs:
        return node
    if isinstance(node, (LUnion, LHConcat)):
        return replace(node, inputs_=new_inputs)
    if isinstance(node, (LJoin, LJoinWhere, LAsofJoin)):
        return replace(node, input_left=new_inputs[0], input_right=new_inputs[1])
    return replace(node, input=new_inputs[0])


def _same(a: Any, b: Any) -> bool:
    return a is b or (isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b)
                      and all(x is y for x, y in zip(a, b)))


def update(node: LNode, **changes: Any) -> LNode:
    """``node`` with the fields ``changes`` names set; the node itself when
    each holds those very objects already, so a pass that changes nothing
    below a node keeps it (and the schema memo's entry for it)."""
    if all(_same(v, getattr(node, k)) for k, v in changes.items()):
        return node
    return replace(node, **changes)
