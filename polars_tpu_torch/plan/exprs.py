"""Expression AST nodes (the port of ``polars_tpu/plan/exprs.py``, trimmed to
the node kinds the ported queries evaluate).

``ESort``, ``ESortBy``, ``EFilter``, ``ESlice``, ``EGather`` and ``EWindow``
(``over``) read other rows than their own: none of them is elementwise
(:func:`is_elementwise`). A filter, slice or gather outside an aggregation
or a window changes the length of its column (:func:`changes_length`).

The wildcards and selectors (``EColumns``, ``EDtypeColumns``,
``ESelector``) and the name wrappers (``EKeepName``, ``ERenameFn``) never
reach the optimizer or the engine: an expression that holds one is expanded
against its input schema when it enters a plan
(``plan/schema_resolve.expand_exprs``), into one expression per matched
column, each named by an ``EAlias``.

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


@dataclass(frozen=True)
class EColumns(ENode):
    """Several columns by name (``pl.col("a", "b")``); no names is the
    wildcard ``pl.col("*")`` / ``pl.all()``."""

    names: tuple[str, ...]


@dataclass(frozen=True)
class EDtypeColumns(ENode):
    """Every column of the given dtypes (``pl.col(pl.Int64)``)."""

    dtypes: tuple[Any, ...]


@dataclass(frozen=True)
class ESelector(ENode):
    """A column selector (``selectors.py``): a kind with its arguments, or a
    set operation (union, difference, intersection, complement) of two."""

    kind: str
    args: tuple[Any, ...] = ()
    op: str | None = None
    left: ENode | None = None
    right: ENode | None = None

    def children(self) -> tuple[ENode, ...]:
        return tuple(c for c in (self.left, self.right) if c is not None)


@dataclass(frozen=True)
class EKeepName(ENode):
    """``name.keep()``: the output takes the name of its first input column."""

    input: ENode

    def children(self) -> tuple[ENode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class ERenameFn(ENode):
    """``name.prefix``/``suffix``/``map``/``to_lowercase``/``to_uppercase``
    of the input's output name."""

    input: ENode
    kind: str
    arg: Any = None

    def children(self) -> tuple[ENode, ...]:
        return (self.input,)


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
    kind: str  # sum|mean|min|max|count|len|first|last|n_unique|null_count|std|var|median|quantile|product|any|all|arg_min|arg_max
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


@dataclass(frozen=True)
class ESort(ENode):
    input: ENode
    descending: bool = False
    nulls_last: bool = False

    def children(self) -> tuple[ENode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class ESortBy(ENode):
    input: ENode
    by: tuple[ENode, ...]
    descending: tuple[bool, ...]
    nulls_last: tuple[bool, ...]

    def children(self) -> tuple[ENode, ...]:
        return (self.input, *self.by)


@dataclass(frozen=True)
class EFilter(ENode):
    """``col(x).filter(cond)``: inside an aggregation it narrows the rows
    the aggregation sees; in a select it shortens the column."""

    input: ENode
    by: ENode

    def children(self) -> tuple[ENode, ...]:
        return (self.input, self.by)


@dataclass(frozen=True)
class EWindow(ENode):
    """``function.over(partition_by)`` (reference: Expr::Over,
    polars-expr/src/expressions/window.rs): the function evaluated per
    group of the partition keys (in ``order_by`` order), its result mapped
    back to the rows."""

    function: ENode
    partition_by: tuple[ENode, ...]
    order_by: tuple[ENode, ...] = ()
    mapping_strategy: str = "group_to_rows"
    order_descending: tuple[bool, ...] = ()

    def children(self) -> tuple[ENode, ...]:
        return (self.function, *self.partition_by, *self.order_by)


@dataclass(frozen=True)
class ESlice(ENode):
    input: ENode
    offset: int
    length: int | None

    def children(self) -> tuple[ENode, ...]:
        return (self.input,)


@dataclass(frozen=True)
class EGather(ENode):
    input: ENode
    indices: ENode

    def children(self) -> tuple[ENode, ...]:
        return (self.input, self.indices)


@dataclass(frozen=True)
class EAnonymous(ENode):
    """A user's function of Series (``map_batches``, ``map_elements``,
    ``pl.map_groups``): a host call, identity-hashed. ``returns_scalar``:
    one value per group in a group-by (else a List per group).
    ``elementwise``: the function maps each row alone (``map_elements``, or
    ``is_elementwise=True``), so a head may move below it."""

    input: tuple[ENode, ...]
    function: Any = field(hash=False, compare=False)
    return_dtype: Any = None
    ident: int = 0
    returns_scalar: bool = False
    elementwise: bool = False

    def __hash__(self) -> int:
        return hash(("EAnonymous", self.ident))

    def children(self) -> tuple[ENode, ...]:
        return self.input


_ORDER_NODES = (ESort, ESortBy, EFilter, EWindow, ESlice, EGather)
_RESIZING = (EFilter, ESlice, EGather)


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
    if isinstance(node, EKeepName):
        return next((n.name for n in walk(node.input) if isinstance(n, EColumn)), None)
    if isinstance(node, ERenameFn):
        base = output_name(node.input)
        if base is None:
            return None
        return {"prefix": lambda: f"{node.arg}{base}", "suffix": lambda: f"{base}{node.arg}",
                "to_lowercase": base.lower, "to_uppercase": base.upper, "map": lambda: node.arg(base)}[node.kind]()
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
    if isinstance(node, EAnonymous):
        return node.returns_scalar
    if isinstance(node, EFunction) and not fn_elementwise(node.name):
        return False
    if isinstance(node, (EBinary, ETernary, EFunction)):
        return all(reduces_in_agg(c) for c in node.children())
    return False


def fn_elementwise(name: str) -> bool:
    """True if the registered function ``name`` is elementwise (an unknown
    name is not)."""
    from polars_tpu_torch.engine.registry import ELEMENTWISE_FNS, _ensure_loaded

    _ensure_loaded()
    return name in ELEMENTWISE_FNS


# functions that run on the host between segments (``engine/hostops.py``)
HOST_FNS = frozenset({"dt.to_string", "rolling_map", "rolling_median_by", "rolling_quantile_by", "rolling_rank_by",
                      "int_range", "temporal_range", "extend_constant", "append", "sample", "shuffle", "rle",
                      "value_counts", "hist", "reshape",
                      "repeat_value", "shrink_dtype", "unique", "unique_counts", "concat_str",
                      "cat.get_categories", "list.join", "struct.json_encode", "str.json_decode"})
# aggregations that make their text on the host (``engine/hostops.py``)
HOST_AGGS = frozenset({"str_concat"})


def cum_eval_kind(sub: ENode | None) -> str | None:
    """sum, min, max or mean where ``sub`` is that aggregation of
    ``pl.element()`` (a prefix scan in the segment), else None."""
    e = sub
    while isinstance(e, (EAlias, EKeepName)):
        e = e.input
    if isinstance(e, EAgg) and e.kind in ("sum", "min", "max", "mean"):
        i = e.input
        while isinstance(i, (EAlias, EKeepName)):
            i = i.input
        if isinstance(i, EColumn) and i.name == "":
            return e.kind
    return None


def is_host_call(node: ENode) -> bool:
    """A host function, a ``cumulative_eval`` of an expression other than a
    prefix sum, min, max or mean, a host aggregation (``str.join``), or a
    cast to String (it formats each distinct value on the host, as the JAX
    package hoists it)."""
    if isinstance(node, EAgg):
        return node.kind in HOST_AGGS
    if isinstance(node, EAnonymous):
        return True
    if isinstance(node, EFunction):
        return node.name in HOST_FNS or (node.name == "cumulative_eval"
                                         and cum_eval_kind(node.opt("expr")) is None)
    return isinstance(node, ECast) and _text_target(node.dtype)


def _text_target(dtype) -> bool:
    """A cast target that is text, or a List or Array of text."""
    while type(dtype).__name__ in ("List", "Array"):
        dtype = dtype.inner
    return type(dtype).__name__ in ("String", "Utf8")


def needs_host(node: ENode) -> bool:
    """True if the expr calls a host function."""
    return any(is_host_call(n) for n in walk(node))


def needs_host_agg(node: ENode) -> bool:
    """True if the expr holds a host aggregation (``str.join``)."""
    return any(isinstance(n, EAgg) and n.kind in HOST_AGGS for n in walk(node))


def is_elementwise(node: ENode, *, host_ok: bool = False) -> bool:
    """True if the expr maps rows independently inside a segment (the
    reference's ``is_elementwise``, ``exprs.py:410-424``): no aggregation,
    window, expression-level sort, filter, slice or gather, no function
    registered with ``elementwise=False``, no user's function of the whole
    column, and no host function (which runs between segments, so no
    predicate moves past it), unless ``host_ok``."""
    for n in walk(node):
        if isinstance(n, (EAgg, ELen, *_ORDER_NODES)) or (is_host_call(n) and not host_ok):
            return False
        if isinstance(n, EAnonymous) and not n.elementwise:
            return False
        if isinstance(n, ESeriesLit) and len(n.column) != 1 and not _in_is_in_set(node, n):
            return False
        if isinstance(n, EFunction) and not fn_elementwise(n.name):
            return False
    return True


def _in_is_in_set(root: ENode, lit: ENode) -> bool:
    """True if ``lit`` is only ever the set of an ``is_in`` under ``root``."""
    for n in walk(root):
        if isinstance(n, EFunction) and n.name == "is_in" and n.inputs[1] is lit:
            return True
    return False


def changes_length(node: ENode) -> bool:
    """True if the expression's column has another length than its input's:
    a filter, slice, gather or ``unique`` that no aggregation or window
    encloses."""
    if isinstance(node, _RESIZING) or (isinstance(node, EFunction)
                                       and node.name in ("unique", "unique_counts", "explode")):
        return True
    if isinstance(node, ESeriesLit):  # a column of its own length, unless it is one value
        return len(node.column) != 1
    if isinstance(node, EFunction) and node.name == "is_in":  # its right side is a set
        return changes_length(node.inputs[0])
    if isinstance(node, EWindow):
        return node.mapping_strategy == "explode"
    if isinstance(node, EAgg):
        return False
    return any(changes_length(c) for c in node.children())


def walk_outside_windows(node: ENode):
    """:func:`walk` that does not enter a window's function or keys (they
    evaluate in the window's own groups)."""
    yield node
    if isinstance(node, EWindow):
        return
    for c in node.children():
        yield from walk_outside_windows(c)


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
