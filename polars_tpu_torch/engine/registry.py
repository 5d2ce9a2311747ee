"""Function-op registry (the port of ``polars_tpu/engine/registry.py``; the
FunctionExpr catalog analogue, polars-plan/src/plans/aexpr/function_expr/mod.rs).

Each opcode registers an implementation (run on :class:`Val` inputs) and a
dtype rule (used by schema resolution without running anything). Every
``EFunction`` is typed and evaluated through this one table; namespaced ops
use dotted names (``"str.starts_with"``). A function registered with
``elementwise=False`` (the order and position functions of
``engine/fn_position.py``, the distinct flags) reads other rows than its
own: no predicate, slice or sort moves past it (``plan/exprs.is_elementwise``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError


@dataclass
class FnSpec:
    impl: Callable  # (ctx, args: list[Val], opts: dict) -> Val
    dtype_rule: Callable  # (in_dtypes: list[DataType], opts: dict) -> DataType
    elementwise: bool = True


REGISTRY: dict[str, FnSpec] = {}
ELEMENTWISE_FNS: set[str] = set()

# The functions besides the ``list.``, ``arr.`` and ``struct.`` namespaces
# that take a List, Array or Struct input: they move, test or merge whole
# values and keep their children, or order, compare and hash them by their
# content (``kernels/nested_keys.py``). ``NESTED_LATER_ARGS`` take one only
# after their first input (each row's patterns). Any other function is not
# defined on such an input and raises, as Polars does.
NESTED_FNS = frozenset({
    "append", "arg_sort", "arg_sort_by", "as_struct", "backward_fill", "coalesce", "concat_list", "cum_count",
    "explode", "extend_constant", "fill_null", "fill_null_with_strategy", "forward_fill", "hash", "is_duplicated",
    "is_first_distinct", "is_in", "is_last_distinct", "is_not_null", "is_null", "is_unique", "rank", "repeat_by",
    "reverse", "rle", "rle_id", "row_position", "sample", "set_sorted", "shift", "shift_fill", "shuffle", "unique",
    "unique_counts", "value_counts",
})
NESTED_LATER_ARGS = frozenset({"str.extract_many", "str.find_many"})


def refuse_nested_input(name: str, dtypes: list) -> None:
    """Raise where ``name`` is not defined on a nested input (it would read
    the words that index the child as values)."""
    if name.startswith(("list.", "arr.", "struct.")) or name in NESTED_FNS:
        return
    for i, d in enumerate(dtypes):
        if d.is_nested() and not (i and name in NESTED_LATER_ARGS):
            raise InvalidOperationError(f"`{name}` operation not supported for dtype `{d!r}`")


def register(name: str, dtype_rule: Any, *, elementwise: bool = True):
    """Decorator: ``@register("is_in", BOOL)``; a DataType as the rule is a
    fixed output dtype."""

    def deco(fn: Callable) -> Callable:
        rule = dtype_rule
        if isinstance(dtype_rule, (dt.DataType, dt.DataTypeClass)):
            fixed = dt.parse_into_dtype(dtype_rule)
            rule = lambda dts, opts: fixed  # noqa: E731
        REGISTRY[name] = FnSpec(fn, rule, elementwise)
        if elementwise:
            ELEMENTWISE_FNS.add(name)
        return fn

    return deco


def raises(message: str, error: type = InvalidOperationError) -> Callable:
    """The implementation of a function that another layer runs (on the
    host, between segments): reached inside a segment, it raises."""

    def impl(ctx, args, opts):
        raise error(message)

    return impl


def get_spec(name: str) -> FnSpec:
    _ensure_loaded()
    try:
        return REGISTRY[name]
    except KeyError:
        raise NotImplementedError(f"function {name!r} is not ported yet (port queue: expression breadth)") from None


# common dtype rules
def SAME(dts, opts):
    return dts[0]


def FLOAT(dts, opts):
    return dt.Float32() if isinstance(dts[0], dt.Float32) else dt.Float64()


def BOOL(dts, opts):
    return dt.Boolean()


def SUPER(dts, opts):
    from polars_tpu_torch.plan.schema_resolve import supertype

    out = dts[0]
    for d in dts[1:]:
        out = supertype(out, d)
    return out


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import polars_tpu_torch.engine.fn_core  # noqa: F401
    import polars_tpu_torch.engine.fn_generators  # noqa: F401
    import polars_tpu_torch.engine.sequences  # noqa: F401
    import polars_tpu_torch.engine.fn_nested  # noqa: F401
    import polars_tpu_torch.engine.fn_position  # noqa: F401
    import polars_tpu_torch.engine.fn_rolling  # noqa: F401
    import polars_tpu_torch.engine.fn_strings  # noqa: F401
    import polars_tpu_torch.engine.fn_temporal  # noqa: F401
