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
# values and keep their children. ``NESTED_LATER_ARGS`` take one only after
# their first input (the set of ``is_in``, each row's patterns). Any other
# function refuses such an input rather than compute on the words that
# index the child.
NESTED_FNS = frozenset({
    "as_struct", "backward_fill", "coalesce", "concat_list", "cum_count", "explode", "fill_null",
    "fill_null_with_strategy", "forward_fill", "is_not_null", "is_null", "reverse", "set_sorted", "shift",
    "shift_fill",
})
NESTED_LATER_ARGS = frozenset({"is_in", "str.extract_many", "str.find_many"})


def refuse_nested_input(name: str, dtypes: list) -> None:
    """Raise where ``name`` would read a nested input's words as values."""
    if name.startswith(("list.", "arr.", "struct.")) or name in NESTED_FNS:
        return
    for i, d in enumerate(dtypes):
        if d.is_nested() and not (i and name in NESTED_LATER_ARGS):
            raise InvalidOperationError(f"{name} of {d!r} is not ported yet (ROADMAP item 4c)")


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
