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


@dataclass
class FnSpec:
    impl: Callable  # (ctx, args: list[Val], opts: dict) -> Val
    dtype_rule: Callable  # (in_dtypes: list[DataType], opts: dict) -> DataType
    elementwise: bool = True


REGISTRY: dict[str, FnSpec] = {}
ELEMENTWISE_FNS: set[str] = set()


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
    import polars_tpu_torch.engine.fn_position  # noqa: F401
    import polars_tpu_torch.engine.fn_rolling  # noqa: F401
    import polars_tpu_torch.engine.fn_strings  # noqa: F401
    import polars_tpu_torch.engine.fn_temporal  # noqa: F401
