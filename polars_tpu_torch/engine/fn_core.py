"""Core elementwise functions (the port of ``polars_tpu/engine/fn_core.py``,
trimmed to ``not``, ``is_in`` and ``is_between``), registered in
``engine/registry.py``."""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.cast import cast_val, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import SCALAR, SERIES, Val, combine_validity, take_lut
from polars_tpu_torch.engine.registry import BOOL, SAME, register
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.plan.schema_resolve import supertype
from polars_tpu_torch.utils import strtable


@register("not", SAME)
def _not(ctx, args, opts):
    v = args[0]
    if isinstance(v.dtype, dt.Boolean):
        return v.with_(values=~v.values.to(torch.bool))
    if v.dtype.is_integer():
        return v.with_(values=wrap_unsigned(torch.bitwise_not(v.values), v.dtype))
    raise InvalidOperationError(f"cannot negate {v.dtype!r}")


# -- membership -----------------------------------------------------------------


@register("is_in", BOOL)
def _is_in(ctx, args, opts):
    """Membership in a literal list, kept as its own (m,) tensor: one (n, m)
    broadcast compare (m is a handful of values; a list of one is a scalar).
    A string list is first probed into the column's dictionary on the host,
    so its values take the column's codes (-1, matching nothing, where the
    dictionary lacks one). A null in the column gives null, unless
    ``nulls_equal``: then it is in the list iff the list holds a null."""
    v, other = args
    if other.domain not in (SCALAR, SERIES):
        raise NotImplementedError(
            "is_in against a column or an expression is not ported yet (port queue: expression breadth)"
        )
    if isinstance(other.dtype, dt.Null):  # [] or [None, ...]: nothing to match
        out = torch.zeros(v.values.shape, dtype=torch.bool, device=v.values.device)
    else:
        if (v.table is None) != (other.table is None):
            raise InvalidOperationError(f"is_in cannot compare {v.dtype!r} with {other.dtype!r}")
        if v.table is not None:
            vv = v.values
            ov = take_lut(strtable.index_in(other.table.values, v.table.values), other.values)
        elif v.dtype != other.dtype:
            st = supertype(v.dtype, other.dtype)
            vv, ov = cast_val(v, st).values, cast_val(other, st).values
        else:
            vv, ov = v.values, other.values
        hits = vv.reshape(-1, 1) == ov.reshape(1, -1)
        if other.validity is not None:
            hits = hits & other.validity.reshape(1, -1)
        out = hits.any(dim=1)
    validity = v.validity
    if opts.get("nulls_equal", False) and validity is not None:
        other_has_null = (
            torch.zeros((), dtype=torch.bool, device=out.device) if other.validity is None else (~other.validity).any()
        )
        out = torch.where(validity, out, other_has_null)
        validity = None
    return Val(out, validity, dt.Boolean(), None, v.domain)


@register("is_between", BOOL)
def _is_between(ctx, args, opts):
    """``lower <= v <= upper``, each side open or closed by ``closed``
    (``both``, ``left``, ``right`` or ``none``), in the three operands'
    supertype; null where any operand is null."""
    v, lo, hi = args
    if any(a.table is not None for a in args):
        raise NotImplementedError("is_between on strings is not ported yet (port queue: expression breadth)")
    closed = opts.get("closed", "both")
    st = supertype(supertype(v.dtype, lo.dtype), hi.dtype)
    vv, lv, hv = (order_word(cast_val(a, st).values, st) for a in args)
    left = vv >= lv if closed in ("both", "left") else vv > lv
    right = vv <= hv if closed in ("both", "right") else vv < hv
    out = left & right
    validity = combine_validity(v.validity, lo.validity, hi.validity)
    if validity is not None and validity.shape != out.shape:  # a bound's (1,) validity
        validity = validity.expand(out.shape)
    dom = next((a.domain for a in args if a.domain != SCALAR), SCALAR)
    return Val(out, validity, dt.Boolean(), None, dom)
