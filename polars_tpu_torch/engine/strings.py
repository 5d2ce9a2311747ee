"""Device-side helpers for dictionary-coded string values (the port of
``polars_tpu/engine/strings.py``): :func:`unify_vals`, :func:`concat_vals`,
:func:`map_over_table`, and the lazy ordinalization of an unordered
dictionary, :func:`needs_ordinal` and :func:`ensure_ordinal_val`."""

from __future__ import annotations

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.cast import cast_val
from polars_tpu_torch.engine.common import ROW, Val, combine_validity, take_lut
from polars_tpu_torch.utils import strtable


def unify_vals(a: Val, b: Val, *, require_ordinal: bool = False) -> tuple[Val, Val]:
    """Remap two dictionary-coded Vals onto one merged table (ordinal iff
    both inputs are small and sorted, or ``require_ordinal``; see
    ``strtable.unify``)."""
    if a.table is b.table:
        if require_ordinal:
            return ensure_ordinal_val(a), ensure_ordinal_val(b)
        return a, b
    merged, lmap, rmap = strtable.unify(a.table, b.table, require_ordinal=require_ordinal)
    return a.with_(values=_remap(a.values, lmap), table=merged), b.with_(values=_remap(b.values, rmap), table=merged)


def needs_ordinal(v: Val) -> bool:
    """True where an ordering operation must remap ``v``'s codes: its
    dictionary keeps the order of first occurrence, and its dtype orders
    by text (String, Binary, Categorical). An Enum orders by its
    categories, which its codes are: it is never ordinalized."""
    return v.table is not None and not v.table.sorted_order and not isinstance(v.dtype, dt.Enum)


def ensure_ordinal_val(v: Val) -> Val:
    """``v`` on its dictionary's sorted table: the host sorts the table once
    (``StringTable.ordinal``, cached on it) and the rank remap goes to each
    device once (cached on the table too), then one gather per use."""
    if not needs_ordinal(v):
        return v
    table, remap = v.table.ordinal()
    dev = v.values.device
    lut = v.table.memo(("ordinal_lut", str(dev)), lambda: torch.as_tensor(remap).to(dev))
    return v.with_(values=take_lut(lut, v.values), table=table)


def concat_vals(vals: list[Val], target: dt.DataType) -> Val:
    """Row Vals one after another (a vertical concat's column): each cast to
    ``target``, dictionary-coded pieces put on one dictionary, the merge of
    all of theirs, and a validity kept where any piece has one."""
    vals = [cast_val(v, target) for v in vals]
    if isinstance(target, dt.NestedType):
        from polars_tpu_torch.engine.fn_nested import concat_nested

        return concat_nested(vals, target)
    table = vals[0].table
    if table is not None:
        for v in vals[1:]:
            if v.table is not table:
                table = strtable.unify(table, v.table)[0]
        vals = [v if v.table is table else
                v.with_(values=take_lut(strtable.index_in(v.table.values, table.values), v.values), table=table)
                for v in vals]
    validity = None
    if any(v.validity is not None for v in vals):
        validity = torch.cat([v.validity if v.validity is not None
                              else torch.ones(v.values.shape[0], dtype=torch.bool, device=v.values.device)
                              for v in vals])
    return Val(torch.cat([v.values for v in vals]), validity, target, table, ROW)


def _remap(codes: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """Codes through a remap table; an empty remap is the identity."""
    if len(remap) == 0:
        return codes
    return take_lut(remap, codes)


def map_over_table(v: Val, fn, *, memo=None, out_dtype: dt.DataType | None = None) -> Val:
    """A host function of one value over the dictionary: ``fn`` runs once per
    dictionary value (a result of None is null), its results become a new
    dictionary of their distinct values, and the codes are remapped through
    it by one gather. Up to ``config().ordinal_dict_max`` values the new
    dictionary is sorted, above it in order of first occurrence, as the JAX
    package keeps them. ``memo``: a key under which the input dictionary
    keeps the result, so that a function runs over it once, not once per
    collect. ``out_dtype``: the result's dtype (by default ``v``'s)."""

    def run():
        out = [fn(u) for u in v.table.values.tolist()]
        ok = np.fromiter((r is not None for r in out), bool, count=len(out))
        codes, _, table = strtable.encode_strings(np.asarray(out, dtype=object))
        return (codes if len(codes) else np.zeros(1, np.int32)), (None if ok.all() else ok), table

    remap, ok, table = run() if memo is None else v.table.memo(("map", memo), run)
    validity = v.validity if ok is None else combine_validity(v.validity, take_lut(ok, v.values))
    return v.with_(values=take_lut(remap, v.values), validity=validity, table=table,
                   dtype=v.dtype if out_dtype is None else out_dtype)
