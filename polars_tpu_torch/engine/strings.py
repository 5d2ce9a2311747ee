"""Device-side helpers for dictionary-coded string values (the port of
``polars_tpu/engine/strings.py``, trimmed to :func:`unify_vals`,
:func:`concat_vals` and :func:`map_over_table`)."""

from __future__ import annotations

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.cast import cast_val
from polars_tpu_torch.engine.common import ROW, Val, take_lut
from polars_tpu_torch.utils import strtable


def unify_vals(a: Val, b: Val) -> tuple[Val, Val]:
    """Remap two dictionary-coded Vals onto one merged table (ordinal iff
    both inputs are small and sorted; see ``strtable.unify``)."""
    if a.table is b.table:
        return a, b
    merged, lmap, rmap = strtable.unify(a.table, b.table)
    return a.with_(values=_remap(a.values, lmap), table=merged), b.with_(values=_remap(b.values, rmap), table=merged)


def concat_vals(vals: list[Val], target: dt.DataType) -> Val:
    """Row Vals one after another (a vertical concat's column): each cast to
    ``target``, dictionary-coded pieces put on one dictionary, the merge of
    all of theirs, and a validity kept where any piece has one."""
    vals = [cast_val(v, target) for v in vals]
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


def map_over_table(v: Val, fn) -> Val:
    """A string-valued host function over the dictionary: ``fn`` runs once per
    dictionary value, its results become a new sorted table of their distinct
    values (ordinal codes), and the codes are remapped through it by one
    gather; validity is kept. The JAX package keeps the results of a
    dictionary above 65536 values in insertion order; here every table comes
    out sorted, with the same strings per row."""
    out = [fn(u) for u in v.table.values.tolist()]
    uniques = sorted(set(out)) or [""]
    rank = {u: i for i, u in enumerate(uniques)}
    remap = np.fromiter(map(rank.__getitem__, out), np.int32, count=len(out))
    table = strtable.StringTable(np.asarray(uniques, dtype=object), sorted_order=True)
    return v.with_(values=_remap(v.values, remap), table=table)
