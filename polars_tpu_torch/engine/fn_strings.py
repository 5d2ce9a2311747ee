"""String functions over dictionary-coded columns (the port of
``polars_tpu/engine/fn_strings.py``, trimmed to ``str.starts_with`` with a
literal prefix).

Device tensors hold int32 codes; a string op runs once per dictionary value
on the host, and its result becomes a lookup table gathered by the codes on
the device: O(|dictionary|) host work, one O(n) gather.
"""

from __future__ import annotations

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import Val, take_lut
from polars_tpu_torch.engine.registry import BOOL, register
from polars_tpu_torch.errors import InvalidOperationError


def _require_str(v: Val) -> Val:
    if v.table is None:
        raise InvalidOperationError(f"expected a String column, got {v.dtype!r}")
    return v


def _lut_op(v: Val, fn, out_dtype: dt.DataType) -> Val:
    """``fn`` over the dictionary's values on the host, gathered by the codes."""
    outs = np.asarray([fn(u) for u in v.table.values] or [0], dt.dtype_to_numpy(out_dtype))
    return Val(take_lut(outs, v.values), v.validity, out_dtype, None, v.domain)


@register("str.starts_with", BOOL)
def _starts_with(ctx, args, opts):
    p = opts["prefix"]
    return _lut_op(_require_str(args[0]), lambda s: s.startswith(p), dt.Boolean())
