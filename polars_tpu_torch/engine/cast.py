"""Value casts (the port of ``polars_tpu/engine/cast.py``, trimmed to the
casts that type promotion needs in this slice: bool, integer and date values
to a wider integer or to a float)."""

from __future__ import annotations

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import Val

_BITS = {"Int8": 8, "Int16": 16, "Int32": 32, "Int64": 64, "UInt8": 8, "UInt16": 16, "UInt32": 32}


def _lossless(src: dt.DataType, target: dt.DataType) -> bool:
    if target.is_float():
        return src.is_numeric() or isinstance(src, (dt.Boolean, dt.Date))
    if isinstance(src, dt.Boolean):
        return target.is_integer()
    sn, tn = type(src).__name__, type(target).__name__
    if isinstance(src, dt.Date):
        sn = "Int32"
    if sn not in _BITS or tn not in _BITS:
        return False
    if src.is_signed_integer() and target.is_unsigned_integer():
        return False
    need = _BITS[sn] + (1 if src.is_unsigned_integer() and target.is_signed_integer() else 0)
    return _BITS[tn] >= need


def cast_val(v: Val, target: dt.DataType, *, strict: bool = False) -> Val:
    if v.dtype == target:
        return v
    if not _lossless(v.dtype, target):
        raise NotImplementedError(
            f"cast from {v.dtype!r} to {target!r} is not ported yet (port queue: expression breadth)"
        )
    return v.with_(values=v.values.to(dt.dtype_to_torch(target)), dtype=target)
