"""Value casts (the port of ``polars_tpu/engine/cast.py``, trimmed to the
casts that type promotion needs in this slice: bool, integer and date values
to a wider integer or to a float), and the helpers that keep an unsigned
integer inside its logical width.

PyTorch has no arithmetic for uint16/32/64, so UInt16 and UInt32 live in the
next wider signed tensor and UInt64 as its bit pattern in int64
(``datatypes.dtype_to_torch``). Whatever produces such a value brings it back
into range with :func:`wrap_unsigned`; whatever orders UInt64 values goes
through :func:`order_word`; whatever reads one as a float through
:func:`float_values`.
"""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import Val

_BITS = {"Int8": 8, "Int16": 16, "Int32": 32, "Int64": 64, "UInt8": 8, "UInt16": 16, "UInt32": 32, "UInt64": 64}
_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1


def wrap_unsigned(values: torch.Tensor, dtype: dt.DataType) -> torch.Tensor:
    """``values`` modulo 2^16 / 2^32 for UInt16 / UInt32 held in a wider
    signed tensor; any other dtype wraps by itself (UInt8 in ``torch.uint8``,
    UInt64 in the bits of int64) and passes through."""
    if isinstance(dtype, dt.UInt16):
        return values & 0xFFFF
    if isinstance(dtype, dt.UInt32):
        return values & 0xFFFFFFFF
    return values


def order_word(values: torch.Tensor, dtype: dt.DataType) -> torch.Tensor:
    """A tensor whose signed order is the values' logical order: UInt64 bit
    patterns get their sign bit flipped (apply again to flip back)."""
    return values ^ _I64_MIN if isinstance(dtype, dt.UInt64) else values


def float_values(values: torch.Tensor, dtype: dt.DataType, target: torch.dtype) -> torch.Tensor:
    """``values`` as the float type ``target``; a UInt64 bit pattern is read
    as unsigned. Values of 2^63 and more are halved with the lost bit kept
    sticky, converted and doubled, which rounds exactly once."""
    if not isinstance(dtype, dt.UInt64):
        return values.to(target)
    half = ((values >> 1) & _I64_MAX) | (values & 1)
    return torch.where(values < 0, half.to(target) * 2, values.to(target))


def int_scalar(value: int, dtype: dt.DataType, device) -> torch.Tensor:
    """A one-element tensor holding ``value`` in ``dtype``'s storage type (a
    UInt64 of 2^63 or more as its bit pattern)."""
    if isinstance(dtype, dt.UInt64) and isinstance(value, int) and value > _I64_MAX:
        value -= 2**64
    return torch.tensor([value], dtype=dt.dtype_to_torch(dtype), device=device)


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
    tdt = dt.dtype_to_torch(target)
    values = float_values(v.values, v.dtype, tdt) if target.is_float() else v.values.to(tdt)
    return v.with_(values=values, dtype=target)
