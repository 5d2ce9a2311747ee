"""Value casts (the port of ``polars_tpu/engine/cast.py``, trimmed to the
casts the ported queries make: bool, integer and date values to a wider
integer or to a float, as type promotion and ``cast(pl.Int64)`` of a Boolean
need them; the temporal casts (Date and Datetime both ways, Datetime to
Time, Time to Duration, between time units with floor division, between
time zones on the same instants, and between temporal and integer storage;
a Datetime with a time zone gives the Date and Time of its zone's wall
clock); and a null to any numeric, bool or temporal type), and the
helpers that keep an unsigned integer inside its logical width.

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
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels.fastmath import floordiv_const

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


def tu_convert(values: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Ticks of time unit ``src`` as ticks of ``dst`` (coarser units floor)."""
    a, b = dt.TICKS_PER_SECOND[src], dt.TICKS_PER_SECOND[dst]
    if a == b:
        return values
    return values * (b // a) if b > a else floordiv_const(values, a // b)


def _temporal_cast(v: Val, target: dt.DataType) -> Val | None:
    """The casts of a temporal value (or to one from an integer), or None
    where neither side is temporal."""
    src = v.dtype
    sn, tn = type(src).__name__, type(target).__name__
    if not (src.is_temporal() or target.is_temporal()):
        return None
    x = v.values
    if sn == "Date" and tn == "Datetime":
        return v.with_(values=x.to(torch.int64) * (dt.TICKS_PER_SECOND[target.time_unit] * 86_400), dtype=target)
    if sn == "Datetime" and tn in ("Date", "Time") and src.time_zone:
        # the day and the time of day of the zone's wall clock, as Polars
        # takes them (the JAX package takes UTC's)
        from polars_tpu_torch.kernels.timezone import local_from_utc

        x = local_from_utc(x, src.time_unit, src.time_zone)
    if sn == "Datetime" and tn == "Date":
        days = floordiv_const(x, dt.TICKS_PER_SECOND[src.time_unit] * 86_400)
        return v.with_(values=days.to(torch.int32), dtype=target)
    if (sn, tn) in (("Datetime", "Datetime"), ("Duration", "Duration")):
        # a change of zone, to or from none, keeps the UTC instants
        return v.with_(values=tu_convert(x, src.time_unit, target.time_unit), dtype=target)
    if sn == "Datetime" and tn == "Time":  # the time of day, in nanoseconds
        per_day = dt.TICKS_PER_SECOND[src.time_unit] * 86_400
        return v.with_(values=tu_convert(x - floordiv_const(x, per_day) * per_day, src.time_unit, "ns"), dtype=target)
    if sn == "Time" and tn == "Duration":
        return v.with_(values=tu_convert(x, "ns", target.time_unit), dtype=target)
    if src.is_temporal() and target.is_numeric():
        values = x.to(dt.dtype_to_torch(target))
        return v.with_(values=wrap_unsigned(values, target), dtype=target)
    if src.is_integer() and target.is_temporal():
        return v.with_(values=x.to(dt.dtype_to_torch(target)), dtype=target)
    if isinstance(src, dt.Null):
        return v.with_(values=x.to(dt.dtype_to_torch(target)), dtype=target)
    raise InvalidOperationError(f"cannot cast {src!r} to {target!r}")


def _lossless(src: dt.DataType, target: dt.DataType) -> bool:
    if isinstance(src, dt.Null):  # every value is null: any storage holds it
        return target.is_numeric() or isinstance(target, dt.Boolean)
    if target.is_float():
        return src.is_numeric() or isinstance(src, dt.Boolean)
    if isinstance(src, dt.Boolean):
        return target.is_integer()
    sn, tn = type(src).__name__, type(target).__name__
    if sn not in _BITS or tn not in _BITS:
        return False
    if src.is_signed_integer() and target.is_unsigned_integer():
        return False
    need = _BITS[sn] + (1 if src.is_unsigned_integer() and target.is_signed_integer() else 0)
    return _BITS[tn] >= need


def cast_val(v: Val, target: dt.DataType, *, strict: bool = False) -> Val:
    if v.dtype == target:
        return v
    out = _temporal_cast(v, target)
    if out is not None:
        return out
    if not _lossless(v.dtype, target):
        raise NotImplementedError(
            f"cast from {v.dtype!r} to {target!r} is not ported yet (port queue: expression breadth)"
        )
    tdt = dt.dtype_to_torch(target)
    values = float_values(v.values, v.dtype, tdt) if target.is_float() else v.values.to(tdt)
    return v.with_(values=values, dtype=target)
