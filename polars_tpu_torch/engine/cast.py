"""Value casts (the port of ``polars_tpu/engine/cast.py`` and of the
numeric and string logic of ``polars_tpu/ops/cast.py``, rewritten on
tensors), and the helpers that keep an unsigned integer inside its logical
width.

The casts: between any numeric and Boolean types (an integer out of the
target's range, or a float that is NaN, infinite or out of range after
truncation toward zero, becomes null; ``wrap`` wraps integers instead);
String to numbers, Boolean, Date and Datetime, one parse per distinct
dictionary value, kept on the dictionary (``StringTable.memo``); the
temporal casts (Date and Datetime both ways, Datetime to Time, Time to
Duration, between time units with floor division, between time zones on
the same instants, and between temporal and integer storage; a Datetime
with a time zone gives the Date and Time of its zone's wall clock); to and
from Decimal (int64 scaled by 10^scale); and a null to any type. A cast to String is a host function
(``engine/hostops.py``): it formats each distinct value once. A value the
cast makes null is what a strict cast raises for: the compiler turns it
into a validation flag on the segment's count read
(``compiler._eval_cast``), so a cast adds no host read.

PyTorch has no arithmetic for uint16/32/64, so UInt16 and UInt32 live in the
next wider signed tensor and UInt64 as its bit pattern in int64
(``datatypes.dtype_to_torch``). Whatever produces such a value brings it back
into range with :func:`wrap_unsigned`; whatever orders UInt64 values goes
through :func:`order_word`; whatever reads one as a float through
:func:`float_values`.
"""

from __future__ import annotations

import torch

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import Val, combine_validity, empty_child, take_lut
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels.argsort import refuse_nested_key
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
    refuse_nested_key(dtype, "an ordered value")
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


def int_bounds(dtype: dt.DataType) -> tuple[int, int]:
    """The logical range of an integer dtype."""
    bits = _BITS[type(dtype).__name__]
    if dtype.is_unsigned_integer():
        return 0, 2**bits - 1
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def wrap_int(x: torch.Tensor, target: dt.DataType) -> torch.Tensor:
    """int64 values (a UInt64's bit pattern) wrapped into ``target``'s width,
    in its storage dtype (two's complement, as a native cast)."""
    bits = _BITS[type(target).__name__]
    if bits < 64:
        x = x & ((1 << bits) - 1)
        if target.is_signed_integer():
            x = torch.where(x >= 2 ** (bits - 1), x - 2**bits, x)
    return x.to(dt.dtype_to_torch(target))


def _int_to_int(v: Val, target: dt.DataType, wrap: bool) -> Val:
    x = v.values.to(torch.int64)
    lo, hi = int_bounds(target)
    if isinstance(v.dtype, dt.UInt64):  # a negative int64 holds 2^63 or more; every other target's hi < 2^63
        ok = (x >= 0) & (x <= hi)
    else:
        slo, shi = int_bounds(v.dtype)
        ok = None if lo <= slo and shi <= hi else (x >= max(lo, slo)) & (x <= min(hi, shi))
    validity = v.validity if wrap or ok is None else combine_validity(v.validity, ok)
    return v.with_(values=wrap_int(x, target), validity=validity, dtype=target, table=None)


def _float_to_int(v: Val, target: dt.DataType) -> Val:
    """Truncation toward zero; NaN, the infinities and what lies out of the
    target's range after truncation are null."""
    t = torch.trunc(v.values.to(torch.float64))
    lo, hi = int_bounds(target)
    ok = torch.isfinite(t) & (t >= float(lo)) & (t < float(hi) + 1.0)
    t = torch.where(ok, t, torch.zeros((), dtype=t.dtype, device=t.device))
    if isinstance(target, dt.UInt64):  # 2^63 and more as their int64 bits
        big = t >= 2.0**63
        x = torch.where(big, t - 2.0**64, t).to(torch.int64)
    else:
        x = t.to(torch.int64)
    return v.with_(values=wrap_int(x, target), validity=combine_validity(v.validity, ok), dtype=target, table=None)


def _decimal_cast(v: Val, target: dt.DataType, wrap: bool) -> Val:
    """Casts to and from Decimal (int64 scaled by 10^scale), as the JAX
    package's ``cast.py:145-160``: a smaller scale and an integer floor
    the value, a float rounds half to even; a value that leaves int64 (or
    the integer target's range) is null."""
    src = v.dtype
    x = v.values
    if isinstance(src, dt.Decimal):
        if isinstance(target, dt.Decimal):
            if target.scale >= src.scale:
                f = 10 ** (target.scale - src.scale)
                ok = (x.abs() <= _I64_MAX // f) if f > 1 else None
                return v.with_(values=x * f, validity=combine_validity(v.validity, ok), dtype=target)
            return v.with_(values=floordiv_const(x, 10 ** (src.scale - target.scale)), dtype=target)
        if target.is_float():
            return v.with_(values=(x.to(torch.float64) / 10.0**src.scale).to(dt.dtype_to_torch(target)), dtype=target)
        if isinstance(target, dt.Boolean):
            return v.with_(values=x != 0, dtype=target)
        if target.is_integer():
            ints = v.with_(values=floordiv_const(x, 10**src.scale), dtype=dt.Int64())
            return _int_to_int(ints, target, wrap)
        raise InvalidOperationError(f"cannot cast {src!r} to {target!r}")
    f = 10**target.scale
    if isinstance(src, dt.Boolean):
        return v.with_(values=x.to(torch.int64) * f, dtype=target)
    if src.is_integer():
        ok = None
        if isinstance(src, dt.UInt64):
            ok = (x >= 0) & (x <= _I64_MAX // f)
        elif f > 1 and int_bounds(src)[1] > _I64_MAX // f:
            ok = x.to(torch.int64).abs() <= _I64_MAX // f
        return v.with_(values=x.to(torch.int64) * f, validity=combine_validity(v.validity, ok), dtype=target)
    if src.is_float():
        scaled = torch.round(x.to(torch.float64) * float(f))
        ok = torch.isfinite(scaled) & (scaled.abs() < 2.0**63)
        values = torch.where(ok, scaled, torch.zeros((), dtype=scaled.dtype, device=x.device)).to(torch.int64)
        return v.with_(values=values, validity=combine_validity(v.validity, ok), dtype=target)
    raise InvalidOperationError(f"cannot cast {src!r} to {target!r}")


def _parse_table(v: Val, target: dt.DataType) -> Val:
    """A dictionary-coded String parsed into ``target``: each distinct value
    once on the host (kept on the dictionary), gathered by the codes; what
    does not parse is null."""
    tn = type(target).__name__

    def parse_one(u):
        s = str(u).strip()
        if tn == "Boolean":
            low = s.lower()
            if low in ("true", "1"):
                return True
            if low in ("false", "0"):
                return False
            return None
        if tn in ("Date", "Datetime"):
            d = np.datetime64(s, "D" if tn == "Date" else target.time_unit)
            return None if np.isnat(d) else int(d.astype(np.int64))
        if target.is_float():
            return float(dt.dtype_to_numpy(target).type(s))
        if tn == "Decimal":
            import decimal

            try:
                value = int(decimal.Decimal(s).scaleb(target.scale).to_integral_value(decimal.ROUND_HALF_EVEN))
            except decimal.InvalidOperation:
                return None
            return value if abs(value) <= _I64_MAX else None
        value = int(s)
        lo, hi = int_bounds(target)
        return value if lo <= value <= hi else None

    def run():
        outs, ok = [], []
        for u in v.table.values:
            try:
                r = parse_one(u)
            except (ValueError, OverflowError, TypeError):
                r = None
            ok.append(r is not None)
            outs.append(0 if r is None else r)
        if not outs:
            outs, ok = [0], [False]
        if target.is_integer() or tn == "Decimal":  # storage: a UInt64 of 2^63 or more as its bits
            arr = np.asarray([x - 2**64 if x > _I64_MAX else x for x in outs], np.int64)
        else:
            arr = np.asarray(outs, np.int64 if tn in ("Date", "Datetime") else dt.dtype_to_numpy(target))
        return arr, np.asarray(ok, bool)

    parsed, ok = v.table.memo(("cast", repr(target)), run)
    values = take_lut(parsed, v.values).to(dt.dtype_to_torch(target))
    okv = None if ok.all() else take_lut(ok, v.values)
    return Val(values, combine_validity(v.validity, okv), target, None, v.domain)


def cast_val(v: Val, target: dt.DataType, *, wrap: bool = False) -> Val:
    """``v`` as ``target``. A value that does not fit becomes null (the
    caller raises for it when the cast is strict); with ``wrap`` an integer
    wraps instead. Never raises for a value."""
    src = v.dtype
    if src == target:
        return v
    if isinstance(src, (dt.List, dt.Array)) and isinstance(target, (dt.List, dt.Array)):
        # the words stay; the child is cast (a List to an Array of its
        # width is ``list.to_array``)
        if isinstance(target, dt.Array) and not (isinstance(src, dt.Array) and src.size == target.size):
            raise InvalidOperationError(f"cannot cast {src!r} to {target!r}: use list.to_array")
        return v.with_(dtype=target, child=cast_val(v.child, target.inner, wrap=wrap))
    if isinstance(src, dt.NestedType) or isinstance(target, dt.NestedType) and not isinstance(src, dt.Null):
        raise InvalidOperationError(f"cannot cast {src!r} to {target!r}")
    if isinstance(src, dt.Null):
        from polars_tpu_torch.utils.strtable import empty_table

        text = _is_text(target)
        tdt = torch.int32 if text else dt.dtype_to_torch(target)
        return Val(torch.zeros(v.values.shape, dtype=tdt, device=v.values.device),
                   torch.zeros(v.values.shape, dtype=torch.bool, device=v.values.device), target,
                   empty_table() if text else None, v.domain, empty_child(target, v.values.device))
    if _is_text(target):
        if v.table is not None and isinstance(target, dt.Enum):
            # onto the categories' positions; a value outside them is null
            # (a strict cast fails at the segment's count read)
            from polars_tpu_torch.engine.compiler import enum_remap
            from polars_tpu_torch.utils.strtable import enum_table

            return enum_remap(v, enum_table(target.categories)).with_(dtype=target)
        if v.table is not None and isinstance(target, (dt.String, dt.Categorical)) and \
                isinstance(src, (dt.String, dt.Categorical, dt.Enum)):
            return v.with_(dtype=target)
        raise InvalidOperationError(
            f"a cast from {src!r} to {target!r} runs on the host: only in a select or with_columns")
    if v.table is not None:
        if isinstance(src, (dt.Categorical, dt.Enum)) and target.is_integer():  # the physical codes
            return _int_to_int(v.with_(dtype=dt.UInt32(), table=None), target, False)
        if target.is_numeric() or type(target).__name__ in ("Boolean", "Date", "Datetime"):
            return _parse_table(v, target)
        raise InvalidOperationError(f"cannot cast {src!r} to {target!r}")
    out = _temporal_cast(v, target)
    if out is not None:
        return out
    if isinstance(src, dt.Decimal) or isinstance(target, dt.Decimal):
        return _decimal_cast(v, target, wrap)
    if not ((src.is_numeric() or isinstance(src, dt.Boolean)) and (target.is_numeric() or isinstance(target, dt.Boolean))):
        raise InvalidOperationError(f"cannot cast {src!r} to {target!r}")
    if isinstance(target, dt.Boolean):
        return v.with_(values=v.values != 0, dtype=target)
    if target.is_float():
        return v.with_(values=float_values(v.values, src, dt.dtype_to_torch(target)), dtype=target)
    if isinstance(src, dt.Boolean):
        return v.with_(values=v.values.to(dt.dtype_to_torch(target)), dtype=target)
    if src.is_float():
        return _float_to_int(v, target)
    return _int_to_int(v, target, wrap)


def _is_text(d: dt.DataType) -> bool:
    return isinstance(d, (dt.String, dt.Categorical, dt.Enum, dt.Binary))
