"""Time-zone math for Datetime columns with a time zone (the port of
``polars_tpu/kernels/timezone.py``).

A tz-aware Datetime stores UTC instants, as Polars does. The offset of an
instant is a ``torch.searchsorted`` over the zone's transition table and a
gather: no host callback per value. The table is built once per zone on
the host from ``zoneinfo``, which lists no transitions, so the walk steps
from 1884 to 2100 in 20-day strides and bisects each change of offset to
the second. Each (zone, time unit) table goes to a device once and stays
there (``_device_tables``).

Not a Pallas kernel in the JAX package either: plain ops there, plain
torch ops here.
"""

from __future__ import annotations

import functools
from datetime import datetime, timezone

import numpy as np
import torch

from polars_tpu_torch.datatypes import TICKS_PER_SECOND
from polars_tpu_torch.errors import ComputeError

_US = 1_000_000
_FAR = 2**62  # past the last transition


def zone_name(tzinfo) -> str:
    """The zone name of a ``tzinfo``, UTC spelt ``"UTC"``."""
    z = str(tzinfo)
    return "UTC" if z in ("UTC", "utc", "UTC+00:00") else z


def zone(tz_name: str):
    """The ``ZoneInfo`` of a zone name; an unknown name raises ComputeError."""
    from zoneinfo import ZoneInfo, ZoneInfoNotFoundError

    try:
        return ZoneInfo(tz_name)
    except (ZoneInfoNotFoundError, ValueError) as exc:
        raise ComputeError(f"unable to parse time zone: {tz_name!r}") from exc


def _offsets_us(tz, epoch_s: int) -> tuple[int, int]:
    """(total UTC offset, DST part) in microseconds at a UTC second."""
    d = datetime.fromtimestamp(epoch_s, tz=timezone.utc).astimezone(tz)
    dst = d.dst()
    return int(d.utcoffset().total_seconds() * _US), 0 if dst is None else int(dst.total_seconds() * _US)


@functools.lru_cache(maxsize=64)
def tz_table(tz_name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(transition instants in UTC microseconds, total offset, DST offset):
    row i holds for the instants in [transition[i], transition[i + 1])."""
    tz = zone(tz_name)
    lo = int(datetime(1884, 1, 1, tzinfo=timezone.utc).timestamp())
    hi = int(datetime(2100, 1, 1, tzinfo=timezone.utc).timestamp())
    step = 20 * 86_400
    instants, offs = [lo], [_offsets_us(tz, lo)]
    t = lo
    while t < hi:
        t2 = min(t + step, hi)
        here = _offsets_us(tz, t)
        if _offsets_us(tz, t2) != here:
            a, b = t, t2
            while b - a > 1:
                m = (a + b) // 2
                if _offsets_us(tz, m) == here:
                    a = m
                else:
                    b = m
            instants.append(b)
            offs.append(_offsets_us(tz, b))
        t = t2
    return (np.asarray(instants, np.int64) * _US, np.asarray([o for o, _ in offs], np.int64),
            np.asarray([d for _, d in offs], np.int64))


def _scaled_tables(tz_name: str, time_unit: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The zone's table in ticks of ``time_unit`` (milliseconds floor)."""
    trans, offs, dsts = tz_table(tz_name)
    scale = TICKS_PER_SECOND[time_unit]
    if scale >= _US:
        k = scale // _US
        return trans * k, offs * k, dsts * k
    k = _US // scale
    return trans // k, offs // k, dsts // k


@functools.lru_cache(maxsize=256)
def _device_tables(tz_name: str, time_unit: str, device: torch.device) -> dict[str, torch.Tensor]:
    """The scaled table on ``device``: transitions (with a sentinel past the
    last), offsets, DST offsets, and each interval's first local wall time."""
    trans, offs, dsts = _scaled_tables(tz_name, time_unit)
    t = {"trans": np.append(trans, _FAR), "offs": offs, "dsts": dsts, "local_starts": trans + offs}
    return {k: torch.as_tensor(v).to(device) for k, v in t.items()}


def _interval(values: torch.Tensor, t: dict[str, torch.Tensor]) -> torch.Tensor:
    """The table row of each UTC instant."""
    idx = torch.searchsorted(t["trans"][:-1], values, right=True) - 1
    return idx.clamp(0, t["offs"].shape[0] - 1)


def utc_offset(values: torch.Tensor, time_unit: str, tz_name: str) -> torch.Tensor:
    """The total UTC offset of each UTC instant, in ticks of ``time_unit``."""
    t = _device_tables(tz_name, time_unit, values.device)
    return t["offs"].index_select(0, _interval(values, t).reshape(-1)).reshape(values.shape)


def dst_offset(values: torch.Tensor, time_unit: str, tz_name: str) -> torch.Tensor:
    """The DST part of each UTC instant's offset, in ticks of ``time_unit``."""
    t = _device_tables(tz_name, time_unit, values.device)
    return t["dsts"].index_select(0, _interval(values, t).reshape(-1)).reshape(values.shape)


def local_from_utc(values: torch.Tensor, time_unit: str, tz_name: str) -> torch.Tensor:
    """UTC instants as the zone's wall-clock values (the same epoch encoding)."""
    return values + utc_offset(values, time_unit, tz_name)


def utc_from_local(values: torch.Tensor, time_unit: str, tz_name: str,
                   ambiguous: str = "earliest") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wall-clock values of the zone as (UTC instants, ambiguous, non-existent).

    A wall time is read with the offset of the interval whose local span
    holds it (candidate A) and with the offset before it (candidate B); a
    candidate counts where its instant falls back into its own interval.
    Both count in a fall-back hour (ambiguous): ``"latest"`` takes A, the
    later instant, anything else B, the earlier one. Neither counts in a
    spring-forward gap (non-existent): the value moves forward by the gap
    (A); the caller nulls it or raises."""
    t = _device_tables(tz_name, time_unit, values.device)
    trans, offs = t["trans"], t["offs"]
    last = offs.shape[0] - 1
    flat = values.reshape(-1)
    ia = (torch.searchsorted(t["local_starts"], flat, right=True) - 1).clamp(0, last)
    ib = (ia - 1).clamp(0, last)
    utc_a = flat - offs.index_select(0, ia)
    utc_b = flat - offs.index_select(0, ib)
    valid_a = (utc_a >= trans.index_select(0, ia)) & (utc_a < trans.index_select(0, ia + 1))
    valid_b = (ia != ib) & (utc_b >= trans.index_select(0, ib)) & (utc_b < trans.index_select(0, ib + 1))
    is_ambiguous = valid_a & valid_b
    is_nonexistent = ~valid_a & ~valid_b
    if ambiguous == "latest":
        out = torch.where(valid_a, utc_a, utc_b)
    else:
        out = torch.where(valid_b, utc_b, utc_a)
    out = torch.where(is_nonexistent, utc_a, out)
    shape = values.shape
    return out.reshape(shape), is_ambiguous.reshape(shape), is_nonexistent.reshape(shape)
