"""Top-level functions outside ``functions/lazy.py`` (the port of
``polars_tpu/functions/parity.py``, trimmed to ``business_day_count``,
``arctan2`` and ``arctan2d``)."""

from __future__ import annotations

import datetime as _dt
from typing import Any

from polars_tpu_torch.expr.expr import Expr, parse_into_expr
from polars_tpu_torch.plan import exprs as E

_EPOCH = _dt.date(1970, 1, 1)


def business_day_count(start: Any, end: Any, week_mask: Any = None, holidays: Any = None) -> Expr:
    """Business days in [start, end) (``week_mask`` Monday first; holidays
    as dates or epoch days)."""
    mask = tuple(bool(x) for x in (week_mask if week_mask is not None else (1, 1, 1, 1, 1, 0, 0)))
    hol = tuple(sorted(_to_days(h) for h in (holidays or ())))
    return Expr(E.EFunction("business_day_count", (parse_into_expr(start), parse_into_expr(end)),
                            (("holidays", hol), ("week_mask", mask))))


def _to_days(d: Any) -> int:
    if isinstance(d, _dt.datetime):
        d = d.date()
    return (d - _EPOCH).days if isinstance(d, _dt.date) else int(d)


def arctan2(y: Any, x: Any) -> Expr:
    """The angle of the point (x, y) in radians (a string is a column)."""
    return Expr(E.EFunction("arctan2", (parse_into_expr(y), parse_into_expr(x))))


def arctan2d(y: Any, x: Any) -> Expr:
    """The angle of the point (x, y) in degrees."""
    return Expr(E.EFunction("arctan2", (parse_into_expr(y), parse_into_expr(x)), (("degrees", True),)))


# -- a user's functions over several columns (engine/udf.py) ---------------------------------------


def map_batches(exprs: Any, function: Any, return_dtype: Any = None, *, is_elementwise: bool = False,
                returns_scalar: bool = False) -> Expr:
    """``function`` of the list of the columns' Series (in a group-by, of
    each group's)."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.expr.expr import parse_into_expr_list
    from polars_tpu_torch.utils.tokens import next_token

    nodes = tuple(parse_into_expr_list(exprs if isinstance(exprs, (list, tuple)) else [exprs]))

    def as_list(arg):
        return function(arg if isinstance(arg, list) else [arg])

    node = E.EAnonymous(nodes, function=as_list, return_dtype=None if return_dtype is None
                        else dt.parse_into_dtype(return_dtype), ident=next_token(), returns_scalar=returns_scalar,
                        elementwise=is_elementwise)
    return Expr(node).alias((E.output_name(nodes[0]) if nodes else None) or "map")


def map_groups(exprs: Any, function: Any, return_dtype: Any = None, *, returns_scalar: bool = False) -> Expr:
    """``map_batches`` meant for a group-by: each group's Series."""
    return map_batches(exprs, function, return_dtype, returns_scalar=returns_scalar)


# -- cumulative folds (a Struct of every intermediate state) ----------------------------------------


def cum_fold(acc: Any, function: Any, exprs: Any, *, include_init: bool = False) -> Expr:
    from polars_tpu_torch.expr.expr import parse_into_expr_list
    from polars_tpu_torch.functions.lazy import struct

    out = Expr(parse_into_expr(acc, str_as_lit=True))
    fields = [out.alias("acc")] if include_init else []
    for n in parse_into_expr_list(exprs if isinstance(exprs, (list, tuple)) else [exprs]):
        out = function(out, Expr(n))
        fields.append(out.alias(E.output_name(n) or f"field_{len(fields)}"))
    return struct(fields).alias("cum_fold")


def cum_reduce(function: Any, exprs: Any) -> Expr:
    from polars_tpu_torch.expr.expr import parse_into_expr_list
    from polars_tpu_torch.functions.lazy import struct

    nodes = parse_into_expr_list(exprs if isinstance(exprs, (list, tuple)) else [exprs])
    if not nodes:
        raise ValueError("cum_reduce needs at least one expression")
    out = Expr(nodes[0])
    fields = [out.alias(E.output_name(nodes[0]) or "field_0")]
    for i, n in enumerate(nodes[1:], 1):
        out = function(out, Expr(n))
        fields.append(out.alias(E.output_name(n) or f"field_{i}"))
    return struct(fields).alias("cum_reduce")


def cum_sum_horizontal(*exprs: Any) -> Expr:
    from polars_tpu_torch.expr.expr import _flat

    return cum_reduce(lambda a, b: a + b, _flat(exprs)).alias("cum_sum")


# -- rolling moments of a pair ------------------------------------------------------------------------


def _rolling_pair(a: Any, b: Any, window_size: int, min_samples: int | None, ddof: int, want: str) -> Expr:
    """Over each window of ``window_size`` rows, the pairs where both are
    valid: their covariance (``ddof``) or Pearson correlation, from rolling
    sums of x, y, x*y (and x*x, y*y); null below ``min_samples`` pairs."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.functions.lazy import col, lit, when

    x = col(a) if isinstance(a, str) else a
    y = col(b) if isinstance(b, str) else b
    both = x.is_not_null() & y.is_not_null()
    xz = when(both).then(x.cast(dt.Float64())).otherwise(0.0)
    yz = when(both).then(y.cast(dt.Float64())).otherwise(0.0)
    n = both.cast(dt.Float64()).rolling_sum(window_size, min_samples=1)
    sx = xz.rolling_sum(window_size, min_samples=1)
    sy = yz.rolling_sum(window_size, min_samples=1)
    sxy = (xz * yz).rolling_sum(window_size, min_samples=1)
    need = float(min_samples if min_samples is not None else window_size)
    if want == "cov":
        out = (sxy - sx * sy / n) / (n - ddof)
        ok = (n >= need) & (n > ddof)
    else:
        sxx = (xz * xz).rolling_sum(window_size, min_samples=1)
        syy = (yz * yz).rolling_sum(window_size, min_samples=1)
        out = (n * sxy - sx * sy) / ((n * sxx - sx * sx) * (n * syy - sy * sy)).sqrt()
        ok = n >= need
    return when(ok).then(out).otherwise(lit(None)).alias(E.output_name(x._node) or want)


def rolling_corr(a: Any, b: Any, *, window_size: int, min_samples: int | None = None, ddof: int = 1) -> Expr:
    return _rolling_pair(a, b, window_size, min_samples, ddof, "corr")


def rolling_cov(a: Any, b: Any, *, window_size: int, min_samples: int | None = None, ddof: int = 1) -> Expr:
    return _rolling_pair(a, b, window_size, min_samples, ddof, "cov")


# -- temporal -------------------------------------------------------------------------------------------


def from_epoch(column: Any, time_unit: str = "s"):
    """Integers since the epoch as a Date (``"d"``) or a Datetime (``"s"``
    as microseconds; ``"ms"``, ``"us"``, ``"ns"`` as themselves); a
    Series gives a Series."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.core.series import Series
    from polars_tpu_torch.errors import InvalidOperationError

    if isinstance(column, Series):
        return column.to_frame().select(from_epoch(Expr(E.EColumn(column.name)), time_unit)).to_series()
    c = column if isinstance(column, Expr) else Expr(parse_into_expr(column))
    if time_unit == "d":
        return c.cast(dt.Int32()).cast(dt.Date())
    if time_unit == "s":
        return (c.cast(dt.Int64()) * 1_000_000).cast(dt.Datetime("us"))
    if time_unit in ("ms", "us", "ns"):
        return c.cast(dt.Int64()).cast(dt.Datetime(time_unit))
    raise InvalidOperationError(f"from_epoch: unknown time_unit {time_unit!r}")


def time(hour: Any = 0, minute: Any = 0, second: Any = 0, microsecond: Any = 0) -> Expr:
    """A Time of the day from its parts (values or expressions)."""
    from polars_tpu_torch import datatypes as dt

    def part(x: Any) -> Expr:
        return (x if isinstance(x, Expr) else Expr(parse_into_expr(x, str_as_lit=True))).cast(dt.Int64())

    us = part(hour) * 3_600_000_000 + part(minute) * 60_000_000 + part(second) * 1_000_000 + part(microsecond)
    return (us * 1000).cast(dt.Time()).alias("time")


def time_range(start: Any = None, end: Any = None, interval: str = "1h", *, closed: str = "both",
               eager: bool = False):
    """The Times of the day from ``start`` (midnight) to ``end``
    (23:59:59.999999) by ``interval``: a datetime range on 1970-01-01 as
    Times."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.functions.lazy import datetime_range

    def at(t: Any, default: _dt.time) -> _dt.datetime:
        t = default if t is None else t
        return _dt.datetime(1970, 1, 1, t.hour, t.minute, t.second, t.microsecond)

    rng = datetime_range(at(start, _dt.time(0)), at(end, _dt.time(23, 59, 59, 999999)), interval, closed=closed,
                         eager=eager)
    return rng.cast(dt.Time()).rename("time") if eager else rng.cast(dt.Time()).alias("time")


def linear_space(start: Any, end: Any, num_samples: Any, *, closed: str = "both", eager: bool = False):
    """``num_samples`` evenly spaced Float64 values from ``start`` to
    ``end`` (``closed`` says which bounds are among them)."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.engine.fn_generators import space_steps
    from polars_tpu_torch.functions.lazy import _eager_series, int_range, lit

    n = int(num_samples)
    s = lit(start).cast(dt.Float64()) if not isinstance(start, Expr) else start.cast(dt.Float64())
    e = lit(end).cast(dt.Float64()) if not isinstance(end, Expr) else end.cast(dt.Float64())
    first, denom = space_steps(n, closed)
    idx = int_range(first, first + n)
    out = (s + (e - s) * idx.cast(dt.Float64()) / float(denom)).alias("literal")
    return _eager_series(out, "literal") if eager else out


# -- frames ------------------------------------------------------------------------------------------


def align_frames(*frames: Any, on: Any, how: str = "full", descending: bool = False) -> list:
    """The frames each with one row per key of the union of their keys
    (``on``), sorted by it, null where a frame lacks the key."""
    if len(frames) < 2:
        return list(frames)
    keys = [on] if isinstance(on, str) else list(on)
    lazy = not hasattr(frames[0], "height")
    lfs = [f if lazy else f.lazy() for f in frames]
    idx = lfs[0].select(keys)
    for f in lfs[1:]:
        idx = idx.join(f.select(keys), on=keys, how=how, coalesce=True)
    idx = idx.unique(subset=keys).sort(keys, descending=descending)
    out = []
    for f in lfs:
        aligned = idx.join(f, on=keys, how="left", coalesce=True).sort(keys, descending=descending)
        out.append(aligned if lazy else aligned.collect())
    return out


def collect_all(lazy_frames: Any, **kwargs: Any) -> list:
    return [lf.collect(**kwargs) for lf in lazy_frames]


def explain_all(lazy_frames: Any, **kwargs: Any) -> str:
    return "\n".join(lf.explain(**kwargs) for lf in lazy_frames)


def union(items: Any, *, how: str = "vertical", strict: bool | None = None):
    """``concat`` without an order promise."""
    from polars_tpu_torch.functions.eager import concat

    return concat(items, how=how)


def merge_sorted(left: Any, right: Any, key: str):
    return left.merge_sorted(right, key)


# -- misc --------------------------------------------------------------------------------------------


def escape_regex(s: str) -> str:
    import re

    return re.escape(s)


def row_index(name: str = "index") -> Expr:
    """The row numbers (UInt32)."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.functions.lazy import int_range
    from polars_tpu_torch.functions.lazy import len as pl_len

    return int_range(0, pl_len(), dtype=dt.UInt32()).alias(name)


def set_random_seed(seed: int) -> None:
    """The seed of ``sample``/``shuffle`` calls that pass none."""
    from polars_tpu_torch.config import config

    config().random_seed = int(seed)



def collect_all_async(lazy_frames: Any, **kwargs: Any):
    """A future of ``collect_all`` run on a worker thread."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(collect_all, list(lazy_frames), **kwargs)
    pool.shutdown(wait=False)
    return future


def groups(column: str) -> Expr:
    """``col(column).agg_groups()``: each group's row positions."""
    from polars_tpu_torch.functions.lazy import col

    return col(column).agg_groups()


def list_(exprs: Any, *more_exprs: Any) -> Expr:
    """``concat_list`` under its older name, ``pl.list``."""
    from polars_tpu_torch.functions.lazy import concat_list

    return concat_list(exprs, *more_exprs)


def get_index_type():
    from polars_tpu_torch import datatypes as dt

    return dt.UInt32()


def thread_pool_size() -> int:
    import os

    return os.cpu_count() or 1


threadpool_size = thread_pool_size


def build_info() -> dict:
    import torch

    return {"version": "0", "torch": torch.__version__, "cuda": torch.version.cuda}


def show_versions() -> None:
    import sys

    import numpy as np
    import torch

    print(f"python {sys.version.split()[0]}\ntorch  {torch.__version__} (CUDA {torch.version.cuda})\n"
          f"numpy  {np.__version__}")


class StringCache:
    """A no-op context: each String column has its own dictionary, and
    dictionaries are merged where two meet (``utils/strtable.unify``)."""

    def __enter__(self) -> StringCache:
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


def enable_string_cache() -> None:
    return None


def disable_string_cache() -> None:
    return None


def using_string_cache() -> bool:
    return False
