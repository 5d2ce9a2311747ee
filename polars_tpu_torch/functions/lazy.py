"""Lazy top-level functions (the port of ``polars_tpu/functions/lazy.py``,
trimmed to ``col``, ``lit`` and ``len``)."""

from __future__ import annotations

import datetime as _pydt
from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.expr.expr import Expr
from polars_tpu_torch.plan import exprs as E


def col(name: str) -> Expr:
    """Reference to one column by name."""
    if not isinstance(name, str) or name == "*":
        raise NotImplementedError("col() of several columns, wildcards or dtypes is not ported yet")
    return Expr(E.EColumn(name))


def lit(value: Any, dtype: Any = None) -> Expr:
    """A scalar literal."""
    if isinstance(value, Expr):
        return value
    if isinstance(value, _pydt.datetime):
        raise NotImplementedError("Datetime literals are not ported yet (port queue: rest of PDS-H)")
    if isinstance(value, _pydt.date) and dtype is None:
        return Expr(E.ELiteral(value.isoformat(), dt.Date()))
    if isinstance(value, np.generic):
        value = value.item()
        if dtype is None:
            dtype = dt.numpy_to_dtype(np.asarray(value).dtype)
    if isinstance(value, (list, tuple, np.ndarray)):
        raise NotImplementedError("Series literals are not ported yet (port queue: expression breadth)")
    return Expr(E.ELiteral(value, dt.parse_into_dtype(dtype) if dtype is not None else None))


def len() -> Expr:  # noqa: A001
    """Row count (per group inside an aggregation)."""
    return Expr(E.ELen())
