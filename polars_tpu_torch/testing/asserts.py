"""assert_frame_equal / assert_series_equal (the port of
``polars_tpu/testing/asserts.py``; reference: py-polars
testing/asserts/{frame.py,series.py})."""

from __future__ import annotations

import math
from typing import Any

from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.series import Series


class AssertionFailure(AssertionError):
    pass


def _values_equal(a: Any, b: Any, rtol: float, atol: float, check_exact: bool) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return True
        if check_exact:
            return a == b
        return math.isclose(a, b, rel_tol=rtol, abs_tol=atol)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) and not isinstance(a, bool) and not isinstance(b, bool):
        if check_exact:
            return a == b
        return math.isclose(float(a), float(b), rel_tol=rtol, abs_tol=atol)
    return a == b


def assert_series_equal(
    left: Series,
    right: Series,
    *,
    check_dtypes: bool = True,
    check_names: bool = True,
    check_exact: bool = False,
    check_order: bool = True,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    **kwargs: Any,
) -> None:
    if not isinstance(left, Series) or not isinstance(right, Series):
        raise AssertionFailure(
            f"inputs are different types: {type(left).__name__} vs {type(right).__name__}"
        )
    if len(left) != len(right):
        raise AssertionFailure(f"length mismatch: {len(left)} != {len(right)}")
    if check_names and left.name != right.name:
        raise AssertionFailure(f"name mismatch: {left.name!r} != {right.name!r}")
    if check_dtypes and left.dtype != right.dtype:
        raise AssertionFailure(f"dtype mismatch: {left.dtype!r} != {right.dtype!r}")
    lv, rv = left.to_list(), right.to_list()
    if not check_order:
        key = lambda x: (x is None, repr(x))  # noqa: E731
        lv, rv = sorted(lv, key=key), sorted(rv, key=key)
    for i, (a, b) in enumerate(zip(lv, rv)):
        if not _values_equal(a, b, rtol, atol, check_exact):
            raise AssertionFailure(
                f"value mismatch at index {i}: {a!r} != {b!r}\nleft:  {lv[:20]}\nright: {rv[:20]}"
            )


def assert_frame_equal(
    left: DataFrame,
    right: DataFrame,
    *,
    check_row_order: bool = True,
    check_column_order: bool = True,
    check_dtypes: bool = True,
    check_exact: bool = False,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    **kwargs: Any,
) -> None:
    if not isinstance(left, DataFrame) or not isinstance(right, DataFrame):
        raise AssertionFailure(
            f"inputs are different types: {type(left).__name__} vs {type(right).__name__}"
        )
    lc, rc = left.columns, right.columns
    if check_column_order:
        if lc != rc:
            raise AssertionFailure(f"columns mismatch: {lc} != {rc}")
    else:
        if sorted(lc) != sorted(rc):
            raise AssertionFailure(f"columns mismatch: {sorted(lc)} != {sorted(rc)}")
        right = right.select(lc)
    if left.height != right.height:
        raise AssertionFailure(f"height mismatch: {left.height} != {right.height}")
    if not check_row_order:
        left = left.sort(lc, nulls_last=True)
        right = right.sort(lc, nulls_last=True)
    for name in lc:
        assert_series_equal(
            left.get_column(name),
            right.get_column(name),
            check_dtypes=check_dtypes,
            check_exact=check_exact,
            check_names=True,
            rtol=rtol,
            atol=atol,
        )


def assert_frame_not_equal(left: DataFrame, right: DataFrame, **kwargs: Any) -> None:
    try:
        assert_frame_equal(left, right, **kwargs)
    except AssertionError:
        return
    raise AssertionFailure("frames are equal")


def assert_series_not_equal(left: Series, right: Series, **kwargs: Any) -> None:
    try:
        assert_series_equal(left, right, **kwargs)
    except AssertionError:
        return
    raise AssertionFailure("series are equal")
