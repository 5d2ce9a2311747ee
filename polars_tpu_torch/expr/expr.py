"""The fluent ``Expr`` wrapper over the expression AST (the port of
``polars_tpu/expr/expr.py``, trimmed to the operations the ported queries
evaluate: arithmetic, comparison, boolean ``&``/``|``/``~``, casts, ``is_in``,
``is_between``, the null functions (``is_null``, ``fill_null`` with a value,
``fill_nan``, ``coalesce``, the NaN and finiteness tests), the ``.str`` and
``.dt`` namespaces, aliasing, the unary and math functions, the ``name``
namespace, ``exclude`` over a wildcard or selector, and the sum, mean, min,
max, count, len, first, last, n_unique, null_count, std, var, median,
quantile, product, any, all, arg_min, arg_max, skew, kurtosis, entropy,
bitwise and item aggregations, windows (``over``), the order and position
functions, the expression-level sort, filter, slice and gather, the
rolling, exponentially weighted and cumulative windows, and the recoding
functions (``replace``, ``replace_strict``, ``hash``, ``cut``, ``qcut``,
``rle_id``, ``search_sorted``, ``index_of``, the bit counts) with the
operator aliases). Nothing executes until a plan is collected. The methods
of later slices raise ``NotImplementedError`` naming their queue item
(``polars_tpu_torch/later.py``).
"""

from __future__ import annotations

import datetime as _pydt
from typing import Any, Callable, Iterable

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels.timezone import zone_name
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.utils.tokens import next_token


def series_literal(values: Any) -> E.ESeriesLit:
    """A list, tuple or 1-D array as a literal Series node. Its column is
    built on the CPU (it is a handful of values); evaluation moves it to the
    frame's device."""
    from polars_tpu_torch.core.column import Column

    vals = values if isinstance(values, np.ndarray) else list(values)
    return E.ESeriesLit(column=Column.from_values("literal", vals, device="cpu"), ident=next_token())


def temporal_literal(value: Any) -> E.ELiteral:
    """A Python date, datetime or timedelta as a literal: a Date, a
    ``Datetime("us")`` (from its ISO string; an aware datetime is its UTC
    instant, with an explicit offset, in a Datetime of its zone) or a
    ``Duration("us")``."""
    if isinstance(value, _pydt.datetime) and value.tzinfo is not None:
        utc = value.astimezone(_pydt.timezone.utc)
        return E.ELiteral(utc.isoformat(), dt.Datetime("us", zone_name(value.tzinfo)))
    if isinstance(value, _pydt.datetime):
        return E.ELiteral(value.isoformat(), dt.Datetime("us"))
    if isinstance(value, _pydt.date):
        return E.ELiteral(value.isoformat(), dt.Date())
    return E.ELiteral((value.days * 86_400 + value.seconds) * 1_000_000 + value.microseconds, dt.Duration("us"))


def _opts(**kwargs: Any) -> tuple[tuple[str, Any], ...]:
    return tuple(sorted(kwargs.items()))


def parse_into_expr(value: Any, *, str_as_lit: bool = False) -> E.ENode:
    """Coerce user input into an AST node (py-polars parse_into_expression)."""
    if isinstance(value, Expr):
        return value._node
    if isinstance(value, E.ENode):
        return value
    if isinstance(value, str) and not str_as_lit:
        return E.EColumn(value)
    if isinstance(value, (_pydt.date, _pydt.timedelta)):
        return temporal_literal(value)
    if isinstance(value, np.generic):
        return E.ELiteral(value.item(), dt.numpy_to_dtype(value.dtype))
    if isinstance(value, (list, tuple, np.ndarray)):
        return series_literal(value)
    from polars_tpu_torch.core.series import Series

    if isinstance(value, Series):  # a literal Series of its own length
        return E.ESeriesLit(column=value._column, ident=next_token())
    return E.ELiteral(value)


def parse_into_expr_list(exprs: Any, named: dict[str, Any] | None = None) -> list[E.ENode]:
    items = [exprs] if isinstance(exprs, (Expr, str, E.ENode)) or not isinstance(exprs, Iterable) else list(exprs)
    flat: list[Any] = []
    for it in items:
        if isinstance(it, (list, tuple)):
            flat.extend(it)
        else:
            flat.append(it)
    out = [parse_into_expr(it) for it in flat]
    for name, v in (named or {}).items():
        out.append(E.EAlias(parse_into_expr(v), name))
    return out


class Expr:
    __slots__ = ("_node",)

    def __init__(self, node: E.ENode) -> None:
        self._node = node

    def __repr__(self) -> str:
        return f"<Expr [{self._node!r}]>"

    def _fn(self, name: str, *inputs: Any, **options: Any) -> Expr:
        nodes = (self._node, *(parse_into_expr(i, str_as_lit=True) for i in inputs))
        return Expr(E.EFunction(name, nodes, _opts(**options)))

    def alias(self, name: str) -> Expr:
        return Expr(E.EAlias(self._node, name))

    def cast(self, dtype: Any, *, strict: bool = True, wrap_numerical: bool = False) -> Expr:
        """``dtype`` values: a value that does not fit (an integer out of
        range, NaN or an infinity to an integer, text that does not parse)
        fails the query when ``strict``, else is null; ``wrap_numerical``
        wraps integers and floats into an integer type instead, as Polars
        does (the JAX package takes the flag and ignores it)."""
        # a DataTypeExpr is resolved when the expression enters a plan
        target = dtype if isinstance(dtype, dt.DataTypeExpr) else dt.parse_into_dtype(dtype)
        if wrap_numerical:
            return self._fn("cast_wrap", dtype=target)
        return Expr(E.ECast(self._node, target, strict))

    def to_physical(self) -> Expr:
        return self._fn("to_physical")

    def exclude(self, *names: Any) -> Expr:
        """A wildcard or selector without the columns ``names``."""
        flat = [n for x in names for n in ([x] if isinstance(x, str) else x)]
        node = self._node
        if isinstance(node, E.EColumns) and node.names:
            node = E.ESelector("by_name", node.names)
        elif isinstance(node, E.EDtypeColumns):
            node = E.ESelector("by_dtype", node.dtypes)
        elif not isinstance(node, (E.EColumns, E.ESelector)):
            raise InvalidOperationError("exclude() applies to a wildcard or a selector only")
        return Expr(E.ESelector("set", (), op="difference", left=node, right=E.ESelector("by_name", tuple(flat))))

    # -- binary ops -----------------------------------------------------------

    def _bin(self, op: str, other: Any, *, swap: bool = False) -> Expr:
        rhs = parse_into_expr(other, str_as_lit=True)
        left, right = (rhs, self._node) if swap else (self._node, rhs)
        return Expr(E.EBinary(left, op, right))

    def __add__(self, other: Any) -> Expr:
        return self._bin("+", other)

    def __radd__(self, other: Any) -> Expr:
        return self._bin("+", other, swap=True)

    def __sub__(self, other: Any) -> Expr:
        return self._bin("-", other)

    def __rsub__(self, other: Any) -> Expr:
        return self._bin("-", other, swap=True)

    def __mul__(self, other: Any) -> Expr:
        return self._bin("*", other)

    def __rmul__(self, other: Any) -> Expr:
        return self._bin("*", other, swap=True)

    def __truediv__(self, other: Any) -> Expr:
        return self._bin("/", other)

    def __rtruediv__(self, other: Any) -> Expr:
        return self._bin("/", other, swap=True)

    def __floordiv__(self, other: Any) -> Expr:
        return self._bin("//", other)

    def __rfloordiv__(self, other: Any) -> Expr:
        return self._bin("//", other, swap=True)

    def __mod__(self, other: Any) -> Expr:
        return self._bin("%", other)

    def __rmod__(self, other: Any) -> Expr:
        return self._bin("%", other, swap=True)

    def __pow__(self, other: Any) -> Expr:
        return self._bin("**", other)

    def __rpow__(self, other: Any) -> Expr:
        return self._bin("**", other, swap=True)

    def pow(self, exponent: Any) -> Expr:
        return self._bin("**", exponent)

    def __neg__(self) -> Expr:
        return self._fn("negate")

    def __pos__(self) -> Expr:
        return self

    def eq_missing(self, other: Any) -> Expr:
        return self._bin("eq_missing", other)

    def ne_missing(self, other: Any) -> Expr:
        return self._bin("ne_missing", other)

    def __eq__(self, other: Any) -> Expr:  # type: ignore[override]
        return self._bin("==", other)

    def __ne__(self, other: Any) -> Expr:  # type: ignore[override]
        return self._bin("!=", other)

    def __lt__(self, other: Any) -> Expr:
        return self._bin("<", other)

    def __le__(self, other: Any) -> Expr:
        return self._bin("<=", other)

    def __gt__(self, other: Any) -> Expr:
        return self._bin(">", other)

    def __ge__(self, other: Any) -> Expr:
        return self._bin(">=", other)

    def __and__(self, other: Any) -> Expr:
        return self._bin("&", other)

    def __rand__(self, other: Any) -> Expr:
        return self._bin("&", other, swap=True)

    def __or__(self, other: Any) -> Expr:
        return self._bin("|", other)

    def __ror__(self, other: Any) -> Expr:
        return self._bin("|", other, swap=True)

    def __xor__(self, other: Any) -> Expr:
        return self._bin("^", other)

    def __invert__(self) -> Expr:
        return self._fn("not")

    def not_(self) -> Expr:
        return self._fn("not")

    def add(self, other: Any) -> Expr:
        return self._bin("+", other)

    def sub(self, other: Any) -> Expr:
        return self._bin("-", other)

    def mul(self, other: Any) -> Expr:
        return self._bin("*", other)

    def truediv(self, other: Any) -> Expr:
        return self._bin("/", other)

    def floordiv(self, other: Any) -> Expr:
        return self._bin("//", other)

    def mod(self, other: Any) -> Expr:
        return self._bin("%", other)

    def eq(self, other: Any) -> Expr:
        return self._bin("==", other)

    def ne(self, other: Any) -> Expr:
        return self._bin("!=", other)

    def lt(self, other: Any) -> Expr:
        return self._bin("<", other)

    def le(self, other: Any) -> Expr:
        return self._bin("<=", other)

    def gt(self, other: Any) -> Expr:
        return self._bin(">", other)

    def ge(self, other: Any) -> Expr:
        return self._bin(">=", other)

    def and_(self, *others: Any) -> Expr:
        out = self
        for o in others:
            out = out._bin("&", o)
        return out

    def or_(self, *others: Any) -> Expr:
        out = self
        for o in others:
            out = out._bin("|", o)
        return out

    def xor(self, other: Any) -> Expr:
        return self._bin("^", other)

    def neg(self) -> Expr:
        return self._fn("negate")

    __hash__ = None  # == builds an expression, so Expr is not hashable

    # -- membership / range ---------------------------------------------------

    def is_in(self, other: Any, *, nulls_equal: bool = False) -> Expr:
        return self._fn("is_in", other, nulls_equal=nulls_equal)

    def is_between(self, lower_bound: Any, upper_bound: Any, closed: str = "both") -> Expr:
        if closed not in ("both", "left", "right", "none"):
            raise ValueError(f"`closed` must be one of 'both', 'left', 'right', 'none', got {closed!r}")
        return self._fn("is_between", lower_bound, upper_bound, closed=closed)

    # -- null handling ----------------------------------------------------------

    def is_null(self) -> Expr:
        return self._fn("is_null")

    def is_not_null(self) -> Expr:
        return self._fn("is_not_null")

    def is_nan(self) -> Expr:
        return self._fn("is_nan")

    def is_not_nan(self) -> Expr:
        return self._fn("is_not_nan")

    def is_finite(self) -> Expr:
        return self._fn("is_finite")

    def is_infinite(self) -> Expr:
        return self._fn("is_infinite")

    def fill_null(self, value: Any = None, strategy: str | None = None, limit: int | None = None) -> Expr:
        """Nulls replaced by ``value`` (a literal or an expression; a plain
        string is a literal), or by ``strategy``: ``forward``/``backward``
        (at most ``limit`` rows on), ``min``, ``max``, ``mean``, ``zero``,
        ``one``."""
        if value is not None and strategy is None:
            return self._fn("fill_null", value)
        if strategy is None:
            raise InvalidOperationError("must specify either a fill value or a strategy")
        if strategy not in ("forward", "backward", "min", "max", "mean", "zero", "one"):
            raise InvalidOperationError(f"unknown fill_null strategy {strategy!r}")
        return self._fn("fill_null_with_strategy", strategy=strategy, limit=limit)

    def drop_nulls(self) -> Expr:
        return Expr(E.EFilter(self._node, E.EFunction("is_not_null", (self._node,))))

    def drop_nans(self) -> Expr:
        return Expr(E.EFilter(self._node, E.EFunction("is_not_nan", (self._node,))))

    def fill_nan(self, value: Any) -> Expr:
        return self._fn("fill_nan", value)

    def coalesce(self, *others: Any) -> Expr:
        from polars_tpu_torch.functions.lazy import coalesce

        return coalesce(self, *others)

    # -- namespaces -----------------------------------------------------------

    @property
    def str(self):
        from polars_tpu_torch.expr.string import ExprStringNamespace

        return ExprStringNamespace(self)

    @property
    def dt(self):
        from polars_tpu_torch.expr.datetime import ExprDateTimeNamespace

        return ExprDateTimeNamespace(self)

    @property
    def cat(self):
        from polars_tpu_torch.expr.categorical import ExprCatNamespace

        return ExprCatNamespace(self)

    @property
    def bin(self):
        from polars_tpu_torch.expr.binary import ExprBinaryNamespace

        return ExprBinaryNamespace(self)

    @property
    def list(self):
        from polars_tpu_torch.expr.list import ExprListNamespace

        return ExprListNamespace(self)

    @property
    def arr(self):
        from polars_tpu_torch.expr.list import ExprListNamespace

        return ExprListNamespace(self)

    @property
    def struct(self):
        from polars_tpu_torch.expr.struct import ExprStructNamespace

        return ExprStructNamespace(self)

    def explode(self) -> Expr:
        """Each list's elements as rows (a null or empty list one null)."""
        return self._fn("explode")

    def flatten(self) -> Expr:
        return self.explode()

    def implode(self) -> Expr:
        """The column's rows as one List (per group in a group-by)."""
        return self._agg("implode")

    def agg_groups(self) -> Expr:
        """Each group's row numbers (UInt32) as a List."""
        return self._agg("agg_groups")

    # -- aggregations ---------------------------------------------------------

    def _agg(self, kind: str, **options: Any) -> Expr:
        return Expr(E.EAgg(self._node, kind, _opts(**options)))

    def sum(self) -> Expr:
        return self._agg("sum")

    def mean(self) -> Expr:
        return self._agg("mean")

    def min(self) -> Expr:
        return self._agg("min")

    def max(self) -> Expr:
        return self._agg("max")

    def count(self) -> Expr:
        return self._agg("count")

    def len(self) -> Expr:
        return self._agg("len")

    def first(self) -> Expr:
        return self._agg("first")

    def last(self) -> Expr:
        return self._agg("last")

    def n_unique(self) -> Expr:
        return self._agg("n_unique")

    def null_count(self) -> Expr:
        return self._agg("null_count")

    def std(self, ddof: int = 1) -> Expr:
        return self._agg("std", ddof=ddof)

    def var(self, ddof: int = 1) -> Expr:
        return self._agg("var", ddof=ddof)

    def median(self) -> Expr:
        return self._agg("median")

    def quantile(self, quantile: float, interpolation: str = "nearest") -> Expr:
        if interpolation not in ("nearest", "lower", "higher", "midpoint", "linear"):
            raise InvalidOperationError(f"unknown interpolation {interpolation!r}")
        if not 0.0 <= float(quantile) <= 1.0:
            raise InvalidOperationError(f"quantile must lie in [0, 1], got {quantile!r}")
        return self._agg("quantile", quantile=float(quantile), interpolation=interpolation)

    def product(self) -> Expr:
        return self._agg("product")

    def any(self, *, ignore_nulls: bool = True) -> Expr:
        return self._agg("any", ignore_nulls=ignore_nulls)

    def all(self, *, ignore_nulls: bool = True) -> Expr:
        return self._agg("all", ignore_nulls=ignore_nulls)

    def arg_min(self) -> Expr:
        return self._agg("arg_min")

    def arg_max(self) -> Expr:
        return self._agg("arg_max")

    def approx_n_unique(self) -> Expr:
        return self._agg("n_unique")

    def item(self, *, allow_empty: bool = False) -> Expr:
        """The one value of the column (of each group); more than one, or
        none without ``allow_empty``, fails the query at its count read."""
        return self._agg("item", allow_empty=allow_empty)

    def bitwise_and(self) -> Expr:
        return self._agg("bitwise_and")

    def bitwise_or(self) -> Expr:
        return self._agg("bitwise_or")

    def bitwise_xor(self) -> Expr:
        return self._agg("bitwise_xor")

    def skew(self, *, bias: bool = True) -> Expr:
        return self._agg("skew", bias=bias)

    def kurtosis(self, *, fisher: bool = True, bias: bool = True) -> Expr:
        return self._agg("kurtosis", fisher=fisher, bias=bias)

    def entropy(self, base: float = 2.718281828459045, *, normalize: bool = True) -> Expr:
        return self._agg("entropy", base=base, normalize=normalize)

    def dot(self, other: Any) -> Expr:
        return (self * other).sum()

    def has_nulls(self) -> Expr:
        return self.null_count() > 0

    def is_empty(self) -> Expr:
        return self.len() == 0

    def nan_max(self) -> Expr:
        """The max, NaN where the column holds a NaN."""
        from polars_tpu_torch.functions.lazy import when

        return when(self.is_nan().any()).then(float("nan")).otherwise(self.max())

    def nan_min(self) -> Expr:
        from polars_tpu_torch.functions.lazy import when

        return when(self.is_nan().any()).then(float("nan")).otherwise(self.min())

    # -- recoding -------------------------------------------------------------

    def hash(self, seed: int = 0, *more_seeds: int) -> Expr:
        """splitmix64 of each value (UInt64); the extra seeds fold into one
        64-bit seed, so that other seeds give other hashes."""
        s = seed & 0xFFFFFFFFFFFFFFFF
        for i, m in enumerate(more_seeds):
            s ^= (int(m) * (0x9E3779B97F4A7C15 + 2 * i + 1)) & 0xFFFFFFFFFFFFFFFF
        return self._fn("hash", seed=s - (1 << 64) if s >= 1 << 63 else s)

    @staticmethod
    def _replace_pairs(old: Any, new: Any) -> tuple[tuple, tuple]:
        if isinstance(old, dict):
            olds, news = list(old), list(old.values())
        else:
            olds, news = old, new
        if not isinstance(olds, (list, tuple)):
            olds = [olds]
        if not isinstance(news, (list, tuple)):
            news = [news] * len(olds)
        if len(olds) != len(news):
            raise InvalidOperationError(f"replace: {len(olds)} old values and {len(news)} new ones")
        return tuple(olds), tuple(news)

    def replace(self, old: Any, new: Any = None) -> Expr:
        """The listed values replaced (a dict, two lists, or one value and
        its new one), in the column's dtype."""
        olds, news = self._replace_pairs(old, new)
        return self._fn("replace", olds=olds, news=news)

    def replace_strict(self, old: Any, new: Any = None, *, default: Any = None, return_dtype: Any = None) -> Expr:
        """Every value mapped to a new one (of the new values' dtype, or
        ``return_dtype``); a value the mapping lacks takes ``default``, or
        fails the query."""
        olds, news = self._replace_pairs(old, new)
        return self._fn("replace_strict", olds=olds, news=news, default=default,
                        return_dtype=None if return_dtype is None else dt.parse_into_dtype(return_dtype))

    def _with_breaks(self, bp: Expr, cat: Expr) -> Expr:
        """``include_breaks=True``: a Struct of each row's bin's upper break
        (``breakpoint``) and its label (``category``)."""
        from polars_tpu_torch.functions.lazy import struct

        name = E.output_name(self._node)
        out = struct(bp.alias("breakpoint"), cat.alias("category"))
        return out.alias(name) if name else out

    def cut(self, breaks: Any, *, labels: Any = None, left_closed: bool = False, include_breaks: bool = False) -> Expr:
        """The bin of each value between ``breaks``: an Enum of the interval
        labels (``include_breaks``: a Struct with each bin's upper break)."""
        cat = self._fn("cut", breaks=tuple(breaks), labels=None if labels is None else tuple(labels),
                       left_closed=left_closed)
        if not include_breaks:
            return cat
        return self._with_breaks(self._fn("cut_breakpoint", breaks=tuple(breaks), left_closed=left_closed), cat)

    def qcut(self, quantiles: Any, *, labels: Any = None, left_closed: bool = False, allow_duplicates: bool = False,
             include_breaks: bool = False) -> Expr:
        """The bin of each value between the column's quantiles (a count
        of bins, or the quantiles themselves)."""
        if isinstance(quantiles, int):
            quantiles = [i / quantiles for i in range(1, quantiles)]
        cat = self._fn("qcut", quantiles=tuple(quantiles), labels=None if labels is None else tuple(labels),
                       left_closed=left_closed, allow_duplicates=allow_duplicates)
        if not include_breaks:
            return cat
        return self._with_breaks(self._fn("qcut_breakpoint", quantiles=tuple(quantiles), left_closed=left_closed), cat)

    def rle_id(self) -> Expr:
        return self._fn("rle_id")

    def unique(self, *, maintain_order: bool = False) -> Expr:
        return self._fn("unique", maintain_order=maintain_order)

    def unique_counts(self) -> Expr:
        return self._fn("unique_counts")

    def truncate(self, decimals: int = 0) -> Expr:
        return self._fn("truncate", decimals=decimals)

    def reinterpret(self, *, signed: bool | None = None, dtype: Any = None) -> Expr:
        return self._fn("reinterpret", signed=signed, dtype=None if dtype is None else dt.parse_into_dtype(dtype))

    def round_sig_figs(self, digits: int) -> Expr:
        return self._fn("round_sig_figs", digits=digits)

    def lower_bound(self) -> Expr:
        return self._fn("lower_bound")

    def upper_bound(self) -> Expr:
        return self._fn("upper_bound")

    def set_sorted(self, *, descending: bool = False) -> Expr:
        return self._fn("set_sorted", descending=descending)

    def shrink_dtype(self) -> Expr:
        """The smallest dtype of the same kind that holds every value (a host
        function: one read of the minimum, maximum and count)."""
        return self._fn("shrink_dtype")

    def pipe(self, function: Callable, *args: Any, **kwargs: Any) -> Any:
        return function(self, *args, **kwargs)

    def is_close(self, other: Any, *, abs_tol: float = 1e-12, rel_tol: float = 1e-9, nans_equal: bool = False) -> Expr:
        o = other if isinstance(other, Expr) else Expr(parse_into_expr(other))
        close = (self - o).abs() <= (abs_tol + rel_tol * o.abs())
        return close | (self.is_nan() & o.is_nan()) if nans_equal else close

    # -- math -----------------------------------------------------------------

    def abs(self) -> Expr:
        return self._fn("abs")

    def round(self, decimals: int = 0) -> Expr:
        return self._fn("round", decimals=decimals)

    def floor(self) -> Expr:
        return self._fn("floor")

    def ceil(self) -> Expr:
        return self._fn("ceil")

    def log(self, base: float | None = None) -> Expr:
        return self._fn("log", base=base)

    def sign(self) -> Expr:
        return self._fn("sign")

    def clip(self, lower_bound: Any = None, upper_bound: Any = None) -> Expr:
        """Values bounded below and above (literals or expressions; None
        leaves that side open)."""
        bounds = [b for b in (lower_bound, upper_bound) if b is not None]
        return self._fn("clip", *bounds, has_lower=lower_bound is not None, has_upper=upper_bound is not None)

    # -- names ----------------------------------------------------------------

    @property
    def name(self) -> ExprNameNamespace:
        return ExprNameNamespace(self)

    # -- distinct flags -------------------------------------------------------

    def is_duplicated(self) -> Expr:
        return self._fn("is_duplicated")

    def is_unique(self) -> Expr:
        return self._fn("is_unique")

    def is_first_distinct(self) -> Expr:
        return self._fn("is_first_distinct")

    def is_last_distinct(self) -> Expr:
        return self._fn("is_last_distinct")

    def arg_unique(self) -> Expr:
        """The positions of each value's first occurrence (a shorter column)."""
        return Expr(E.EFilter(E.EFunction("row_position", (self._node,)), self.is_first_distinct()._node))

    # -- positional -----------------------------------------------------------

    def shift(self, n: int = 1, *, fill_value: Any = None) -> Expr:
        if fill_value is None:
            return self._fn("shift", n=n)
        return self._fn("shift_fill", fill_value, n=n)

    def diff(self, n: int = 1, null_behavior: str = "ignore") -> Expr:
        out = self._fn("diff", n=n)
        if null_behavior == "drop":  # without the first |n| undefined rows
            return out.slice(n, None) if n >= 0 else out.slice(0, None)
        return out

    def pct_change(self, n: int = 1) -> Expr:
        return self._fn("pct_change", n=n)

    def cum_sum(self, *, reverse: bool = False) -> Expr:
        return self._fn("cum_sum", reverse=reverse)

    def cum_prod(self, *, reverse: bool = False) -> Expr:
        return self._fn("cum_prod", reverse=reverse)

    def cum_min(self, *, reverse: bool = False) -> Expr:
        return self._fn("cum_min", reverse=reverse)

    def cum_max(self, *, reverse: bool = False) -> Expr:
        return self._fn("cum_max", reverse=reverse)

    def cum_count(self, *, reverse: bool = False) -> Expr:
        return self._fn("cum_count", reverse=reverse)

    def forward_fill(self, limit: int | None = None) -> Expr:
        return self._fn("forward_fill", limit=limit)

    def backward_fill(self, limit: int | None = None) -> Expr:
        return self._fn("backward_fill", limit=limit)

    def interpolate(self, method: str = "linear") -> Expr:
        if method not in ("linear", "nearest"):
            raise InvalidOperationError(f"unknown interpolation method {method!r}")
        return self._fn("interpolate", method=method)

    def rank(self, method: str = "average", *, descending: bool = False, seed: int | None = None) -> Expr:
        if method not in ("average", "min", "max", "dense", "ordinal", "random"):
            raise InvalidOperationError(f"unknown rank method {method!r}")
        return self._fn("rank", method=method, descending=descending, seed=seed)

    def peak_min(self) -> Expr:
        return self._fn("peak_min")

    def peak_max(self) -> Expr:
        return self._fn("peak_max")

    def reverse(self) -> Expr:
        return self._fn("reverse")

    # -- rolling, exponentially weighted and cumulative windows -----------------

    def _window_fn(self, fname: str, window_size: int, weights: Any, min_samples: int | None, center: bool,
                   **extra: Any) -> Expr:
        return self._fn(fname, window_size=window_size, min_samples=min_samples, center=center,
                        weights=None if weights is None else tuple(float(w) for w in weights), **extra)

    def rolling_sum(self, window_size: int, *, weights: Any = None, min_samples: int | None = None,
                    center: bool = False) -> Expr:
        return self._window_fn("rolling_sum", window_size, weights, min_samples, center)

    def rolling_mean(self, window_size: int, *, weights: Any = None, min_samples: int | None = None,
                     center: bool = False) -> Expr:
        return self._window_fn("rolling_mean", window_size, weights, min_samples, center)

    def rolling_min(self, window_size: int, *, weights: Any = None, min_samples: int | None = None,
                    center: bool = False) -> Expr:
        return self._window_fn("rolling_min", window_size, weights, min_samples, center)

    def rolling_max(self, window_size: int, *, weights: Any = None, min_samples: int | None = None,
                    center: bool = False) -> Expr:
        return self._window_fn("rolling_max", window_size, weights, min_samples, center)

    def rolling_std(self, window_size: int, *, weights: Any = None, ddof: int = 1, min_samples: int | None = None,
                    center: bool = False) -> Expr:
        return self._window_fn("rolling_std", window_size, weights, min_samples, center, ddof=ddof)

    def rolling_var(self, window_size: int, *, weights: Any = None, ddof: int = 1, min_samples: int | None = None,
                    center: bool = False) -> Expr:
        return self._window_fn("rolling_var", window_size, weights, min_samples, center, ddof=ddof)

    def rolling_median(self, window_size: int, *, weights: Any = None, min_samples: int | None = None,
                       center: bool = False) -> Expr:
        return self._window_fn("rolling_median", window_size, weights, min_samples, center)

    def rolling_quantile(self, quantile: float, interpolation: str = "nearest", window_size: int = 2, *,
                         weights: Any = None, min_samples: int | None = None, center: bool = False) -> Expr:
        return self._window_fn("rolling_quantile", window_size, weights, min_samples, center, quantile=quantile,
                               interpolation=interpolation)

    def rolling_rank(self, window_size: int, *, method: str = "average", descending: bool = False,
                     seed: int | None = None, min_samples: int | None = None) -> Expr:
        return self._window_fn("rolling_rank", window_size, None, min_samples, False, method=method,
                               descending=descending, seed=seed)

    def rolling_skew(self, window_size: int, *, bias: bool = True, min_samples: int | None = None,
                     center: bool = False) -> Expr:
        return self._window_fn("rolling_skew", window_size, None, min_samples, center, bias=bias)

    def rolling_kurtosis(self, window_size: int, *, fisher: bool = True, bias: bool = True,
                         min_samples: int | None = None, center: bool = False) -> Expr:
        return self._window_fn("rolling_kurtosis", window_size, None, min_samples, center, fisher=fisher, bias=bias)

    def _rolling_by(self, kind: str, by: Any, window_size: str, min_samples: int, closed: str, **extra: Any) -> Expr:
        return Expr(E.EFunction(f"rolling_{kind}_by", (self._node, parse_into_expr(by)),
                                _opts(window_size=window_size, min_samples=min_samples, closed=closed, **extra)))

    def rolling_sum_by(self, by: Any, window_size: str, *, min_samples: int = 1, closed: str = "right") -> Expr:
        return self._rolling_by("sum", by, window_size, min_samples, closed)

    def rolling_mean_by(self, by: Any, window_size: str, *, min_samples: int = 1, closed: str = "right") -> Expr:
        return self._rolling_by("mean", by, window_size, min_samples, closed)

    def rolling_min_by(self, by: Any, window_size: str, *, min_samples: int = 1, closed: str = "right") -> Expr:
        return self._rolling_by("min", by, window_size, min_samples, closed)

    def rolling_max_by(self, by: Any, window_size: str, *, min_samples: int = 1, closed: str = "right") -> Expr:
        return self._rolling_by("max", by, window_size, min_samples, closed)

    def rolling_std_by(self, by: Any, window_size: str, *, min_samples: int = 1, closed: str = "right",
                       ddof: int = 1) -> Expr:
        return self._rolling_by("std", by, window_size, min_samples, closed, ddof=ddof)

    def rolling_var_by(self, by: Any, window_size: str, *, min_samples: int = 1, closed: str = "right",
                       ddof: int = 1) -> Expr:
        return self._rolling_by("var", by, window_size, min_samples, closed, ddof=ddof)

    def rolling_median_by(self, by: Any, window_size: str, *, min_samples: int = 1, closed: str = "right") -> Expr:
        return self._rolling_by("median", by, window_size, min_samples, closed)

    def rolling_quantile_by(self, by: Any, window_size: str, *, quantile: float = 0.5,
                            interpolation: str = "nearest", min_samples: int = 1, closed: str = "right") -> Expr:
        return self._rolling_by("quantile", by, window_size, min_samples, closed, quantile=quantile,
                                interpolation=interpolation)

    def rolling_rank_by(self, by: Any, window_size: str, *, method: str = "average", descending: bool = False,
                        seed: int | None = None, min_samples: int = 1, closed: str = "right") -> Expr:
        return self._rolling_by("rank", by, window_size, min_samples, closed, method=method, descending=descending)

    def rolling(self, index_column: Any, *, period: str, offset: str | None = None, closed: str = "right") -> Expr:
        """An aggregation over each row's time window:
        ``pl.col("v").sum().rolling(index_column="t", period="2d")`` is
        ``rolling_sum_by("t", "2d")`` (the reference's ``Expr.rolling``)."""
        node = self._node
        if not isinstance(node, E.EAgg):
            raise InvalidOperationError(".rolling() must be applied to an aggregation expression "
                                        "(e.g. pl.col('v').sum().rolling(...))")
        if offset is not None:
            raise InvalidOperationError("Expr.rolling with a custom offset is not supported yet")
        inner, kind = Expr(node.input), node.kind
        if kind in ("sum", "mean", "min", "max", "first", "last", "count"):
            return inner._rolling_by(kind, index_column, period, 1, closed)
        if kind in ("std", "var"):
            return inner._rolling_by(kind, index_column, period, 1, closed, ddof=node.opt("ddof", 1))
        if kind == "median":
            return inner.rolling_median_by(index_column, period, closed=closed)
        if kind == "quantile":
            return inner.rolling_quantile_by(index_column, period, quantile=node.opt("quantile", 0.5),
                                             interpolation=node.opt("interpolation", "nearest"), closed=closed)
        raise InvalidOperationError(f".rolling() does not support aggregation {kind!r}")

    def ewm_mean(self, *, com: float | None = None, span: float | None = None, half_life: float | None = None,
                 alpha: float | None = None, adjust: bool = True, min_samples: int = 1,
                 ignore_nulls: bool = False) -> Expr:
        return self._fn("ewm_mean", com=com, span=span, half_life=half_life, alpha=alpha, adjust=adjust,
                        ignore_nulls=ignore_nulls, min_samples=min_samples)

    def ewm_std(self, *, com: float | None = None, span: float | None = None, half_life: float | None = None,
                alpha: float | None = None, adjust: bool = True, bias: bool = False, min_samples: int = 1,
                ignore_nulls: bool = False) -> Expr:
        return self._fn("ewm_std", com=com, span=span, half_life=half_life, alpha=alpha, adjust=adjust,
                        ignore_nulls=ignore_nulls, min_samples=min_samples, bias=bias)

    def ewm_var(self, *, com: float | None = None, span: float | None = None, half_life: float | None = None,
                alpha: float | None = None, adjust: bool = True, bias: bool = False, min_samples: int = 1,
                ignore_nulls: bool = False) -> Expr:
        return self._fn("ewm_var", com=com, span=span, half_life=half_life, alpha=alpha, adjust=adjust,
                        ignore_nulls=ignore_nulls, min_samples=min_samples, bias=bias)

    def ewm_sum(self, *, com: float | None = None, span: float | None = None, half_life: float | None = None,
                alpha: float | None = None, min_samples: int = 1, ignore_nulls: bool = False) -> Expr:
        return self._fn("ewm_sum", com=com, span=span, half_life=half_life, alpha=alpha, min_samples=min_samples,
                        ignore_nulls=ignore_nulls)

    def ewm_mean_by(self, by: Any, *, half_life: Any) -> Expr:
        return Expr(E.EFunction("ewm_mean_by", (self._node, parse_into_expr(by)), _opts(half_life=half_life)))

    def ewm_sum_by(self, by: Any, *, half_life: Any) -> Expr:
        return Expr(E.EFunction("ewm_sum_by", (self._node, parse_into_expr(by)), _opts(half_life=half_life)))

    def interpolate_by(self, by: Any) -> Expr:
        return Expr(E.EFunction("interpolate_by", (self._node, parse_into_expr(by)), ()))

    def cumulative_eval(self, expr: Expr, *, min_samples: int = 1) -> Expr:
        """``expr`` (over ``pl.element()``) evaluated over each prefix of the
        column: a prefix sum, min, max or mean is one scan on the device,
        any other expression runs on the host, one select per prefix."""
        return self._fn("cumulative_eval", expr=expr._node, min_samples=min_samples)

    # -- sorting, slicing, gathering ------------------------------------------

    def sort(self, *, descending: bool = False, nulls_last: bool = False) -> Expr:
        return Expr(E.ESort(self._node, descending, nulls_last))

    def arg_sort(self, *, descending: bool = False, nulls_last: bool = False) -> Expr:
        return self._fn("arg_sort", descending=descending, nulls_last=nulls_last)

    def sort_by(self, by: Any, *more_by: Any, descending: Any = False, nulls_last: Any = False) -> Expr:
        by_nodes = tuple(parse_into_expr(b) for b in _flat((by, *more_by)))
        k = len(by_nodes)
        desc = tuple(descending) if isinstance(descending, (list, tuple)) else (descending,) * k
        nl = tuple(nulls_last) if isinstance(nulls_last, (list, tuple)) else (nulls_last,) * k
        if len(desc) != k or len(nl) != k:
            raise InvalidOperationError("sort_by: descending and nulls_last need one value per key")
        return Expr(E.ESortBy(self._node, by_nodes, tuple(map(bool, desc)), tuple(map(bool, nl))))

    def top_k(self, k: int = 5) -> Expr:
        return Expr(E.ESlice(E.ESort(self._node, True, True), 0, k))

    def bottom_k(self, k: int = 5) -> Expr:
        return Expr(E.ESlice(E.ESort(self._node, False, True), 0, k))

    def max_by(self, by: Any) -> Expr:
        return self.sort_by(by, descending=True).first()

    def min_by(self, by: Any) -> Expr:
        return self.sort_by(by).first()

    def head(self, n: int = 10) -> Expr:
        return Expr(E.ESlice(self._node, 0, n))

    def tail(self, n: int = 10) -> Expr:
        return Expr(E.ESlice(self._node, -n, None))

    def slice(self, offset: int, length: int | None = None) -> Expr:
        return Expr(E.ESlice(self._node, offset, length))

    def gather(self, indices: Any) -> Expr:
        return Expr(E.EGather(self._node, parse_into_expr(indices)))

    def get(self, index: Any) -> Expr:
        return Expr(E.EGather(self._node, parse_into_expr(index)))

    def filter(self, *predicates: Any) -> Expr:
        nodes = parse_into_expr_list(list(predicates))
        if not nodes:
            raise InvalidOperationError("filter() needs a predicate")
        pred = nodes[0]
        for p in nodes[1:]:
            pred = E.EBinary(pred, "&", p)
        return Expr(E.EFilter(self._node, pred))

    def limit(self, n: int = 10) -> Expr:
        return self.head(n)

    def where(self, predicate: Any) -> Expr:
        return self.filter(predicate)

    def arg_true(self) -> Expr:
        """The positions of the true values (a shorter column)."""
        return Expr(E.EFilter(E.EFunction("row_position", (self._node,)), self._node))

    def gather_every(self, n: int, offset: int = 0) -> Expr:
        """Every ``n``-th value from position ``offset`` (a shorter column)."""
        pos = Expr(E.EFunction("row_position", (self._node,)))
        return Expr(E.EFilter(self._node, ((pos >= offset) & ((pos - offset) % n == 0))._node))

    def top_k_by(self, by: Any, k: int = 5) -> Expr:
        return self.sort_by(by, descending=True).head(k)

    def bottom_k_by(self, by: Any, k: int = 5) -> Expr:
        return self.sort_by(by).head(k)

    def search_sorted(self, element: Any, side: str = "any") -> Expr:
        """Where ``element`` would go in this sorted column (UInt32)."""
        if side not in ("any", "left", "right"):
            raise InvalidOperationError(f"search_sorted: unknown side {side!r}")
        return self._fn("search_sorted", element, side=side)

    def index_of(self, element: Any) -> Expr:
        """The position of the first value equal to ``element``, null where
        there is none."""
        from polars_tpu_torch.functions.lazy import when

        hit = self == element
        return when(hit.any()).then((~hit).cast(dt.Int64()).arg_min()).otherwise(None)

    # -- sequences of their own length (engine/sequences.py) and ranges --------

    def extend_constant(self, value: Any, n: int) -> Expr:
        """The column with ``n`` copies of ``value`` after it."""
        return self._fn("extend_constant", value, n=int(n))

    def append(self, other: Any, *, upcast: bool = True) -> Expr:
        """The column with ``other``'s values after it."""
        return self._fn("append", other)

    def sample(self, n: int | None = None, *, fraction: float | None = None, with_replacement: bool = False,
               shuffle: bool = False, seed: int | None = None) -> Expr:
        """``n`` values (or a ``fraction``), drawn on the device from
        ``seed``; in column order unless ``shuffle``."""
        return self._fn("sample", n=n, fraction=fraction, with_replacement=with_replacement, shuffle=shuffle,
                        seed=seed)

    def shuffle(self, seed: int | None = None) -> Expr:
        """The values in a random order drawn from ``seed``."""
        return self._fn("shuffle", seed=seed)

    def rle(self) -> Expr:
        """Runs of equal values: a Struct of each run's ``len`` and ``value``."""
        return self._fn("rle")

    def value_counts(self, *, sort: bool = False, parallel: bool = False, name: str | None = None,
                     normalize: bool = False) -> Expr:
        """Each distinct value with its count (or share): a Struct."""
        return self._fn("value_counts", sort=sort, normalize=normalize, field=E.output_name(self._node) or "",
                        count_name=name or ("proportion" if normalize else "count"))

    def hist(self, bins: Any = None, *, bin_count: int | None = None, include_category: bool = False,
             include_breakpoint: bool = False) -> Expr:
        """Counts per bin of ``bins`` (edges) or of ``bin_count`` equal bins."""
        return self._fn("hist", bins=None if bins is None else tuple(float(b) for b in bins), bin_count=bin_count,
                        include_category=include_category, include_breakpoint=include_breakpoint)

    def reshape(self, dimensions: tuple) -> Expr:
        """``(rows, width)``: an Array of ``width`` per row (-1 infers)."""
        return self._fn("reshape", dimensions=tuple(int(d) for d in dimensions))

    def repeat_by(self, by: Any) -> Expr:
        """Each value repeated ``by`` times (a column name or an
        expression), as a List."""
        return self._fn("repeat_by", parse_into_expr(by))

    def repeat(self, n: Any) -> Expr:
        """``pl.repeat`` of this (one-value) expression."""
        from polars_tpu_torch.functions.lazy import repeat

        return repeat(self, n)

    def mode(self) -> Expr:
        """The most frequent values (every one of a tie, in value order): a
        column of its own length in a select, a List per group in a
        group-by."""
        return self._agg("mode")

    def is_sorted(self, *, descending: bool | None = False, nulls_last: bool | None = False) -> Expr:
        """Whether the values are in order (``descending=None``: either way)."""
        return self._agg("is_sorted", descending=descending, nulls_last=bool(nulls_last))

    # -- a user's functions (engine/udf.py) -------------------------------------

    def map_batches(self, function: Callable, return_dtype: Any = None, *, agg_list: bool = False,
                    is_elementwise: bool = False, returns_scalar: bool = False) -> Expr:
        """``function`` of the whole column (a Series on the frame's
        device); in a group-by, of each group's rows."""
        return Expr(E.EAnonymous((self._node,), function=function, return_dtype=_dtype_or_none(return_dtype),
                                 ident=next_token(), returns_scalar=returns_scalar, elementwise=is_elementwise))

    def map_elements(self, function: Callable, return_dtype: Any = None, *, skip_nulls: bool = True,
                     **kwargs: Any) -> Expr:
        """``function`` of each value (a null stays null), on the host."""
        target = _dtype_or_none(return_dtype)

        def each(s):
            from polars_tpu_torch.core.series import Series

            return Series(s.name, [None if v is None and skip_nulls else function(v) for v in s.to_list()],
                          dtype=target, device=s.device)

        return Expr(E.EAnonymous((self._node,), function=each, return_dtype=target, ident=next_token(),
                                 elementwise=True))

    def rolling_map(self, function: Callable, window_size: int, weights: Any = None, *,
                    min_samples: int | None = None, center: bool = False) -> Expr:
        """``function`` of each window of ``window_size`` rows (a Series)."""
        if weights is not None:
            raise InvalidOperationError("rolling_map takes no weights")
        return self._fn("rolling_map", function=function, window_size=int(window_size),
                        min_samples=min_samples if min_samples is not None else int(window_size), center=center)

    def rechunk(self) -> Expr:
        return self

    def inspect(self, fmt: str = "{}") -> Expr:
        """The column unchanged, printed as it passes."""
        def show(s):
            print(fmt.format(s))
            return s

        return self.map_batches(show)

    # -- windows --------------------------------------------------------------

    def over(self, partition_by: Any, *more_exprs: Any, order_by: Any = None, descending: Any = False,
             mapping_strategy: str = "group_to_rows") -> Expr:
        """The expression per group of ``partition_by`` (in ``order_by``
        order within a group), mapped back to the rows: an aggregation is
        broadcast to its group's rows, a positional function keeps its
        rows; with ``mapping_strategy="join"`` each row takes its group's
        values as a List; with ``"explode"`` each group's results follow
        one another, a column of its own length (in a select)."""
        if mapping_strategy not in ("group_to_rows", "join", "explode"):
            raise InvalidOperationError(f"unknown mapping_strategy {mapping_strategy!r}")
        parts = tuple(parse_into_expr(p) for p in _flat((partition_by, *more_exprs)))
        order: tuple = ()
        if order_by is not None:
            order = tuple(parse_into_expr(o) for o in _flat((order_by,)))
        desc = tuple(descending) if isinstance(descending, (list, tuple)) else (bool(descending),) * len(order)
        return Expr(E.EWindow(self._node, parts, order, mapping_strategy, tuple(map(bool, desc))))


def _dtype_or_none(d: Any):
    return None if d is None else dt.parse_into_dtype(d)


def _flat(items: Any) -> list:
    out: list = []
    for it in items:
        if isinstance(it, (list, tuple)):
            out.extend(it)
        else:
            out.append(it)
    return out


def _unary(fname: str):
    def method(self: Expr) -> Expr:
        return self._fn(fname)

    method.__name__ = fname
    return method


# the float functions of ``engine/fn_core.py`` (Float32 stays Float32,
# anything else gives Float64)
UNARY_FLOAT = (
    "sqrt", "cbrt", "exp", "log10", "log1p", "sin", "cos", "tan", "cot", "arcsin", "arccos", "arctan",
    "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "degrees", "radians",
)
for _n in UNARY_FLOAT:
    setattr(Expr, _n, _unary(_n))

# the bit counts of an integer or Boolean column (UInt32)
BIT_COUNTS = ("bitwise_count_ones", "bitwise_count_zeros", "bitwise_leading_ones", "bitwise_leading_zeros",
              "bitwise_trailing_ones", "bitwise_trailing_zeros")
for _n in BIT_COUNTS:
    setattr(Expr, _n, _unary(_n))


class ExprNameNamespace:
    """``expr.name``: the output name from the input's (reference:
    ``ExprNameNamespace``)."""

    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _rename(self, kind: str, arg: Any = None) -> Expr:
        return Expr(E.ERenameFn(self._expr._node, kind, arg))

    def keep(self) -> Expr:
        return Expr(E.EKeepName(self._expr._node))

    def prefix(self, prefix: str) -> Expr:
        return self._rename("prefix", prefix)

    def suffix(self, suffix: str) -> Expr:
        return self._rename("suffix", suffix)

    def to_lowercase(self) -> Expr:
        return self._rename("to_lowercase")

    def to_uppercase(self) -> Expr:
        return self._rename("to_uppercase")

    def map(self, function: Callable[[str], str]) -> Expr:
        return self._rename("map", function)

    def replace(self, pattern: str, value: str, *, literal: bool = False) -> Expr:
        """The name with ``pattern`` (a regex unless ``literal``) replaced."""
        import re

        if literal:
            return self._rename("map", lambda n: n.replace(pattern, value))
        return self._rename("map", lambda n: re.sub(pattern, value, n))

    def _fields(self, function: Callable[[str], str]) -> Expr:
        return self._expr._fn("struct.map_field_names", function=function)

    def map_fields(self, function: Callable[[str], str]) -> Expr:
        """A Struct's fields renamed by ``function``."""
        return self._fields(function)

    def prefix_fields(self, prefix: str) -> Expr:
        return self._fields(lambda n: f"{prefix}{n}")

    def suffix_fields(self, suffix: str) -> Expr:
        return self._fields(lambda n: f"{n}{suffix}")

