"""String expression namespace (the port of ``polars_tpu/expr/string.py``).
Ops run once per dictionary value on the host and map through the codes on
the device (see ``engine/fn_strings.py``); ``join``/``concat`` make one
string per group, and ``json_decode`` parses each dictionary value once, on
the host (``engine/hostops.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr

def _str_seq(x: Any) -> list:
    if x is None:
        return []
    if hasattr(x, "to_list"):  # a Series
        return list(x.to_list())
    return list(x)


class ExprStringNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _fn(self, name: str, *inputs: Any, **options: Any) -> Expr:
        return self._expr._fn(f"str.{name}", *inputs, **options)

    def starts_with(self, prefix: Any) -> Expr:
        if not isinstance(prefix, str) and prefix is not None:
            return self._fn("starts_with", prefix)  # expression right-hand side
        return self._fn("starts_with", prefix=prefix)

    def ends_with(self, suffix: Any) -> Expr:
        if not isinstance(suffix, str) and suffix is not None:
            return self._fn("ends_with", suffix)
        return self._fn("ends_with", suffix=suffix)

    def contains(self, pattern: str, *, literal: bool = False, strict: bool = True) -> Expr:
        return self._fn("contains", pattern=pattern, literal=literal, strict=strict)

    def slice(self, offset: int, length: int | None = None) -> Expr:
        return self._fn("slice", offset=offset, length=length)

    def to_date(self, format: str | None = None, *, strict: bool = True, exact: bool = True,
                cache: bool = True) -> Expr:
        return self._fn("to_date", format=format, strict=strict, exact=exact)

    def to_datetime(self, format: str | None = None, *, time_unit: str | None = None, time_zone: str | None = None,
                    strict: bool = True, exact: bool = True, cache: bool = True, ambiguous: str = "raise") -> Expr:
        return self._fn("to_datetime", format=format, time_unit=time_unit or "us", time_zone=time_zone,
                        strict=strict, exact=exact, ambiguous=ambiguous)

    def to_time(self, format: str | None = None, *, strict: bool = True, cache: bool = True) -> Expr:
        return self._fn("to_time", format=format, strict=strict)

    def strptime(self, dtype: Any, format: str | None = None, *, strict: bool = True, exact: bool = True,
                 cache: bool = True, ambiguous: str = "raise") -> Expr:
        """``to_date``, ``to_datetime`` (in the dtype's unit and zone) or
        ``to_time``, by ``dtype``."""
        dtype = dt.parse_into_dtype(dtype)
        if isinstance(dtype, dt.Date):
            return self.to_date(format, strict=strict, exact=exact)
        if isinstance(dtype, dt.Datetime):
            return self.to_datetime(format, time_unit=dtype.time_unit, time_zone=dtype.time_zone, strict=strict,
                                    exact=exact, ambiguous=ambiguous)
        if isinstance(dtype, dt.Time):
            return self.to_time(format, strict=strict)
        raise InvalidOperationError(f"strptime target must be temporal, got {dtype!r}")

    def contains_any(self, patterns: Any, *, ascii_case_insensitive: bool = False) -> Expr:
        return self._fn("contains_any", patterns=tuple(_str_seq(patterns)),
                        ascii_case_insensitive=ascii_case_insensitive)

    def to_lowercase(self) -> Expr:
        return self._fn("to_lowercase")

    def to_uppercase(self) -> Expr:
        return self._fn("to_uppercase")

    def to_titlecase(self) -> Expr:
        return self._fn("to_titlecase")

    def len_chars(self) -> Expr:
        return self._fn("len_chars")

    def len_bytes(self) -> Expr:
        return self._fn("len_bytes")

    def head(self, n: int) -> Expr:
        return self._fn("slice", offset=0, length=n)

    def tail(self, n: int) -> Expr:
        return self._fn("tail", n=n)

    def strip_chars(self, characters: str | None = None) -> Expr:
        return self._fn("strip_chars", characters=characters)

    def strip_chars_start(self, characters: str | None = None) -> Expr:
        return self._fn("strip_chars_start", characters=characters)

    def strip_chars_end(self, characters: str | None = None) -> Expr:
        return self._fn("strip_chars_end", characters=characters)

    def strip_prefix(self, prefix: str) -> Expr:
        return self._fn("strip_prefix", prefix=prefix)

    def strip_suffix(self, suffix: str) -> Expr:
        return self._fn("strip_suffix", suffix=suffix)

    def pad_start(self, length: int, fill_char: str = " ") -> Expr:
        return self._fn("pad_start", length=length, fill_char=fill_char)

    def pad_end(self, length: int, fill_char: str = " ") -> Expr:
        return self._fn("pad_end", length=length, fill_char=fill_char)

    def zfill(self, length: int) -> Expr:
        return self._fn("zfill", length=length)

    def replace(self, pattern: str, value: str, *, literal: bool = False, n: int = 1) -> Expr:
        return self._fn("replace", pattern=pattern, value=value, literal=literal, n=n)

    def replace_all(self, pattern: str, value: str, *, literal: bool = False) -> Expr:
        return self._fn("replace", pattern=pattern, value=value, literal=literal, n=-1)

    def replace_many(self, patterns: Any, replace_with: Any = None, *, ascii_case_insensitive: bool = False,
                     leftmost: bool = False) -> Expr:
        if hasattr(patterns, "items"):  # a mapping of pattern to replacement
            pats, reps = zip(*patterns.items()) if patterns else ((), ())
        else:
            pats = tuple(_str_seq(patterns))
            reps = (replace_with,) if isinstance(replace_with, str) else tuple(_str_seq(replace_with))
        return self._fn("replace_many", patterns=tuple(pats), replace_with=tuple(reps),
                        ascii_case_insensitive=ascii_case_insensitive, leftmost=leftmost)

    def reverse(self) -> Expr:
        return self._fn("reverse")

    def escape_regex(self) -> Expr:
        return self._fn("escape_regex")

    def normalize(self, form: str = "NFC") -> Expr:
        return self._fn("normalize", form=form)

    def split(self, by: str, *, inclusive: bool = False) -> Expr:
        return self._fn("split", by=by, inclusive=inclusive)

    def split_exact(self, by: str, n: int, *, inclusive: bool = False) -> Expr:
        return self._fn("split_exact", by=by, n=n, inclusive=inclusive)

    def splitn(self, by: str, n: int) -> Expr:
        return self._fn("splitn", by=by, n=n)

    def extract_all(self, pattern: str) -> Expr:
        return self._fn("extract_all", pattern=pattern)

    def extract_groups(self, pattern: str) -> Expr:
        return self._fn("extract_groups", pattern=pattern)

    def explode(self) -> Expr:
        """One row per character."""
        return self._fn("extract_all", pattern=r"(?s).").explode()

    def _many(self, name: str, patterns: Any, ci: bool, overlapping: bool, leftmost: bool) -> Expr:
        if overlapping and leftmost:
            raise ValueError("can not match overlapping patterns when leftmost == True")
        opts = dict(ascii_case_insensitive=ci, overlapping=overlapping, leftmost=leftmost)
        from polars_tpu_torch.expr.expr import Expr as _Expr
        from polars_tpu_torch.plan import exprs as E

        if isinstance(patterns, str):  # a column of pattern lists, one per row
            return self._fn(name, E.EColumn(patterns), **opts)
        if isinstance(patterns, _Expr):
            return self._fn(name, patterns, **opts)
        return self._fn(name, patterns=tuple(_str_seq(patterns)), **opts)

    def extract_many(self, patterns: Any, *, ascii_case_insensitive: bool = False, overlapping: bool = False,
                     leftmost: bool = False) -> Expr:
        return self._many("extract_many", patterns, ascii_case_insensitive, overlapping, leftmost)

    def find_many(self, patterns: Any, *, ascii_case_insensitive: bool = False, overlapping: bool = False,
                  leftmost: bool = False) -> Expr:
        return self._many("find_many", patterns, ascii_case_insensitive, overlapping, leftmost)

    def extract(self, pattern: str, group_index: int = 1) -> Expr:
        return self._fn("extract", pattern=pattern, group_index=group_index)

    def count_matches(self, pattern: str, *, literal: bool = False) -> Expr:
        return self._fn("count_matches", pattern=pattern, literal=literal)

    def find(self, pattern: str, *, literal: bool = False, strict: bool = True) -> Expr:
        return self._fn("find", pattern=pattern, literal=literal, strict=strict)

    def to_integer(self, *, base: int = 10, strict: bool = True) -> Expr:
        return self._fn("to_integer", base=base, strict=strict)

    def to_decimal(self, *args: Any, **kwargs: Any) -> Expr:
        """As the JAX package: a non-strict cast to Decimal(38, 2)."""
        return self._expr.cast(dt.Decimal(38, 2), strict=False)

    def json_path_match(self, json_path: str) -> Expr:
        return self._fn("json_path_match", json_path=json_path)

    def concat(self, delimiter: str = "-", *, ignore_nulls: bool = True) -> Expr:
        return self._expr._agg("str_concat", delimiter=delimiter, ignore_nulls=ignore_nulls)

    def join(self, delimiter: str = "", *, ignore_nulls: bool = True) -> Expr:
        return self._expr._agg("str_concat", delimiter=delimiter, ignore_nulls=ignore_nulls)

    def encode(self, encoding: str) -> Expr:
        return self._fn("encode", encoding=encoding)

    def decode(self, encoding: str, *, strict: bool = True) -> Expr:
        return self._fn("decode", encoding=encoding, strict=strict)

    def json_decode(self, dtype: Any = None, *, infer_schema_length: int | None = 100) -> Expr:
        """Each string parsed as JSON (null where it does not parse), as
        ``dtype``, else as the parsed values infer it."""
        return self._fn("json_decode", dtype=dt.parse_into_dtype(dtype) if dtype is not None else None)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        raise AttributeError(f"str.{name}")
