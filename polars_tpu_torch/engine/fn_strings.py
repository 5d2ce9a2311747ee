"""String functions over dictionary-coded columns (the port of
``polars_tpu/engine/fn_strings.py``, trimmed to ``str.starts_with`` and
``str.ends_with`` with a literal or an expression right-hand side, literal
and regex ``str.contains``, ``str.slice``, and the parsers ``str.to_date``,
``str.to_datetime`` and ``str.to_time``, which ``str.strptime`` picks by
dtype).

Device tensors hold int32 codes; a string op runs once per dictionary value
on the host, and its result becomes a lookup table gathered by the codes on
the device: O(|dictionary|) host work, one O(n) gather. An op that gives
strings maps the dictionary to a new, re-normalised one
(``engine/strings.map_over_table``) and remaps the codes. Regexes are
Python's ``re``, as in the JAX package.
"""

from __future__ import annotations

import datetime as _pydt
import re

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import SCALAR, Val, combine_validity, flag_rows, take_lut
from polars_tpu_torch.engine.registry import BOOL, register
from polars_tpu_torch.engine.strings import map_over_table
from polars_tpu_torch.errors import ComputeError, InvalidOperationError


def _require_str(v: Val) -> Val:
    if v.table is None:
        raise InvalidOperationError(f"expected a String column, got {v.dtype!r}")
    return v


def _lut_op(v: Val, fn, out_dtype: dt.DataType, *, memo=None) -> Val:
    """``fn`` over the dictionary's values on the host, gathered by the
    codes; a result of None is null (a failed parse). ``memo``: a key under
    which the dictionary keeps the results, so that each distinct string is
    parsed once, not once per collect."""

    def run():
        results = [fn(u) for u in v.table.values] or [None]
        return (np.asarray([0 if r is None else r for r in results], dt.dtype_to_numpy(out_dtype)),
                np.asarray([r is not None for r in results], bool))

    outs, ok = run() if memo is None else v.table.memo(memo, run)
    okv = None if ok.all() else take_lut(ok, v.values)
    return Val(take_lut(outs, v.values), combine_validity(v.validity, okv), out_dtype, None, v.domain)


def _lut2_op(v: Val, p: Val, fn, out_dtype: dt.DataType) -> Val:
    """A row-wise predicate with an expression right-hand side: both sides
    are dictionary-coded, so ``fn`` fills a host |t1| x |t2| table and one
    gather at ``i * |t2| + j`` reads it on the device."""
    t1, t2 = v.table.values, p.table.values
    n1, n2 = max(len(t1), 1), max(len(t2), 1)
    m = np.zeros((n1, n2), dt.dtype_to_numpy(out_dtype))
    for i, a in enumerate(t1):
        for j, b in enumerate(t2):
            m[i, j] = fn(a, b)
    i = v.values.to(torch.int64).clamp(0, n1 - 1)
    j = p.values.to(torch.int64).clamp(0, n2 - 1)
    out = take_lut(m.reshape(-1), i * n2 + j)
    dom = v.domain if p.domain == SCALAR else p.domain
    validity = combine_validity(v.validity, p.validity)
    if validity is not None and validity.shape != out.shape:
        validity = validity.expand(out.shape)
    return Val(out, validity, out_dtype, None, dom)


def _affix(args: list, opts: dict, key: str, fn) -> Val:
    """``starts_with``/``ends_with``: a literal affix in ``opts[key]``, or an
    expression as the second input."""
    v = _require_str(args[0])
    if len(args) > 1:
        return _lut2_op(v, _require_str(args[1]), fn, dt.Boolean())
    a = opts[key]
    return _lut_op(v, lambda s: fn(s, a), dt.Boolean())


@register("str.starts_with", BOOL)
def _starts_with(ctx, args, opts):
    return _affix(args, opts, "prefix", str.startswith)


@register("str.ends_with", BOOL)
def _ends_with(ctx, args, opts):
    return _affix(args, opts, "suffix", str.endswith)


def _compile_or_null(v: Val, pat: str, opts: dict):
    """(compiled pattern, None), or, for an invalid pattern without
    ``strict``, (None, an all-null Boolean result); with ``strict`` (the
    default) an invalid pattern raises."""
    try:
        return re.compile(pat), None
    except re.error as exc:
        if opts.get("strict", True):
            raise ComputeError(f"invalid regex pattern {pat!r}: {exc}") from None
        z = torch.zeros(v.values.shape, dtype=torch.bool, device=v.values.device)
        return None, Val(z, z.clone(), dt.Boolean(), None, v.domain)


@register("str.contains", BOOL)
def _contains(ctx, args, opts):
    v = _require_str(args[0])
    pat = opts["pattern"]
    if opts.get("literal", False):
        return _lut_op(v, lambda s: pat in s, dt.Boolean())
    rx, bail = _compile_or_null(v, pat, opts)
    if bail is not None:
        return bail
    return _lut_op(v, lambda s: rx.search(s) is not None, dt.Boolean())


@register("str.slice", dt.String())
def _slice(ctx, args, opts):
    """Characters ``[offset, offset + length)``; a negative offset counts from
    the end, and ``length=None`` runs to the end."""
    v = _require_str(args[0])
    off, length = opts.get("offset", 0), opts.get("length")

    def f(s):
        if length is None:
            return s[off:]
        if off < 0:
            end = off + length
            return s[off: end if end < 0 else None]
        return s[off: off + length]

    return map_over_table(v, f)


# -- parsing --------------------------------------------------------------------------------


def _strict_parse_flag(ctx, v: Val, out: Val, opts: dict, what: str) -> Val:
    """With ``strict`` (the default) a non-null string that does not parse
    fails the segment at its count read; otherwise it is null."""
    if opts.get("strict", True) and out.validity is not None:
        flag_rows(ctx, v, ~out.validity, f"conversion from `str` to `{what}` failed; use `strict=False` for nulls")
    return out


_FMT_RX = {
    "%Y": r"\d{4}", "%y": r"\d{2}", "%m": r"\d{1,2}", "%d": r"\d{1,2}",
    "%H": r"\d{1,2}", "%M": r"\d{1,2}", "%S": r"\d{1,2}", "%j": r"\d{1,3}",
    "%f": r"\d+", "%b": r"[A-Za-z]{3}", "%B": r"[A-Za-z]+",
    "%a": r"[A-Za-z]{3}", "%A": r"[A-Za-z]+", "%p": r"[APap][Mm]",
    "%z": r"(?:[+-]\d{2}:?\d{2}|Z)", "%%": r"%",
}


def _fmt_search_regex(fmt: str) -> re.Pattern:
    """A regex of the format's shape, to find the date within a longer
    string (``exact=False``)."""
    out, i = [], 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            spec = fmt[i:i + 2]
            out.append(_FMT_RX.get(spec, re.escape(spec[1])))
            i += 2
        else:
            out.append(re.escape(fmt[i]))
            i += 1
    return re.compile("".join(out))


def _parser(opts: dict, default_rx: str, parse):
    """A host function of one string: its match (``exact=False``: the first
    substring in the format's shape) parsed by ``parse``, None where either
    fails."""
    fmt = opts.get("format")
    srx = None
    if not opts.get("exact", True):
        srx = _fmt_search_regex(fmt) if fmt is not None else re.compile(default_rx)

    def f(s):
        s = str(s)
        if srx is not None:
            m = srx.search(s)
            if m is None:
                return None
            s = m.group(0)
        try:
            return parse(s, fmt)
        except (ValueError, TypeError, OverflowError):
            return None

    return f


def _memo_key(name: str, opts: dict) -> tuple:
    """A parse's results depend on its name and options only."""
    return (name, tuple(sorted(opts.items())))


def _micros_since_epoch(d: _pydt.datetime) -> int:
    """Exact microseconds (an aware datetime: of its UTC instant)."""
    epoch = _pydt.datetime(1970, 1, 1, tzinfo=_pydt.timezone.utc if d.tzinfo is not None else None)
    delta = d - epoch
    return (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds


@register("str.to_date", dt.Date())
def _to_date(ctx, args, opts):
    def parse(s, fmt):
        if fmt is None:
            d = np.datetime64(s, "D")
            return None if np.isnat(d) else int(d.astype(np.int64))  # "" parses to NaT
        return (_pydt.datetime.strptime(s, fmt).date() - _pydt.date(1970, 1, 1)).days

    v = _require_str(args[0])
    out = _lut_op(v, _parser(opts, r"\d{4}-\d{2}-\d{2}", parse), dt.Date(),
                  memo=_memo_key("str.to_date", opts))
    return _strict_parse_flag(ctx, v, out, opts, "date")


def _datetime_dtype(dts, opts) -> dt.Datetime:
    """A format with ``%z`` parses instants: their zone is ``time_zone`` or
    UTC; without it, ``time_zone`` (or none) reads the wall clock."""
    tz = opts.get("time_zone")
    if tz is None and "%z" in (opts.get("format") or ""):
        tz = "UTC"
    return dt.Datetime(opts.get("time_unit") or "us", tz)


@register("str.to_datetime", _datetime_dtype)
def _to_datetime(ctx, args, opts):
    """Each distinct string parsed once on the host: with ``%z`` to its UTC
    instant, without it to its wall clock, which ``time_zone`` then
    localizes on the device (``fn_temporal.localize``, with ``ambiguous``;
    a time the zone skips fails). The JAX package drops ``time_zone``, and
    reads a ``%z`` string's wall clock as UTC (ROADMAP §3)."""
    from polars_tpu_torch.engine.fn_temporal import localize

    out_dt = _datetime_dtype(None, opts)
    per_s = dt.TICKS_PER_SECOND[out_dt.time_unit]
    aware = "%z" in (opts.get("format") or "")

    def parse(s, fmt):
        if fmt is None:
            d = np.datetime64(s, out_dt.time_unit)
            return None if np.isnat(d) else int(d.astype(np.int64))
        d = _pydt.datetime.strptime(s, fmt)
        if aware and d.tzinfo is None:
            return None
        return _micros_since_epoch(d) * per_s // 1_000_000

    v = _require_str(args[0])
    rx = r"\d{4}-\d{2}-\d{2}[T ]?(\d{2}:\d{2}(:\d{2}(\.\d+)?)?)?"
    out = _lut_op(v, _parser(opts, rx, parse), dt.Datetime(out_dt.time_unit),
                  memo=_memo_key("str.to_datetime", opts))
    out = _strict_parse_flag(ctx, v, out, opts, "datetime")
    if aware:
        return out.with_(dtype=out_dt)
    if out_dt.time_zone is None:
        return out
    return localize(ctx, out, out_dt.time_zone, opts.get("ambiguous", "raise"), "raise")


@register("str.to_time", dt.Time())
def _to_time(ctx, args, opts):
    """A time of day as nanoseconds since midnight (default format
    ``%H:%M:%S``); strict as the other parsers, where the JAX package nulls
    a failure whatever ``strict`` says (ROADMAP §3)."""
    def parse(s, fmt):
        t = _pydt.datetime.strptime(s, fmt or "%H:%M:%S").time()
        return ((t.hour * 60 + t.minute) * 60 + t.second) * 1_000_000_000 + t.microsecond * 1000

    v = _require_str(args[0])
    out = _lut_op(v, _parser(opts, "", parse), dt.Time(), memo=_memo_key("str.to_time", opts))
    return _strict_parse_flag(ctx, v, out, opts, "time")
