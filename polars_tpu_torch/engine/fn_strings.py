"""String and Binary functions over dictionary-coded columns (the port of
``polars_tpu/engine/fn_strings.py``, l.74-722, and the ``bin.*`` functions
from l.750; ``json_decode`` parses on the host, ``engine/hostops.py``).

Device tensors hold int32 codes; a string op runs once per dictionary value
on the host, and its result becomes a lookup table gathered by the codes on
the device: O(|dictionary|) host work, one O(n) gather. An op that gives
strings maps the dictionary to a new one (``engine/strings.map_over_table``)
and remaps the codes. Each result is kept on its input dictionary under the
function's name and options (``StringTable.memo``), so that a dictionary is
worked over once, not once per collect. Regexes are Python's ``re``, as in
the JAX package, with Rust's named groups ``(?<name>`` translated.
"""

from __future__ import annotations

import datetime as _pydt
import re

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import SCALAR, Val, combine_validity, flag_rows, take_lut
from polars_tpu_torch.engine.registry import BOOL, SAME, register
from polars_tpu_torch.engine.strings import map_over_table
from polars_tpu_torch.errors import ComputeError, InvalidOperationError


def _require_str(v: Val) -> Val:
    if v.table is None:
        raise InvalidOperationError(f"expected a String column, got {v.dtype!r}")
    return v


def _str_map(v: Val, name: str, opts: dict, fn, out_dtype: dt.DataType | None = None) -> Val:
    """``fn`` of one string over the dictionary, giving strings (None is
    null), kept on the dictionary under ``name`` and ``opts``."""
    return map_over_table(v, fn, memo=_memo_key(name, opts), out_dtype=out_dtype or dt.String())


def translate_group_syntax(pattern: str) -> str:
    """Rust-regex named groups ``(?<name>`` as Python's ``(?P<name>``
    (lookbehinds ``(?<=`` and ``(?<!`` untouched)."""
    return re.sub(r"\(\?<([A-Za-z_][A-Za-z0-9_]*)>", r"(?P<\1>", pattern)


def group_field_names(pattern: str) -> list[str]:
    """The capture groups' names: a named group its name, an unnamed one its
    1-based position as a string."""
    rx = re.compile(translate_group_syntax(pattern))
    names = {v: k for k, v in rx.groupindex.items()}
    return [names.get(i, str(i)) for i in range(1, rx.groups + 1)]


_ASCII_LOWER = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")


def ac_occurrences(hay: str, pats: list, *, overlapping: bool = False, leftmost: bool = False,
                   ascii_ci: bool = False) -> list:
    """Literal multi-pattern matches as Aho-Corasick reports them: (start,
    end, pattern index) tuples, by match end (or, ``leftmost``, by start and
    then pattern index), each non-overlapping with the ones before unless
    ``overlapping``."""
    h = hay.translate(_ASCII_LOWER) if ascii_ci else hay
    occ = []
    for pi, p in enumerate(pats):
        if not p:
            continue
        pp = p.translate(_ASCII_LOWER) if ascii_ci else p
        st = h.find(pp)
        while st >= 0:
            occ.append((st, st + len(pp), pi))
            st = h.find(pp, st + 1)
    if overlapping:
        return sorted(occ, key=lambda t: (t[1], t[0]))
    occ.sort(key=(lambda t: (t[0], t[2])) if leftmost else (lambda t: (t[1], t[0])))
    out, pos = [], 0
    for st, en, pi in occ:
        if st >= pos:
            out.append((st, en, pi))
            pos = en
    return out


def _lut_op(v: Val, fn, out_dtype: dt.DataType, *, memo=None) -> Val:
    """``fn`` over the dictionary's values on the host, gathered by the
    codes; a result of None is null (a failed parse). ``memo``: a key under
    which the dictionary keeps the results, so that each distinct string is
    parsed once, not once per collect."""

    storage = torch.empty(0, dtype=dt.dtype_to_torch(out_dtype)).numpy().dtype  # UInt32 lives in int64

    def run():
        results = [fn(u) for u in v.table.values] or [None]
        return (np.asarray([0 if r is None else r for r in results], storage),
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


def _compile_or_null(v: Val, pat: str, opts: dict, out_dtype: dt.DataType | None = None):
    """(compiled pattern, None), or, for an invalid pattern without
    ``strict``, (None, an all-null result of ``out_dtype``, by default
    Boolean); with ``strict`` (the default) an invalid pattern raises."""
    try:
        return re.compile(translate_group_syntax(pat)), None
    except re.error as exc:
        if opts.get("strict", True):
            raise ComputeError(f"invalid regex pattern {pat!r}: {exc}") from None
        out_dtype = out_dtype or dt.Boolean()
        z = torch.zeros(v.values.shape, dtype=dt.dtype_to_torch(out_dtype), device=v.values.device)
        return None, Val(z, torch.zeros_like(z, dtype=torch.bool), out_dtype, None, v.domain)


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

    return _str_map(v, "str.slice", opts, f, v.dtype)


@register("str.contains_any", BOOL)
def _contains_any(ctx, args, opts):
    v = _require_str(args[0])
    pats = list(opts["patterns"])
    if opts.get("ascii_case_insensitive"):
        pats = [p.translate(_ASCII_LOWER) for p in pats]
        return _lut_op(v, lambda s: any(p in s.translate(_ASCII_LOWER) for p in pats), dt.Boolean(),
                       memo=_memo_key("str.contains_any", opts))
    return _lut_op(v, lambda s: any(p in s for p in pats), dt.Boolean(), memo=_memo_key("str.contains_any", opts))


@register("str.len_chars", dt.UInt32())
def _len_chars(ctx, args, opts):
    return _lut_op(_require_str(args[0]), len, dt.UInt32(), memo=("str.len_chars",))


@register("str.len_bytes", dt.UInt32())
def _len_bytes(ctx, args, opts):
    return _lut_op(_require_str(args[0]), lambda s: len(s.encode()), dt.UInt32(), memo=("str.len_bytes",))


@register("str.count_matches", dt.UInt32())
def _count_matches(ctx, args, opts):
    v = _require_str(args[0])
    pat = opts["pattern"]
    if opts.get("literal", False):
        return _lut_op(v, lambda s: s.count(pat) if pat else len(s) + 1, dt.UInt32(),
                       memo=_memo_key("str.count_matches", opts))
    rx = re.compile(translate_group_syntax(pat))
    return _lut_op(v, lambda s: sum(1 for _ in rx.finditer(s)), dt.UInt32(), memo=_memo_key("str.count_matches", opts))


@register("str.find", dt.UInt32())
def _find(ctx, args, opts):
    """The character position of the first match, null where none."""
    v = _require_str(args[0])
    pat = opts["pattern"]
    if opts.get("literal", False):
        return _lut_op(v, lambda s: s.find(pat) if pat in s else None, dt.UInt32(), memo=_memo_key("str.find", opts))
    rx, bail = _compile_or_null(v, pat, opts, dt.UInt32())
    if bail is not None:
        return bail

    def f(s):
        m = rx.search(s)
        return m.start() if m else None

    return _lut_op(v, f, dt.UInt32(), memo=_memo_key("str.find", opts))


_CASE_STRIP_PAD = {
    "to_lowercase": lambda s, o: s.lower(),
    "to_uppercase": lambda s, o: s.upper(),
    "to_titlecase": lambda s, o: s.title(),
    "reverse": lambda s, o: s[::-1],
    "strip_chars": lambda s, o: s.strip(o.get("characters")),
    "strip_chars_start": lambda s, o: s.lstrip(o.get("characters")),
    "strip_chars_end": lambda s, o: s.rstrip(o.get("characters")),
    "strip_prefix": lambda s, o: s[len(o["prefix"]):] if s.startswith(o["prefix"]) else s,
    "strip_suffix": lambda s, o: s[: len(s) - len(o["suffix"])] if o["suffix"] and s.endswith(o["suffix"]) else s,
    "pad_start": lambda s, o: s.rjust(o["length"], o.get("fill_char", " ")),
    "pad_end": lambda s, o: s.ljust(o["length"], o.get("fill_char", " ")),
    "zfill": lambda s, o: s.zfill(o["length"]),
    "escape_regex": lambda s, o: re.escape(s),
}


def _register_map(name: str, f) -> None:
    @register(f"str.{name}", dt.String())
    def _(ctx, args, opts):
        return _str_map(_require_str(args[0]), f"str.{name}", opts, lambda s: f(s, opts))


for _name, _f in _CASE_STRIP_PAD.items():
    _register_map(_name, _f)


@register("str.normalize", dt.String())
def _normalize(ctx, args, opts):
    import unicodedata

    form = opts.get("form", "NFC")
    if form not in ("NFC", "NFKC", "NFD", "NFKD"):
        raise InvalidOperationError(f"invalid normalization form {form!r}")
    return _str_map(_require_str(args[0]), "str.normalize", opts, lambda s: unicodedata.normalize(form, s))


@register("str.tail", dt.String())
def _tail(ctx, args, opts):
    n = opts["n"]
    return _str_map(_require_str(args[0]), "str.tail", opts, lambda s: s[-n:] if n else "")


@register("str.replace", dt.String())
def _replace(ctx, args, opts):
    """The first ``n`` matches (all where ``n`` < 0) replaced; ``$1`` and
    ``${name}`` in the value refer to groups, as in Rust's regex."""
    v = _require_str(args[0])
    pat, val, n = opts["pattern"], opts["value"], opts.get("n", 1)
    if opts.get("literal", False):
        return _str_map(v, "str.replace", opts, lambda s: s.replace(pat, val, -1 if n < 0 else n))
    rx = re.compile(translate_group_syntax(pat))
    repl = re.sub(r"\$\{(\w+)\}|\$(\d+|[A-Za-z_]\w*)", lambda m: f"\\g<{m.group(1) or m.group(2)}>",
                  val.replace("\\", "\\\\"))
    return _str_map(v, "str.replace", opts, lambda s: rx.sub(repl, s, count=0 if n < 0 else n))


@register("str.replace_many", dt.String())
def _replace_many(ctx, args, opts):
    v = _require_str(args[0])
    pats, reps = list(opts["patterns"]), list(opts["replace_with"])
    if len(reps) == 1:
        reps = reps * len(pats)
    if len(reps) != len(pats):
        raise InvalidOperationError("replace_with must have the same length as patterns (or length 1)")
    ci, leftmost = bool(opts.get("ascii_case_insensitive", False)), bool(opts.get("leftmost", False))

    def f(s):
        out, pos = [], 0
        for st, en, pi in ac_occurrences(s, pats, leftmost=leftmost, ascii_ci=ci):
            out += [s[pos:st], reps[pi]]
            pos = en
        return "".join(out) + s[pos:]

    return _str_map(v, "str.replace_many", opts, f)


@register("str.extract", dt.String())
def _extract(ctx, args, opts):
    """Group ``group_index`` of the first match; null where there is none."""
    v = _require_str(args[0])
    rx = re.compile(translate_group_syntax(opts["pattern"]))
    gi = opts.get("group_index", 1)

    def f(s):
        m = rx.search(s)
        return None if m is None else m.group(gi)

    return _str_map(v, "str.extract", opts, f)


@register("str.to_integer", dt.Int64())
def _to_integer(ctx, args, opts):
    """An integer in ``base``; what does not parse is null, or, with
    ``strict``, fails the segment at its count read."""
    v = _require_str(args[0])
    base = opts.get("base", 10)

    def f(s):
        try:
            x = int(s.strip(), base)
        except ValueError:
            return None
        return x if -(2**63) <= x < 2**63 else None

    out = _lut_op(v, f, dt.Int64(), memo=_memo_key("str.to_integer", opts))
    return _strict_parse_flag(ctx, v, out, opts, "i64")


@register("str.json_path_match", dt.String())
def _json_path_match(ctx, args, opts):
    """The value at a ``$.a.b`` path as text; null where the path is absent
    or the text is no JSON."""
    import json

    path = opts["json_path"]
    if not path.startswith("$."):
        raise InvalidOperationError("only simple $.field json paths supported")
    parts = path[2:].split(".")

    def f(s):
        try:
            val = json.loads(s)
            for p in parts:
                val = val[p]
        except (ValueError, KeyError, TypeError, IndexError):
            return None
        return val if isinstance(val, str) else json.dumps(val)

    return _str_map(_require_str(args[0]), "str.json_path_match", opts, f)


def _codec(enc: str, decode: bool):
    import base64
    import binascii

    table = {("hex", False): lambda b: b.hex(), ("base64", False): lambda b: base64.b64encode(b).decode(),
             ("hex", True): binascii.unhexlify, ("base64", True): lambda s: base64.b64decode(s, validate=True)}
    if (enc, decode) not in table:
        raise InvalidOperationError(f"unknown encoding {enc!r}")
    return table[(enc, decode)]


@register("str.encode", dt.String())
def _encode(ctx, args, opts):
    code = _codec(opts["encoding"], False)
    return _str_map(_require_str(args[0]), "str.encode", opts, lambda s: code(s.encode()))


def _decoded(v: Val, name: str, opts: dict) -> Val:
    """Hex or base64 text (a String's, or a Binary's bytes) as Binary; text
    that does not decode raises, or, without ``strict``, is null."""
    enc, strict = opts["encoding"], opts.get("strict", True)
    code = _codec(enc, True)

    def f(s):
        try:
            return code(s)
        except (ValueError, TypeError):
            if strict:
                raise ComputeError(f"invalid value while {enc}-decoding {s!r}") from None
            return None

    return _str_map(v, name, opts, f, dt.Binary())


@register("str.decode", dt.Binary())
def _decode(ctx, args, opts):
    return _decoded(_require_str(args[0]), "str.decode", opts)


@register("concat_str", dt.String())
def _concat_str(ctx, args, opts):
    raise InvalidOperationError("concat_str runs on the host between segments (engine/hostops.py)")


@register("cat.get_categories", dt.String(), elementwise=False)
def _get_categories(ctx, args, opts):
    raise InvalidOperationError("cat.get_categories runs on the host between segments (engine/hostops.py)")


# -- Binary --------------------------------------------------------------------------------


def _as_bytes(u) -> bytes:
    return u if isinstance(u, (bytes, bytearray)) else str(u).encode()


def _bin_pred(name: str, key: str, test) -> None:
    @register(f"bin.{name}", BOOL)
    def _(ctx, args, opts):
        lit = _as_bytes(opts[key])
        return _lut_op(_require_str(args[0]), lambda b: test(_as_bytes(b), lit), dt.Boolean(),
                       memo=_memo_key(f"bin.{name}", opts))


_bin_pred("contains", "literal", lambda b, x: x in b)
_bin_pred("starts_with", "prefix", bytes.startswith)
_bin_pred("ends_with", "suffix", bytes.endswith)


@register("bin.size", dt.UInt32())
def _bin_size(ctx, args, opts):
    return _lut_op(_require_str(args[0]), lambda b: len(_as_bytes(b)), dt.UInt32(), memo=("bin.size",))


@register("bin.slice", SAME)
def _bin_slice(ctx, args, opts):
    off, length = int(opts.get("offset", 0)), opts.get("length")

    def f(u):
        b = _as_bytes(u)
        if length is None:
            return b[off:]
        if off < 0:
            end = off + int(length)
            return b[off: end if end < 0 else None]
        return b[off: off + int(length)]

    return _str_map(_require_str(args[0]), "bin.slice", opts, f, dt.Binary())


@register("bin.get", dt.UInt8())
def _bin_get(ctx, args, opts):
    idx = int(opts.get("index", 0))

    def f(u):
        b = _as_bytes(u)
        i = idx if idx >= 0 else len(b) + idx
        return b[i] if 0 <= i < len(b) else None

    return _lut_op(_require_str(args[0]), f, dt.UInt8(), memo=_memo_key("bin.get", opts))


@register("bin.reinterpret", lambda dts, opts: dt.parse_into_dtype(opts["dtype"]))
def _bin_reinterpret(ctx, args, opts):
    """Fixed-width bytes as a number; a payload of another width is null."""
    import struct

    out_dt = dt.parse_into_dtype(opts["dtype"])
    code = {"Int8": "b", "UInt8": "B", "Int16": "h", "UInt16": "H", "Int32": "i", "UInt32": "I", "Int64": "q",
            "UInt64": "Q", "Float32": "f", "Float64": "d"}.get(type(out_dt).__name__)
    if code is None:
        raise InvalidOperationError(f"cannot reinterpret binary as {out_dt!r}")
    fmt = ("<" if opts.get("endianness", "little") == "little" else ">") + code
    size = struct.calcsize(fmt)

    def f(u):
        b = _as_bytes(u)
        if len(b) != size:
            return None
        x = struct.unpack(fmt, b)[0]
        return x - 2**64 if code == "Q" and x >= 2**63 else x  # a UInt64 as its bits

    return _lut_op(_require_str(args[0]), f, out_dt, memo=_memo_key("bin.reinterpret", opts))


@register("bin.encode", dt.String())
def _bin_encode(ctx, args, opts):
    code = _codec(opts["encoding"], False)
    return _str_map(_require_str(args[0]), "bin.encode", opts, lambda u: code(_as_bytes(u)))


@register("bin.decode", dt.Binary())
def _bin_decode(ctx, args, opts):
    return _decoded(_require_str(args[0]), "bin.decode", opts)


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


# -- functions that give a List or a Struct ---------------------------------------------


def _lists_per_entry(v: Val, name: str, opts: dict, fn, inner: dt.DataType) -> Val:
    """A List per row from ``fn``'s list for each dictionary value: each
    value's list is made once (kept on the dictionary) and stored once in
    the child, and every row of that value points at its range (rows share
    it, as in the JAX package)."""
    from polars_tpu_torch.engine.fn_nested import pack
    from polars_tpu_torch.utils import strtable

    def run():
        parts = [list(fn(u)) for u in v.table.values.tolist()] or [[]]
        lens = np.fromiter((len(p) for p in parts), np.int64, len(parts))
        flat = [x for p in parts for x in p]
        if isinstance(inner, dt.String):
            codes, validity, table = strtable.encode_strings(np.asarray(flat, dtype=object))
            child = (codes.astype(np.int32), validity, table)
        else:
            child = (np.asarray(flat, dtype=torch.empty(0, dtype=dt.dtype_to_torch(inner)).numpy().dtype), None, None)
        return (np.cumsum(lens) - lens) << 32 | lens, child

    words, (cvals, cvalid, ctable) = v.table.memo(("list", _memo_key(name, opts)), run)
    dev = v.values.device
    child = Val(torch.as_tensor(cvals).to(dev), None if cvalid is None else torch.as_tensor(cvalid).to(dev), inner,
                ctable)
    return Val(take_lut(words, v.values), v.validity, dt.List(inner), None, v.domain, child)


def _split_parts(u: str, by: str, inclusive: bool) -> list:
    parts = list(u) if by == "" else u.split(by)
    if inclusive and len(parts) > 1 and by:
        return [p + by for p in parts[:-1]] + [parts[-1]]
    return parts


@register("str.split", lambda dts, opts: dt.List(dt.String()))
def _split(ctx, args, opts):
    by, inclusive = opts.get("by", " "), bool(opts.get("inclusive", False))
    return _lists_per_entry(_require_str(args[0]), "split", opts, lambda u: _split_parts(u, by, inclusive),
                            dt.String())


@register("str.extract_all", lambda dts, opts: dt.List(dt.String()))
def _extract_all(ctx, args, opts):
    rx = re.compile(translate_group_syntax(opts.get("pattern", "")))
    return _lists_per_entry(_require_str(args[0]), "extract_all", opts,
                            lambda u: [m.group(0) for m in rx.finditer(u)], dt.String())


def _many(opts: dict, pats: list):
    ci, overlapping, leftmost = (bool(opts.get(k)) for k in ("ascii_case_insensitive", "overlapping", "leftmost"))
    return lambda u: ac_occurrences(u, pats, overlapping=overlapping, leftmost=leftmost, ascii_ci=ci)


def _many_per_row(v: Val, pats: Val, fn, inner: dt.DataType) -> Val:
    """``extract_many``/``find_many`` with a List column of patterns per
    row: the rows' strings and patterns read to the host and matched row by
    row (the JAX package's host path)."""
    from polars_tpu_torch.core.column import Column
    from polars_tpu_torch.engine.common import child_column, col_to_val

    strings = Column("s", v.dtype, _buffer(v), v.table).to_pylist()
    lists = Column("p", pats.dtype, _buffer(pats), None, child_column(pats, pats.dtype)).to_pylist()
    out = [None if s is None or p is None else fn(s, [x for x in p if x is not None]) for s, p in zip(strings, lists)]
    col = Column.from_values("", out, dt.List(inner), device=v.values.device)
    return col_to_val(col).with_(domain=v.domain)


def _buffer(v: Val):
    from polars_tpu_torch.core.buffer import Buffer

    return Buffer(v.values.reshape(-1), None if v.validity is None else v.validity.reshape(-1))


def _extract_row(u: str, pats: list, opts: dict | None = None) -> list:
    return [u[st:en] for st, en, _ in _many(opts or {}, pats)(u)]


def _find_row(u: str, pats: list, opts: dict | None = None) -> list:
    return [len(u[:st].encode()) for st, _, _ in _many(opts or {}, pats)(u)]


@register("str.extract_many", lambda dts, opts: dt.List(dt.String()))
def _extract_many(ctx, args, opts):
    v = _require_str(args[0])
    if len(args) > 1:
        return _many_per_row(v, args[1], lambda u, p: _extract_row(u, p, opts), dt.String())
    pats = list(opts.get("patterns", ()))
    return _lists_per_entry(v, "extract_many", opts, lambda u: _extract_row(u, pats, opts), dt.String())


@register("str.find_many", lambda dts, opts: dt.List(dt.UInt32()))
def _find_many(ctx, args, opts):
    """Byte offsets of the matches, as Polars gives them."""
    v = _require_str(args[0])
    if len(args) > 1:
        return _many_per_row(v, args[1], lambda u, p: _find_row(u, p, opts), dt.UInt32())
    pats = list(opts.get("patterns", ()))
    return _lists_per_entry(v, "find_many", opts, lambda u: _find_row(u, pats, opts), dt.UInt32())


def _struct_per_entry(v: Val, name: str, opts: dict, names: list[str], fn) -> Val:
    """A Struct of String fields from ``fn``'s tuple for each dictionary
    value (None past its end): each field maps the dictionary once, the
    rows' ids are their own positions."""
    fields = []
    for i in range(len(names)):
        def field(u, i=i):
            parts = fn(u)
            return parts[i] if i < len(parts) else None

        fields.append(map_over_table(v.with_(validity=None), field, memo=(name, i, tuple(sorted(opts.items()))),
                                     out_dtype=dt.String()).with_(domain="row"))
    n = v.values.shape[0]
    return Val(torch.arange(n, device=v.values.device), v.validity,
               dt.Struct([(f, dt.String()) for f in names]), None, v.domain, tuple(fields))


def _split_exact_dt(dts, opts):
    return dt.Struct([(f"field_{i}", dt.String()) for i in range(int(opts["n"]) + 1)])


@register("str.split_exact", _split_exact_dt)
def _split_exact(ctx, args, opts):
    """The first n + 1 parts (null where there are fewer)."""
    by, inclusive = opts["by"], bool(opts.get("inclusive", False))
    names = [f.name for f in _split_exact_dt([], opts).fields]
    return _struct_per_entry(_require_str(args[0]), "split_exact", opts, names,
                             lambda u: _split_parts(u, by, inclusive))


def _splitn_dt(dts, opts):
    return dt.Struct([(f"field_{i}", dt.String()) for i in range(int(opts["n"]))])


@register("str.splitn", _splitn_dt)
def _splitn(ctx, args, opts):
    """At most n parts, the last holding the rest."""
    by, n = opts["by"], int(opts["n"])
    names = [f.name for f in _splitn_dt([], opts).fields]
    return _struct_per_entry(_require_str(args[0]), "splitn", opts, names, lambda u: u.split(by, max(n - 1, 0)))


def _groups_dt(dts, opts):
    return dt.Struct([(f, dt.String()) for f in group_field_names(opts["pattern"])])


@register("str.extract_groups", _groups_dt)
def _extract_groups(ctx, args, opts):
    """The capture groups of the first match (every field null without
    one)."""
    rx = re.compile(translate_group_syntax(opts["pattern"]))
    names = group_field_names(opts["pattern"])

    def groups(u):
        m = rx.search(u)
        return m.groups() if m else ()

    return _struct_per_entry(_require_str(args[0]), "extract_groups", opts, names, groups)
