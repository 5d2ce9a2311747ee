"""String functions over dictionary-coded columns (the port of
``polars_tpu/engine/fn_strings.py``, trimmed to ``str.starts_with`` and
``str.ends_with`` with a literal or an expression right-hand side, literal
and regex ``str.contains`` and ``str.slice``).

Device tensors hold int32 codes; a string op runs once per dictionary value
on the host, and its result becomes a lookup table gathered by the codes on
the device: O(|dictionary|) host work, one O(n) gather. An op that gives
strings maps the dictionary to a new, re-normalised one
(``engine/strings.map_over_table``) and remaps the codes. Regexes are
Python's ``re``, as in the JAX package.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import SCALAR, Val, combine_validity, take_lut
from polars_tpu_torch.engine.registry import BOOL, register
from polars_tpu_torch.engine.strings import map_over_table
from polars_tpu_torch.errors import ComputeError, InvalidOperationError


def _require_str(v: Val) -> Val:
    if v.table is None:
        raise InvalidOperationError(f"expected a String column, got {v.dtype!r}")
    return v


def _lut_op(v: Val, fn, out_dtype: dt.DataType) -> Val:
    """``fn`` over the dictionary's values on the host, gathered by the codes."""
    outs = np.asarray([fn(u) for u in v.table.values] or [0], dt.dtype_to_numpy(out_dtype))
    return Val(take_lut(outs, v.values), v.validity, out_dtype, None, v.domain)


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
