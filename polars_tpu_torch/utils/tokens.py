"""Process-monotonic identity tokens for plan keys (the port of
``polars_tpu/utils/tokens.py``).

``id()`` values are reused by CPython after garbage collection, so a key
built from ``id(obj)`` can collide with a structurally equal plan over a
different (dead) object. Tokens from this module are assigned once per
object and never reused.
"""

from __future__ import annotations

import itertools

_counter = itertools.count(1)


def next_token() -> int:
    return next(_counter)


def obj_token(obj) -> int:
    """A stable token for ``obj``: cached on the object where it can hold an
    attribute (same object, same token), a fresh one otherwise (never
    aliases)."""
    tok = getattr(obj, "_pt_token", None)
    if tok is None:
        tok = next(_counter)
        try:
            obj._pt_token = tok
        except (AttributeError, TypeError):
            pass
    return tok
