"""Evaluation value/context types shared by the expression compiler (the
port of ``polars_tpu/engine/common.py``).

``Val.domain`` tracks whether a value is per-row, per-group, or a
broadcastable scalar as expressions are evaluated (the reference's
AggState, polars-expr/src/expressions/mod.rs:65-156).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import ComputeError
from polars_tpu_torch.utils.strtable import StringTable, empty_table, enum_table

ROW = "row"
GROUP = "group"
SCALAR = "scalar"
SERIES = "series"  # a literal Series of its own length (is_in's list)


@dataclass
class Val:
    values: torch.Tensor
    validity: torch.Tensor | None  # bool, same shape, None = all valid
    dtype: dt.DataType
    table: StringTable | None = None
    domain: str = ROW
    # a nested value's child (the port of the JAX package's TracedChild):
    # for a List or Array, the flat elements as a Val of their own length,
    # which ``values``' packed (start << 32) | length words index; for a
    # Struct, a tuple of one Val per field, which ``values``' row ids index.
    # PyTorch runs eagerly, so the child is the tensors themselves.
    child: Any = None

    def with_(self, **kw: Any) -> Val:
        return replace(self, **kw)


def col_to_val(col) -> Val:
    """A frame's column as a per-row Val, its child with it."""
    return Val(col.buffer.values, col.buffer.validity, col.dtype, col.table, ROW, _child_val(col.child))


def _child_val(child):
    if child is None:
        return None
    if isinstance(child, list):
        return tuple(col_to_val(c) for c in child)
    return col_to_val(child)


def empty_child(dtype: dt.DataType, device):
    """The child of a nested value whose rows are all null (a null literal,
    a cast null): no elements for a List or Array, one null row per field
    for a Struct (its null rows' ids point there)."""

    def column(d: dt.DataType, n: int) -> Val:
        table = None
        if isinstance(d, (dt.String, dt.Categorical, dt.Enum, dt.Binary)):
            table = enum_table(d.categories) if isinstance(d, dt.Enum) else empty_table()
        tdt = torch.int32 if table is not None or isinstance(d, dt.Null) else dt.dtype_to_torch(d)
        validity = torch.zeros(n, dtype=torch.bool, device=device) if n else None
        return Val(torch.zeros(n, dtype=tdt, device=device), validity, d, table, ROW, empty_child(d, device))

    if isinstance(dtype, dt.Struct):
        return tuple(column(f.dtype, 1) for f in dtype.fields)
    if isinstance(dtype, (dt.List, dt.Array)):
        return column(dtype.inner, 0)
    return None


def child_column(v: Val, dtype: dt.DataType):
    """The child column(s) of a nested Val of ``dtype``, for a frame."""
    from polars_tpu_torch.core.buffer import Buffer
    from polars_tpu_torch.core.column import Column

    def column(name: str, c: Val, d: dt.DataType) -> Column:
        validity = None if c.validity is None else c.validity.contiguous()
        return Column(name, d, Buffer(c.values.to(dt.dtype_to_torch(d)).contiguous(), validity), c.table,
                      child_column(c, d))

    if v.child is None:
        if dtype.is_nested():
            raise ComputeError(f"a {dtype!r} value has lost its elements (an operation that moves nested "
                               "values dropped their child)")
        return None
    if isinstance(dtype, dt.Struct):
        return [column(f.name, c, f.dtype) for f, c in zip(dtype.fields, v.child)]
    if isinstance(dtype, (dt.List, dt.Array)):
        return column("", v.child, dtype.inner)
    return None


@dataclass
class GroupCtx:
    """Group assignment for one group-by evaluation."""

    gids: torch.Tensor  # (rows,) int32 — group id per row (-1 or garbage where ~rowmask)
    num_groups: torch.Tensor  # 0-d int32 tensor, stays on the device
    capacity: int  # static upper bound on the group count
    group_valid: torch.Tensor  # (capacity,) bool — slot < num_groups
    # (capacity,) int64 — rowmask rows per group (0 past num_groups); the
    # dense path has them from its occupancy pass, the sorted path takes them
    # on first use (groupby.group_counts)
    counts: torch.Tensor | None = None
    # dense path: the key slot of each group (decodes the key codes without
    # a pass over the rows)
    slots: torch.Tensor | None = None
    # sorted path: the stable permutation that numbered the groups (rows by
    # group, the dropped rows last), which a window's group order reuses
    sort_perm: torch.Tensor | None = None
    # a window's ``order_by`` words: the order of the rows within a group
    order_words: list | None = None


@dataclass
class EvalCtx:
    cols: dict[str, Val]
    rowmask: torch.Tensor  # (rows,) bool — rows that survive the filters so far
    groups: GroupCtx | None = None
    # pre-fused aggregation results (EAgg node -> Val), see executors._batch_aggs
    precomputed: dict | None = None
    # common-subexpression memo (structural ENode -> Val)
    memo: dict | None = None
    # validation flags: (bool 0-d tensor, message); raised at the segment's
    # count read-back
    flags: list | None = None
    # outside a group-by: the one group of capacity 1 that aggregations
    # reduce into (made on first use, compiler.group_of)
    scalar_group: GroupCtx | None = None
    # the rows' group order for the position functions (made on first use,
    # fn_position.group_order)
    order: Any = None
    # over(): the groups of each partition key tuple, and the context of each
    # (keys, order) pair (compiler._eval_window)
    windows: dict | None = None
    # the context of an over() window's function (not a group-by's)
    in_window: bool = False
    # the time orders that the windows over one index share
    # (fn_rolling.by_order)
    time_orders: list | None = None
    # the elements of each list value the context's list functions read
    # (fn_nested.elements)
    lists: dict | None = None

    @property
    def device(self) -> torch.device:
        return self.rowmask.device

    @property
    def rows(self) -> int:
        return self.rowmask.shape[0]

    def add_flag(self, flag: torch.Tensor, msg: str, error: type | None = None) -> None:
        """A check raised at the segment's count read: ``error`` (by default
        InvalidOperationError) with ``msg`` where ``flag`` holds."""
        if self.flags is not None:
            self.flags.append((flag, msg) if error is None else (flag, msg, error))


def flag_rows(ctx: EvalCtx | None, v: Val, bad: torch.Tensor, msg: str) -> None:
    """A validation flag, raised at the segment's count read where ``bad``
    holds on a row that counts: valid, and kept by the row mask where ``v``
    is per row."""
    if ctx is None:
        return
    if v.validity is not None:
        bad = bad & v.validity
    if v.domain == ROW:
        bad = bad & ctx.rowmask
    ctx.add_flag(bad.any(), msg)


def take_lut(lut, codes: torch.Tensor) -> torch.Tensor:
    """``lut[codes]`` for a host lookup table (a numpy array indexed by
    dictionary code), on the codes' device; codes are clamped into it."""
    t = torch.as_tensor(lut).to(codes.device)
    if t.shape[0] == 0:  # an empty dictionary: every code is under a null
        return torch.zeros(codes.shape, dtype=t.dtype, device=codes.device)
    return t.index_select(0, codes.clamp(0, max(len(lut) - 1, 0)).reshape(-1).long()).reshape(codes.shape)


def combine_validity(*vals: torch.Tensor | None) -> torch.Tensor | None:
    out = None
    for v in vals:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def reject_series(*vals: Val) -> None:
    """Raise where a literal Series meets anything but ``is_in``."""
    if any(v.domain == SERIES for v in vals):
        from polars_tpu_torch.errors import InvalidOperationError

        raise InvalidOperationError(
            "a literal Series of more than one value is a column of its own length: it applies in a select or "
            "with_columns (or as is_in's set)"
        )


def broadcast_pair(a: Val, b: Val) -> tuple[Val, Val, str]:
    """Reconcile domains for an elementwise binary op."""
    reject_series(a, b)
    if a.domain == b.domain:
        return a, b, a.domain
    if SCALAR in (a.domain, b.domain):
        dom = a.domain if b.domain == SCALAR else b.domain
        return a, b, dom
    from polars_tpu_torch.errors import ShapeError

    raise ShapeError(f"cannot combine {a.domain}-domain and {b.domain}-domain expressions")
