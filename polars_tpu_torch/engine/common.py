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
from polars_tpu_torch.utils.strtable import StringTable

ROW = "row"
GROUP = "group"
SCALAR = "scalar"


@dataclass
class Val:
    values: torch.Tensor
    validity: torch.Tensor | None  # bool, same shape, None = all valid
    dtype: dt.DataType
    table: StringTable | None = None
    domain: str = ROW

    def with_(self, **kw: Any) -> Val:
        return replace(self, **kw)


@dataclass
class GroupCtx:
    """Group assignment for one group-by evaluation."""

    gids: torch.Tensor  # (rows,) int32 — group id per row (-1 or garbage where ~rowmask)
    num_groups: torch.Tensor  # 0-d int32 tensor, stays on the device
    capacity: int  # static upper bound on the group count
    group_valid: torch.Tensor  # (capacity,) bool — slot < num_groups
    counts: torch.Tensor  # (capacity,) int64 — rowmask rows per group (0 past num_groups)
    # dense path: the key slot of each group (decodes the key codes without
    # a pass over the rows)
    slots: torch.Tensor | None = None


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

    @property
    def device(self) -> torch.device:
        return self.rowmask.device

    @property
    def rows(self) -> int:
        return self.rowmask.shape[0]

    def add_flag(self, flag: torch.Tensor, msg: str) -> None:
        if self.flags is not None:
            self.flags.append((flag, msg))


def combine_validity(*vals: torch.Tensor | None) -> torch.Tensor | None:
    out = None
    for v in vals:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def broadcast_pair(a: Val, b: Val) -> tuple[Val, Val, str]:
    """Reconcile domains for an elementwise binary op."""
    if a.domain == b.domain:
        return a, b, a.domain
    if SCALAR in (a.domain, b.domain):
        dom = a.domain if b.domain == SCALAR else b.domain
        return a, b, dom
    from polars_tpu_torch.errors import ShapeError

    raise ShapeError(f"cannot combine {a.domain}-domain and {b.domain}-domain expressions")
