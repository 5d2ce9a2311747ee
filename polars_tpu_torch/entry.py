"""The PDS-H Q1 kernel step over the port's group machinery: the
counterpart of ``entry()`` in the repository's ``__graft_entry__.py``, with
the same example arguments drawn from the same numpy seed."""

from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """(q1_step, example_args): a filter + two-key dense group aggregate,
    with arguments on ``device`` (default: the package default)."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.config import resolve_device
    from polars_tpu_torch.engine.common import ROW, Val
    from polars_tpu_torch.engine.groupby import dense_group_ctx, seg_count, seg_sum

    dev = resolve_device(device)
    N = 1 << 14

    def q1_step(rf_codes, ls_codes, shipdate, qty, price, disc, tax, length):
        """PDS-H Q1: masked filter + two-key dense group aggregate."""
        iota = torch.arange(N, dtype=torch.int32, device=shipdate.device)
        rowmask = (iota < length) & (shipdate <= 10471)
        rf = Val(rf_codes, None, dt.String(), None, ROW)
        ls = Val(ls_codes, None, dt.String(), None, ROW)
        g = dense_group_ctx([rf, ls], rowmask, [3, 2])
        disc_price = price * (1.0 - disc)
        charge = disc_price * (1.0 + tax)
        cap = g.capacity
        sum_qty = seg_sum(qty, rowmask, g.gids, cap)
        sum_price = seg_sum(price, rowmask, g.gids, cap)
        sum_disc_price = seg_sum(disc_price, rowmask, g.gids, cap)
        sum_charge = seg_sum(charge, rowmask, g.gids, cap)
        cnt = seg_count(rowmask, g.gids, cap)
        denom = cnt.clamp(min=1).to(torch.float64)
        return (
            sum_qty, sum_price, sum_disc_price, sum_charge,
            sum_qty / denom, sum_price / denom, cnt, g.num_groups,
        )

    rng = np.random.default_rng(0)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    example_args = (
        t(rng.integers(0, 3, N), torch.int32),
        t(rng.integers(0, 2, N), torch.int32),
        t(rng.integers(8000, 10600, N), torch.int32),
        t(rng.integers(1, 51, N).astype(np.float64), torch.float64),
        t(rng.uniform(900.0, 10000.0, N), torch.float64),
        t(rng.integers(0, 11, N) / 100.0, torch.float64),
        t(rng.integers(0, 9, N) / 100.0, torch.float64),
        N - 7,
    )
    return q1_step, example_args
