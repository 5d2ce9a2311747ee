#!/usr/bin/env python3
"""Time the two ways a dense group-by's min or max is taken, on one CUDA
card, and print one JSON line: ``engine/groupby.extreme_per_group`` (one
full reduction per group, no atomics) against
``engine/groupby.extreme_by_scatter`` (one ``scatter_reduce_`` pass of
atomics into the group slots). ``engine/groupby._FEW_GROUPS`` is the largest
capacity that takes the first way.

Cases (inputs made from ``--seed`` on the card): 60M and 120M rows (SF10's
lineitem, and the two years of it that the ``frameops`` phase concatenates),
group ids uniform over ``live`` of ``cap`` slots, at capacities 12 (with 6
live: the ``frameops`` concat's group-by), 12, 32, 64, 128 and 256 (every
slot live); two kinds of values: random f64, and a rising int64 row number
(the ``frameops`` concat's ``row.max()``), where each atomic changes its
slot's value and the compare-and-swap loops retry. Each time is the median
of 3 calls after one warm-up, on the card's clock (CUDA events); both ways
must give the same bits.

    python3 -m polars_tpu_torch.testing.bench_minmax

It needs a CUDA card; it imports neither JAX nor ``polars_tpu``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

CASES = ((12, 6), (12, 12), (32, 32), (64, 64), (128, 128), (256, 256))
ROWS = (60_000_000, 120_000_000)


def cuda_ms(torch, fn, reps: int = 3, warmup: int = 1) -> float:
    """Median time of one call of ``fn`` on the card's clock (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_minmax: no CUDA device is available", file=sys.stderr)
        return 1
    from polars_tpu_torch.engine.groupby import _FEW_GROUPS, extreme_by_scatter, extreme_per_group

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for n in ROWS:
        for kind in ("f64 random", "i64 rising"):
            if kind == "f64 random":
                x, ident = torch.rand(n, generator=g, device=dev, dtype=torch.float64), float("-inf")
            else:
                x, ident = torch.arange(n, device=dev, dtype=torch.int64), torch.iinfo(torch.int64).min
            for cap, live in CASES:
                gids = torch.randint(0, live, (n,), generator=g, device=dev, dtype=torch.int32)
                a = extreme_per_group(x, gids, cap, "amax", ident)
                b = extreme_by_scatter(x, gids, cap, "amax", ident)
                if not torch.equal(a, b):
                    raise AssertionError(f"n={n} {kind} cap={cap}: the two ways differ: {a} vs {b}")
                rows.append({
                    "rows": n, "values": kind, "cap": cap, "live": live,
                    "per_group_ms": cuda_ms(torch, lambda: extreme_per_group(x, gids, cap, "amax", ident)),
                    "scatter_ms": cuda_ms(torch, lambda: extreme_by_scatter(x, gids, cap, "amax", ident)),
                })
                del gids
            del x
    print(json.dumps({"bench_minmax": rows, "few_groups": _FEW_GROUPS, "card": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
