#!/usr/bin/env python3
"""Time the two ways a List's content rank is made, on one CUDA card, and
print one JSON line: ``kernels/nested_keys._refine`` (a pass per position,
over the lists still running) against ``kernels/nested_keys._double``
(prefix doubling, ceil(log2(longest)) passes over all the elements), and
the way ``kernels/nested_keys._refines`` chooses for each case.

Cases (inputs made from ``--seed`` on the card): lists of a given count and
length range, their elements uniform over a few int32 values, so that many
lists share long prefixes: 15M lists of 1-7 elements (the ``nestkeys``
baskets' shape), lists of 8, 16 and 32 elements, and
10,000 lists of 1,000 and 100 lists of 100,000 elements. Refinement is not
run past 1,000 elements (a pass per position). Each time is the median of
3 calls after one warm-up, on the card's clock (CUDA events); both ways must
give the same order.

    python3 -m polars_tpu_torch.testing.bench_list_rank

It needs a CUDA card; it imports neither JAX nor ``polars_tpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from polars_tpu_torch.testing.bench_minmax import cuda_ms

# (lists, shortest, longest, distinct element values)
CASES = ((15_000_000, 1, 7, 7), (8_000_000, 8, 8, 4), (4_000_000, 16, 16, 4), (2_000_000, 32, 32, 4),
         (10_000, 1_000, 1_000, 2), (100, 100_000, 100_000, 2))
REFINE_LIMIT = 1_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_list_rank: no CUDA device is available", file=sys.stderr)
        return 1
    from polars_tpu_torch.kernels.nested_keys import _dense_rank, _double, _refine, _refines

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for n, lo, hi, values in CASES:
        lens = torch.randint(lo, hi + 1, (n,), generator=g, device=dev, dtype=torch.int64)
        starts = torch.cumsum(lens, 0) - lens
        total, longest = int(lens.sum()), int(lens.max())
        elem = [torch.randint(0, values, (total,), generator=g, device=dev, dtype=torch.int32)]
        by_len = torch.sort(lens, stable=True)
        order = by_len.indices.flip(0)
        longer = (n - torch.searchsorted(by_len.values, torch.arange(longest, device=dev), right=True)).tolist()
        row = {"lists": n, "lengths": [lo, hi], "elements": total, "values": values,
               "chosen": "refine" if _refines(longest, total) else "double",
               "double_ms": cuda_ms(torch, lambda: _double(starts, lens, elem, longest, total, torch.int32))}
        if longest <= REFINE_LIMIT:
            a = _dense_rank([_refine(starts, elem, order, longer, torch.int32)], torch.int32)
            if not torch.equal(a, _double(starts, lens, elem, longest, total, torch.int32)):
                raise AssertionError(f"{n} lists of {lo}-{hi}: the two ways order them differently")
            row["refine_ms"] = cuda_ms(torch, lambda: _refine(starts, elem, order, longer, torch.int32))
        rows.append(row)
        del lens, starts, elem, by_len, order
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"bench_list_rank": rows, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
