"""K1's f64 sums on the card: the exact words of global scratch
(``kernels/groupagg.plan`` ``words``) at the shapes of the sorted group-by
(capacity = the rows), and two dense capacities that run in shared slices
(f64 atomics) and in global scratch.

For each shape it checks that the kernel agrees with the plain version to
rtol 1e-9 (NaN, inf and zeros included at the small shapes) and, where it
adds exact words, that two runs give the same bits; then it prints one JSON
line with the plan and the median times (CUDA events, 7 runs after a
warm-up) of the kernel (``ms``) and of the plain version (``plain_ms``),
beside the card's name and power limit.

Run from the repository root on a machine with a CUDA device:
    python3 -m polars_tpu_torch.testing.bench_groupagg
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np

SHAPES = [  # (rows, capacity, columns, selected share, special values)
    (1_000_003, 1_000_003, 1, 0.5, True),
    (2_000_001, 4096, 5, 0.7, True),
    (60_000_000, 60_000_000, 1, 0.005, False),  # Q3's call: few rows selected
    (60_000_000, 60_000_000, 1, 1.0, False),
    (60_000_000, 15_000_000, 1, 1.0, False),  # Q18's: every row, 15M groups
    (60_000_000, 1024, 5, 0.7, False),  # shared slices, f64 atomics
    (60_000_000, 65536, 2, 0.7, False),
]


def _ms(torch, fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_groupagg: no CUDA device is available", file=sys.stderr)
        return 1
    from polars_tpu_torch.kernels import groupagg as k1

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    for n, cap, k, share, special in SHAPES:
        gids = torch.as_tensor(rng.integers(0, cap, n, dtype=np.int32)).to(dev)
        keep = rng.random(n) < share
        x = rng.uniform(1, 1e5, (k, n)) * (10.0 ** rng.integers(-3, 3, (k, n)))
        if special:
            x[0, :50] = np.asarray([np.inf, -np.inf, np.nan, 0.0, -0.0] * 10)
            keep[:50] = True
        mask = torch.as_tensor(keep).to(dev)
        cols = [torch.as_tensor(c).to(dev) for c in x]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        p = k1.plan(cap, k, sms, n, True)
        got = k1.groupagg_sums(gids, cols, mask, cap)
        want = k1.groupagg_sums_plain(gids, cols, mask, cap)
        same_bits = torch.equal(got.view(torch.int64), k1.groupagg_sums(gids, cols, mask, cap).view(torch.int64))
        agree = torch.allclose(got, want, rtol=1e-9, atol=0.0, equal_nan=True)
        res = {"rows": n, "cap": cap, "k": k, "selected_share": share, "plan": p._asdict(), "same_bits": same_bits,
               "agree_rtol_1e-9": agree, "ms": _ms(torch, lambda: k1.groupagg_sums(gids, cols, mask, cap)),
               "plain_ms": _ms(torch, lambda: k1.groupagg_sums_plain(gids, cols, mask, cap), reps=3), "card": card}
        print(json.dumps(res), flush=True)
        if not (agree and (same_bits or not p.words)):
            return 1
        del gids, mask, cols, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
