#!/usr/bin/env python3
"""Time kernel K2 (the segment-end compaction) at the five shapes the main
path gives it, on one CUDA card, and print one JSON line.

Shapes (inputs made from ``--seed`` on the card, at SF10's sizes):
  timing  60M rows, 1 f64 column, density 0.94 (Q1's filter density);
  filter  60M rows, 4 f64 + 3 i32 columns, density 0.94 (Q1's filter alone);
  q3      60M slots, i64/f64/i32/i64, 10 survive (Q3's result);
  q1      12 slots, 13 columns, 6 survive (Q1's result);
  q4      6 slots, i32 + i64, 5 survive (Q4's result).
For each: the whole compaction as the engine runs it (count, host read of
the total, scatter; CUDA events, median of 11 after 2 warm-ups), the plain
version (``nonzero`` + ``index_select``), ``masked_select`` over every
column (the library version), the byte bound and the count of mismatching
bits against the plain version, and the count-and-scan half alone where the
version has one. At Q1's shape it also times the host work that makes a
call's outputs three ways (``alloc``): k ``torch.empty``, one allocation
per dtype cut into rows, one allocation split into k views.

The script times whichever ``polars_tpu_torch`` is first on the path, so two
versions compare in one call, in turns (parent, change, change, parent):

    PYTHONPATH=<root of a version> python3 polars_tpu_torch/testing/bench_compact.py --label <name>

It needs a CUDA card and ``nvcc``; it imports neither JAX nor ``polars_tpu``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SF10_ROWS = 60_000_000


def cuda_ms(torch, fn, reps: int = 11, warmup: int = 2) -> float:
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


def shapes(torch, dev, seed: int) -> dict:
    """The five main-path shapes: (columns, mask) made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = SF10_ROWS

    def f64(rows):
        return torch.rand(rows, generator=g, device=dev, dtype=torch.float64)

    def ints(rows, dtype):
        return torch.randint(-(2**31), 2**31 - 1, (rows,), generator=g, device=dev, dtype=torch.int64).to(dtype)

    def dense(rows, p):
        return torch.rand(rows, generator=g, device=dev) < p

    def exactly(rows, keep):
        mask = torch.zeros(rows, dtype=torch.bool, device=dev)
        mask[torch.randperm(rows, generator=g, device=dev)[:keep]] = True
        return mask

    q1_cols = [ints(12, torch.int32), ints(12, torch.int32)] + [f64(12) for _ in range(4)]
    for _ in range(3):
        q1_cols += [f64(12), dense(12, 0.5)]
    q1_cols.append(ints(12, torch.int64))
    return {
        "timing": ([f64(n)], dense(n, 0.94)),
        "filter": ([f64(n) for _ in range(4)] + [ints(n, torch.int32) for _ in range(3)], dense(n, 0.94)),
        "q3": ([ints(n, torch.int64), f64(n), ints(n, torch.int32), ints(n, torch.int64)], exactly(n, 10)),
        "q1": (q1_cols, exactly(12, 6)),
        "q4": ([ints(6, torch.int32), ints(6, torch.int64)], exactly(6, 5)),
    }


def mismatched_bits(torch, got: list, want: list) -> int:
    def bits(t):
        return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])

    return sum(int((bits(a) != bits(b)).sum()) for a, b in zip(got, want))


def alloc_us(torch, dev, cols: list, count: int) -> dict:
    """Card-clock time of the host work that makes one call's outputs: k
    ``torch.empty``; one allocation per dtype, a 16-byte-aligned row per
    column (``unbind``); one byte allocation split into k aligned views."""
    def separate():
        return [torch.empty(count, dtype=c.dtype, device=dev) for c in cols]

    def per_dtype():
        by_dtype = {}
        for c in cols:
            by_dtype.setdefault(c.dtype, []).append(c)
        outs = []
        for dtype, group in by_dtype.items():
            per16 = 16 // group[0].element_size()
            width = -(-count // per16) * per16
            outs += torch.empty((len(group), width), dtype=dtype, device=dev)[:, :count].unbind(0)
        return outs

    def carved():
        sizes = [-(-count * c.element_size() // 16) * 16 for c in cols]
        views = torch.empty(sum(sizes), dtype=torch.uint8, device=dev).split_with_sizes(sizes)
        return [v[:count * c.element_size()].view(c.dtype) for v, c in zip(views, cols)]

    return {name: 1e3 * cuda_ms(torch, fn, reps=101)
            for name, fn in (("separate_us", separate), ("per_dtype_us", per_dtype), ("carved_us", carved))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_compact: no CUDA device is available", file=sys.stderr)
        return 1
    import polars_tpu_torch
    from polars_tpu_torch.kernels import compact as K2
    from polars_tpu_torch.kernels.compact import compact, compact_plain

    dev = torch.device("cuda", 0)
    out = {"label": args.label, "package": polars_tpu_torch.__file__, "card": torch.cuda.get_device_name(0)}
    for name, (cols, mask) in shapes(torch, dev, args.seed).items():
        got, count = compact(cols, mask)
        want, count_p = compact_plain(cols, mask)
        bad = mismatched_bits(torch, got, want) if count == count_p else -1
        del got, want
        moved = mask.shape[0] + 2 * count * sum(c.element_size() for c in cols)
        out[name] = {
            "n": mask.shape[0], "k": len(cols), "count": count, "mismatched_bits": bad,
            "ms": cuda_ms(torch, lambda: compact(cols, mask)),
            # the count-and-scan half alone, where the version has one
            "count_ms": cuda_ms(torch, lambda: K2.compact_count(mask)) if hasattr(K2, "compact_count") else None,
            "plain_ms": cuda_ms(torch, lambda: compact_plain(cols, mask)),
            "library_ms": cuda_ms(torch, lambda: [torch.masked_select(c, mask) for c in cols]),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        }
        if name == "q1":
            out["alloc"] = {"k": len(cols), **alloc_us(torch, dev, cols, count)}
        if bad:
            print(json.dumps(out), flush=True)
            print(f"bench_compact: {name} disagrees with the plain version", file=sys.stderr)
            return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
