"""Where PDS-H Q1's time goes on the card.

Builds the SF10 lineitem frame as ``chip_smoke.py`` does, warms Q1 up, then
runs ``--runs`` collects under ``torch.profiler`` and prints one JSON line:
the wall time per collect, the device time per collect summed over kernels,
the device's busy and idle shares of the wall, and device time per kernel
(largest first), with the port's own kernels (K1 ``groupagg``, K2
``compact``) named as such.

Run from the repository root on a machine with a CUDA device:
    python3 -m polars_tpu_torch.testing.profile_q1 [--scale 10] [--runs 5]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_q1: no CUDA device is available", file=sys.stderr)
        return 1
    import polars_tpu_torch as pl
    from polars_tpu_torch.testing import pdsh

    cols = ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount", "l_tax"]
    raw = pdsh.generate_pdsh(args.scale, seed=args.seed, tables=("lineitem",))["lineitem"]
    df = pl.DataFrame({c: raw[c] for c in cols}, device="cuda")
    del raw
    for _ in range(2):
        pdsh.q1(df).collect()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            pdsh.q1(df).collect()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.runs

    per_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / args.runs

    def label(name: str) -> str:
        if "groupagg" in name:
            part = next((p for p in ("main", "finish", "zero") if f"groupagg_{p}" in name), "kernel")
            return f"K1 {part}: " + name[:90]
        if "compact" in name:
            return "K2: " + name[:90]
        return name[:110]

    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[: args.top]
    print(json.dumps({
        "profile": "q1", "scale": args.scale, "rows": df.height, "runs": args.runs,
        "wall_ms_per_collect": wall * 1e3, "device_ms_per_collect": device_ms,
        "device_busy_share": device_ms / (wall * 1e3), "device_idle_share": 1 - device_ms / (wall * 1e3),
        "k1_ms": sum(v for k, v in per_kernel.items() if "groupagg" in k),
        "k2_ms": sum(v for k, v in per_kernel.items() if "compact" in k),
        "kernels": [{"name": label(k), "ms": v} for k, v in top],
        "device": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
