"""Where a PDS-H query's time goes on the card (any query the port runs:
q1, q3, q4, q5, q6, q10, q11, q12, q14, q15, q17, q18, q19 or q20, with
``pdsh.run_params``).

Builds the SF10 frames of the columns the query reads
(``pdsh.QUERY_COLUMNS``), as ``chip_smoke.py`` does, warms the
query up, then:

1. runs ``--runs`` collects under ``torch.profiler`` and prints one JSON line:
   the wall time per collect, the device time per collect summed over
   kernels, the device's busy and idle shares of the wall, device time by
   kind (sorts, searchsorted, gathers and scatters, K1 ``groupagg``, K2
   ``compact``, scans, reductions, elementwise, copies and fills), per
   kernel, and per PyTorch operator (the device time of the kernels each
   ``aten::`` call launched, its nested calls included; largest first);
2. runs one more collect outside the profiler with every multi-word argsort
   (``kernels/argsort.stable_argsort_words``) timed on its own by CUDA events
   (a synchronize around each), and prints each sort's caller, rows, word
   types and time.

Several queries in one run share the data, made and loaded once; each gets
frames of only its own columns (``pdsh.frames_for``).

Run from the repository root on a machine with a CUDA device:
    python3 -m polars_tpu_torch.testing.profile_query [--query q3 [q5 ...]] [--scale 10] [--runs 5]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

# device kernel name -> kind, first match wins
KINDS = [
    ("K1 groupagg", r"groupagg"),
    ("K2 compact", r"compact"),
    ("searchsorted", r"searchsorted"),
    ("sort", r"[Ss]ort|[Rr]adix"),
    ("gather/scatter", r"index|[Gg]ather|[Ss]catter"),
    ("scan", r"[Ss]can"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise"),
    ("copy/fill", r"[Mm]emcpy|[Mm]emset|fill|copy"),
]


def kind_of(name: str) -> str:
    return next((k for k, pat in KINDS if re.search(pat, name)), "other")


def timed_sorts(torch, run) -> list[dict]:
    """One collect with each call of ``stable_argsort_words`` timed alone."""
    import inspect

    from polars_tpu_torch.engine import groupby, join, join_traced, sort
    from polars_tpu_torch.kernels import argsort

    inner = argsort.stable_argsort_words
    records: list[dict] = []

    def timed(words):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        perm = inner(words)
        end.record()
        end.synchronize()
        caller = inspect.stack()[1]
        records.append({"caller": f"{caller.filename.rsplit('/', 1)[-1]}:{caller.function}",
                        "rows": int(words[0].shape[0]), "words": [str(w.dtype).replace("torch.", "") for w in words],
                        "ms": start.elapsed_time(end)})
        return perm

    mods = (groupby, join, join_traced, sort)
    for m in mods:
        m.stable_argsort_words = timed
    try:
        run().collect()
        torch.cuda.synchronize()
    finally:
        for m in mods:
            m.stable_argsort_words = inner
    return records


def profile_query(torch, query: str, run, rows: dict, scale: float, runs: int, top: int) -> None:
    """Profile ``runs`` warm collects of ``run()`` and print the two lines."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run().collect()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run().collect()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / runs

    per_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / runs

    per_op: dict[str, list] = {}  # aten op -> [device ms, calls] per collect, nested ops included
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.key.startswith("aten::"):
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            per_op[ev.key] = [us / 1e3 / runs, ev.count / runs]

    by_kind: dict[str, float] = {}
    for name, ms in per_kernel.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    device_ms = sum(per_kernel.values())
    top_kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    print(json.dumps({
        "profile": query, "scale": scale, "rows": rows, "runs": runs,
        "wall_ms_per_collect": wall * 1e3, "device_ms_per_collect": device_ms,
        "device_busy_share": device_ms / (wall * 1e3), "device_idle_share": 1 - device_ms / (wall * 1e3),
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "kernels": [{"name": name[:110], "kind": kind_of(name), "ms": ms} for name, ms in top_kernels],
        "ops": [{"op": op, "device_ms": v[0], "calls": v[1]}
                for op, v in sorted(per_op.items(), key=lambda kv: -kv[1][0])[: top]],
        "device": torch.cuda.get_device_name(0),
    }), flush=True)
    print(json.dumps({"profile": query, "sorts": timed_sorts(torch, run)}), flush=True)


def main() -> int:
    from polars_tpu_torch.testing.pdsh import QUERY_COLUMNS

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--query", nargs="+", choices=sorted(QUERY_COLUMNS), default=["q1"],
                    help="one or more queries; the data is made and loaded once for all")
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_query: no CUDA device is available", file=sys.stderr)
        return 1
    import polars_tpu_torch as pl
    from polars_tpu_torch.testing import pdsh

    need: dict[str, dict] = {}  # table -> the columns any chosen query reads
    for q in args.query:
        for t, cs in QUERY_COLUMNS[q].items():
            need.setdefault(t, {}).update(dict.fromkeys(cs))
    raw = pdsh.generate_pdsh(args.scale, seed=args.seed, tables=tuple(need))
    tables = {t: pl.DataFrame({c: raw[t][c] for c in cs}, device="cuda") for t, cs in need.items()}
    del raw
    for q in args.query:
        f = pdsh.frames_for(q, tables)
        params = pdsh.run_params(q, args.scale)
        profile_query(torch, q, lambda: pdsh.query(q, f, **params), {t: d.height for t, d in f.items()},
                      args.scale, args.runs, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
