"""Where a PDS-H query's time goes on the card (any of the 22, q1 to q22,
with ``pdsh.run_params``), or one of ``chip_smoke.py``'s phases
``temporal``, ``asof`` (its backward join), ``range``, ``tz.ship`` and
``tz.orders`` (``testing/phases.py``).

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
frames of only its own columns (``pdsh.frames_for``). Each collect runs the
optimized plan, or with ``--no-optimization`` the plan as written
(``collect(no_optimization=True)``); the first line says which.

Run from the repository root on a machine with a CUDA device:
    python3 -m polars_tpu_torch.testing.profile_query [--query q3 [q5 ... temporal asof range tz.ship tz.orders]]
        [--scale 10] [--runs 5]
        [--no-optimization]
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


def timed_sorts(torch, run, no_optimization: bool = False) -> list[dict]:
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
        run().collect(no_optimization=no_optimization)
        torch.cuda.synchronize()
    finally:
        for m in mods:
            m.stable_argsort_words = inner
    return records


def profile_query(torch, query: str, run, rows: dict, scale: float, runs: int, top: int,
                  no_optimization: bool = False) -> None:
    """Profile ``runs`` warm collects of ``run()`` (its plan as written where
    ``no_optimization``) and print the two lines."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run().collect(no_optimization=no_optimization)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run().collect(no_optimization=no_optimization)
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
        "profile": query, "optimized": not no_optimization, "scale": scale, "rows": rows, "runs": runs,
        "wall_ms_per_collect": wall * 1e3, "device_ms_per_collect": device_ms,
        "device_busy_share": device_ms / (wall * 1e3), "device_idle_share": 1 - device_ms / (wall * 1e3),
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "kernels": [{"name": name[:110], "kind": kind_of(name), "ms": ms} for name, ms in top_kernels],
        "ops": [{"op": op, "device_ms": v[0], "calls": v[1]}
                for op, v in sorted(per_op.items(), key=lambda kv: -kv[1][0])[: top]],
        "device": torch.cuda.get_device_name(0),
    }), flush=True)
    print(json.dumps({"profile": query, "sorts": timed_sorts(torch, run, no_optimization)}), flush=True)


PHASES = ("temporal", "asof", "range", "tz.ship", "tz.orders")


def main() -> int:
    from polars_tpu_torch.testing.pdsh import QUERY_COLUMNS

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--query", nargs="+", choices=sorted(QUERY_COLUMNS) + list(PHASES), default=["q1"],
                    help="one or more queries; the data is made and loaded once for all")
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--no-optimization", action="store_true", help="run each plan as written, not optimized")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_query: no CUDA device is available", file=sys.stderr)
        return 1
    import polars_tpu_torch as pl
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    own = {"temporal": {"lineitem": P.TEMPORAL_COLUMNS}, "range": {"orders": ["o_orderdate", "o_totalprice"]},
           "asof": {}, "tz.ship": {"lineitem": ["l_shipdate", "l_quantity"]},
           "tz.orders": {"orders": ["o_orderdate", "o_totalprice"]}}
    need: dict[str, dict] = {}  # table -> the columns any chosen query reads
    for q in args.query:
        for t, cs in (own[q] if q in own else QUERY_COLUMNS[q]).items():
            need.setdefault(t, {}).update(dict.fromkeys(cs))
    raw = pdsh.generate_pdsh(args.scale, seed=args.seed, tables=tuple(need)) if need else {}
    if "temporal" in args.query or "tz.ship" in args.query:
        P.add_shipts(raw["lineitem"], args.seed)
        need["lineitem"]["l_shipts"] = None
    if "tz.orders" in args.query:
        P.add_orderts(raw["orders"], args.seed)
        need["orders"]["o_orderts"] = None
    tables = {t: pl.DataFrame({c: raw[t][c] for c in cs}, device="cuda") for t, cs in need.items()}
    del raw
    for q in args.query:
        if q == "temporal":
            line = tables["lineitem"]
            run, rows = (lambda: P.temporal_plan(pl, line)), {"lineitem": line.height}
        elif q == "tz.ship":
            line = tables["lineitem"]
            run, rows = (lambda: P.tz_ship_plan(pl, line)), {"lineitem": line.height}
        elif q == "tz.orders":
            orders = tables["orders"]
            run, rows = (lambda: P.tz_orders_plan(pl, orders)), {"orders": orders.height}
        elif q == "range":
            orders, windows = tables["orders"], pl.DataFrame(P.range_windows(), device="cuda")
            run, rows = (lambda: P.range_plan(pl, windows, orders)), {"orders": orders.height, "windows": 12}
        elif q == "asof":
            frames = P.asof_frames(pl, P.asof_data(args.scale, args.seed), "cuda")
            run = lambda: P.asof_plan(pl, frames, "backward", "1s")  # noqa: E731
            rows = {side: f.height for side, f in frames.items()}
        else:
            f = pdsh.frames_for(q, tables)
            params = pdsh.run_params(q, args.scale)
            run, rows = (lambda: pdsh.query(q, f, **params)), {t: d.height for t, d in f.items()}
        profile_query(torch, q, run, rows, args.scale, args.runs, args.top, args.no_optimization)
    return 0


if __name__ == "__main__":
    sys.exit(main())
