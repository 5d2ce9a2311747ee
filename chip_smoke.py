#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (polars_tpu_torch) on one NVIDIA GPU.

Phases, each printed as one JSON line:
  1. build    — compile the CUDA kernels from polars_tpu_torch/csrc with nvcc;
  2. kernels  — hold each kernel against its plain PyTorch version at Q1's
                shapes, at ragged, misaligned and poisoned ones, and (K1)
                at capacity = 60M rows over f64 values of three scales, one
                far below the column's largest, and time
                it (CUDA events, median of 11 runs after warm-up; 5 runs for
                the plain and library versions of K1) beside the plain
                version, the PyTorch calls that compute the same function
                (the row selection and the zeroed output included) and the
                least time the card could take;
  3. frames   — the lineitem (Q1's, Q3's and Q4's columns, built once),
                orders and customer frames on the card;
  4. q1       — PDS-H Q1 end to end at SF10 (60M lineitem rows) through the
                port's public API, against a numpy oracle written here, with
                the kernels' launch counters set to 0 just before the first
                collect and read just after;
  5. filter   — Q1's filter alone (compaction of 60M rows), against numpy;
  6. q3, q4   — PDS-H Q3 (two fused 1:m joins, a sort-based group-by over
                the 60M joined rows, top 10) and Q4 (a semi join, a dense
                group-by), each against its numpy oracle, launches counted
                the same way;
  7. q5, q6, q10, q12, q14, q18, q19 — the rest of the JAX package's first
                PDS-H file: joins of up to six tables, is_in, is_between,
                when/then, str.starts_with, casts and one-row aggregate
                selects (K1 at capacity 1), each against a numpy oracle,
                launches counted the same way;
  8. q11, q15, q17, q20 — a cross join of a one-row aggregate (Q11, Q15),
                an unvalidated join (Q15), 1:m and two-key joins (Q17,
                Q20), each against a numpy oracle; Q11 at the TPC-H
                FRACTION 0.0001 / scale, Q20 with color="part";
  9. q2, q7, q8, q9, q13, q16, q21, q22 — the rest of PDS-H: str.contains
                (literal and regex), str.ends_with, str.slice, dt.year,
                n_unique and first, a join against the query's own
                group-by (Q2), a left join counted without its nulls (Q13),
                each against a numpy oracle; Q9 with color="color3", Q13
                with words "comment" and "7";
 10. joins    — host-sized joins at SF10, each against a numpy oracle that
                gives the same rows in the same order (stable argsort +
                searchsorted): inner m:m (orders x lineitem, 60M rows), left
                and right (customer and orders), full (Q3's two filtered
                sides), cross (supplier x nation), a two-key hashed inner
                join with verification and the same keys as an anti join
                (lineitem and partsupp); each with its warm median, host
                reads and peak device memory.
 11. temporal — a Datetime("us") column on SF10 lineitem (l_shipdate plus a
                time of day from the seed): datetime literals in a filter,
                dt.truncate("1w"), Date cast to Datetime minus Datetime,
                dt.hour, offset_by("1mo").month_end(), a group-by of the
                week with Duration means, maxima and sums (about 104 rows);
 12. asof     — one trading day of NYSE TAQ's size (60M quotes, 15M trades,
                2,000 tickers, 09:30-16:00): join_asof by ticker, backward
                with tolerance "1s", then per ticker sums, a mean and
                counts; one more collect with strategy "nearest";
 13. range    — twelve monthly windows of 1995 join_where SF10 orders on
                two date inequalities (about 90M range pairs, 2.3M kept by
                K2), then a sum and a count per window;
                each of 11-13 against a numpy oracle written here, with its
                warm median, peak device memory, result rows and host reads;
 14. frameops — SF10 lineitem: unique by order with keep "first" and
                "none" (about 15M orders), a lazy concat of the 1995 and
                1996 lines with with_row_index, rename, drop and a group-by,
                and the per-order totals joined back to their own mean by
                line count (a subplan used twice, run once); each against a
                numpy oracle, a line each.
 15. tz       — time zones, formatting and parsing at SF10, two lines:
                tz.ship: the temporal phase's l_shipts read as New York's
                wall clock (replace_time_zone, about 7,000 spring-forward
                rows null, the fall-back hours the earlier instant), shown
                in Amsterdam (convert_time_zone), its hour, weekday,
                base_utc_offset and dst_offset, a filter against an aware
                literal, a group-by of the Amsterdam day (about 2,200 days)
                labelled by dt.to_string("%Y-%m-%d %z") (a host op);
                tz.orders: o_orderts, "%Y-%m-%d %H:%M" text of o_orderdate
                and an hour from the seed (about 58K distinct values, one
                row in 1,000 "N/A", built and encoded with the frames),
                parsed with str.strptime(strict=False), localized in New
                York, coalesced with the order date's midnight, is_null
                counted, then summed by local year and month behind a year
                filter; the text outside New York's 01:00 and 02:00
                hours parsed straight into the zone (strptime to
                Datetime("us", "America/New_York")); a strict parse of
                the same column must raise. Each
                against a numpy oracle whose UTC offsets come from zoneinfo
                for each distinct local or UTC hour (never the port's
                transition tables): keys, counts, instants and strings
                exactly, sums to rtol 1e-9; its plan as written too.
Every collect runs the optimized plan. Each PDS-H query and each frameops
query also runs its plan as written (collect(no_optimization=True)): a
warm-up, then 6 collects as written and 6 optimized, in turns with the
side that goes first alternating, each optimized one timed as optimize()
and the run of the optimized plan; its frame held to the same oracle and
to the optimized frame's schema and rows, the K1/K2 launches and host
reads of one collect each way ("unoptimized" on its line).
Each query reads frames of only its own columns (``pdsh.QUERY_COLUMNS``),
cut from one frame per table that is built once (string encoding timed per
column). Each query phase then collects once more with the engine's kernel calls
kept, and holds every one of them against its plain version on the very
inputs the query gave it, and times it there (``kernel_calls``); K2's
count-and-scan and scatter halves make one kept call, its offsets held
against the plain count, and at Q3's and the filter's call K2 runs 50 times,
each run bit for bit against the first;
then the kernels line, the card's name and power limit, and the final line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.

Run from the repository root:
    python3 chip_smoke.py [--scale 10] [--seed 42] [--only q1 filter q3 q4 ... q22 joins temporal asof range frameops tz]
(``--only`` runs the build and kernel phases and the named query phases, for
an A/B of a few queries against a parent tree). It needs a CUDA device and
nvcc; it never imports JAX or polars_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime as dtm
import json
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_OPS_PER_S = 33.5e12  # H100 SXM FP64 outside the tensor cores (data sheet)
Q1_DATE = dtm.date(1998, 9, 2)
Q1_DAYS = (Q1_DATE - dtm.date(1970, 1, 1)).days  # 10471
Q1_COLS = [
    "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
    "l_extendedprice", "l_discount", "l_tax",
]
EPOCH = dtm.date(1970, 1, 1)


def day(y: int, m: int, d: int) -> int:
    return (dtm.date(y, m, d) - EPOCH).days


Q3_DAYS = day(1995, 3, 15)
Q4_FROM, Q4_TO = day(1993, 7, 1), day(1993, 10, 1)
PHASES = ["q1", "filter", "q3", "q4", "q5", "q6", "q10", "q12", "q14", "q18", "q19", "q11", "q15", "q17", "q20",
          "q2", "q7", "q8", "q9", "q13", "q16", "q21", "q22", "joins", "temporal", "asof", "range", "frameops", "tz"]
# the columns the phases outside PDS-H read of each table (asof makes its own)
PHASE_COLUMNS = {
    "joins": {"customer": ["c_custkey", "c_mktsegment"], "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
              "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity"],
              "supplier": ["s_suppkey", "s_nationkey"], "nation": ["n_nationkey", "n_name"],
              "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty"]},
    "temporal": {"lineitem": ["l_shipdate", "l_commitdate", "l_receiptdate", "l_shipts"]},
    "range": {"orders": ["o_orderdate", "o_totalprice"]},
    "asof": {},
    "frameops": {"lineitem": ["l_orderkey", "l_linenumber", "l_shipdate", "l_returnflag", "l_linestatus",
                              "l_quantity", "l_extendedprice"]},  # testing/phases.FRAMEOPS_COLUMNS
    "tz": {"lineitem": ["l_shipts", "l_quantity"], "orders": ["o_orderdate", "o_totalprice", "o_orderts"]},
}
_MADE_COLUMNS = ("l_shipts", "o_orderts")  # made from the generated columns (testing/phases.py)


T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended (seconds since the start)."""
    if "phase" in obj:
        obj = {**obj, "ended_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = 11, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> dict:
    from polars_tpu_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    seconds = time.perf_counter() - t0
    regs, spills = {}, {}
    for name, text in reports.items():
        lines = text.splitlines()
        regs[name] = sorted({
            int(line.split("Used ")[1].split(" registers")[0]) for line in lines if "Used " in line and " registers" in line
        })
        spills[name] = max(
            [int(line.split("bytes spill stores")[0].split(",")[-1]) for line in lines if "spill stores" in line],
            default=0,
        )
    out = {"phase": "build", "seconds": seconds, "sources": list(build.SOURCES), "registers_used": regs,
           "max_spill_store_bytes": spills}
    emit(out)
    return out


def k1_agree(torch, got, want) -> tuple[float, bool]:
    """(max |got - want|, agreement): f64 to rtol 1e-9, i64 exactly."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.dtype == torch.float64:
        return err, bool(torch.allclose(got, want, rtol=1e-9, atol=0.0))
    return err, bool(torch.equal(got, want))


def k1_library(torch, gids, cols, mask, cap):
    """K1's whole function as PyTorch calls (the library version that is
    timed): at capacity 1 a masked sum per column (``torch.where(mask, x,
    0).sum()``; a count is ``mask.sum()``), else select the rows, zero the
    ``(cap, k)`` output, ``index_add_``."""
    if cap == 1:
        return torch.stack([mask.sum() if c is None else torch.where(mask, c, 0).sum() for c in cols]).reshape(1, -1)
    g = gids[mask].long()
    acc = next((c.dtype for c in cols if c is not None), torch.int64)
    vals = torch.stack([c[mask] if c is not None else torch.ones(g.shape[0], dtype=acc, device=g.device) for c in cols], 1)
    return torch.zeros((cap, len(cols)), dtype=acc, device=g.device).index_add_(0, g, vals)


def k1_bound(torch, gids, cols, mask, cap) -> tuple[float, str]:
    """K1's least time on this run's data: every mask byte, the selected
    rows' ids and values, the whole output; one add per selected value."""
    n, k, n_sel = gids.shape[0], len(cols), int(mask.sum())
    vbytes = sum(c.element_size() for c in cols if c is not None)
    return bound(n + n_sel * (4 + vbytes) + cap * k * 8, n_sel * k, FP64_OPS_PER_S)


def hold_k1(torch, gids, cols, mask, cap, label) -> dict:
    """K1 on these inputs against its plain version (and the library
    version against the plain one, so that it computes the same function),
    then each of the three timed, beside the bound."""
    from polars_tpu_torch.kernels.groupagg import MODE_SHARED, groupagg_sums, groupagg_sums_plain, plan

    want = groupagg_sums_plain(gids, cols, mask, cap)
    f64 = want.dtype == torch.float64
    n, k = gids.shape[0], len(cols)
    sms = torch.cuda.get_device_properties(gids.device).multi_processor_count
    p = plan(cap, k, sms, n, f64)
    first = groupagg_sums(gids, cols, mask, cap)
    err, ok = k1_agree(torch, first, want)
    if not ok:
        raise AssertionError(f"groupagg_sums {label} disagrees with its plain version (max err {err})")
    repeats = not (f64 and p.mode == MODE_SHARED)  # the shared slices' f64 atomics vary in their last bits
    if repeats and not torch.equal(_bits(torch, first), _bits(torch, groupagg_sums(gids, cols, mask, cap))):
        raise AssertionError(f"groupagg_sums {label}: a second run differs from the first in its bits")
    del first
    if not k1_agree(torch, k1_library(torch, gids, cols, mask, cap), want)[1]:
        raise AssertionError(f"the library version of groupagg_sums {label} disagrees with the plain version")
    del want
    ms = cuda_ms(torch, lambda: groupagg_sums(gids, cols, mask, cap))
    plain_ms = cuda_ms(torch, lambda: groupagg_sums_plain(gids, cols, mask, cap), reps=5, warmup=1)
    library_ms = cuda_ms(torch, lambda: k1_library(torch, gids, cols, mask, cap), reps=5, warmup=1)
    b_ms, b_by = k1_bound(torch, gids, cols, mask, cap)
    out = {"n": n, "n_selected": int(mask.sum()), "cap": cap, "k": k,
           "dtype": "i64" if all(c is None or c.dtype == torch.int64 for c in cols) else "f64",
           "plan": p._asdict(), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "repeats_bit_for_bit": True if repeats else None}
    if cap == 1:  # what the all-zero ids of a one-group call cost to make
        out["ids_fill_ms"] = cuda_ms(torch, lambda: torch.zeros(n, dtype=torch.int32, device=gids.device))
    return out


def k2_library(torch, cols, mask):
    """K2's function as PyTorch calls (the library version that is timed):
    ``masked_select`` of every column of the call."""
    return [torch.masked_select(c, mask) for c in cols]


def hold_k2(torch, cols, mask, label, main_offs=None, repeats: int = 1) -> dict:
    """K2 on these inputs against its plain version, bit for bit (``repeats``
    runs, each held against the first: a look-back ordering fault shows only
    now and then), the main path's own offsets ``main_offs`` against the plain
    count; then the whole compaction (count, host read, scatter), the count
    alone, the plain version and ``masked_select`` over every column timed
    beside the bound."""
    from polars_tpu_torch.kernels.compact import compact, compact_count, compact_count_plain, compact_plain

    cnt, err, mismatches = compact_diff(torch, cols, mask, label, repeats)
    if mismatches:
        raise AssertionError(f"compact {label} disagrees with its plain version in {mismatches} elements")
    if main_offs is not None and not torch.equal(main_offs, compact_count_plain(mask)):
        raise AssertionError(f"compact_count {label}: the main path's offsets differ from the plain count")
    n = mask.shape[0]
    ms = cuda_ms(torch, lambda: compact(cols, mask))
    count_ms = cuda_ms(torch, lambda: compact_count(mask))
    plain_ms = cuda_ms(torch, lambda: compact_plain(cols, mask))
    library_ms = cuda_ms(torch, lambda: k2_library(torch, cols, mask))
    b_ms, b_by = bound(n + 2 * cnt * sum(c.element_size() for c in cols), cnt, FP64_OPS_PER_S)
    return {"n": n, "count": cnt, "dtypes": [str(c.dtype).replace("torch.", "") for c in cols], "ms": ms,
            "count_ms": count_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err_bits": err, "mismatches": mismatches, "repeats_bit_for_bit": repeats}


def check_groupagg(torch, rng, n, cap, k, i64_cols, density, dev, offsets=(0, 0, 0), poison=False) -> dict:
    """K1 against its plain version: ``k`` f64 columns to rtol 1e-9, and the
    i64 columns ``i64_cols`` (``"int"`` = random integers, None = a count)
    exactly. ``offsets`` makes the ids, the mask and the columns contiguous
    views that start that many elements into their storage; ``poison`` puts
    NaN, inf and ids out of range into the rows the mask leaves out."""
    from polars_tpu_torch.kernels.groupagg import groupagg_sums, groupagg_sums_plain, plan

    def put(arr, off):
        if not off:
            return torch.as_tensor(arr).to(dev)
        pad = np.zeros(off, arr.dtype)
        return torch.as_tensor(np.concatenate([pad, arr])).to(dev)[off:]

    keep = rng.random(n) < density
    ids = rng.integers(0, cap, n, dtype=np.int32)
    fvals = [rng.uniform(1.0, 1000.0, n) for _ in range(k)]
    ivals = [None if c is None else rng.integers(-(2**40), 2**40, n) for c in i64_cols]
    if poison:
        out = ~keep
        ids[out] = rng.choice(np.asarray([-1, -(2**31), cap, 2**31 - 1], np.int32), int(out.sum()))
        for v in fvals:
            v[out] = rng.choice(np.asarray([np.nan, np.inf, -np.inf, 1e308]), int(out.sum()))
        for v in ivals:
            if v is not None:
                v[out] = 2**62
    gids, mask = put(ids, offsets[0]), put(keep, offsets[1])
    fcols = [put(v, offsets[2]) for v in fvals]
    icols = [None if v is None else put(v, offsets[2]) for v in ivals]
    err_f, ok_f = k1_agree(torch, groupagg_sums(gids, fcols, mask, cap), groupagg_sums_plain(gids, fcols, mask, cap))
    err_i, ok_i = k1_agree(torch, groupagg_sums(gids, icols, mask, cap), groupagg_sums_plain(gids, icols, mask, cap))
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"n": n, "cap": cap, "k_f64": k, "i64_cols": ["count" if c is None else c for c in i64_cols],
           "plan_f64": plan(cap, k, sms, n, True)._asdict(), "plan_i64": plan(cap, len(i64_cols), sms, n)._asdict(), "density": density,
           "offsets": list(offsets), "poison": poison,
           "max_abs_err_f64": err_f, "max_abs_err_i64": err_i, "f64_rtol_1e-9": ok_f, "i64_exact": ok_i}
    if not (ok_f and ok_i):
        raise AssertionError(f"groupagg_sums disagrees with its plain version: {res}")
    return res


def _bits(torch, t):
    """The raw bit pattern of ``t`` as a signed integer tensor of its width."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.view(view) if t.dtype != torch.bool else t.to(torch.int8)


def compact_diff(torch, cols, mask, label, repeats: int = 1) -> tuple[int, float, int]:
    """K2 and its plain version on the same inputs: (count, largest
    difference of the bit patterns, wrapping for 8-byte payloads; number of
    elements whose bits differ). The kernel's offsets must equal the plain
    count's; ``repeats`` - 1 further runs must repeat the first bit for bit.
    Raises if counts, offsets, shapes or repeats differ."""
    from polars_tpu_torch.kernels.compact import compact_count, compact_count_plain, compact_plain, compact_scatter

    want_offs = compact_count_plain(mask)
    want, cnt_p = compact_plain(cols, mask)
    first = None
    for rep in range(repeats):
        offs = compact_count(mask)
        cnt = int(offs[-1])
        got = compact_scatter(cols, mask, offs, cnt)
        torch.cuda.synchronize()
        if not torch.equal(offs, want_offs):
            raise AssertionError(f"compact_count offsets differ from the plain count ({label}, run {rep})")
        if first is None:
            first = got
        elif not all(torch.equal(_bits(torch, a), _bits(torch, b)) for a, b in zip(got, first)):
            raise AssertionError(f"compact run {rep} differs from run 0 in its bits ({label})")
    got = first
    if cnt != cnt_p or any(a.shape != b.shape for a, b in zip(got, want)):
        raise AssertionError(f"compact count {cnt} != plain {cnt_p} ({label})")
    err, mismatches = 0.0, 0
    for a, b in zip(got, want):
        if a.numel():
            d = _bits(torch, a).long() - _bits(torch, b).long()
            err = max(err, float(d.double().abs().max()))
            mismatches += int((d != 0).sum())
    return cnt, err, mismatches


def check_compact(torch, rng, n, mask, dtypes, dev, label="", offset=0) -> dict:
    """K2 against its plain version, bit for bit, on one column per entry of
    ``dtypes`` (random bit patterns: NaN payloads must survive). ``offset``
    makes the mask and every column contiguous views that start that many
    elements into their storage (that many bytes for the mask and the 1-byte
    columns)."""
    if not isinstance(mask, np.ndarray):
        mask = rng.random(n) < mask
    width = {torch.bool: 1, torch.int8: 1, torch.int16: 2, torch.int32: 4, torch.int64: 8, torch.float64: 8}
    ints = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
    cols = []
    for d in dtypes:
        if d == torch.bool:
            cols.append(torch.as_tensor(rng.random(n + offset) < 0.5).to(dev)[offset:])
            continue
        w = width[d]
        raw = rng.integers(-(2 ** (8 * w - 1)), 2 ** (8 * w - 1) - 1, n + offset, dtype=ints[w])
        cols.append(torch.as_tensor(raw).to(dev).view(d)[offset:])
    mask_t = torch.as_tensor(np.concatenate([np.zeros(offset, bool), mask])).to(dev)[offset:]
    cnt, err, mismatches = compact_diff(torch, cols, mask_t, f"n={n}, {label}")
    res = {"n": n, "label": label, "offset": offset, "density": float(mask.mean()) if n else 0.0, "count": cnt,
           "k": len(dtypes), "dtypes": sorted({str(d).replace("torch.", "") for d in dtypes}),
           "max_abs_err_bits": err, "mismatches": mismatches}
    if mismatches:
        raise AssertionError(f"compact disagrees with its plain version: {res}")
    return res


def phase_kernels(torch, dev, seed: int, q1_density: float, n_main: int) -> dict:
    from polars_tpu_torch.kernels.compact import CHUNK_ROWS as compact_chunk, TILE_ROWS as compact_tile
    from polars_tpu_torch.kernels.groupagg import plan

    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = plan(12, 5, sms, n_main).tile_rows  # rows per tile of Q1's f64 batch
    both = ("int", None)
    # the main path's own calls are held in the query phases; these cover
    # the rest of the input space
    checks_k1 = [
        check_groupagg(torch, rng, n_main, 12, 10, ("int", None), q1_density, dev),  # JAX batch width
        check_groupagg(torch, rng, 1_000_003, 1, 3, ("int", None), 0.5, dev),
        check_groupagg(torch, rng, 1_000_003, 12, 5, ("int", None), q1_density, dev),
        check_groupagg(torch, rng, 2_000_001, 1024, 5, ("int", None), 0.7, dev),
        check_groupagg(torch, rng, 3_000_001, 65536, 2, ("int", None), 0.7, dev),  # global-memory path
        check_groupagg(torch, rng, 0, 12, 2, ("int", None), 0.5, dev),
        # the ring's edges: one tile less a row, one tile, one tile and a row,
        # a single row, and a few tiles with a ragged end on every block
        *[check_groupagg(torch, rng, n, 12, 5, both, q1_density, dev) for n in (tile - 1, tile, tile + 1, 1)],
        check_groupagg(torch, rng, tile * (sms + 3) + 77, 12, 5, both, q1_density, dev),
        # contiguous views that start 1, 3 and 5 elements into their storage:
        # every operand misaligned, then one kind at a time
        *[check_groupagg(torch, rng, 1_000_003, 12, 5, both, q1_density, dev, offsets=(o, o, o)) for o in (1, 3, 5)],
        check_groupagg(torch, rng, 1_000_003, 12, 5, both, q1_density, dev, offsets=(1, 0, 0)),
        check_groupagg(torch, rng, 1_000_003, 12, 5, both, q1_density, dev, offsets=(0, 3, 0)),
        check_groupagg(torch, rng, 1_000_003, 1024, 5, both, q1_density, dev, offsets=(0, 16, 5)),
        check_groupagg(torch, rng, 1_000_003, 65536, 2, both, 0.7, dev, offsets=(4, 0, 1)),
        # nothing or almost nothing selected
        check_groupagg(torch, rng, 1_000_003, 12, 5, both, 0.0, dev),
        check_groupagg(torch, rng, 1_000_003, 12, 5, both, 0.01, dev),
        # NaN, inf and ids out of range under a false mask, in every mode
        check_groupagg(torch, rng, 1_000_003, 12, 5, both, 0.5, dev, poison=True),
        check_groupagg(torch, rng, 1_000_003, 1024, 5, both, 0.5, dev, poison=True),
        check_groupagg(torch, rng, 1_000_003, 65536, 2, both, 0.5, dev, poison=True, offsets=(1, 1, 1)),
        # more columns than one launch takes
        check_groupagg(torch, rng, 1_000_003, 12, 17, both, q1_density, dev),
        check_groupagg(torch, rng, 300_007, 4096, 17, both, 0.7, dev),
    ]
    emit({"phase": "kernels.groupagg_checks", "checks": checks_k1})
    payloads = [torch.bool, torch.int16, torch.int32, torch.float64]
    # Q1's output columns (2 int32 key codes, 4 f64 sums, 3 f64 means each
    # with its bool validity, the int64 count) under a random mask
    q1_out = [torch.int32, torch.int32] + [torch.float64] * 4 + [torch.float64, torch.bool] * 3 + [torch.int64]
    checks_k2 = [check_compact(torch, rng, n_main, d, payloads, dev, "payloads") for d in (0.0, 0.5, q1_density, 1.0)]
    # edges of a chunk (one offset), of a scatter block (32 chunks) and of a
    # count tile (one status word), a ragged last tile and a run of many
    # tiles, at three densities
    chunk, tile = compact_chunk, compact_tile
    edges = (0, 1, chunk - 1, chunk, chunk + 1, 32 * chunk - 1, 32 * chunk, 32 * chunk + 1, tile - 1, tile, tile + 1,
             5 * tile + 77, 1_000_003)
    checks_k2 += [check_compact(torch, rng, n, d, payloads, dev, "payloads") for n in edges for d in (0.0, 0.5, 1.0)]
    # mask and columns misaligned: views 1-15 bytes into their storage (the
    # kernel's byte path), 8-byte columns 1 and 3 elements in
    checks_k2 += [check_compact(torch, rng, 3 * tile + 5, 0.5, [torch.bool, torch.int8], dev, "view", o)
                  for o in range(1, 16)]
    checks_k2 += [check_compact(torch, rng, 3 * tile + 5, 0.5, payloads, dev, "view", o) for o in (1, 3)]
    # more columns than one launch takes
    checks_k2.append(check_compact(torch, rng, 1_000_003, q1_density, q1_out * 3, dev, "39 columns"))
    checks_k2.append(check_compact(torch, rng, 12, 0.5, q1_out, dev, "q1 output"))
    emit({"phase": "kernels.compact_checks", "checks": checks_k2})

    # K1 timing at the main path's shapes, cap 12: Q1's f64 batch (5
    # distinct columns read in place, dense group ids) and its occupancy
    # count (key slot ids); then two shapes off the main path, one for each
    # of the other accumulator modes. Each timed run is held against the
    # plain version, beside ``index_add_`` and the least time the card needs
    n = n_main
    mask = torch.as_tensor(rng.random(n) < q1_density).to(dev)
    f64_cols = [torch.as_tensor(rng.uniform(1.0, 1e5, n)).to(dev) for _ in range(5)]
    timings = {}
    for label, cols, ids, cap in (
        ("f64_k5", f64_cols, 6, 12),
        ("i64_count", [None], 12, 12),
        ("f64_k5_cap1024", f64_cols, 1024, 1024),
        ("f64_k2_cap65536", f64_cols[:2], 65536, 65536),
    ):
        gids = torch.as_tensor(rng.integers(0, ids, n, dtype=np.int32)).to(dev)
        # hold_k1 also runs each twice: every call repeats bit for bit but f64 in the shared slices
        timings[label] = hold_k1(torch, gids, cols, mask, cap, label)
        del gids
    del f64_cols
    # the exact words of the sorted group-by's shape (capacity = rows, about
    # 64 rows a group) over values of three scales, one group in three each:
    # near 1e12, near 1e-20, and near 2^-80, below 2^-108 of the column's
    # largest, where one scale per column summed them to 0; held to rtol
    # 1e-9 of the plain version and run twice, bit for bit
    gids = torch.as_tensor(rng.integers(0, max(n // 64, 1), n, dtype=np.int32)).to(dev)
    third = gids.long() % 3
    u = torch.as_tensor(rng.uniform(0.5, 2.0, n)).to(dev)
    scales = torch.where(third == 0, u * 1e12, torch.where(third == 1, u * 1e-20, u * 2.0 ** -80))
    del third, u
    timings["f64_scales_cap_rows"] = hold_k1(torch, gids, [scales], mask, n, "three scales, capacity = rows")
    del gids, scales
    emit({"phase": "kernels.groupagg_timing", **timings})

    # K2 timing: one f64 column, 60M rows, Q1 density (the filter phase
    # times its own call over Q1's seven columns)
    col8 = torch.as_tensor(rng.uniform(1.0, 1e5, n)).to(dev)
    k2_one = hold_k2(torch, [col8], mask, "one column")
    emit({"phase": "kernels.compact_timing", "one_column": k2_one})
    del col8, mask
    torch.cuda.empty_cache()
    k1_err = max([t["max_abs_err"] for t in timings.values()]
                 + [max(c["max_abs_err_f64"], c["max_abs_err_i64"]) for c in checks_k1])
    k2_err = max([k2_one["max_abs_err_bits"]] + [c["max_abs_err_bits"] for c in checks_k2])
    return {"k1_err": k1_err, "k1": timings["f64_k5"], "k1_scales": timings["f64_scales_cap_rows"], "k2_err": k2_err,
            "k2": k2_one}


def q1_oracle(raw: dict) -> dict:
    """PDS-H Q1 in numpy, independent of the port: groups by the sorted
    distinct (returnflag, linestatus) pairs present after the filter."""
    ship = raw["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    m = ship <= Q1_DAYS
    rf_u, rf = np.unique(raw["l_returnflag"].astype("U"), return_inverse=True)
    ls_u, ls = np.unique(raw["l_linestatus"].astype("U"), return_inverse=True)
    g = (rf * len(ls_u) + ls)[m]
    ng = len(rf_u) * len(ls_u)
    qty, price = raw["l_quantity"][m], raw["l_extendedprice"][m]
    disc, tax = raw["l_discount"][m], raw["l_tax"][m]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    cnt = np.bincount(g, minlength=ng)

    def s(x):
        return np.bincount(g, weights=x, minlength=ng)

    present = np.nonzero(cnt)[0]
    c = cnt[present]
    sums = {"sum_qty": s(qty)[present], "sum_base_price": s(price)[present],
            "sum_disc_price": s(disc_price)[present], "sum_charge": s(charge)[present]}
    return {
        "l_returnflag": [str(rf_u[i // len(ls_u)]) for i in present],
        "l_linestatus": [str(ls_u[i % len(ls_u)]) for i in present],
        **sums,
        "avg_qty": sums["sum_qty"] / c,
        "avg_price": sums["sum_base_price"] / c,
        "avg_disc": s(disc)[present] / c,
        "count_order": c,
    }


def generate(scale: float, seed: int, queries) -> tuple[dict, float]:
    """Every column one of ``queries`` reads (``pdsh.QUERY_COLUMNS``), of
    each PDS-H table at ``scale`` (host numpy)."""
    from polars_tpu_torch.testing import pdsh

    t0 = time.perf_counter()
    need: dict[str, dict] = {"lineitem": {"l_shipdate": None}}  # the kernels phase takes Q1's filter density
    for q in queries:
        for t, cols in PHASE_COLUMNS.get(q, pdsh.QUERY_COLUMNS.get(q, {})).items():
            need.setdefault(t, {}).update(dict.fromkeys(c for c in cols if c not in _MADE_COLUMNS))
    if "tz" in queries:
        need["lineitem"]["l_shipdate"] = need["orders"]["o_orderdate"] = None
    full = pdsh.generate_pdsh(scale, seed=seed, tables=tuple(need))
    raw = {t: {c: full[t][c] for c in cols} for t, cols in need.items()}
    if "temporal" in queries or "tz" in queries:
        _phases().add_shipts(raw["lineitem"], seed)
    if "tz" in queries:
        _phases().add_orderts(raw["orders"], seed)
    return raw, time.perf_counter() - t0


def phase_frames(torch, pl, dev, raw: dict, queries) -> tuple[dict, dict]:
    """One frame per table on the card, built column by column (the host
    encodes each string column), then each query's frames: its own columns
    of those tables, sharing their device columns (``pdsh.frames_for``)."""
    from polars_tpu_torch.core.frame import DataFrame
    from polars_tpu_torch.testing import pdsh

    tables, seconds, string_s = {}, {}, {}
    for t, cols in raw.items():
        t0 = time.perf_counter()
        built = []
        for c, values in cols.items():
            t1 = time.perf_counter()
            built.append(pl.DataFrame({c: values}, device=dev)._get(c))
            torch.cuda.synchronize()
            if values.dtype == object:
                string_s[c] = time.perf_counter() - t1
        tables[t] = DataFrame._from_columns(built)
        seconds[t] = time.perf_counter() - t0
    frames = {q: pdsh.frames_for(q, tables) for q in queries if q not in PHASE_COLUMNS}
    for q in queries:
        if q in PHASE_COLUMNS:
            frames[q] = {t: DataFrame._from_columns([tables[t]._get(c) for c in cols], tables[t].height)
                         for t, cols in PHASE_COLUMNS[q].items()}
    res = {"phase": "frames", "build_s": seconds, "string_encode_s": string_s,
           "rows": {t: f.height for t, f in tables.items()}, "device_bytes": torch.cuda.memory_allocated()}
    emit(res)
    return frames, res


def record_kernel_calls(torch, run) -> list:
    """One more collect of the query with the engine's K1 and K2 wrappers
    swapped, for that collect only, for ones that keep each call's inputs
    and then launch as before (K2's two halves make one kept call: its mask,
    the offsets the main path counted, its columns). Fails unless every
    launch of that collect was kept, so that no call site of the engine is
    missed."""
    import polars_tpu_torch.engine.executors as executors
    import polars_tpu_torch.engine.groupby as groupby
    import polars_tpu_torch.engine.join as join
    from polars_tpu_torch.kernels.compact import compact, compact_count, compact_scatter
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    calls = []

    def k1(gids, columns, mask, cap):
        calls.append(("groupagg_sums", (gids, list(columns), mask, cap)))
        return groupagg_sums(gids, columns, mask, cap)

    def k2_count(mask):
        offs = compact_count(mask)
        calls.append(("compact", {"mask": mask, "offs": offs.clone(), "cols": None}))
        return offs

    def k2_scatter(columns, mask, offs, count):
        kept = next(c[1] for c in reversed(calls) if c[0] == "compact" and c[1]["mask"] is mask)
        kept["cols"] = list(columns)
        return compact_scatter(columns, mask, offs, count)

    sites = [(executors, "groupagg_sums", k1, groupagg_sums), (groupby, "groupagg_sums", k1, groupagg_sums),
             (executors, "compact_count", k2_count, compact_count),
             (executors, "compact_scatter", k2_scatter, compact_scatter),
             (join, "compact_count", k2_count, compact_count), (join, "compact_scatter", k2_scatter, compact_scatter)]
    before = groupagg_sums.launches + compact.launches
    for module, name, recorder, _ in sites:
        setattr(module, name, recorder)
    try:
        run().collect()
        torch.cuda.synchronize()
    finally:
        for module, name, _, wrapper in sites:
            setattr(module, name, wrapper)
    if groupagg_sums.launches + compact.launches - before != len(calls):
        raise AssertionError(f"{len(calls)} kernel calls kept of {groupagg_sums.launches + compact.launches - before}")
    if any(c[0] == "compact" and c[1]["cols"] is None for c in calls):
        raise AssertionError("a K2 count was kept without its scatter")
    return calls


def hold_kernel_calls(torch, calls: list, query: str, k2_repeats: int = 1) -> list:
    """Each kept call again on its own inputs: the kernel against its plain
    version, and its times (these launches come after the counts were read).
    K2 runs ``k2_repeats`` times, each run held against the first."""
    out = []
    for i, (name, args) in enumerate(calls):
        label = f"{query} call {i}"
        if name == "groupagg_sums":
            held = hold_k1(torch, *args, label)
        else:
            held = hold_k2(torch, args["cols"], args["mask"], label, args["offs"], k2_repeats)
        out.append({"kernel": name, **held})
    return out


def run_query(torch, query: str, run, need=("groupagg_sums", "compact", "compact_scatter"), k2_repeats=1) -> dict:
    """The main path for one query: every launch counter at 0 just before the
    first collect (the warm-up), read just after; then five warm collects
    timed on the host clock around ``collect()`` and a synchronize; then one
    more collect whose kernel calls are kept and held against the plain
    versions on the very same inputs."""
    from polars_tpu_torch.kernels.compact import compact, compact_scatter
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    groupagg_sums.launches = 0
    compact.launches = 0
    compact_scatter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run().collect()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {"groupagg_sums": groupagg_sums.launches, "compact": compact.launches,
                "compact_scatter": compact_scatter.launches}
    if not all(launches[k] for k in need):
        raise AssertionError(f"the query did not launch every kernel of its path: {launches}")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run().collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    calls = record_kernel_calls(torch, run)
    kept = {k: sum(1 for c in calls if c[0] == k) for k in ("groupagg_sums", "compact")}
    if kept != {k: launches[k] for k in kept}:
        raise AssertionError(f"the kept collect launched {kept}, the counted one {launches}")
    return {"out": out, "first_collect_s": t_first, "warm_walls_s": walls, "warm_wall_s": statistics.median(walls),
            "launches": launches, "peak_device_bytes": peak,
            "kernel_calls": hold_kernel_calls(torch, calls, query, k2_repeats)}


def run_unoptimized(torch, run, out, check) -> dict:
    """The query's plan as written (``collect(no_optimization=True)``) beside
    the optimized one, after the main path: a warm-up, then 6 rounds of one
    collect as written and one optimized, in turns (as written first in the
    even rounds, optimized first in the odd ones, so neither side always runs
    second), each LazyFrame built by ``run()``. Each collect runs as
    ``collect()`` does and is timed on the host clock in two parts:
    ``optimize()`` of the plan (nothing as written), then the run of the
    plan up to a synchronize. The medians: ``warm_wall_s`` (as written),
    ``optimized_warm_wall_s`` (the optimized whole), ``optimize_s`` and
    ``optimized_run_s`` (its two parts). The frame as written is held by
    ``check`` (the optimized frame's oracle, with the same rules) and to the
    optimized frame's schema and rows; the K1/K2 launches and host reads of
    one more collect each way."""
    from polars_tpu_torch.engine.run import execute_plan, plan_cache_scope
    from polars_tpu_torch.kernels.compact import compact, compact_scatter
    from polars_tpu_torch.kernels.groupagg import groupagg_sums
    from polars_tpu_torch.plan.optimizer import optimize

    def timed_collect(no_opt: bool) -> tuple[float, float]:
        lf = run()
        t0 = time.perf_counter()
        node = lf._node if no_opt else optimize(lf._node)
        t1 = time.perf_counter()
        with plan_cache_scope():
            execute_plan(node)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    lf = run()
    plain = lf.collect(no_optimization=True)
    torch.cuda.synchronize()
    parts: dict[bool, list] = {True: [], False: []}
    for r in range(6):
        for no_opt in ((True, False) if r % 2 == 0 else (False, True)):
            parts[no_opt].append(timed_collect(no_opt))
    walls = [o + x for o, x in parts[True]]
    opt_walls = [o + x for o, x in parts[False]]
    if [(c, repr(d)) for c, d in plain.schema.items()] != [(c, repr(d)) for c, d in out.schema.items()]:
        raise AssertionError(f"unoptimized schema {plain.schema} != optimized {out.schema}")
    if plain.height != out.height:
        raise AssertionError(f"unoptimized rows {plain.height} != optimized {out.height}")
    check(plain)
    launches, reads = {}, {}
    for way, no_opt in (("optimized", False), ("unoptimized", True)):
        groupagg_sums.launches = compact.launches = compact_scatter.launches = 0
        with count_host_reads(torch) as seen:
            lf.collect(no_optimization=no_opt)
            torch.cuda.synchronize()
        launches[way] = {"groupagg_sums": groupagg_sums.launches, "compact": compact.launches}
        reads[way] = seen["reads"]
    return {"warm_wall_s": statistics.median(walls), "warm_walls_s": walls,
            "optimized_warm_wall_s": statistics.median(opt_walls), "optimized_warm_walls_s": opt_walls,
            "optimize_s": statistics.median(o for o, _ in parts[False]),
            "optimized_run_s": statistics.median(x for _, x in parts[False]),
            "launches": launches, "host_reads": reads, "equal_to_optimized": True}


def phase_q1(torch, raw: dict, df, t_gen: float, t_frame: float, scale: float) -> dict:
    from polars_tpu_torch.testing import pdsh

    n = df.height
    r = run_query(torch, "q1", lambda: pdsh.q1(df))
    out = r["out"]
    want = q1_oracle(raw)

    def check(out) -> float:
        got = out.to_dict(as_series=False)
        schema = [(k, repr(v)) for k, v in out.schema.items()]
        expect_schema = [("l_returnflag", "String"), ("l_linestatus", "String")] + [
            (k, "Float64") for k in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
                                     "avg_qty", "avg_price", "avg_disc")] + [("count_order", "UInt32")]
        if schema != expect_schema:
            raise AssertionError(f"Q1 schema {schema} != {expect_schema}")
        for key in ("l_returnflag", "l_linestatus"):
            if got[key] != want[key]:
                raise AssertionError(f"Q1 {key}: {got[key]} != {want[key]}")
        if got["count_order"] != [int(x) for x in want["count_order"]]:
            raise AssertionError(f"Q1 count_order: {got['count_order']} != {list(want['count_order'])}")
        worst = 0.0
        for key in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc"):
            g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
            if g.shape != w.shape or not np.all(np.isfinite(g)):
                raise AssertionError(f"Q1 {key}: shape or finiteness mismatch {g} vs {w}")
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"Q1 {key}")
            worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))) if len(w) else 0.0)
        return worst

    worst = check(out)
    unopt = run_unoptimized(torch, lambda: pdsh.q1(df), out, check)
    res = {
        "phase": "q1", "scale": scale, "rows": n, "groups": out.height, "datagen_s": t_gen,
        "frame_build_s": t_frame, "first_collect_s": r["first_collect_s"], "warm_wall_s": r["warm_wall_s"],
        "warm_walls_s": r["warm_walls_s"], "rows_per_s": n / r["warm_wall_s"], "launches": r["launches"],
        "peak_device_bytes": r["peak_device_bytes"],
        "max_rel_err_vs_numpy": worst, "matches_numpy_oracle": True, "unoptimized": unopt,
        "kernel_calls": r["kernel_calls"],
    }
    emit(res)
    return res


def phase_filter(torch, pl, raw: dict, df) -> dict:
    lf = df.lazy().select(Q1_COLS).filter(pl.col("l_shipdate") <= Q1_DATE)
    r = run_query(torch, "filter", lambda: lf, need=("compact", "compact_scatter"), k2_repeats=50)
    out = r["out"]
    ship = raw["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    m = ship <= Q1_DAYS
    if out.height != int(m.sum()):
        raise AssertionError(f"filter height {out.height} != {int(m.sum())}")
    checks = {}
    for name in Q1_COLS:
        col = out._get(name)
        got = col.buffer.values.cpu().numpy()
        src = raw[name][m]
        if col.table is not None:  # compare codes and the dictionary they index
            uniq, want = np.unique(src.astype("U"), return_inverse=True)
            if list(col.table.values) != list(uniq):
                raise AssertionError(f"filter {name}: dictionary {list(col.table.values)} != {list(uniq)}")
            ok = np.array_equal(got, want.astype(np.int32))
        elif name == "l_shipdate":
            ok = np.array_equal(got, src.astype("datetime64[D]").astype(np.int64).astype(np.int32))
        else:
            ok = np.array_equal(got.view(np.int64), src.view(np.int64))
        checks[name] = {"exact": bool(ok), "checksum": float(got.astype(np.float64).sum())}
        if not ok:
            raise AssertionError(f"filter column {name} differs from numpy")
    res = {"phase": "filter", "rows_in": df.height, "rows_out": out.height, "launches": r["launches"],
           "warm_wall_s": r["warm_wall_s"], "warm_walls_s": r["warm_walls_s"], "columns": checks,
           "kernel_calls": r["kernel_calls"]}
    emit(res)
    return res


def _days(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[D]").astype(np.int64)


def q3_oracle(raw: dict):
    """PDS-H Q3 in numpy: the lineitem rows that survive both joins and the
    three filters; every group's revenue (o_orderkey is unique, so it alone
    is the group), sorted by revenue descending, then date."""
    cust, orders, line = raw["customer"], raw["orders"], raw["lineitem"]
    good = cust["c_custkey"][cust["c_mktsegment"].astype("U") == "BUILDING"]
    odate = _days(orders["o_orderdate"])
    okeep = np.isin(orders["o_custkey"], good) & (odate < Q3_DAYS)
    lo = line["l_orderkey"] - 1  # o_orderkey = row + 1
    m = okeep[lo] & (_days(line["l_shipdate"]) > Q3_DAYS)
    rev = line["l_extendedprice"][m] * (1 - line["l_discount"][m])
    keys, inv = np.unique(line["l_orderkey"][m], return_inverse=True)
    revenue = np.bincount(inv.reshape(-1), weights=rev, minlength=len(keys))
    first = keys - 1
    order = np.lexsort((odate[first], -revenue))
    want = {"l_orderkey": keys[order], "revenue": revenue[order], "o_orderdate": odate[first][order],
            "o_shippriority": orders["o_shippriority"][first][order]}
    return want, "revenue", 10, ("revenue",), {"joined_rows": int(m.sum()), "groups": len(keys)}


def _host_value(v):
    """A frame value as the oracles hold it: a date as its day count."""
    return (v - EPOCH).days if isinstance(v, dtm.date) else v


def check_top(out, want: dict, sort_col: str, k: int, floats=(), label: str = "") -> float:
    """The first ``k`` rows of ``out`` against the oracle's rows, sorted as
    the query sorts them: ``want`` holds every column in order. Where the
    oracle's neighbouring ``sort_col`` values lie within rtol 1e-9 of each
    other, the rows of that run are compared as a set; every column but the
    ``floats`` exactly, those to rtol 1e-9 of the same row of the oracle.
    Returns the largest relative float error."""
    got = out.to_dict(as_series=False)
    k = min(k, len(want[sort_col]))
    if out.height != k or list(got) != list(want):
        raise AssertionError(f"{label} shape {out.height} x {list(got)}, want {k} x {list(want)}")
    r = np.asarray(want[sort_col], np.float64)
    run_of = np.concatenate([[0], np.cumsum(np.abs(np.diff(r)) > 1e-9 * np.abs(r[:-1]))])
    exact = [c for c in want if c not in floats]
    worst, seen = 0.0, set()
    for i in range(k):
        row = tuple(_host_value(got[c][i]) for c in exact)
        members = {tuple(_host_value(want[c][j]) for c in exact): j for j in np.nonzero(run_of == run_of[i])[0]}
        if row not in members or row in seen:
            raise AssertionError(f"{label} row {i} {row} is not the oracle's {sorted(members)[:4]}")
        seen.add(row)
        j = members[row]
        for c in floats:
            g, w = got[c][i], float(want[c][j])
            if g is None or not np.isfinite(g) or abs(g - w) > 1e-9 * abs(w):
                raise AssertionError(f"{label} {c} at row {i}: {g} != {w}")
            worst = max(worst, abs(g - w) / abs(w) if w else 0.0)
    return worst


def q4_oracle(raw: dict):
    """PDS-H Q4 in numpy: orders of the quarter with a late line, counted by
    priority."""
    orders, line = raw["orders"], raw["lineitem"]
    odate = _days(orders["o_orderdate"])
    late = np.unique(line["l_orderkey"][_days(line["l_commitdate"]) < _days(line["l_receiptdate"])])
    sel = (odate >= Q4_FROM) & (odate < Q4_TO) & np.isin(orders["o_orderkey"], late)
    prio, inv = np.unique(orders["o_orderpriority"].astype("U"), return_inverse=True)
    cnt = np.bincount(inv.reshape(-1)[sel], minlength=len(prio))
    present = np.nonzero(cnt)[0]
    want = {"o_orderpriority": [str(prio[i]) for i in present], "order_count": [int(cnt[i]) for i in present]}
    return want, None, 0, (), {}


def _revenue(line: dict, m: np.ndarray) -> np.ndarray:
    return line["l_extendedprice"][m] * (1 - line["l_discount"][m])


def q5_oracle(raw: dict):
    """PDS-H Q5 in numpy: revenue of the lines of 1994 orders whose customer
    and supplier share a nation of ASIA, by nation, largest first."""
    reg, nat, cust, orders, line, supp = (raw[t] for t in ("region", "nation", "customer", "orders", "lineitem",
                                                           "supplier"))
    in_asia = np.isin(nat["n_regionkey"], reg["r_regionkey"][reg["r_name"] == "ASIA"])  # n_nationkey = row
    onat = cust["c_nationkey"][orders["o_custkey"] - 1]
    odate = _days(orders["o_orderdate"])
    okeep = (odate >= day(1994, 1, 1)) & (odate < day(1995, 1, 1)) & in_asia[onat]
    lo = line["l_orderkey"] - 1
    lnat = onat[lo]
    m = okeep[lo] & (supp["s_nationkey"][line["l_suppkey"] - 1] == lnat)
    sums = np.bincount(lnat[m], weights=_revenue(line, m), minlength=len(in_asia))
    present = np.nonzero(np.bincount(lnat[m], minlength=len(in_asia)))[0]
    order = present[np.argsort(-sums[present], kind="stable")]
    want = {"n_name": [str(nat["n_name"][i]) for i in order], "revenue": sums[order]}
    return want, "revenue", 25, ("revenue",), {"joined_rows": int(m.sum())}


def q6_oracle(raw: dict):
    """PDS-H Q6 in numpy: one sum over the lines of 1994 with a discount in
    [0.05, 0.07] and a quantity under 24."""
    line = raw["lineitem"]
    ship, disc = _days(line["l_shipdate"]), line["l_discount"]
    m = (ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1)) & (disc >= 0.05) & (disc <= 0.07)
    m &= line["l_quantity"] < 24
    return {"revenue": [float(np.sum(line["l_extendedprice"][m] * disc[m]))]}, None, 0, ("revenue",), {
        "selected_rows": int(m.sum())}


def q10_oracle(raw: dict):
    """PDS-H Q10 in numpy: returned lines of the quarter's orders, revenue by
    customer (c_custkey decides the other six keys), sorted by revenue
    descending, then key."""
    cust, orders, line, nat = (raw[t] for t in ("customer", "orders", "lineitem", "nation"))
    odate = _days(orders["o_orderdate"])
    okeep = (odate >= day(1993, 10, 1)) & (odate < day(1994, 1, 1))
    lo = line["l_orderkey"] - 1
    m = okeep[lo]
    idx = np.nonzero(m)[0]
    m[idx] = line["l_returnflag"][idx] == "R"  # the string compare only where the date holds
    ci = orders["o_custkey"][lo[m]] - 1
    sums = np.bincount(ci, weights=_revenue(line, m), minlength=len(cust["c_custkey"]))
    present = np.nonzero(np.bincount(ci, minlength=len(cust["c_custkey"])))[0]
    order = present[np.lexsort((cust["c_custkey"][present], -sums[present]))]
    want = {"c_custkey": cust["c_custkey"][order], "c_name": cust["c_name"][order], "revenue": sums[order],
            "c_acctbal": cust["c_acctbal"][order], "n_name": nat["n_name"][cust["c_nationkey"][order]],
            "c_address": cust["c_address"][order], "c_phone": cust["c_phone"][order],
            "c_comment": cust["c_comment"][order]}
    return want, "revenue", 20, ("revenue", "c_acctbal"), {"joined_rows": int(m.sum()), "groups": len(present)}


def q12_oracle(raw: dict):
    """PDS-H Q12 in numpy: lines shipped by MAIL or SHIP, late but shipped
    before their commit date, received in 1994; high- and low-priority
    counts by ship mode."""
    orders, line = raw["orders"], raw["lineitem"]
    commit, receipt = _days(line["l_commitdate"]), _days(line["l_receiptdate"])
    base = (commit < receipt) & (_days(line["l_shipdate"]) < commit)
    base &= (receipt >= day(1994, 1, 1)) & (receipt < day(1995, 1, 1))
    idx = np.nonzero(base)[0]
    mode = line["l_shipmode"][idx]
    prio = orders["o_orderpriority"]
    high = ((prio == "1-URGENT") | (prio == "2-HIGH"))[line["l_orderkey"][idx] - 1]
    want = {"l_shipmode": [], "high_line_count": [], "low_line_count": []}
    for name in ("MAIL", "SHIP"):
        sel = mode == name
        if sel.any():
            want["l_shipmode"].append(name)
            want["high_line_count"].append(int((sel & high).sum()))
            want["low_line_count"].append(int((sel & ~high).sum()))
    return want, None, 0, (), {"selected_rows": sum(want["high_line_count"]) + sum(want["low_line_count"])}


def q14_oracle(raw: dict):
    """PDS-H Q14 in numpy: the share of September 1995's revenue from PROMO
    parts, in percent."""
    line, part = raw["lineitem"], raw["part"]
    ship = _days(line["l_shipdate"])
    m = (ship >= day(1995, 9, 1)) & (ship < day(1995, 10, 1))
    promo = np.char.startswith(part["p_type"].astype(str), "PROMO")[line["l_partkey"][m] - 1]
    rev = _revenue(line, m)
    return {"promo_revenue": [100.0 * float(np.sum(rev[promo])) / float(np.sum(rev))]}, None, 0, (
        "promo_revenue",), {"selected_rows": int(m.sum())}


def q18_oracle(raw: dict):
    """PDS-H Q18 in numpy: orders of more than 300 units, with their
    customer, largest total price first, then date, top 100."""
    cust, orders, line = raw["customer"], raw["orders"], raw["lineitem"]
    qty = np.bincount(line["l_orderkey"] - 1, weights=line["l_quantity"], minlength=len(orders["o_orderkey"]))
    big = np.nonzero(qty > 300)[0]
    odate = _days(orders["o_orderdate"])
    order = big[np.lexsort((odate[big], -orders["o_totalprice"][big]))]
    ck = orders["o_custkey"][order]
    want = {"c_name": cust["c_name"][ck - 1], "c_custkey": ck, "o_orderkey": orders["o_orderkey"][order],
            "o_orderdate": odate[order], "o_totalprice": orders["o_totalprice"][order], "col_qty": qty[order]}
    return want, "o_totalprice", 100, ("o_totalprice", "col_qty"), {"big_orders": len(big)}


def q19_oracle(raw: dict):
    """PDS-H Q19 in numpy: revenue of the lines that meet one of three
    container, quantity and size rules, shipped by air in person."""
    line, part = raw["lineitem"], raw["part"]
    pi = line["l_partkey"] - 1
    size, qty = part["p_size"][pi], line["l_quantity"]
    cont = part["p_container"]
    m = ((cont == "SM CASE")[pi] & (qty >= 1) & (qty <= 11) & (size <= 5)) | (
        (cont == "MED BAG")[pi] & (qty >= 10) & (qty <= 20) & (size <= 10)) | (
        (cont == "LG BOX")[pi] & (qty >= 20) & (qty <= 30) & (size <= 15))
    idx = np.nonzero(m)[0]
    mode = line["l_shipmode"][idx]
    m[idx] = ((mode == "AIR") | (mode == "REG AIR")) & (line["l_shipinstruct"][idx] == "DELIVER IN PERSON")
    return {"revenue": [float(np.sum(_revenue(line, m)))]}, None, 0, ("revenue",), {"selected_rows": int(m.sum())}


def q11_oracle(raw: dict, scale: float):
    """PDS-H Q11 in numpy: the parts whose stock value at GERMANY's
    suppliers exceeds FRACTION (0.0001 / scale, as TPC-H sets it) of the
    total, largest first, then key."""
    nat, supp, ps = raw["nation"], raw["supplier"], raw["partsupp"]
    german = np.nonzero(nat["n_name"] == "GERMANY")[0]  # n_nationkey = row
    m = np.isin(supp["s_nationkey"][ps["ps_suppkey"] - 1], german)
    value = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
    keys, inv = np.unique(ps["ps_partkey"][m], return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=value, minlength=len(keys))
    keep = sums > value.sum() * (0.0001 / scale)
    order = np.lexsort((keys[keep], -sums[keep]))
    want = {"ps_partkey": keys[keep][order], "value": sums[keep][order]}
    return want, "value", len(order), ("value",), {"german_rows": int(m.sum())}


def q15_oracle(raw: dict):
    """PDS-H Q15 in numpy: the supplier(s) with the largest revenue of the
    first quarter of 1996."""
    line, supp = raw["lineitem"], raw["supplier"]
    ship = _days(line["l_shipdate"])
    m = (ship >= day(1996, 1, 1)) & (ship < day(1996, 4, 1))
    rev = np.bincount(line["l_suppkey"][m], weights=_revenue(line, m), minlength=len(supp["s_suppkey"]) + 1)
    top = np.nonzero(rev == rev.max())[0]  # s_suppkey = row + 1
    want = {"supplier_no": top, "s_name": supp["s_name"][top - 1], "s_address": supp["s_address"][top - 1],
            "s_phone": supp["s_phone"][top - 1], "total_revenue": rev[top]}
    return want, None, 0, ("total_revenue",), {"selected_rows": int(m.sum())}


def q17_oracle(raw: dict):
    """PDS-H Q17 in numpy: the yearly revenue lost on small orders of
    Brand#11's SM CASE parts (quantity under 0.2 of the part's average)."""
    line, part = raw["lineitem"], raw["part"]
    good = (part["p_brand"] == "Brand#11") & (part["p_container"] == "SM CASE")  # p_partkey = row + 1
    pk = line["l_partkey"]
    m = good[pk - 1]
    n_part = len(good) + 1
    qty_sum = np.bincount(pk[m], weights=line["l_quantity"][m], minlength=n_part)
    cnt = np.bincount(pk[m], minlength=n_part)
    limit = 0.2 * (qty_sum / np.maximum(cnt, 1))  # the mean as the engine takes it: sum / count
    small = m.copy()
    idx = np.nonzero(m)[0]
    small[idx] = line["l_quantity"][idx] < limit[pk[idx]]
    return {"avg_yearly": [float(line["l_extendedprice"][small].sum()) / 7.0]}, None, 0, ("avg_yearly",), {
        "eligible_rows": int(m.sum()), "small_rows": int(small.sum())}


def q20_oracle(raw: dict):
    """PDS-H Q20 in numpy (color "part", which every part name starts with):
    CANADA's suppliers with a part whose stock exceeds half of what was
    shipped of it in 1994, by name."""
    nat, supp, ps, part, line = (raw[t] for t in ("nation", "supplier", "partsupp", "part", "lineitem"))
    stride = len(supp["s_suppkey"]) + 1
    ship = _days(line["l_shipdate"])
    m = (ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1))
    lkey = line["l_partkey"][m] * stride + line["l_suppkey"][m]
    keys, inv = np.unique(lkey, return_inverse=True)
    half = 0.5 * np.bincount(inv.reshape(-1), weights=line["l_quantity"][m], minlength=len(keys))
    named = np.char.startswith(part["p_name"].astype(str), "part")[ps["ps_partkey"] - 1]
    pkey = ps["ps_partkey"] * stride + ps["ps_suppkey"]
    at = np.clip(np.searchsorted(keys, pkey), 0, max(len(keys) - 1, 0))
    found = (keys[at] == pkey) if len(keys) else np.zeros(len(pkey), bool)
    ok = named & found & (ps["ps_availqty"] > np.where(found, half[at] if len(keys) else 0.0, np.inf))
    canada = np.nonzero(nat["n_name"] == "CANADA")[0]
    sk = np.unique(ps["ps_suppkey"][ok])
    sk = sk[np.isin(supp["s_nationkey"][sk - 1], canada)]
    names = supp["s_name"][sk - 1].astype(str)
    order = np.argsort(names, kind="stable")
    want = {"s_name": names[order], "s_address": supp["s_address"][sk - 1][order]}
    return want, None, 0, (), {"qualifying_partsupp": int(ok.sum())}


def _str_test(arr: np.ndarray, fn) -> np.ndarray:
    """``fn`` of each string of ``arr`` (bool), run once per distinct value."""
    vals = arr.tolist()
    of = {u: bool(fn(u)) for u in set(vals)}
    return np.fromiter(map(of.__getitem__, vals), bool, len(vals))


def _codes(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(sorted distinct strings, each value's index among them)."""
    vals = arr.tolist()
    uniq = sorted(set(vals))
    rank = {u: i for i, u in enumerate(uniq)}
    return np.asarray(uniq, object), np.fromiter(map(rank.__getitem__, vals), np.int64, len(vals))


def _year(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970


def _group_sums(keys: list, weights: np.ndarray) -> tuple[list, np.ndarray]:
    """(each key column's value per group, sums), groups in lexicographic
    key order; keys are non-negative int64 columns."""
    mixed, inv = np.unique(np.stack(keys, 1), axis=0, return_inverse=True)
    return [mixed[:, i] for i in range(len(keys))], np.bincount(inv.reshape(-1), weights=weights,
                                                                 minlength=len(mixed))


def q2_oracle(raw: dict):
    """PDS-H Q2 in numpy: the partsupp rows of size-15 BRASS parts whose
    supplier lies in EUROPE and whose cost is the least among those rows of
    their part; richest supplier first, then nation, supplier, part; top 100."""
    reg, nat, supp, ps, part = (raw[t] for t in ("region", "nation", "supplier", "partsupp", "part"))
    pmask = (part["p_size"] == 15) & _str_test(part["p_type"], lambda s: s.endswith("BRASS"))
    in_reg = np.isin(nat["n_regionkey"], reg["r_regionkey"][reg["r_name"] == "EUROPE"])  # n_nationkey = row
    idx = np.nonzero(pmask[ps["ps_partkey"] - 1])[0]
    idx = idx[in_reg[supp["s_nationkey"][ps["ps_suppkey"][idx] - 1]]]
    pk, cost = ps["ps_partkey"][idx], ps["ps_supplycost"][idx]
    order = np.lexsort((cost, pk))
    keys, start = np.unique(pk[order], return_index=True)
    least = np.minimum.reduceat(cost[order], start) if len(keys) else cost[:0]
    keep = idx[cost == least[np.searchsorted(keys, pk)]]
    s, p = ps["ps_suppkey"][keep] - 1, ps["ps_partkey"][keep] - 1
    cols = {"s_acctbal": supp["s_acctbal"][s], "s_name": supp["s_name"][s],
            "n_name": nat["n_name"][supp["s_nationkey"][s]], "p_partkey": part["p_partkey"][p],
            "p_mfgr": part["p_mfgr"][p], "s_address": supp["s_address"][s], "s_phone": supp["s_phone"][s],
            "s_comment": supp["s_comment"][s]}
    order = np.lexsort((cols["p_partkey"], cols["s_name"].astype(str), cols["n_name"].astype(str), -cols["s_acctbal"]))
    want = {c: v[order] for c, v in cols.items()}
    return want, "s_acctbal", 100, (), {"eligible_rows": len(idx), "least_cost_rows": len(keep)}


def q7_oracle(raw: dict):
    """PDS-H Q7 in numpy: revenue shipped in 1995-1996 between FRANCE and
    GERMANY, by supplier nation, customer nation and year."""
    cust, orders, line, supp, nat = (raw[t] for t in ("customer", "orders", "lineitem", "supplier", "nation"))
    fr, de = (int(np.nonzero(nat["n_name"] == n)[0][0]) for n in ("FRANCE", "GERMANY"))
    ship = _days(line["l_shipdate"])
    idx = np.nonzero((ship >= day(1995, 1, 1)) & (ship <= day(1996, 12, 31)))[0]
    sn = supp["s_nationkey"][line["l_suppkey"][idx] - 1]
    cn = cust["c_nationkey"][orders["o_custkey"][line["l_orderkey"][idx] - 1] - 1]
    ok = ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
    idx, sn, cn = idx[ok], sn[ok], cn[ok]
    names = nat["n_name"]
    rank = np.argsort(np.argsort(names.astype(str)))  # nation -> position of its name in sorted order
    (rs, rc, yr), rev = _group_sums([rank[sn], rank[cn], _year(ship[idx])], _revenue(line, idx))
    by_rank = np.argsort(rank)
    want = {"supp_nation": names[by_rank[rs]], "cust_nation": names[by_rank[rc]], "l_year": yr, "revenue": rev}
    return want, None, 0, ("revenue",), {"joined_rows": len(idx)}


def q8_oracle(raw: dict):
    """PDS-H Q8 in numpy: BRAZIL's share of the revenue of ECONOMY ANODIZED
    STEEL parts sold to AMERICA in 1995-1996, by year."""
    reg, nat, cust, orders, line, supp, part = (raw[t] for t in ("region", "nation", "customer", "orders", "lineitem",
                                                                 "supplier", "part"))
    pmask = _str_test(part["p_type"], lambda s: s == "ECONOMY ANODIZED STEEL")
    idx = np.nonzero(pmask[line["l_partkey"] - 1])[0]
    oi = line["l_orderkey"][idx] - 1
    odate = _days(orders["o_orderdate"][oi])
    in_reg = np.isin(nat["n_regionkey"], reg["r_regionkey"][reg["r_name"] == "AMERICA"])
    ok = (odate >= day(1995, 1, 1)) & (odate <= day(1996, 12, 31))
    ok &= in_reg[cust["c_nationkey"][orders["o_custkey"][oi] - 1]]
    idx, odate = idx[ok], odate[ok]
    vol = _revenue(line, idx)
    brazil = nat["n_name"][supp["s_nationkey"][line["l_suppkey"][idx] - 1]] == "BRAZIL"
    (yr,), total = _group_sums([_year(odate)], vol)
    _, share = _group_sums([_year(odate)], np.where(brazil, vol, 0.0))
    return {"o_year": yr, "mkt_share": share / total}, None, 0, ("mkt_share",), {"joined_rows": len(idx)}


def q9_oracle(raw: dict):
    """PDS-H Q9 in numpy (color "color3"): profit on the lines of parts named
    with the color, whose (part, supplier) is in partsupp, by supplier nation
    and order year, the newest year first."""
    nat, orders, line, supp, part, ps = (raw[t] for t in ("nation", "orders", "lineitem", "supplier", "part",
                                                          "partsupp"))
    pmask = _str_test(part["p_name"], lambda s: "color3" in s)
    idx = np.nonzero(pmask[line["l_partkey"] - 1])[0]
    base = (line["l_partkey"][idx] - 1) * 4  # partsupp holds four rows per part, in part order
    if not np.array_equal(ps["ps_partkey"][::4], np.arange(1, len(ps["ps_partkey"]) // 4 + 1)):
        raise AssertionError("partsupp is not four rows per part in part order")
    hit = ps["ps_suppkey"][base[:, None] + np.arange(4)] == line["l_suppkey"][idx][:, None]
    found = hit.any(1)
    idx, psi = idx[found], base[found] + hit[found].argmax(1)
    amount = _revenue(line, idx) - ps["ps_supplycost"][psi] * line["l_quantity"][idx]
    names = nat["n_name"]
    rank = np.argsort(np.argsort(names.astype(str)))
    year = _year(_days(orders["o_orderdate"][line["l_orderkey"][idx] - 1]))
    (rn, ny), profit = _group_sums([rank[supp["s_nationkey"][line["l_suppkey"][idx] - 1]], 9999 - year], amount)
    want = {"nation": names[np.argsort(rank)[rn]], "o_year": 9999 - ny, "sum_profit": profit}
    return want, None, 0, ("sum_profit",), {"color_rows": int(pmask.sum()), "joined_rows": len(idx)}


def q13_oracle(raw: dict):
    """PDS-H Q13 in numpy (words "comment" and "7"): customers by their number
    of orders whose comment does not match "comment.*7" (none: 0), counted."""
    cust, orders = raw["customer"], raw["orders"]
    rx = re.compile("comment.*7")
    keep = ~_str_test(orders["o_comment"], lambda s: rx.search(s) is not None)
    cnt = np.bincount(orders["o_custkey"][keep] - 1, minlength=len(cust["c_custkey"]))  # c_custkey = row + 1
    dist = np.bincount(cnt)
    cc = np.nonzero(dist)[0]
    order = np.lexsort((-cc, -dist[cc]))
    return {"c_count": cc[order], "custdist": dist[cc][order]}, None, 0, (), {"kept_orders": int(keep.sum())}


def q16_oracle(raw: dict):
    """PDS-H Q16 in numpy: distinct suppliers (none with a complaint comment)
    of the parts not of Brand#44, not STANDARD, of eight sizes, by brand,
    type and size, most suppliers first."""
    supp, ps, part = raw["supplier"], raw["partsupp"], raw["part"]
    bad = _str_test(supp["s_comment"], lambda s: re.search("Customer.*Complaints", s) is not None)
    brands, bc = _codes(part["p_brand"])
    types, tc = _codes(part["p_type"])
    size = part["p_size"]
    pmask = (part["p_brand"] != "Brand#44") & ~_str_test(part["p_type"], lambda s: s.startswith("STANDARD"))
    pmask &= np.isin(size, [49, 14, 23, 45, 19, 3, 36, 9])
    idx = np.nonzero(pmask[ps["ps_partkey"] - 1])[0]
    idx = idx[~bad[ps["ps_suppkey"][idx] - 1]]
    p = ps["ps_partkey"][idx] - 1
    key = (bc[p] * len(types) + tc[p]) * 64 + size[p]
    pairs = np.unique(key * (len(supp["s_suppkey"]) + 1) + ps["ps_suppkey"][idx])
    keys, cnt = np.unique(pairs // (len(supp["s_suppkey"]) + 1), return_counts=True)
    order = np.lexsort((keys, -cnt))  # key order is brand, type, size order
    keys, cnt = keys[order], cnt[order]
    want = {"p_brand": brands[keys // 64 // len(types)], "p_type": types[keys // 64 % len(types)],
            "p_size": keys % 64, "supplier_cnt": cnt}
    return want, None, 0, (), {"partsupp_rows": len(idx), "complaining_suppliers": int(bad.sum())}


def q21_oracle(raw: dict):
    """PDS-H Q21 in numpy: SAUDI ARABIA's suppliers that were the only late
    one of a multi-supplier order of status F, by count, top 100."""
    nat, supp, line, orders = (raw[t] for t in ("nation", "supplier", "lineitem", "orders"))
    lk, sk = line["l_orderkey"], line["l_suppkey"]
    late = _days(line["l_receiptdate"]) > _days(line["l_commitdate"])
    stride, n_orders = len(supp["s_suppkey"]) + 1, len(orders["o_orderkey"])

    def distinct(sel):
        """Distinct suppliers of each order over the rows ``sel`` (by order key)."""
        u = np.sort(lk[sel] * stride + sk[sel], kind="stable")  # lk is sorted: runs of a few rows
        first = np.concatenate([[True], u[1:] != u[:-1]]) if len(u) else np.zeros(0, bool)
        return np.bincount(u[first] // stride, minlength=n_orders + 1)

    n_supp, n_late = distinct(slice(None)), distinct(late)
    idx = np.nonzero(late)[0]
    ok = (orders["o_orderstatus"][lk[idx] - 1] == "F") & (n_supp[lk[idx]] > 1) & (n_late[lk[idx]] == 1)
    saudi = np.nonzero(nat["n_name"] == "SAUDI ARABIA")[0]
    idx = idx[ok]
    idx = idx[np.isin(supp["s_nationkey"][sk[idx] - 1], saudi)]
    cnt = np.bincount(sk[idx], minlength=stride)
    present = np.nonzero(cnt)[0]
    names = supp["s_name"][present - 1]
    order = np.lexsort((names.astype(str), -cnt[present]))
    want = {"s_name": names[order], "numwait": cnt[present][order]}
    return want, "numwait", 100, (), {"waiting_lines": len(idx)}


def q22_oracle(raw: dict):
    """PDS-H Q22 in numpy: customers of seven country codes with more than
    the average positive balance and no order, counted and summed by code."""
    cust, orders = raw["customer"], raw["orders"]
    codes, cc = _codes(np.asarray([s[:2] for s in cust["c_phone"].tolist()], object))
    elig = np.isin(codes, ["13", "31", "23", "29", "30", "18", "17"])[cc]
    bal = cust["c_acctbal"]
    pos = elig & (bal > 0.0)
    avg = bal[pos].sum() / pos.sum()
    none = np.bincount(orders["o_custkey"], minlength=len(bal) + 1)[cust["c_custkey"]] == 0
    keep = elig & (bal > avg) & none
    (g,), total = _group_sums([cc[keep]], bal[keep])
    want = {"cntrycode": codes[g], "numcust": np.bincount(cc[keep], minlength=len(codes))[g], "totacctbal": total}
    return want, None, 0, ("totacctbal",), {"customers_without_orders": int(none.sum())}


ORACLES = {"q3": q3_oracle, "q4": q4_oracle, "q5": q5_oracle, "q6": q6_oracle, "q10": q10_oracle,
           "q12": q12_oracle, "q14": q14_oracle, "q18": q18_oracle, "q19": q19_oracle, "q15": q15_oracle,
           "q17": q17_oracle, "q20": q20_oracle, "q2": q2_oracle, "q7": q7_oracle, "q8": q8_oracle, "q9": q9_oracle,
           "q13": q13_oracle, "q16": q16_oracle, "q21": q21_oracle, "q22": q22_oracle}

# each query's result schema, as polars_tpu gives it
SCHEMAS = {
    "q3": [("l_orderkey", "Int64"), ("revenue", "Float64"), ("o_orderdate", "Date"), ("o_shippriority", "Int64")],
    "q4": [("o_orderpriority", "String"), ("order_count", "UInt32")],
    "q5": [("n_name", "String"), ("revenue", "Float64")],
    "q6": [("revenue", "Float64")],
    "q10": [("c_custkey", "Int64"), ("c_name", "String"), ("revenue", "Float64"), ("c_acctbal", "Float64"),
            ("n_name", "String"), ("c_address", "String"), ("c_phone", "String"), ("c_comment", "String")],
    "q12": [("l_shipmode", "String"), ("high_line_count", "Int64"), ("low_line_count", "Int64")],
    "q14": [("promo_revenue", "Float64")],
    "q18": [("c_name", "String"), ("c_custkey", "Int64"), ("o_orderkey", "Int64"), ("o_orderdate", "Date"),
            ("o_totalprice", "Float64"), ("col_qty", "Float64")],
    "q19": [("revenue", "Float64")],
    "q11": [("ps_partkey", "Int64"), ("value", "Float64")],
    "q15": [("supplier_no", "Int64"), ("s_name", "String"), ("s_address", "String"), ("s_phone", "String"),
            ("total_revenue", "Float64")],
    "q17": [("avg_yearly", "Float64")],
    "q20": [("s_name", "String"), ("s_address", "String")],
    "q2": [("s_acctbal", "Float64"), ("s_name", "String"), ("n_name", "String"), ("p_partkey", "Int64"),
           ("p_mfgr", "String"), ("s_address", "String"), ("s_phone", "String"), ("s_comment", "String")],
    "q7": [("supp_nation", "String"), ("cust_nation", "String"), ("l_year", "Int32"), ("revenue", "Float64")],
    "q8": [("o_year", "Int32"), ("mkt_share", "Float64")],
    "q9": [("nation", "String"), ("o_year", "Int32"), ("sum_profit", "Float64")],
    "q13": [("c_count", "UInt32"), ("custdist", "UInt32")],
    "q16": [("p_brand", "String"), ("p_type", "String"), ("p_size", "Int64"), ("supplier_cnt", "UInt32")],
    "q21": [("s_name", "String"), ("numwait", "UInt32")],
    "q22": [("cntrycode", "String"), ("numcust", "UInt32"), ("totacctbal", "Float64")],
}


def check_dense_keys(raw: dict) -> None:
    """The oracles join by position: PDS-H's keys are dense (a key is its
    row, plus 1 where the table counts from 1)."""
    for t, col, base in (("nation", "n_nationkey", 0), ("region", "r_regionkey", 0), ("customer", "c_custkey", 1),
                         ("orders", "o_orderkey", 1), ("part", "p_partkey", 1), ("supplier", "s_suppkey", 1)):
        if col not in raw.get(t, {}):
            continue
        keys = raw[t][col]
        if not np.array_equal(keys, np.arange(base, base + len(keys))):
            raise AssertionError(f"{t}.{col} is not dense from {base}")


def check_exact(out, want: dict, floats=(), label: str = "") -> float:
    """Every row of ``out`` in order: floats to rtol 1e-9, the rest exactly.
    Returns the largest relative float error."""
    got = out.to_dict(as_series=False)
    n = len(next(iter(want.values())))
    if list(got) != list(want) or out.height != n:
        raise AssertionError(f"{label} shape {out.height} x {list(got)}, want {n} x {list(want)}")
    worst = 0.0
    for c, w in want.items():
        g = [_host_value(v) for v in got[c]]
        if c not in floats:
            if g != list(w):
                raise AssertionError(f"{label} {c}: {g} != {list(w)}")
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if not np.all(np.isfinite(g)):
            raise AssertionError(f"{label} {c}: {g} is not finite")
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"{label} {c}")
        worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))) if n else 0.0)
    return worst


def phase_query(torch, name: str, frames: dict, raw: dict, scale: float, k2_repeats: int = 1) -> dict:
    """One query phase at the frames of its own columns: the main path
    (``run_query``), the schema, and the result against its numpy oracle."""
    from polars_tpu_torch.testing import pdsh

    # Q11's FRACTION depends on the scale
    want, sort_col, k, floats, extra = q11_oracle(raw, scale) if name == "q11" else ORACLES[name](raw)
    f = frames[name]
    params = pdsh.run_params(name, scale)
    r = run_query(torch, name, lambda: pdsh.query(name, f, **params), k2_repeats=k2_repeats)
    out = r["out"]
    schema = [(c, repr(d)) for c, d in out.schema.items()]
    if schema != SCHEMAS[name]:
        raise AssertionError(f"{name} schema {schema} != {SCHEMAS[name]}")
    if not len(want[next(iter(want))]):
        raise AssertionError(f"{name}: the oracle's result is empty at this scale")

    def check(out) -> float:
        if sort_col is None:
            return check_exact(out, want, floats, name)
        return check_top(out, want, sort_col, k, floats, name)

    worst = check(out)
    unopt = run_unoptimized(torch, lambda: pdsh.query(name, f, **params), out, check)
    rows = {t: d.height for t, d in f.items()}
    got = out.to_dict(as_series=False)
    res = {"phase": name, "rows": rows, **extra, "result_rows": out.height, "first_collect_s": r["first_collect_s"],
           "warm_wall_s": r["warm_wall_s"], "warm_walls_s": r["warm_walls_s"],
           "rows_per_s": sum(rows.values()) / r["warm_wall_s"],  # input rows of every table it reads
           "launches": r["launches"], "peak_device_bytes": r["peak_device_bytes"],
           "max_rel_err_vs_numpy": worst, "matches_numpy_oracle": True,
           "result": {c: [str(v) if isinstance(v, dtm.date) else v for v in vals[:5]] for c, vals in got.items()},
           "unoptimized": unopt, "kernel_calls": r["kernel_calls"]}
    emit(res)
    return res


def expand_oracle(pk: np.ndarray, bk: np.ndarray, unmatched: bool) -> tuple[np.ndarray, np.ndarray]:
    """An equi-join's pairs in the port's order, in numpy: each probe row in
    order with its build rows in their order (stable argsort +
    searchsorted); -1 for the build row of an unmatched probe row when
    ``unmatched``."""
    perm = np.argsort(bk, kind="stable")
    sk = bk[perm]
    lo, hi = np.searchsorted(sk, pk, "left"), np.searchsorted(sk, pk, "right")
    m = hi - lo
    counts = np.maximum(m, 1) if unmatched else m
    pi = np.repeat(np.arange(len(pk)), counts)
    j = np.arange(len(pi)) - (np.cumsum(counts) - counts)[pi]
    hit = m[pi] > 0
    bi = np.full(len(pi), -1, np.int64)
    bi[hit] = perm[lo[pi[hit]] + j[hit]]
    return pi, bi


def check_join_column(col, src: np.ndarray, rows: np.ndarray, label: str) -> None:
    """One output column against ``src`` (the table's numpy column) at
    ``rows`` (-1 = null), value for value and null for null: strings by
    their codes in the column's dictionary, dates as day counts."""
    got = col.buffer.values.cpu().numpy()
    valid = rows >= 0
    got_valid = np.ones(len(got), bool) if col.buffer.validity is None else col.buffer.validity.cpu().numpy()
    if len(got) != len(rows) or not np.array_equal(got_valid, valid):
        raise AssertionError(f"joins {label} {col.name}: {len(got)} rows or nulls differ from the oracle's {len(rows)}")
    if col.table is not None:  # the source's strings as codes of the column's dictionary, then gathered
        uniq, inv = np.unique(src.astype(str), return_inverse=True)
        pos = {v: i for i, v in enumerate(col.table.values.tolist())}
        src = np.asarray([pos[u] for u in uniq.tolist()], np.int64)[inv.reshape(-1)]
    want = src[rows[valid]]
    if want.dtype.kind == "M":
        want = _days(want)
    if not np.array_equal(got[valid].astype(np.int64) if want.dtype.kind in "iu" else got[valid], want):
        raise AssertionError(f"joins {label} {col.name}: values differ from the oracle's")


@contextlib.contextmanager
def count_host_reads(torch):
    """Host reads during the block: every tensor-to-Python conversion, and
    every synchronising CUDA call that PyTorch's sync debug mode reports."""
    seen = {"reads": 0, "syncs": 0}
    saved = {}
    for name in ("__int__", "__bool__", "__float__", "__index__", "item", "tolist"):
        saved[name] = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=saved[name], **kw):
            seen["reads"] += 1
            return _orig(self, *a, **kw)

        setattr(torch.Tensor, name, counted)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                yield seen
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # the mode's own notice ("Synchronization debug mode is a prototype ...") is no sync
        sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]
        seen["syncs"] = len(sites)
        seen["sync_sites"] = sorted(set(sites))
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def phase_joins(torch, pl, frames: dict, raw: dict) -> dict:
    """Host-sized joins at SF10, each through ``LazyFrame.join`` on frames of
    its own columns, against the numpy oracle of its rows in order."""
    t = frames["joins"]
    cust, orders, line, supp, nat, ps = (raw[n] for n in ("customer", "orders", "lineitem", "supplier", "nation",
                                                           "partsupp"))
    def cut(table, cols):
        return pl.DataFrame._from_columns([t[table]._get(c) for c in cols], t[table].height).lazy()

    building = cust["c_mktsegment"] == "BUILDING"
    early = _days(orders["o_orderdate"]) < Q3_DAYS
    cb, oe = np.nonzero(building)[0], np.nonzero(early)[0]
    lkey = line["l_partkey"] * (len(supp["s_suppkey"]) + 1) + line["l_suppkey"]
    pkey = ps["ps_partkey"] * (len(supp["s_suppkey"]) + 1) + ps["ps_suppkey"]

    def cases():
        """(label, lazy plan, oracle) of each join; the oracle gives each
        output column's source and its rows."""
        pi, bi = expand_oracle(orders["o_orderkey"], line["l_orderkey"], False)
        yield ("inner_mm", lambda: cut("orders", ["o_orderkey", "o_orderdate"]).join(
            cut("lineitem", ["l_orderkey", "l_quantity"]), left_on="o_orderkey", right_on="l_orderkey"),
            [("o_orderkey", orders["o_orderkey"], pi), ("o_orderdate", orders["o_orderdate"], pi),
             ("l_quantity", line["l_quantity"], bi)])
        pi, bi = expand_oracle(cust["c_custkey"], orders["o_custkey"], True)
        yield ("left", lambda: cut("customer", ["c_custkey", "c_mktsegment"]).join(
            cut("orders", ["o_custkey", "o_orderkey"]), left_on="c_custkey", right_on="o_custkey", how="left"),
            [("c_custkey", cust["c_custkey"], pi), ("c_mktsegment", cust["c_mktsegment"], pi),
             ("o_orderkey", orders["o_orderkey"], bi)])
        pi, bi = expand_oracle(cust["c_custkey"], orders["o_custkey"], True)
        yield ("right", lambda: cut("orders", ["o_custkey", "o_orderkey"]).join(
            cut("customer", ["c_custkey", "c_mktsegment"]), left_on="o_custkey", right_on="c_custkey", how="right"),
            [("o_orderkey", orders["o_orderkey"], bi), ("c_custkey", cust["c_custkey"], pi),
             ("c_mktsegment", cust["c_mktsegment"], pi)])
        pi, bi = expand_oracle(cust["c_custkey"][cb], orders["o_custkey"][oe], True)
        pi, bi = cb[pi], np.where(bi >= 0, oe[np.maximum(bi, 0)], -1)
        extra = np.setdiff1d(oe, bi[bi >= 0])  # the early orders no BUILDING customer placed, in order
        pi = np.concatenate([pi, np.full(len(extra), -1)])
        bi = np.concatenate([bi, extra])
        yield ("full", lambda: cut("customer", ["c_custkey", "c_mktsegment"]).filter(
            pl.col("c_mktsegment") == "BUILDING").join(
            cut("orders", ["o_orderkey", "o_custkey", "o_orderdate"]).filter(
                pl.col("o_orderdate") < dtm.date(1995, 3, 15)),
            left_on="c_custkey", right_on="o_custkey", how="full"),
            [("c_custkey", cust["c_custkey"], pi), ("c_mktsegment", cust["c_mktsegment"], pi),
             ("o_orderkey", orders["o_orderkey"], bi), ("o_custkey", orders["o_custkey"], bi),
             ("o_orderdate", orders["o_orderdate"], bi)])
        ns, nn = len(supp["s_suppkey"]), len(nat["n_nationkey"])
        pi, bi = np.repeat(np.arange(ns), nn), np.tile(np.arange(nn), ns)
        yield ("cross", lambda: cut("supplier", ["s_suppkey", "s_nationkey"]).join(
            cut("nation", ["n_nationkey", "n_name"]), how="cross"),
            [("s_suppkey", supp["s_suppkey"], pi), ("s_nationkey", supp["s_nationkey"], pi),
             ("n_nationkey", nat["n_nationkey"], bi), ("n_name", nat["n_name"], bi)])
        pi, bi = expand_oracle(lkey, pkey, False)
        yield ("hashed_inner", lambda: cut("lineitem", ["l_partkey", "l_suppkey", "l_quantity"]).join(
            cut("partsupp", ["ps_partkey", "ps_suppkey", "ps_availqty"]), left_on=["l_partkey", "l_suppkey"],
            right_on=["ps_partkey", "ps_suppkey"]),
            [("l_partkey", line["l_partkey"], pi), ("l_suppkey", line["l_suppkey"], pi),
             ("l_quantity", line["l_quantity"], pi), ("ps_availqty", ps["ps_availqty"], bi)])
        keep = np.nonzero(~np.isin(lkey, pkey))[0]
        yield ("hashed_anti", lambda: cut("lineitem", ["l_partkey", "l_suppkey", "l_quantity"]).join(
            cut("partsupp", ["ps_partkey", "ps_suppkey"]), left_on=["l_partkey", "l_suppkey"],
            right_on=["ps_partkey", "ps_suppkey"], how="anti"),
            [("l_partkey", line["l_partkey"], keep), ("l_suppkey", line["l_suppkey"], keep),
             ("l_quantity", line["l_quantity"], keep)])

    res = {"phase": "joins", "cases": {}, "launches": {"groupagg_sums": 0, "compact": 0, "compact_scatter": 0},
           "kernel_calls": []}
    for label, run, want in cases():
        need = ("compact", "compact_scatter") if label in ("full", "hashed_inner", "hashed_anti") else ()
        r = run_query(torch, f"joins.{label}", run, need=need)
        out = r["out"]
        if out.columns != [c for c, _, _ in want]:
            raise AssertionError(f"joins {label}: columns {out.columns} != {[c for c, _, _ in want]}")
        for c, src, rows in want:
            check_join_column(out._get(c), src, rows, label)
        with count_host_reads(torch) as reads:
            run().collect()
            torch.cuda.synchronize()
        res["cases"][label] = {"rows_out": out.height, "warm_wall_s": r["warm_wall_s"],
                               "warm_walls_s": r["warm_walls_s"], "first_collect_s": r["first_collect_s"],
                               "host_reads": reads["reads"], "syncs": reads["syncs"], "sync_sites": reads["sync_sites"],
                               "peak_device_bytes": r["peak_device_bytes"], "launches": r["launches"],
                               "matches_numpy_oracle": True}
        for k, v in r["launches"].items():
            res["launches"][k] += v
        res["kernel_calls"] += [{"join": label, **c} for c in r["kernel_calls"]]
        del out, r
        torch.cuda.empty_cache()
    emit(res)
    return res


# -- temporal, asof and range phases (plans and data: polars_tpu_torch/testing/phases.py) ----------


def _phases():
    from polars_tpu_torch.testing import phases

    return phases

def temporal_oracle(line: dict) -> dict:
    """The temporal phase in numpy on the microsecond integers: weeks from
    Monday (1970-01-01 was a Thursday), the lead time, the hour, and the end
    of the next month at the same time of day."""
    P = _phases()
    DAY_US = P.DAY_US
    ts = line["l_shipts"].astype(np.int64)
    m = (ts >= P.TEMPORAL_FROM) & (ts < P.TEMPORAL_TO)
    ts = ts[m]
    week = (ts + 3 * DAY_US) // (7 * DAY_US) * (7 * DAY_US) - 3 * DAY_US
    lead = _days(line["l_receiptdate"][m]) * DAY_US - ts
    tod = ts % DAY_US
    next_month_end = (ts // DAY_US).astype("datetime64[D]").astype("datetime64[M]") + 2
    due = (next_month_end.astype("datetime64[D]").astype(np.int64) - 1) * DAY_US + tod
    keys, inv = np.unique(week, return_inverse=True)
    inv = inv.reshape(-1)
    n = np.bincount(inv, minlength=len(keys))
    lead_sum = np.bincount(inv, weights=lead.astype(np.float64), minlength=len(keys))
    by_group = np.argsort(inv, kind="stable")
    lead_max = np.maximum.reduceat(lead[by_group], np.concatenate([[0], np.cumsum(n)[:-1]]))
    # whole hours, truncated toward zero; each group's sum is far below 2^53, so exact in f64
    whole = np.where(lead >= 0, lead // 3_600_000_000, -(-lead // 3_600_000_000))
    hours = np.bincount(inv, weights=whole, minlength=len(keys)).astype(np.int64)
    return {"week": keys, "lead_mean": lead_sum / n, "lead_max": lead_max, "lead_hours": hours,
            "morning": np.bincount(inv, weights=tod < 12 * 3_600_000_000, minlength=len(keys)).astype(np.int64),
            "on_time": np.bincount(inv, weights=_days(line["l_commitdate"][m]) * DAY_US < due,
                                   minlength=len(keys)).astype(np.int64),
            "n": n.astype(np.int64), "rows": int(m.sum())}


def _storage(out, name: str) -> tuple[np.ndarray, np.ndarray | None]:
    """A result column's storage values (int64 ticks, codes or floats) and
    its validity, on the host."""
    buf = out._get(name).buffer
    return buf.values.cpu().numpy(), None if buf.validity is None else buf.validity.cpu().numpy()


def check_columns(out, want: dict, exact=(), floats=(), means=(), label: str = "") -> float:
    """Result columns against the oracle's, row for row: ``exact`` equal in
    storage, ``floats`` to rtol 1e-9; ``means`` (a Duration's mean, a float
    mean truncated to whole ticks) within 1 tick or rtol 1e-9. Returns the
    largest relative float error."""
    worst = 0.0
    n = len(want[(exact or floats)[0]])
    if out.height != n:
        raise AssertionError(f"{label}: {out.height} rows, want {n}")
    for c in (*exact, *floats, *means):
        got, valid = _storage(out, c)
        w = np.asarray(want[c])
        ok = np.ones(n, bool) if valid is None else valid
        wok = ~np.isnan(w) if w.dtype.kind == "f" else np.ones(n, bool)
        if not np.array_equal(ok, wok):
            raise AssertionError(f"{label} {c}: nulls differ from the oracle's")
        got, w = got[ok], w[ok]
        if c in exact:
            if not np.array_equal(got.astype(np.int64), w.astype(np.int64)):
                raise AssertionError(f"{label} {c}: {got[:5]} != {w[:5]}")
        elif c in means:
            if not np.all(np.abs(got - np.trunc(w)) <= np.maximum(1.0, 1e-9 * np.abs(w))):
                raise AssertionError(f"{label} {c}: {got[:5]} != {np.trunc(w)[:5]}")
        else:
            np.testing.assert_allclose(got, w, rtol=1e-9, atol=0, err_msg=f"{label} {c}")
            worst = max(worst, float(np.max(np.abs(got - w) / np.maximum(np.abs(w), 1e-300))) if len(w) else 0.0)
    return worst


def run_phase(torch, name: str, run, need=("groupagg_sums", "compact", "compact_scatter")) -> dict:
    """``run_query`` for a phase outside PDS-H, and the host reads of one
    more collect."""
    r = run_query(torch, name, run, need=need)
    with count_host_reads(torch) as reads:
        run().collect()
        torch.cuda.synchronize()
    r["host_reads"] = {"reads": reads["reads"], "syncs": reads["syncs"], "sync_sites": reads["sync_sites"]}
    return r


def phase_result(name: str, r: dict, out, rows_in: dict, worst: float, **extra) -> dict:
    res = {"phase": name, "rows": rows_in, **extra, "result_rows": out.height, "first_collect_s": r["first_collect_s"],
           "warm_wall_s": r["warm_wall_s"], "warm_walls_s": r["warm_walls_s"],
           "rows_per_s": sum(rows_in.values()) / r["warm_wall_s"], "launches": r["launches"],
           "peak_device_bytes": r["peak_device_bytes"], "host_reads": r["host_reads"],
           "max_rel_err_vs_numpy": worst, "matches_numpy_oracle": True, "kernel_calls": r["kernel_calls"]}
    emit(res)
    return res


def phase_temporal(torch, pl, line_frame, raw: dict) -> dict:
    """A Datetime column on SF10 lineitem: datetime literals in a filter,
    ``dt.truncate("1w")``, a Date cast to Datetime minus a Datetime,
    ``dt.hour``, ``offset_by("1mo").month_end()``, and a group-by of the
    week with Duration means, maxima and sums."""
    want = temporal_oracle(raw["lineitem"])
    r = run_phase(torch, "temporal", lambda: _phases().temporal_plan(pl, line_frame))
    out = r["out"]
    schema = [(c, repr(d)) for c, d in out.schema.items()]
    expect = [("week", "Datetime(time_unit='us', time_zone=None)"), ("lead_mean", "Duration(time_unit='us')"),
              ("lead_max", "Duration(time_unit='us')"), ("lead_hours", "Int64"), ("morning", "UInt32"),
              ("on_time", "UInt32"), ("n", "UInt32")]
    if schema != expect:
        raise AssertionError(f"temporal schema {schema} != {expect}")
    worst = check_columns(out, want, exact=("week", "lead_max", "lead_hours", "morning", "on_time", "n"),
                          means=("lead_mean",), label="temporal")
    return phase_result("temporal", r, out, {"lineitem": line_frame.height}, worst, filtered_rows=want["rows"])


def asof_oracle(data: dict, strategy: str, tolerance_us: int | None) -> dict:
    """The asof join by ticker in numpy: quotes sorted stably by (ticker,
    time), each trade's neighbours in its own ticker found by one
    searchsorted over ticker * 2^36 + time; backward takes the last quote
    at or before, nearest the nearer of it and the first at or after (the
    earlier on a tie); then the per-ticker aggregates."""
    P = _phases()
    q, t = data["quotes"], data["trades"]
    order = np.lexsort((q["ts"], q["ticker"]))
    qk = q["ticker"][order].astype(np.int64) << 36 | (q["ts"][order] - P.ASOF_DAY_US)
    tk = t["ticker"].astype(np.int64) << 36 | (t["ts"] - P.ASOF_DAY_US)
    nq = len(qk)
    prev = np.searchsorted(qk, tk, side="right") - 1
    nxt = np.searchsorted(qk, tk, side="left")
    p_ok = (prev >= 0) & ((qk[np.maximum(prev, 0)] >> 36) == t["ticker"])
    n_ok = (nxt < nq) & ((qk[np.minimum(nxt, nq - 1)] >> 36) == t["ticker"])
    d_prev = tk - qk[np.maximum(prev, 0)]
    d_next = qk[np.minimum(nxt, nq - 1)] - tk
    if strategy == "backward":
        pick, ok = prev, p_ok
    else:
        use_prev = p_ok & (~n_ok | (d_prev <= d_next))
        pick, ok = np.where(use_prev, prev, nxt), p_ok | n_ok
    pick = np.clip(pick, 0, nq - 1)
    if tolerance_us is not None:
        ok &= np.abs(tk - qk[pick]) <= tolerance_us
    row = order[pick]
    mid = (q["ask"][row] + q["bid"][row]) / 2
    g = t["ticker"]
    n = np.bincount(g, minlength=P.ASOF_TICKERS)
    matched = np.bincount(g, weights=ok, minlength=P.ASOF_TICKERS)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.bincount(g, weights=np.where(ok, mid, 0.0), minlength=P.ASOF_TICKERS) / matched
    keep = n > 0
    return {"ticker": np.nonzero(keep)[0], "notional": np.bincount(g, weights=t["qty"] * t["price"],
                                                                   minlength=P.ASOF_TICKERS)[keep],
            "mid": mean[keep], "matched": matched[keep].astype(np.int64), "n": n[keep].astype(np.int64),
            "matched_trades": int(ok.sum())}


def phase_asof(torch, pl, scale: float, seed: int, dev) -> dict:
    """``trades.join_asof(quotes, on="ts", by="ticker", strategy="backward",
    tolerance="1s")`` over one trading day, then per ticker the notional,
    the mean mid of the matched quotes, the matches and the trades; and one
    collect with ``strategy="nearest"`` and no tolerance, held the same way."""
    P = _phases()
    t0 = time.perf_counter()
    data = P.asof_data(scale, seed)
    frames = P.asof_frames(pl, data, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    r = run_phase(torch, "asof", lambda: P.asof_plan(pl, frames, "backward", "1s"))
    out = r["out"]
    schema = [(c, repr(d)) for c, d in out.schema.items()]
    expect = [("ticker", "String"), ("notional", "Float64"), ("mid", "Float64"), ("matched", "UInt32"),
              ("n", "UInt32")]
    if schema != expect:
        raise AssertionError(f"asof schema {schema} != {expect}")
    want = asof_oracle(data, "backward", 1_000_000)
    tickers = out._get("ticker")
    got_tickers = [tickers.table.values[i] for i in tickers.buffer.values.cpu().tolist()]
    if got_tickers != data["names"][want["ticker"]].tolist():
        raise AssertionError("asof: the tickers differ from the oracle's")
    worst = check_columns(out, want, exact=("matched", "n"), floats=("notional", "mid"), label="asof")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    near = P.asof_plan(pl, frames, "nearest", None).collect()
    torch.cuda.synchronize()
    t_near = time.perf_counter() - t1
    want_near = asof_oracle(data, "nearest", None)
    worst = max(worst, check_columns(near, want_near, exact=("matched", "n"), floats=("notional", "mid"),
                                     label="asof nearest"))
    return phase_result("asof", r, out, {"quotes": frames["quotes"].height, "trades": frames["trades"].height}, worst,
                        build_s=t_build, matched_trades=want["matched_trades"],
                        matched_share=want["matched_trades"] / frames["trades"].height,
                        nearest={"wall_s": t_near, "matched_trades": want_near["matched_trades"],
                                 "result_rows": near.height})


def phase_range(torch, pl, orders_frame, raw: dict, dev) -> dict:
    """Twelve monthly windows of 1995 ``join_where`` SF10 orders: the first
    predicate drives a range join (about 90M pairs), the second filters
    them through K2; then the sum and count per window."""
    P = _phases()
    windows = pl.DataFrame(P.range_windows(), device=dev)
    od = _days(raw["orders"]["o_orderdate"])
    price = raw["orders"]["o_totalprice"]
    starts = [day(1995, m, 1) for m in range(1, 13)] + [day(1996, 1, 1)]
    pairs = int(sum((od >= s).sum() for s in starts[:12]))
    want = {"w_id": np.arange(1, 13), "o_totalprice": np.asarray([price[(od >= a) & (od < b)].sum()
                                                                  for a, b in zip(starts, starts[1:])]),
            "len": np.asarray([((od >= a) & (od < b)).sum() for a, b in zip(starts, starts[1:])])}
    r = run_phase(torch, "range", lambda: P.range_plan(pl, windows, orders_frame))
    out = r["out"]
    schema = [(c, repr(d)) for c, d in out.schema.items()]
    if schema != [("w_id", "Int64"), ("o_totalprice", "Float64"), ("len", "UInt32")]:
        raise AssertionError(f"range schema {schema}")
    worst = check_columns(out, want, exact=("w_id", "len"), floats=("o_totalprice",), label="range")
    return phase_result("range", r, out, {"windows": 12, "orders": orders_frame.height}, worst, range_pairs=pairs,
                        kept_pairs=int(want["len"].sum()))


def frameops_oracle(line: dict) -> dict:
    """The frameops phase in numpy (``l_orderkey`` comes sorted): the first
    row of each order and the rows of the orders of one line; the 1995 and
    1996 rows one after the other, numbered, per (flag, status) the sums,
    the rows and the last number; the per-order totals above the mean of
    the orders with as many lines, per line count."""
    key = line["l_orderkey"]
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    runs = np.diff(np.r_[start, len(key)])
    days = _days(line["l_shipdate"])
    sel = np.concatenate([np.flatnonzero((days >= day(y, 1, 1)) & (days < day(y + 1, 1, 1))) for y in (1995, 1996)])
    flag, status = line["l_returnflag"][sel], line["l_linestatus"][sel]
    pairs = sorted(set(zip(flag.tolist(), status.tolist())))
    concat = {c: [] for c in ("flag", "status", "qty", "price", "n", "last_row")}
    for f_, s_ in pairs:
        m = (flag == f_) & (status == s_)
        for c, v in (("flag", f_), ("status", s_), ("qty", line["l_quantity"][sel][m].sum()),
                     ("price", line["l_extendedprice"][sel][m].sum()), ("n", int(m.sum())),
                     ("last_row", int(np.flatnonzero(m)[-1]))):
            concat[c].append(v)
    total = np.add.reduceat(line["l_extendedprice"], start)
    avg = np.bincount(runs, weights=total) / np.maximum(np.bincount(runs), 1)
    above = total > avg[runs]
    lines = np.unique(runs[above])
    cache = {"lines": lines, "orders": np.asarray([int((runs[above] == n).sum()) for n in lines]),
             "total": np.asarray([total[above & (runs == n)].sum() for n in lines])}
    return {"first": start, "single": start[runs == 1], "concat": concat, "cache": cache,
            "orders": len(start), "concat_rows": len(sel)}


def phase_frameops(torch, pl, line_frame, raw: dict) -> dict:
    """The frame operations the optimizer rewrites, on SF10 lineitem, each
    through its own main path and its plan as written (``run_unoptimized``):
    ``unique`` by order with ``keep`` first and none (60M rows, K2 only), a
    lazy concat of two years with a row index, a rename, a drop and a
    group-by (K1), and the per-order totals joined back to their own mean
    (a cached subplan: its group-by's K1 launches count once optimized)."""
    P = _phases()
    line = raw["lineitem"]
    want = frameops_oracle(line)
    out_all = {}
    for name in ("first", "single", "concat", "cache"):
        need = ("compact", "compact_scatter") if name in ("first", "single") else ("groupagg_sums", "compact",
                                                                                   "compact_scatter")
        r = run_phase(torch, f"frameops.{name}", lambda name=name: P.frameops_plans(pl, line_frame)[name], need)
        out = r["out"]
        if name in ("first", "single"):
            rows = want[name]

            def check(out, rows=rows, name=name) -> float:
                if out.height != len(rows):
                    raise AssertionError(f"frameops.{name}: {out.height} rows, want {len(rows)}")
                for c in ("l_orderkey", "l_linenumber", "l_shipdate"):
                    got = _storage(out, c)[0].astype(np.int64)
                    w = line[c][rows]
                    if not np.array_equal(got, _days(w) if w.dtype.kind == "M" else w.astype(np.int64)):
                        raise AssertionError(f"frameops.{name} {c}: {got[:5]} differ from the oracle's")
                return 0.0

            extra = {"distinct_orders": want["orders"], "kept_rows": len(rows)}
        elif name == "concat":
            def check(out) -> float:
                got = out.to_dict(as_series=False)
                w = want["concat"]
                for c in ("flag", "status", "n", "last_row"):
                    if got[c] != list(w[c]):
                        raise AssertionError(f"frameops.concat {c}: {got[c]} != {list(w[c])}")
                np.testing.assert_allclose(got["qty"], w["qty"], rtol=1e-9, atol=0, err_msg="frameops.concat qty")
                np.testing.assert_allclose(got["price"], w["price"], rtol=1e-9, atol=0,
                                           err_msg="frameops.concat price")
                return float(max(np.max(np.abs(np.asarray(got[c]) - w[c]) / np.abs(w[c])) for c in ("qty", "price")))

            extra = {"concat_rows": want["concat_rows"]}
        else:
            def check(out) -> float:
                return check_columns(out, want["cache"], exact=("lines", "orders"), floats=("total",),
                                     label="frameops.cache")

            extra = {"orders_above_mean": int(want["cache"]["orders"].sum())}
        worst = check(out)
        unopt = run_unoptimized(torch, lambda name=name: P.frameops_plans(pl, line_frame)[name], out, check)
        out_all[name] = phase_result(f"frameops.{name}", r, out, {"lineitem": line_frame.height}, worst,
                                     unoptimized=unopt, **extra)
    return out_all


# -- tz phase (plans and data: polars_tpu_torch/testing/phases.py) ------------------------------

HOUR_US = 3_600_000_000


def zone_hours(tz_name: str, first_hour: int, n: int, *, local: bool) -> dict:
    """zoneinfo's answer for each hour of a contiguous range, asked once per
    hour (every transition of these zones falls on a whole hour): for local
    wall hours (``local``), the offset of the earlier instant (``fold=0``)
    and whether the wall hour exists; for UTC hours, the total and DST
    offsets of that instant. Microseconds, int64 arrays indexed from
    ``first_hour``."""
    from zoneinfo import ZoneInfo

    z = ZoneInfo(tz_name)
    off, dst, exists = np.zeros(n, np.int64), np.zeros(n, np.int64), np.ones(n, bool)
    base = dtm.datetime(1970, 1, 1)
    for i in range(n):
        wall = base + dtm.timedelta(hours=first_hour + i)
        if local:
            aware = wall.replace(tzinfo=z)
            exists[i] = aware.astimezone(dtm.timezone.utc).astimezone(z).replace(tzinfo=None) == wall
        else:
            aware = wall.replace(tzinfo=dtm.timezone.utc).astimezone(z)
        off[i] = aware.utcoffset() // dtm.timedelta(microseconds=1)
        dst[i] = (aware.dst() or dtm.timedelta(0)) // dtm.timedelta(microseconds=1)
    return {"first": first_hour, "off": off, "dst": dst, "exists": exists}


def _hours_of(ts: np.ndarray, tz_name: str, *, local: bool) -> tuple[dict, np.ndarray]:
    """``zone_hours`` over the hours ``ts`` spans, and each value's index."""
    h = ts // HOUR_US
    lo = int(h.min())
    return zone_hours(tz_name, lo, int(h.max()) - lo + 1, local=local), h - lo


def tz_ship_oracle(line: dict) -> dict:
    """Part (a) in numpy: New York wall clock to instants (a skipped hour
    null, a repeated one the earlier instant), Amsterdam's wall clock of
    those, the rows kept by the filter, per Amsterdam day (the null group
    first) the sums, and each day's key (its local midnight's instant) and
    label, from zoneinfo."""
    from zoneinfo import ZoneInfo

    P = _phases()
    DAY_US = P.DAY_US
    wall = line["l_shipts"].astype(np.int64)
    ny, i = _hours_of(wall, P.TZ_SHIP, local=True)
    ok = ny["exists"][i]
    utc = wall - ny["off"][i]
    ams, j = _hours_of(utc, P.TZ_SHOWN, local=False)
    off, dst = ams["off"][j], ams["dst"][j]
    local = utc + off
    since = int((P.TZ_SINCE.replace(tzinfo=ZoneInfo(P.TZ_SHOWN)) - dtm.datetime(1970, 1, 1, tzinfo=dtm.timezone.utc))
                // dtm.timedelta(microseconds=1))
    keep = ~ok | (utc >= since)
    ok, local, off, dst, qty = ok[keep], local[keep], off[keep], dst[keep], line["l_quantity"][keep]
    day = local // DAY_US
    d0 = int(day[ok].min())
    g = np.where(ok, day - d0 + 1, 0)  # group 0: the null key
    size = int(g.max()) + 1
    n = np.bincount(g, minlength=size)
    present = np.flatnonzero(n)

    def count(m):
        return np.bincount(g, weights=m & ok, minlength=size).astype(np.int64)[present]

    hour = local % DAY_US // HOUR_US
    weekday = (day + 3) % 7 + 1
    base = np.full(size, np.iinfo(np.int64).min)
    np.maximum.at(base, g[ok], (off - dst)[ok] // 1000)
    z = ZoneInfo(P.TZ_SHOWN)
    keys, labels = [], []
    for k in present.tolist():
        if k == 0:
            keys.append(0)
            labels.append(None)
            continue
        midnight = (dtm.datetime(1970, 1, 1) + dtm.timedelta(days=d0 + k - 1)).replace(tzinfo=z)
        keys.append((midnight - dtm.datetime(1970, 1, 1, tzinfo=dtm.timezone.utc)) // dtm.timedelta(microseconds=1))
        labels.append(midnight.strftime("%Y-%m-%d %z"))
    has_null = bool(n[0])
    return {"day": np.asarray(keys, np.int64), "day_valid": present != 0, "n": n[present].astype(np.int64),
            "qty": np.bincount(g, weights=qty, minlength=size)[present],
            "nulls": np.bincount(g, weights=~ok, minlength=size).astype(np.int64)[present],
            "evening": count(hour >= 18), "weekend": count(weekday >= 6), "summer": count(dst > 0),
            "base": base[present], "base_valid": present != 0, "label": labels,
            "null_rows": int((~ok).sum()), "kept_rows": int(keep.sum()), "has_null_group": has_null}


def tz_orders_oracle(orders: dict, seed: int) -> dict:
    """Part (b) in numpy: each order's wall clock (its date and hour, the
    "N/A" rows and New York's skipped hours unparsed) to its instant, else
    its date's local midnight; New York's wall clock of that instant; from
    ORDERTS_FROM_YEAR on, per local year and month the price, the orders,
    the unparsed rows and the first instant; offsets from zoneinfo."""
    P = _phases()
    DAY_US = P.DAY_US
    day = _days(orders["o_orderdate"])
    hour, na = P.orderts_parts(day, seed)
    wall = day * DAY_US + hour * HOUR_US
    ny, i = _hours_of(np.concatenate([wall, day * DAY_US]), P.TZ_SHIP, local=True)
    i_wall, i_mid = i[:len(day)], i[len(day):]
    parsed = ~na & ny["exists"][i_wall]
    ts = np.where(parsed, wall - ny["off"][i_wall], day * DAY_US - ny["off"][i_mid])
    back, j = _hours_of(ts, P.TZ_SHIP, local=False)
    months = ((ts + back["off"][j]) // DAY_US).astype("datetime64[D]").astype("datetime64[M]").astype(np.int64)
    year, month = months // 12 + 1970, months % 12 + 1
    keep = year >= P.ORDERTS_FROM_YEAR
    keys, inv = np.unique(months[keep], return_inverse=True)
    inv = inv.reshape(-1)
    first = np.full(len(keys), np.iinfo(np.int64).max)
    np.minimum.at(first, inv, ts[keep])
    return {"year": keys // 12 + 1970, "month": keys % 12 + 1,
            "price": np.bincount(inv, weights=orders["o_totalprice"][keep], minlength=len(keys)),
            "n": np.bincount(inv, minlength=len(keys)).astype(np.int64),
            "unparsed": np.bincount(inv, weights=~parsed[keep], minlength=len(keys)).astype(np.int64),
            "first": first, "unparsed_rows": int((~parsed).sum()), "na_rows": int(na.sum()),
            "skipped_rows": int((~na & ~ny["exists"][i_wall]).sum())}


def tz_localize_oracle(orders: dict, seed: int) -> dict:
    """``tz_localize_plan`` in numpy: the rows outside the 01:00 and 02:00
    hours (and the "N/A" ones), the parsed ones, the nulls, the first and
    last instant; offsets from zoneinfo."""
    P = _phases()
    day = _days(orders["o_orderdate"])
    hour, na = P.orderts_parts(day, seed)
    keep = na | ((hour != 1) & (hour != 2))
    parsed = keep & ~na
    wall = (day * P.DAY_US + hour * HOUR_US)[parsed]
    ny, i = _hours_of(wall, P.TZ_SHIP, local=True)
    ts = wall - ny["off"][i]
    return {"n": [int(keep.sum())], "same": [int(parsed.sum())], "nulls": [int(na[keep].sum())],
            "first": [int(ts.min())], "last": [int(ts.max())]}


def _check_nullable(out, name: str, values: np.ndarray, valid: np.ndarray, label: str) -> None:
    """A result column's storage and validity against the oracle's, where
    int64 ticks would not fit a float (no NaN for null)."""
    got, ok = _storage(out, name)
    ok = np.ones(len(got), bool) if ok is None else ok
    if not np.array_equal(ok, valid) or not np.array_equal(got[valid].astype(np.int64), values[valid]):
        raise AssertionError(f"{label} {name}: differs from the oracle's")


def phase_tz(torch, pl, frames: dict, raw: dict, seed: int) -> dict:
    """Time zones, formatting and parsing at SF10 (``testing/phases.py``
    ``tz_ship_plan`` and ``tz_orders_plan``), each part through its main
    path and its plan as written, against its zoneinfo-built oracle; then
    the zone-aware parse of the text outside New York's 01:00 and 02:00
    hours against its oracle; a strict parse of the same text, which must
    fail."""
    P = _phases()
    line, orders = frames["lineitem"], frames["orders"]
    results = {}

    want = tz_ship_oracle(raw["lineitem"])

    def check_ship(out) -> float:
        label = "tz.ship"
        _check_nullable(out, "day", want["day"], want["day_valid"], label)
        _check_nullable(out, "base", want["base"], want["base_valid"], label)
        worst = check_columns(out, want, exact=("n", "nulls", "evening", "weekend", "summer"), floats=("qty",),
                              label=label)
        if out["label"].to_list() != want["label"]:
            raise AssertionError(f"{label}: the labels differ from the oracle's")
        return worst

    r = run_phase(torch, "tz.ship", lambda: P.tz_ship_plan(pl, line))
    out = r["out"]
    schema = [(c, repr(d)) for c, d in out.schema.items()]
    expect = [("day", "Datetime(time_unit='us', time_zone='Europe/Amsterdam')"), ("n", "UInt32"),
              ("qty", "Float64"), ("nulls", "UInt32"), ("evening", "UInt32"), ("weekend", "UInt32"),
              ("summer", "UInt32"), ("base", "Duration(time_unit='ms')"), ("label", "String")]
    if schema != expect:
        raise AssertionError(f"tz.ship schema {schema} != {expect}")
    worst = check_ship(out)
    unopt = run_unoptimized(torch, lambda: P.tz_ship_plan(pl, line), out, check_ship)
    results["ship"] = phase_result("tz.ship", r, out, {"lineitem": line.height}, worst, unoptimized=unopt,
                                   null_rows=want["null_rows"], kept_rows=want["kept_rows"])

    want_o = tz_orders_oracle(raw["orders"], seed)

    def check_orders(out) -> float:
        return check_columns(out, want_o, exact=("year", "month", "n", "unparsed", "first"), floats=("price",),
                             label="tz.orders")

    r = run_phase(torch, "tz.orders", lambda: P.tz_orders_plan(pl, orders))
    out = r["out"]
    schema = [(c, repr(d)) for c, d in out.schema.items()]
    expect = [("year", "Int32"), ("month", "Int8"), ("price", "Float64"), ("n", "UInt32"), ("unparsed", "UInt32"),
              ("first", "Datetime(time_unit='us', time_zone='America/New_York')")]
    if schema != expect:
        raise AssertionError(f"tz.orders schema {schema} != {expect}")
    worst = check_orders(out)
    unopt = run_unoptimized(torch, lambda: P.tz_orders_plan(pl, orders), out, check_orders)
    try:
        P.tz_orders_plan(pl, orders, strict=True).collect()
    except pl.InvalidOperationError as e:
        strict_error = str(e)
    else:
        raise AssertionError("tz.orders: the strict parse of text with 'N/A' did not raise")
    # the zone-aware parse, over the text where New York skips and repeats no hour
    check_columns(P.tz_localize_plan(pl, orders).collect(), tz_localize_oracle(raw["orders"], seed),
                  exact=("n", "same", "nulls", "first", "last"), label="tz.localize")
    results["orders"] = phase_result("tz.orders", r, out, {"orders": orders.height}, worst, unoptimized=unopt,
                                     unparsed_rows=want_o["unparsed_rows"], na_rows=want_o["na_rows"],
                                     skipped_hour_rows=want_o["skipped_rows"], strict_parse_raised=strict_error,
                                     zone_aware_parse="equal to its oracle")
    return results



def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=float, default=10.0, help="PDS-H scale factor (10 = 60M lineitem rows)")
    ap.add_argument("--seed", type=int, default=42, help="data seed")
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES, help="the query phases to run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import polars_tpu_torch as pl

    dev = torch.device("cuda", 0)
    card = card_line()
    phase_build()
    queries = list(dict.fromkeys("q1" if p == "filter" else p for p in args.only))  # the filter reads Q1's frame
    raw, t_gen = generate(args.scale, args.seed, queries)
    check_dense_keys(raw)
    line = raw["lineitem"]
    q1_density = float(np.mean(_days(line["l_shipdate"]) <= Q1_DAYS))  # Q1's own filter density
    kern = phase_kernels(torch, dev, args.seed, q1_density, len(line["l_shipdate"]))
    frames, fr = phase_frames(torch, pl, dev, raw, queries)
    runs = {}
    for name in args.only:
        if name == "q1":
            runs[name] = phase_q1(torch, line, frames["q1"]["lineitem"], t_gen, fr["build_s"]["lineitem"], args.scale)
        elif name == "filter":
            runs[name] = phase_filter(torch, pl, line, frames["q1"]["lineitem"])
        elif name == "joins":
            runs[name] = phase_joins(torch, pl, frames, raw)
        elif name == "temporal":
            runs[name] = phase_temporal(torch, pl, frames["temporal"]["lineitem"], raw)
        elif name == "asof":
            runs[name] = phase_asof(torch, pl, args.scale, args.seed, dev)
        elif name == "range":
            runs[name] = phase_range(torch, pl, frames["range"]["orders"], raw, dev)
        elif name == "frameops":
            for sub, res in phase_frameops(torch, pl, frames["frameops"]["lineitem"], raw).items():
                runs[f"frameops.{sub}"] = res
        elif name == "tz":
            for sub, res in phase_tz(torch, pl, frames["tz"], raw, args.seed).items():
                runs[f"tz.{sub}"] = res
        else:  # Q3's K2 call runs 50 times, each against the first
            runs[name] = phase_query(torch, name, frames, raw, args.scale, k2_repeats=50 if name == "q3" else 1)
    del frames, raw, line

    # every call the main path made, as held above: the shape and the times
    calls = {name: [{"query": q, **{key: c[key] for key in c if key not in ("kernel", "plan")}}
                    for q, r in runs.items() for c in r["kernel_calls"] if c["kernel"] == name]
             for name in ("groupagg_sums", "compact")}

    def k1_call(query):
        return next((c for c in calls["groupagg_sums"] if c["query"] == query), None)

    k1, k2 = kern["k1"], kern["k2"]
    kernels = [
        {
            "name": "groupagg_sums", "route": "cuda", "source": "polars_tpu_torch/csrc/groupagg.cu",
            "replaces": "polars_tpu/kernels/pallas_groupagg.py:49",
            "launches": sum(r["launches"]["groupagg_sums"] for r in runs.values()),
            "launches_per_query": {q: r["launches"]["groupagg_sums"] for q, r in runs.items()},
            "max_abs_err": max([kern["k1_err"]] + [c["max_abs_err"] for c in calls["groupagg_sums"]]),
            "ms": k1["ms"], "kernel_ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
            "shape": f"n={k1['n']} cap=12 k=5 f64 (Q1's float batch)",
            # the global-atomic mode at capacity = the rows (Q3, Q10, Q18)
            # and one group of capacity 1 (Q6's one-row select)
            "q3_shape": k1_call("q3"), "q10_shape": k1_call("q10"), "q18_shape": k1_call("q18"),
            "q15_shape": k1_call("q15"), "scales_shape": kern["k1_scales"],
            "cap1_shape": k1_call("q6"), "main_path_calls": calls["groupagg_sums"],
        },
        {
            "name": "compact", "route": "cuda", "source": "polars_tpu_torch/csrc/compact.cu",
            "replaces": "polars_tpu/kernels/pallas_compact.py:49",
            "launches": sum(r["launches"]["compact"] for r in runs.values()),
            "launches_per_query": {q: r["launches"]["compact"] for q, r in runs.items()},
            "scatter_launches_per_query": {q: r["launches"]["compact_scatter"] for q, r in runs.items()},
            "max_abs_err": max([kern["k2_err"]] + [c["max_abs_err_bits"] for c in calls["compact"]]),
            "ms": k2["ms"], "kernel_ms": k2["ms"], "count_ms": k2["count_ms"], "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
            "shape": f"n={k2['n']} 1 x f64, Q1 filter density", "main_path_calls": calls["compact"],
        },
    ]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
