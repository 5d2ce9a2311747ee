#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (polars_tpu_torch) on one NVIDIA GPU.

Phases, each printed as one JSON line:
  1. build    — compile the CUDA kernels from polars_tpu_torch/csrc with nvcc;
  2. kernels  — hold each kernel against its plain PyTorch version at the
                main path's shapes and at ragged, misaligned and poisoned
                ones, and time it (CUDA events, median of 11 runs after
                warm-up; 5 runs for K1's plain version and ``index_add_``)
                beside the plain version, the one PyTorch call that computes
                the same function and the least time the card could take;
  3. q1       — PDS-H Q1 end to end at SF10 (60M lineitem rows) through the
                port's public API, against a numpy oracle written here, with
                the kernels' launch counters read around the run;
  4. filter   — Q1's filter alone (compaction of 60M rows), against numpy;
then the kernels line, the card's name and power limit, and the final line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.

Run from the repository root:  python3 chip_smoke.py [--scale 10] [--seed 42]
It needs a CUDA device and nvcc; it never imports JAX or polars_tpu.
"""

from __future__ import annotations

import argparse
import datetime as dtm
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_OPS_PER_S = 33.5e12  # H100 SXM FP64 outside the tensor cores (data sheet)
Q1_DATE = dtm.date(1998, 9, 2)
Q1_DAYS = (Q1_DATE - dtm.date(1970, 1, 1)).days  # 10471
Q1_COLS = [
    "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
    "l_extendedprice", "l_discount", "l_tax",
]


def emit(obj: dict) -> None:
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
           "plan_f64": plan(cap, k, sms, n)._asdict(), "plan_i64": plan(cap, len(i64_cols), sms, n)._asdict(), "density": density,
           "offsets": list(offsets), "poison": poison,
           "max_abs_err_f64": err_f, "max_abs_err_i64": err_i, "f64_rtol_1e-9": ok_f, "i64_exact": ok_i}
    if not (ok_f and ok_i):
        raise AssertionError(f"groupagg_sums disagrees with its plain version: {res}")
    return res


def _bits(torch, t):
    """The raw bit pattern of ``t`` as a signed integer tensor of its width."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.view(view) if t.dtype != torch.bool else t.to(torch.int8)


def check_compact(torch, rng, n, mask, dtypes, dev, label="") -> dict:
    """K2 against its plain version, bit for bit, on one column per entry of
    ``dtypes`` (random bit patterns: NaN payloads must survive)."""
    from polars_tpu_torch.kernels.compact import compact, compact_plain

    if not isinstance(mask, np.ndarray):
        mask = rng.random(n) < mask
    width = {torch.bool: 1, torch.int16: 2, torch.int32: 4, torch.int64: 8, torch.float64: 8}
    ints = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
    cols = []
    for d in dtypes:
        if d == torch.bool:
            cols.append(torch.as_tensor(rng.random(n) < 0.5).to(dev))
            continue
        w = width[d]
        raw = rng.integers(-(2 ** (8 * w - 1)), 2 ** (8 * w - 1) - 1, n, dtype=ints[w])
        cols.append(torch.as_tensor(raw).to(dev).view(d))
    mask_t = torch.as_tensor(mask).to(dev)
    got, cnt = compact(cols, mask_t)
    want, cnt_p = compact_plain(cols, mask_t)
    torch.cuda.synchronize()
    if cnt != cnt_p or any(a.shape != b.shape for a, b in zip(got, want)):
        raise AssertionError(f"compact count {cnt} != plain {cnt_p} (n={n}, {label})")
    # largest difference of the bit patterns (wrapping for 8-byte payloads)
    # and the number of elements whose bits differ
    err, mismatches = 0.0, 0
    for a, b in zip(got, want):
        if a.numel():
            d = _bits(torch, a).long() - _bits(torch, b).long()
            err = max(err, float(d.double().abs().max()))
            mismatches += int((d != 0).sum())
    res = {"n": n, "label": label, "density": float(mask.mean()) if n else 0.0, "count": cnt,
           "dtypes": [str(d).replace("torch.", "") for d in dtypes], "max_abs_err_bits": err,
           "mismatches": mismatches}
    if mismatches:
        raise AssertionError(f"compact disagrees with its plain version: {res}")
    return res


def phase_kernels(torch, dev, seed: int, q1_density: float, n_main: int) -> dict:
    from polars_tpu_torch.kernels.compact import compact, compact_plain
    from polars_tpu_torch.kernels.groupagg import MODE_PRIVATE, groupagg_sums, groupagg_sums_plain, plan

    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = plan(12, 5, sms, n_main).tile_rows  # rows per tile of Q1's f64 batch
    both = ("int", None)
    checks_k1 = [
        # Q1's two K1 calls: the occupancy count over 12 key slots and the
        # batch of 5 distinct f64 columns
        check_groupagg(torch, rng, n_main, 12, 5, (None,), q1_density, dev),
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
    # Q1's segment-end compaction: 12 group slots, the 6 groups (every
    # returnflag x linestatus pair of the generator) a prefix after the
    # sort; 2 int32 key codes, 4 f64 sums, 3 f64 means each with its bool
    # validity, and the int64 count
    q1_out = [torch.int32, torch.int32] + [torch.float64] * 4 + [torch.float64, torch.bool] * 3 + [torch.int64]
    checks_k2 = [check_compact(torch, rng, n_main, d, payloads, dev, "payloads") for d in (0.0, 0.5, q1_density, 1.0)]
    checks_k2 += [check_compact(torch, rng, n, 0.5, payloads, dev, "payloads") for n in (0, 1, 4097)]
    checks_k2 += [
        check_compact(torch, rng, 12, np.arange(12) < 6, q1_out, dev, "q1 output"),
        check_compact(torch, rng, 12, 0.5, q1_out, dev, "q1 output"),
    ]
    emit({"phase": "kernels.compact_checks", "checks": checks_k2})

    # K1 timing at the main path's shapes, cap 12: Q1's f64 batch (5
    # distinct columns read in place, dense group ids) and its occupancy
    # count (key slot ids); then two shapes off the main path, one for each
    # of the other accumulator modes. Each timed run is held against the
    # plain version, beside ``index_add_`` and the least time the card needs
    n = n_main
    mask = torch.as_tensor(rng.random(n) < q1_density).to(dev)
    n_sel = int(mask.sum())
    f64_cols = [torch.as_tensor(rng.uniform(1.0, 1e5, n)).to(dev) for _ in range(5)]
    timings = {}
    for label, cols, ids, cap in (
        ("f64_k5", f64_cols, 6, 12),
        ("i64_count", [None], 12, 12),
        ("f64_k5_cap1024", f64_cols, 1024, 1024),
        ("f64_k2_cap65536", f64_cols[:2], 65536, 65536),
    ):
        k = len(cols)
        gids = torch.as_tensor(rng.integers(0, ids, n, dtype=np.int32)).to(dev)
        got = groupagg_sums(gids, cols, mask, cap)
        err, ok = k1_agree(torch, got, groupagg_sums_plain(gids, cols, mask, cap))
        if not ok:
            raise AssertionError(f"groupagg_sums {label} disagrees with its plain version (max err {err})")
        p = plan(cap, k, sms, n)
        if p.mode == MODE_PRIVATE and not torch.equal(got, groupagg_sums(gids, cols, mask, cap)):
            raise AssertionError(f"groupagg_sums {label}: two runs with private accumulators differ in their bits")
        ms = cuda_ms(torch, lambda: groupagg_sums(gids, cols, mask, cap))
        plain_ms = cuda_ms(torch, lambda: groupagg_sums_plain(gids, cols, mask, cap), reps=5, warmup=1)
        g_sel = gids[mask].long()
        acc = torch.float64 if cols[0] is not None else torch.int64
        v_sel = torch.stack(
            [c[mask] if c is not None else torch.ones(n_sel, dtype=acc, device=dev) for c in cols], 1
        )
        out = torch.zeros((cap, k), dtype=acc, device=dev)
        library_ms = cuda_ms(torch, lambda: out.index_add_(0, g_sel, v_sel), reps=5, warmup=1)
        del g_sel, v_sel, gids
        vbytes = sum(8 for c in cols if c is not None)
        b_ms, b_by = bound(n * 1 + n_sel * (4 + vbytes) + cap * k * 8, n_sel * k, FP64_OPS_PER_S)
        timings[label] = {"n": n, "n_selected": n_sel, "cap": cap, "k": k, "plan": p._asdict(), "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err, "repeats_bit_for_bit": True if p.mode == MODE_PRIVATE else None}
    del f64_cols
    emit({"phase": "kernels.groupagg_timing", **timings})

    # K2 timing: one f64 column and Q1's seven columns, 60M rows, Q1 density
    col8 = torch.as_tensor(rng.uniform(1.0, 1e5, n)).to(dev)
    ms = cuda_ms(torch, lambda: compact([col8], mask))
    plain_ms = cuda_ms(torch, lambda: compact_plain([col8], mask))
    library_ms = cuda_ms(torch, lambda: torch.masked_select(col8, mask))
    b_ms, b_by = bound(n + 2 * n_sel * 8, n_sel, FP64_OPS_PER_S)
    k2_one = {"n": n, "n_selected": n_sel, "columns": "1 x f64", "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}
    q1cols = [col8, col8.clone(), col8.clone(), col8.clone()] + [
        torch.as_tensor(rng.integers(0, 3, n, dtype=np.int32)).to(dev) for _ in range(3)
    ]
    ms7 = cuda_ms(torch, lambda: compact(q1cols, mask))
    plain7 = cuda_ms(torch, lambda: compact_plain(q1cols, mask))
    b7, b7_by = bound(n + 2 * n_sel * (4 * 8 + 3 * 4), n_sel, FP64_OPS_PER_S)
    k2_seven = {"n": n, "n_selected": n_sel, "columns": "4 x f64 + 3 x i32", "ms": ms7, "plain_ms": plain7,
                "library_ms": None, "bound_ms": b7, "bound_by": b7_by}
    emit({"phase": "kernels.compact_timing", "one_column": k2_one, "q1_columns": k2_seven})
    del col8, q1cols, mask
    torch.cuda.empty_cache()
    k1_err = max([t["max_abs_err"] for t in timings.values()]
                 + [max(c["max_abs_err_f64"], c["max_abs_err_i64"]) for c in checks_k1])
    k2_err = max(c["max_abs_err_bits"] for c in checks_k2)
    return {"k1_err": k1_err, "k1": timings["f64_k5"], "k2_err": k2_err, "k2": k2_one}


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


def generate(scale: float, seed: int) -> tuple[dict, float]:
    """The seven Q1 columns of PDS-H lineitem at ``scale`` (host numpy)."""
    from polars_tpu_torch.testing import pdsh

    t0 = time.perf_counter()
    full = pdsh.generate_pdsh(scale, seed=seed, tables=("lineitem",))["lineitem"]
    return {c: full[c] for c in Q1_COLS}, time.perf_counter() - t0


def phase_q1(torch, pl, dev, raw: dict, t_gen: float, scale: float) -> tuple[dict, object]:
    from polars_tpu_torch.kernels.compact import compact
    from polars_tpu_torch.kernels.groupagg import groupagg_sums
    from polars_tpu_torch.testing import pdsh

    t0 = time.perf_counter()
    df = pl.DataFrame(raw, device=dev)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    n = df.height

    # the main path: counters at 0 just before, read just after
    groupagg_sums.launches = 0
    compact.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pdsh.q1(df).collect()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {"groupagg_sums": groupagg_sums.launches, "compact": compact.launches}
    peak = torch.cuda.max_memory_allocated()
    if not all(launches.values()):
        raise AssertionError(f"Q1 did not launch every kernel of its path: {launches}")

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pdsh.q1(df).collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    want = q1_oracle(raw)
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
    res = {
        "phase": "q1", "scale": scale, "rows": n, "groups": out.height, "datagen_s": t_gen,
        "frame_build_s": t_frame, "first_collect_s": t_first, "warm_wall_s": wall, "warm_walls_s": walls,
        "rows_per_s": n / wall, "launches": launches, "peak_device_bytes": peak,
        "max_rel_err_vs_numpy": worst, "matches_numpy_oracle": True,
    }
    emit(res)
    return res, df


def phase_filter(torch, pl, raw: dict, df) -> dict:
    from polars_tpu_torch.kernels.compact import compact
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    lf = df.lazy().filter(pl.col("l_shipdate") <= Q1_DATE)
    groupagg_sums.launches = 0
    compact.launches = 0
    out = lf.collect()
    torch.cuda.synchronize()
    launches = {"groupagg_sums": groupagg_sums.launches, "compact": compact.launches}
    if launches["compact"] < 1:
        raise AssertionError(f"the filter did not launch compact: {launches}")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        lf.collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

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
    res = {"phase": "filter", "rows_in": df.height, "rows_out": out.height, "launches": launches,
           "warm_wall_s": statistics.median(walls), "warm_walls_s": walls, "columns": checks}
    emit(res)
    return res


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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import polars_tpu_torch as pl

    dev = torch.device("cuda", 0)
    card = card_line()
    phase_build()
    raw, t_gen = generate(args.scale, args.seed)
    ship = raw["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    q1_density = float(np.mean(ship <= Q1_DAYS))  # Q1's own filter density
    kern = phase_kernels(torch, dev, args.seed, q1_density, len(ship))
    del ship
    q1, df = phase_q1(torch, pl, dev, raw, t_gen, args.scale)
    phase_filter(torch, pl, raw, df)
    del df, raw

    k1, k2 = kern["k1"], kern["k2"]
    kernels = [
        {
            "name": "groupagg_sums", "route": "cuda", "source": "polars_tpu_torch/csrc/groupagg.cu",
            "replaces": "polars_tpu/kernels/pallas_groupagg.py:49",
            "launches": q1["launches"]["groupagg_sums"],
            "max_abs_err": kern["k1_err"],
            "ms": k1["ms"], "kernel_ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
            "shape": f"n={k1['n']} cap=12 k=5 f64 (Q1's float batch)",
        },
        {
            "name": "compact", "route": "cuda", "source": "polars_tpu_torch/csrc/compact.cu",
            "replaces": "polars_tpu/kernels/pallas_compact.py:49",
            "launches": q1["launches"]["compact"],
            "max_abs_err": kern["k2_err"],
            "ms": k2["ms"], "kernel_ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
            "shape": f"n={k2['n']} 1 x f64, Q1 filter density",
        },
    ]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
