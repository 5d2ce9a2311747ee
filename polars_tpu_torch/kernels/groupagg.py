"""K1: masked per-group sums of k columns (CUDA kernel ``csrc/groupagg.cu``).

The port of ``polars_tpu/kernels/pallas_groupagg.py``: ``(cap, k)`` sums of
each column over the rows where ``mask`` holds, by group id. Two
instantiations of one kernel template: f64 columns accumulate in f64, i64
columns in i64 (exact for counts and integer sums). A ``None`` column stands
for a column of ones, so a count reads only the mask and the ids. Rows whose
id lies outside ``[0, cap)`` are dropped, like the JAX scatter's
``mode="drop"``.

:func:`groupagg_sums` launches the kernel for CUDA tensors and runs
:func:`groupagg_sums_plain` for CPU tensors; it never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch

THREADS = 128  # csrc/groupagg.cu THREADS
ROWS_PER_THREAD = 4  # csrc/groupagg.cu U
MAX_KT = 16
REPL = THREADS // 32
SMEM_MAX = 232448  # bytes of dynamic shared memory a block may opt into on sm_90
SMEM_PER_SM = 233472
GLOBAL_SCRATCH_MAX = 64 << 20
MODE_PRIVATE, MODE_SHARED, MODE_GLOBAL = 0, 1, 2

_ACC = {torch.float64: "f64", torch.int64: "i64"}


def groupagg_sums_plain(gids: torch.Tensor, columns: list, mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Reference version: one ``index_add_`` over the selected rows."""
    dtype = _acc_dtype(columns)
    keep = mask & (gids >= 0) & (gids < cap)
    g = gids[keep].long()
    vals = [
        torch.ones(g.shape[0], dtype=dtype, device=gids.device) if c is None else c[keep]
        for c in columns
    ]
    out = torch.zeros((cap, len(columns)), dtype=dtype, device=gids.device)
    if vals:
        out.index_add_(0, g, torch.stack(vals, dim=1))
    return out


def _acc_dtype(columns: list) -> torch.dtype:
    dts = {c.dtype for c in columns if c is not None}
    if len(dts) > 1:
        raise TypeError(f"groupagg_sums: columns of one call share a dtype, got {sorted(map(str, dts))}")
    dtype = dts.pop() if dts else torch.int64
    if dtype not in _ACC:
        raise TypeError(f"groupagg_sums: columns must be float64 or int64, got {dtype}")
    return dtype


def plan(cap: int, k: int, sms: int, n: int) -> tuple[int, int, int]:
    """(mode, columns per launch, blocks) for one call."""
    per_col = cap * 8
    kt = min(k, MAX_KT, SMEM_MAX // (THREADS * per_col))
    if kt >= 1:
        mode, smem = MODE_PRIVATE, THREADS * per_col * kt
    else:
        kt = min(k, MAX_KT, SMEM_MAX // (REPL * per_col))
        if kt >= 1:
            mode, smem = MODE_SHARED, REPL * per_col * kt
        else:
            mode, smem, kt = MODE_GLOBAL, 0, min(k, MAX_KT)
    per_sm = 16 if smem == 0 else max(1, min(16, SMEM_PER_SM // smem))
    want = -(-max(n, 1) // (THREADS * ROWS_PER_THREAD))
    blocks = max(1, min(sms * per_sm, want))
    if mode == MODE_GLOBAL:
        blocks = max(1, min(blocks, GLOBAL_SCRATCH_MAX // (per_col * kt)))
    return mode, kt, blocks


def _check(gids, columns, mask, cap) -> torch.dtype:
    dev = gids.device
    if gids.dtype != torch.int32 or gids.dim() != 1 or not gids.is_contiguous():
        raise TypeError("groupagg_sums: gids must be a contiguous 1-D int32 tensor")
    n = gids.shape[0]
    if mask.dtype != torch.bool or mask.shape != (n,) or not mask.is_contiguous() or mask.device != dev:
        raise TypeError("groupagg_sums: mask must be a contiguous bool tensor shaped like gids on its device")
    for c in columns:
        if c is None:
            continue
        if c.shape != (n,) or not c.is_contiguous() or c.device != dev:
            raise TypeError("groupagg_sums: columns must be contiguous 1-D tensors shaped like gids on its device")
    if not columns:
        raise ValueError("groupagg_sums: no columns")
    if cap < 1:
        raise ValueError(f"groupagg_sums: cap must be >= 1, got {cap}")
    return _acc_dtype(columns)


def groupagg_sums(gids: torch.Tensor, columns: list, mask: torch.Tensor, cap: int) -> torch.Tensor:
    """(cap, k) sums of ``columns[c]`` over rows with ``mask`` by ``gids``.

    Columns are 1-D float64 or int64 tensors of one dtype (``None`` = ones);
    the result has that dtype."""
    dtype = _check(gids, columns, mask, cap)
    if gids.device.type == "cpu":
        return groupagg_sums_plain(gids, columns, mask, cap)
    if gids.device.type != "cuda":
        raise TypeError(f"groupagg_sums: unsupported device {gids.device}")
    from polars_tpu_torch.kernels.build import load

    lib = load("groupagg")
    fn = getattr(lib, f"groupagg_sums_{_ACC[dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    n, k = gids.shape[0], len(columns)
    sms = torch.cuda.get_device_properties(gids.device).multi_processor_count
    mode, kt, blocks = plan(cap, k, sms, n)
    out = torch.empty((cap, k), dtype=dtype, device=gids.device)
    partials = torch.empty(blocks * cap * kt, dtype=dtype, device=gids.device)
    stream = torch.cuda.current_stream(gids.device).cuda_stream
    for c0 in range(0, k, kt):
        tile = columns[c0:c0 + kt]
        ptrs = (ctypes.c_void_p * len(tile))(*[None if c is None else c.data_ptr() for c in tile])
        err = fn(gids.data_ptr(), mask.data_ptr(), ptrs, len(tile), n, cap, mode, blocks,
                 partials.data_ptr(), out.data_ptr(), k, c0, stream)
        if err != 0:
            raise RuntimeError(f"groupagg_sums kernel launch failed: cudaError {err}")
    groupagg_sums.launches += 1
    return out


groupagg_sums.launches = 0
