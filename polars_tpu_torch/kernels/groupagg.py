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
the other. :func:`plan` is the one place that sizes a launch: persistent
blocks (one per SM) that walk fixed row tiles, a ring of bulk-copy stages in
shared memory, and the accumulator mode; ``csrc/groupagg.cu`` lays shared
memory out by the same arithmetic and refuses a launch that disagrees.
An f64 call in global scratch, the mode of the sorted group-by (capacity =
rows), adds exact int64 words there (``Plan.words``; :func:`exact_words` is
the same arithmetic in PyTorch): f64 atomics would add in a run-dependent
order, and a query that compares two evaluations of one sum (PDS-H Q15)
needs its sums to repeat bit for bit. The shared slices keep f64 atomics,
whose sums vary from run to run within rtol 1e-9.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

ROWS_PER_THREAD = 4  # csrc/groupagg.cu U: consecutive rows a consumer thread takes per step
CONSUMER_THREADS = (512, 256, 128)  # candidate consumer counts, widest first (one producer warp rides along)
MAX_KT = 16  # columns per launch
MIN_STAGES, MAX_STAGES = 2, 8  # ring depth
HEADER = 128  # bytes of mbarriers ahead of the accumulators
SMEM_MAX = 232448  # bytes of dynamic shared memory a block may opt into on sm_90
GLOBAL_SCRATCH_MAX = 16 << 20  # global accumulator slices stay inside the L2 (32 MB of them measured slower: PERF.md)
WORDS_SCRATCH_MAX = 4 << 30  # exact words: columns per launch so that one slice stays under 4 GiB
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


class Plan(NamedTuple):
    """The launch shape of one call (every field an argument of the kernel)."""

    mode: int
    kt: int  # columns per launch
    threads: int  # consumer threads of a block
    tile_rows: int  # rows per tile, a multiple of threads * ROWS_PER_THREAD
    stages: int  # ring depth
    repl: int  # MODE_SHARED: accumulator slices per block
    blocks: int  # persistent blocks; block b walks tiles b, b + blocks, ...
    slices: int  # partial slices the finish kernel sums
    smem: int  # bytes of shared memory per block
    words: bool  # f64 in MODE_GLOBAL: exact int64 words (csrc/groupagg.cu ``add_words``)


def _acc_bytes(mode: int, cap: int, kt: int, threads: int, repl: int) -> int:
    units = {MODE_PRIVATE: threads, MODE_SHARED: repl, MODE_GLOBAL: 0}[mode]
    return -(-8 * cap * kt * units // 128) * 128


def _stage_bytes(threads: int, kt: int) -> int:
    return threads * ROWS_PER_THREAD * (8 * kt + 5)  # per row: kt values, a 4-byte id, a mask byte


def _fits(mode: int, cap: int, kt: int, threads: int, repl: int) -> bool:
    return HEADER + _acc_bytes(mode, cap, kt, threads, repl) + MIN_STAGES * _stage_bytes(threads, kt) <= SMEM_MAX


@functools.lru_cache(maxsize=256)
def plan(cap: int, k: int, sms: int, n: int, f64: bool = False) -> Plan:
    """Size one call: the first mode in which a column fits (private slices,
    shared slices, global scratch), the most columns per launch that leave
    room for a ring of ``MIN_STAGES`` stages, the most consumer threads that
    still fit, and then as deep a ring as the rest of shared memory holds.
    An ``f64`` call in global scratch adds exact words there (``words``:
    four int64 accumulators per sum), so that its sums repeat bit for bit."""
    narrow = CONSUMER_THREADS[-1]
    kmax = min(k, MAX_KT)
    for mode in (MODE_PRIVATE, MODE_SHARED, MODE_GLOBAL):
        kt = next((c for c in range(kmax, 0, -1) if _fits(mode, cap, c, narrow, 1)), 0)
        if kt:
            break
    words = f64 and mode == MODE_GLOBAL
    if words:
        kt = max(1, min(kt, WORDS_SCRATCH_MAX // (8 * cap * NWORDS)))
    threads = next(t for t in CONSUMER_THREADS if _fits(mode, cap, kt, t, 1))
    repl = 0
    if mode == MODE_SHARED:
        repl = next(r for r in range(threads // 32, 0, -1) if _fits(mode, cap, kt, threads, r))
    acc = _acc_bytes(mode, cap, kt, threads, repl)
    stage = _stage_bytes(threads, kt)
    stages = min(MAX_STAGES, (SMEM_MAX - HEADER - acc) // stage)
    tile_rows = threads * ROWS_PER_THREAD
    blocks = max(1, min(sms, n // tile_rows))
    slices = blocks
    if mode == MODE_GLOBAL:
        slices = max(1, min(blocks, GLOBAL_SCRATCH_MAX // (8 * cap * kt * (NWORDS if words else 1))))
    return Plan(mode, kt, threads, tile_rows, stages, repl, blocks, slices, HEADER + acc + stages * stage, words)


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
    the result has that dtype. Every operand is read in place. The kernel
    streams an operand through its bulk-copy ring only if its address is a
    multiple of 16 bytes; a contiguous view with a storage offset that breaks
    that (``x[1:]``) is taken as it is and read with plain loads, which is
    slower, rather than copied. f64 sums repeat bit for bit from run to run
    but in the shared slices (``Plan.words``)."""
    dtype = _check(gids, columns, mask, cap)
    if gids.device.type == "cpu":
        return groupagg_sums_plain(gids, columns, mask, cap)
    if gids.device.type != "cuda":
        raise TypeError(f"groupagg_sums: unsupported device {gids.device}")
    n, k = gids.shape[0], len(columns)
    sms = torch.cuda.get_device_properties(gids.device).multi_processor_count
    p = plan(cap, k, sms, n, dtype == torch.float64)
    fn = _entry(dtype)
    out = torch.empty((cap, k), dtype=dtype, device=gids.device)
    partials = torch.empty(p.slices * cap * p.kt * (NWORDS if p.words else 1), dtype=dtype, device=gids.device)
    exps = torch.empty(p.kt, dtype=torch.int32, device=gids.device) if p.words else None
    wbits = word_bits(n) if p.words else 0
    stream = torch.cuda.current_stream(gids.device).cuda_stream
    for c0 in range(0, k, p.kt):  # one launch per p.kt columns
        tile = columns[c0:c0 + p.kt]
        kt = len(tile)
        ptrs = (ctypes.c_void_p * kt)(*[None if c is None else c.data_ptr() for c in tile])
        # a narrower last launch keeps the plan's threads, tile and stages: its
        # accumulators and stages only shrink
        smem = HEADER + _acc_bytes(p.mode, cap, kt, p.threads, p.repl) + p.stages * _stage_bytes(p.threads, kt)
        err = fn(gids.data_ptr(), mask.data_ptr(), ptrs, kt, n, cap, p.mode, p.threads, p.tile_rows,
                 p.stages, p.repl, p.blocks, p.slices, smem, partials.data_ptr(), out.data_ptr(), k, c0,
                 None if exps is None else exps.data_ptr(), wbits, sms, stream)
        if err != 0:
            raise RuntimeError(f"groupagg_sums kernel launch failed: cudaError {err} with {p}")
    groupagg_sums.launches += 1
    return out


# The exact words of an f64 call in MODE_GLOBAL, as csrc/groupagg.cu adds
# them (``add_words``, ``groupagg_finish_words``), in PyTorch: the kernel
# cannot run on the CPU, so the tests hold this copy of its arithmetic. Each
# selected finite value v is, to within 2^(e - 3w) where 2^e bounds the
# column's largest selected finite |v|, the sum of three int64 words
# d_k * 2^(e - k w), |d_k| < 2^w; w = min(50, 62 - bits(n)), so n of them sum
# in int64 without overflow and their sums do not depend on the order of the
# adds. Each value loses what lies below 2^(e - 3w), so a group whose values
# all lie far below the column's largest loses their low bits: at 60M rows
# (w = 36) a group's sum keeps rtol 1e-9 down to about 2^-78 of the column's
# largest value, and sums to 0 below 2^-108 of it; at 4096 rows (w = 49),
# 2^-117 and 2^-147. A fourth word counts the non-finite
# values: +inf in its low 32 bits, -inf in its high bits, NaN in both.
NWORDS = 4
_EXP_MIN = -800  # every scale 2^(+-(k w - e)) stays a normal f64 (values under 2^-800 lose precision)


def word_bits(n: int) -> int:
    """w: the bits of one exact word for ``n`` rows."""
    return min(50, 62 - max(n, 1).bit_length())


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k for int64 ``k`` in [-1022, 1023], exactly (built from its bits)."""
    return ((k + 1023) << 52).view(torch.float64)


def exact_words(col: torch.Tensor, mask: torch.Tensor, n: int | None = None) -> tuple[list, torch.Tensor]:
    """([NWORDS] int64 columns, e): the exact words of ``col`` where ``mask``
    holds (0 elsewhere) and the 0-d exponent ``e`` of their scale, with the
    word width of a call of ``n`` rows (default: ``col``'s)."""
    w = word_bits(col.shape[0] if n is None else n)
    x = torch.where(mask, col, 0.0)
    r = torch.where(torch.isfinite(x), x, 0.0)
    e = torch.frexp(r.abs().amax() if col.shape[0] else torch.zeros((), dtype=torch.float64, device=col.device))[1]
    e = e.to(torch.int64).clamp(min=_EXP_MIN)
    words = []
    for k in range(1, NWORDS):
        d = torch.trunc(r * _pow2(k * w - e))
        words.append(d.to(torch.int64))
        r = r - d * _pow2(e - k * w)
    nan = torch.isnan(x)
    pos, neg = (x == float("inf")) | nan, (x == float("-inf")) | nan
    words.append(pos.to(torch.int64) + (neg.to(torch.int64) << 32))
    return words, e


def from_words(sums: torch.Tensor, e: torch.Tensor, n: int) -> torch.Tensor:
    """(cap,) f64 sums from the (cap, NWORDS) sums of :func:`exact_words`
    over ``n`` rows: the parts added in a fixed order, then inf or NaN where
    non-finite values were summed."""
    w = word_bits(n)
    out = sums[:, 0].to(torch.float64) * _pow2(e - w) + sums[:, 1].to(torch.float64) * _pow2(e - 2 * w)
    out = out + sums[:, 2].to(torch.float64) * _pow2(e - 3 * w)
    pos, neg = (sums[:, NWORDS - 1] & 0xFFFFFFFF) > 0, (sums[:, NWORDS - 1] >> 32) > 0
    out = torch.where(pos, float("inf"), out)
    out = torch.where(neg, float("-inf"), out)
    return torch.where(pos & neg, float("nan"), out)


groupagg_sums.launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The library's entry point for one accumulation dtype, built at first use."""
    from polars_tpu_torch.kernels.build import load

    fn = getattr(load("groupagg"), f"groupagg_sums_{_ACC[dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn
