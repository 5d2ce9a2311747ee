"""K2: stable stream compaction of a set of columns (CUDA kernel ``csrc/compact.cu``).

The port of ``polars_tpu/kernels/pallas_compact.py``: the rows where ``mask``
holds, in their order, for every column at once, plus the survivor count.
Payloads of 1, 2, 4 and 8 bytes move as raw bits, so the result is bit-exact
for every dtype. The count is read back to the host once per call, to size
the outputs exactly.

:func:`compact` launches the kernel for CUDA tensors and runs
:func:`compact_plain` for CPU tensors; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

_SIZES = (1, 2, 4, 8)


def compact_plain(columns: list, mask: torch.Tensor) -> tuple[list, int]:
    """Reference version: ``nonzero`` + ``index_select``."""
    idx = torch.nonzero(mask).squeeze(1)
    return [c.index_select(0, idx) for c in columns], int(idx.shape[0])


def _check(columns: list, mask: torch.Tensor) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise TypeError("compact: mask must be a contiguous 1-D bool tensor")
    n = mask.shape[0]
    for c in columns:
        if c.shape != (n,) or not c.is_contiguous() or c.device != mask.device:
            raise TypeError("compact: columns must be contiguous 1-D tensors shaped like mask on its device")
        if c.element_size() not in _SIZES:
            raise TypeError(f"compact: unsupported element size {c.element_size()} ({c.dtype})")


def compact(columns: list, mask: torch.Tensor) -> tuple[list, int]:
    """(columns restricted to the rows where ``mask`` holds, in order; count)."""
    _check(columns, mask)
    if mask.device.type == "cpu":
        return compact_plain(columns, mask)
    if mask.device.type != "cuda":
        raise TypeError(f"compact: unsupported device {mask.device}")
    from polars_tpu_torch.kernels.build import load

    lib = load("compact")
    lib.compact_tile_rows.restype = ctypes.c_longlong
    lib.compact_tile_rows.argtypes = []
    lib.compact_count.restype = ctypes.c_int
    lib.compact_count.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.compact_scatter.restype = ctypes.c_int
    lib.compact_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    n = mask.shape[0]
    tile = lib.compact_tile_rows()
    nb = -(-n // tile)
    offs = torch.empty(nb + 1, dtype=torch.int64, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = lib.compact_count(mask.data_ptr(), n, offs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"compact count kernel launch failed: cudaError {err}")
    count = int(offs[nb])
    outs = [torch.empty(count, dtype=c.dtype, device=c.device) for c in columns]
    if count and columns:
        k = len(columns)
        ins = (ctypes.c_void_p * k)(*[c.data_ptr() for c in columns])
        dsts = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
        sizes = (ctypes.c_int * k)(*[c.element_size() for c in columns])
        err = lib.compact_scatter(mask.data_ptr(), n, offs.data_ptr(), k, ins, dsts, sizes, stream)
        if err != 0:
            raise RuntimeError(f"compact scatter kernel launch failed: cudaError {err}")
    compact.launches += 1
    return outs, count


compact.launches = 0
