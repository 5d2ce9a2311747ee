"""K2: stable stream compaction of a set of columns (CUDA kernel ``csrc/compact.cu``).

The port of ``polars_tpu/kernels/pallas_compact.py``: the rows where ``mask``
holds, in their order, for every column at once. Payloads of 1, 2, 4 and 8
bytes move as raw bits, so the result is bit-exact for every dtype.

The interface has two halves, so that a segment reads the device once:

- :func:`compact_count` returns a device tensor of per-chunk offsets with
  the total at the end (one fused count-and-scan launch), and does not
  synchronise;
- :func:`compact_scatter` moves the survivors, given those offsets and the
  total the caller read to the host (which sizes the outputs).

:func:`compact` composes them: count, one host read, scatter. Each half
launches its kernel for CUDA tensors and runs its plain PyTorch version
(``*_plain``) for CPU tensors; it never falls back from one to the other.
``compact.launches`` counts the count-and-scan launches, one per segment-end
compaction; ``compact_scatter.launches`` the scatter launches (none where no
row survives).
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch

_SIZES = (1, 2, 4, 8)
CHUNK_ROWS = 512  # csrc/compact.cu CHUNK: rows per offset
TILE_ROWS = 65536  # csrc/compact.cu TILE: rows per count block and status word


def chunks(n: int) -> int:
    """Number of chunks, and so of offsets before the total, for ``n`` rows."""
    return -(-n // CHUNK_ROWS)


def compact_plain(columns: list, mask: torch.Tensor) -> tuple[list, int]:
    """Reference version of the whole compaction: ``nonzero`` + ``index_select``."""
    idx = torch.nonzero(mask).squeeze(1)
    return [c.index_select(0, idx) for c in columns], int(idx.shape[0])


def compact_count_plain(mask: torch.Tensor) -> torch.Tensor:
    """Reference version of :func:`compact_count`: survivors per chunk of
    ``CHUNK_ROWS`` rows, scanned."""
    n, nc = mask.shape[0], chunks(mask.shape[0])
    per_row = torch.zeros(nc * CHUNK_ROWS, dtype=torch.int64, device=mask.device)
    per_row[:n] = mask
    offs = torch.zeros(nc + 1, dtype=torch.int64, device=mask.device)
    offs[1:] = per_row.view(nc, CHUNK_ROWS).sum(1).cumsum(0)
    return offs


def compact_scatter_plain(columns: list, mask: torch.Tensor, offs: torch.Tensor, count: int) -> list:
    """Reference version of :func:`compact_scatter` (``offs`` and ``count``
    are implied by ``mask``)."""
    return compact_plain(columns, mask)[0]


def _check_mask(mask: torch.Tensor) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise TypeError("compact: mask must be a contiguous 1-D bool tensor")
    if not (mask.is_cuda or mask.is_cpu):
        raise TypeError(f"compact: unsupported device {mask.device}")


def _check_columns(columns: list, mask: torch.Tensor) -> None:
    n, device = mask.shape[0], mask.get_device()
    for c in columns:
        if c.dim() != 1 or c.shape[0] != n or not c.is_contiguous() or c.get_device() != device:
            raise TypeError("compact: columns must be contiguous 1-D tensors shaped like mask on its device")
        if c.element_size() not in _SIZES:
            raise TypeError(f"compact: unsupported element size {c.element_size()} ({c.dtype})")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures bound (once per process)."""
    from polars_tpu_torch.kernels.build import load

    lib = load("compact")
    for layout in (lib.compact_chunk_rows, lib.compact_tile_rows):
        layout.restype = ctypes.c_longlong
        layout.argtypes = []
    lib.compact_count.restype = ctypes.c_int
    lib.compact_count.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.compact_scatter.restype = ctypes.c_int
    lib.compact_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    if (lib.compact_chunk_rows(), lib.compact_tile_rows()) != (CHUNK_ROWS, TILE_ROWS):
        raise RuntimeError("csrc/compact.cu and kernels/compact.py disagree on CHUNK_ROWS or TILE_ROWS")
    return lib


def _stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as the raw handle."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def compact_count(mask: torch.Tensor) -> torch.Tensor:
    """Offsets of the survivors of each chunk of ``CHUNK_ROWS`` rows, on
    ``mask``'s device: ``chunks(n) + 1`` int64 values, the last the total.
    Nothing is read to the host."""
    _check_mask(mask)
    if mask.is_cpu:
        return compact_count_plain(mask)
    n = mask.shape[0]
    nc = chunks(n)
    # one allocation: the offsets, then the kernel's status words (one per
    # count tile) and its ticket
    scratch = torch.empty(nc + 1 + -(-n // TILE_ROWS) + 1, dtype=torch.int64, device=mask.device)
    err = _lib().compact_count(mask.data_ptr(), n, scratch.data_ptr(), _stream(mask))
    if err != 0:
        raise RuntimeError(f"compact count kernel launch failed: cudaError {err}")
    if n:
        compact.launches += 1
    return scratch[: nc + 1]


def compact_scatter(columns: list, mask: torch.Tensor, offs: torch.Tensor, count: int) -> list:
    """``columns`` restricted to the rows where ``mask`` holds, in order.
    ``offs`` is :func:`compact_count`'s result for ``mask`` and ``count`` its
    last value, read to the host."""
    _check_mask(mask)
    _check_columns(columns, mask)
    if mask.is_cpu:
        return compact_scatter_plain(columns, mask, offs, count)
    n = mask.shape[0]
    if offs.dtype != torch.int64 or offs.shape[0] != chunks(n) + 1 or offs.get_device() != mask.get_device():
        raise TypeError("compact_scatter: offs must be compact_count(mask)")
    if not columns:
        return []
    outs = [torch.empty(count, dtype=c.dtype, device=c.device) for c in columns]
    if count:
        k = len(columns)
        # the input pointers, the output pointers, the element sizes
        desc = array.array("Q", [c.data_ptr() for c in columns] + [o.data_ptr() for o in outs]
                           + [c.element_size() for c in columns])
        err = _lib().compact_scatter(mask.data_ptr(), n, offs.data_ptr(), count, k, desc.buffer_info()[0], _stream(mask))
        if err != 0:
            raise RuntimeError(f"compact scatter kernel launch failed: cudaError {err}")
        compact_scatter.launches += 1
    return outs


def compact(columns: list, mask: torch.Tensor) -> tuple[list, int]:
    """(columns restricted to the rows where ``mask`` holds, in order; count):
    :func:`compact_count`, one host read of the total, :func:`compact_scatter`."""
    offs = compact_count(mask)
    count = int(offs[-1])
    return compact_scatter(columns, mask, offs, count), count


compact.launches = 0
compact_scatter.launches = 0
