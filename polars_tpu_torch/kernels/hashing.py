"""Vectorized 64-bit row hashing (the port of ``polars_tpu/kernels/hashing.py``:
``splitmix64``, ``hash_column``, ``combine_hashes`` and ``hash_columns``).

Hashes are int64 bit patterns, equal bit for bit to the JAX package's, so a
key hashed by either package lands on the same word. Add, multiply and xor
wrap alike in int64 and uint64, so the mix runs in int64. PyTorch's ``>>`` on
int64 is an arithmetic shift; :func:`_shr` masks the sign bits it copies in,
which makes it the logical shift that splitmix64 needs.
"""

from __future__ import annotations

import torch

# splitmix64 constants as signed int64 two's-complement python ints
_C1 = 0x9E3779B97F4A7C15 - (1 << 64)
_C2 = 0xBF58476D1CE4E5B9 - (1 << 64)
_C3 = 0x94D049BB133111EB - (1 << 64)
_NULL_HASH = 0xC0FFEE_DEAD_BEEF


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical (zero-fill) right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 bit patterns."""
    x = x.to(torch.int64) + _C1
    x = (x ^ _shr(x, 30)) * _C2
    x = (x ^ _shr(x, 27)) * _C3
    return x ^ _shr(x, 31)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values flushed to a zero of their sign."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0, x)


def hash_column(values: torch.Tensor, validity: torch.Tensor | None, seed: int = 0) -> torch.Tensor:
    """Hash one column to int64 bit patterns (nulls hash to a fixed sentinel).

    Floats are canonicalized first (one NaN, -0.0 as 0.0), so equal keys hash
    equal. An f64 hashes as the JAX package hashes it: the bits of its f32
    rounding ``hi`` in the high word and of the f32 remainder ``lo`` in the
    low word (the TPU backend had no 64-bit bitcast); equal f64s give equal
    pairs, and callers verify hashed candidates on the values anyway.

    XLA treats subnormal floats as zero (inputs) and flushes subnormal results
    to a zero of the same sign; :func:`_ftz` does the same here, so that
    subnormals hash as in the JAX package."""
    d = values.dtype
    if d in (torch.float32, torch.float64):
        v = torch.where(torch.isnan(values), torch.full((), float("nan"), dtype=d, device=values.device), values)
        v = torch.where(v.abs() < torch.finfo(d).tiny, torch.zeros((), dtype=d, device=values.device), v)
        if d == torch.float64:
            hi = _ftz(v.to(torch.float32))
            lo = _ftz((v - hi.to(torch.float64)).to(torch.float32))
            nan32 = torch.full((), float("nan"), dtype=torch.float32, device=values.device)
            hi = torch.where(torch.isnan(hi), nan32, hi)
            lo = torch.where(torch.isnan(lo) | torch.isinf(hi), torch.zeros((), dtype=torch.float32, device=values.device), lo)
            bhi = hi.view(torch.int32).to(torch.int64)
            blo = lo.view(torch.int32).to(torch.int64)
            x = (bhi << 32) | (blo & 0xFFFFFFFF)
        else:
            x = v.view(torch.int32).to(torch.int64)
    else:
        x = values.to(torch.int64)
    h = splitmix64(x + seed)
    if validity is not None:
        h = torch.where(validity, h, _NULL_HASH)
    return h


def combine_hashes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-dependent combination of two hashes (boost::hash_combine style)."""
    return splitmix64(a ^ (b + _C1 + (a << 6) + _shr(a, 2)))


def hash_columns(cols: list[tuple[torch.Tensor, torch.Tensor | None]], seed: int = 0) -> torch.Tensor:
    """Hash several key columns into one int64 word per row."""
    h = hash_column(cols[0][0], cols[0][1], seed)
    for values, validity in cols[1:]:
        h = combine_hashes(h, hash_column(values, validity, seed))
    return h
