"""Division with Polars semantics (the port of the engine-wide entry points
of ``polars_tpu/kernels/fastmath.py``). The JAX package keeps division-free
variants for a TPU backend; on the GPU native division is exact IEEE, so
only the semantics remain: float ``/`` is IEEE (x/0 = ±inf, 0/0 = NaN),
``//`` floors and ``%`` takes the divisor's sign. UInt64 values live as
their bit pattern in int64 tensors (PyTorch has no uint64 arithmetic), so
their ``//`` and ``%`` are built here from signed operations.
"""

from __future__ import annotations

import torch


def div_any(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.true_divide(x, y)


def floordiv_any(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_floating_point or (isinstance(y, torch.Tensor) and y.dtype.is_floating_point):
        return torch.floor(torch.true_divide(x, y))
    return torch.div(x, y, rounding_mode="floor")


def mod_any(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x, y)


_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1


def floordiv_u64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x // y`` of UInt64 bit patterns held in int64 tensors (``y`` != 0).

    For a divisor below 2^63: halve the dividend (logical shift), divide,
    double, and correct by at most one. A divisor of 2^63 or more goes into
    the dividend once or not at all."""
    q = torch.div((x >> 1) & _I64_MAX, y, rounding_mode="trunc") << 1
    r = x - q * y
    q = q + ((r ^ _I64_MIN) >= (y ^ _I64_MIN)).to(torch.int64)
    return torch.where(y < 0, ((x ^ _I64_MIN) >= (y ^ _I64_MIN)).to(torch.int64), q)


def mod_u64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x % y`` of UInt64 bit patterns held in int64 tensors (``y`` != 0)."""
    return x - floordiv_u64(x, y) * y
