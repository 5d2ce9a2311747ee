"""Division with Polars semantics (the port of the engine-wide entry points
of ``polars_tpu/kernels/fastmath.py``). The JAX package keeps division-free
variants for a TPU backend; on the GPU native division is exact IEEE, so
only the semantics remain: float ``/`` is IEEE (x/0 = ±inf, 0/0 = NaN),
``//`` floors and ``%`` takes the divisor's sign.
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
