"""Process-wide configuration: the dense group-by's capacity limit, and the
default device of the port's entry points.

Entry points place data on ``cuda`` unless the caller asks for the CPU, either
per frame (``DataFrame(..., device="cpu")``) or for the process through
:func:`set_default_device`. Asking for ``cuda`` where PyTorch sees no CUDA
device raises; nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch

# Largest key domain the dense (perfect-hash) group-by takes: the JAX
# package's default hot table (4096 entries, polars_tpu/config.py:46) x 16
DENSE_MAX_CAP = 4096 * 16

_default_device = ["cuda"]


def set_default_device(device) -> str:
    """Set the device that frames are built on when the caller names none;
    returns the previous default."""
    prev = _default_device[0]
    _default_device[0] = str(torch.device(device))
    return prev


def resolve_device(device=None) -> torch.device:
    """The device for a new frame: ``device`` if given, else the default.
    Raises when that is a CUDA device and PyTorch sees none."""
    dev = torch.device(device if device is not None else _default_device[0])
    if dev.type == "cuda" and not torch.cuda.is_available():
        from polars_tpu_torch.errors import ComputeError

        raise ComputeError(
            "no CUDA device is available; pass device='cpu' (or call "
            "polars_tpu_torch.set_default_device('cpu')) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
