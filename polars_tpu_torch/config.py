"""Process-wide configuration: the dense group-by's capacity limit, the
size above which a String dictionary keeps its order of first occurrence
(:func:`config`), the default device of the port's entry points, and the
table repr's limits (:class:`Config`).

Entry points place data on ``cuda`` unless the caller asks for the CPU, either
per frame (``DataFrame(..., device="cpu")``) or for the process through
:func:`set_default_device`. Asking for ``cuda`` where PyTorch sees no CUDA
device raises; nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import torch

# Largest key domain the dense (perfect-hash) group-by takes: the JAX
# package's default hot table (4096 entries, polars_tpu/config.py:46) x 16
DENSE_MAX_CAP = 4096 * 16

# ``ordinal_dict_max``: a String dictionary of at most this many values is
# sorted at ingest (code order is lexicographic order); a larger one keeps
# the order of first occurrence and is sorted on the host only when an
# ordering operation first reads it (``StringTable.ordinal``). The JAX
# package's default and variable (polars_tpu/config.py:46-54).
# ``random_seed``: the seed of a ``sample``/``shuffle`` that passes none
# (``set_random_seed``); None draws a fresh one each call.
_CONFIG = SimpleNamespace(ordinal_dict_max=int(os.environ.get("POLARS_TPU_ORDINAL_DICT_MAX", 1 << 16)),
                          random_seed=None)


def config() -> SimpleNamespace:
    """The process's settings (``ordinal_dict_max``, ``random_seed``)."""
    return _CONFIG

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


def _fmt_defaults() -> dict:
    return {"fmt_max_rows": int(os.environ.get("POLARS_FMT_MAX_ROWS", 10)),
            "fmt_max_cols": int(os.environ.get("POLARS_FMT_MAX_COLS", 8)),
            "fmt_str_len": int(os.environ.get("POLARS_FMT_STR_LEN", 30))}


_FMT = SimpleNamespace(**_fmt_defaults())


def fmt_config() -> SimpleNamespace:
    """The repr's limits: rows, columns, characters of a string."""
    return _FMT


class Config:
    """The repr's limits (the JAX package's ``Config``, trimmed to them); as
    a context manager, the defaults come back at its end."""

    def __init__(self, **options: int) -> None:
        for k, v in options.items():
            setter = getattr(self, f"set_{k}", None)
            if setter is None:
                raise ValueError(f"unknown Config option {k!r}")
            setter(v)

    def __enter__(self) -> Config:
        return self

    def __exit__(self, *exc: object) -> None:
        self.restore_defaults()

    @classmethod
    def set_tbl_rows(cls, n: int) -> type[Config]:
        _FMT.fmt_max_rows = n
        return cls

    @classmethod
    def set_tbl_cols(cls, n: int) -> type[Config]:
        _FMT.fmt_max_cols = n
        return cls

    @classmethod
    def set_fmt_str_lengths(cls, n: int) -> type[Config]:
        _FMT.fmt_str_len = n
        return cls

    @classmethod
    def restore_defaults(cls) -> type[Config]:
        _FMT.__dict__.update(_fmt_defaults())
        return cls
