"""Device buffer: a tensor of exactly ``length`` rows, an optional validity
tensor and the device they live on.

The port of ``polars_tpu/core/buffer.py``. The JAX package pads every array
to a power of two (``padded_size``/``pad_to``) so that XLA sees few static
shapes; PyTorch runs eagerly, so tensors here have their exact length and a
row mask exists only between a filter and its compaction. The packed-word
host ingest of the JAX package serves its TPU's host link and has no
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch


class Buffer:
    """Values + validity (bool, None = all valid) + length, on ``device``."""

    __slots__ = ("values", "validity", "length", "device")

    def __init__(self, values: torch.Tensor, validity: torch.Tensor | None, length: int | None = None) -> None:
        n = values.shape[0] if length is None else int(length)
        if values.shape[0] != n or (validity is not None and validity.shape != (n,)):
            raise ValueError(f"Buffer of length {n} got tensors of {values.shape[0]} rows")
        if validity is not None and (validity.dtype != torch.bool or validity.device != values.device):
            raise TypeError("Buffer validity must be a bool tensor on the values' device")
        self.values = values
        self.validity = validity
        self.length = n
        self.device = values.device

    @staticmethod
    def from_numpy(values: np.ndarray, validity: np.ndarray | None, *, dtype: torch.dtype, device) -> Buffer:
        """Copy host arrays to ``device`` as ``dtype``; an all-true validity
        is dropped."""
        device = torch.device(device)

        def put(arr: np.ndarray) -> torch.Tensor:
            arr = np.ascontiguousarray(arr)
            host = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
            # the frame never aliases the caller's array
            return host.clone() if device.type == "cpu" else host.to(device)

        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        vals = put(np.asarray(values).astype(np_dtype, copy=False))
        valid = None
        if validity is not None:
            v = np.asarray(validity, dtype=bool)
            if not v.all():
                valid = put(v)
        return Buffer(vals, valid, vals.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def __len__(self) -> int:
        return self.length

    def __repr__(self) -> str:
        return (
            f"Buffer(len={self.length}, dtype={self.values.dtype}, device={self.device}, "
            f"has_validity={self.validity is not None})"
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray | None]:
        """(values, validity or None) on the host."""
        vals = self.values.cpu().numpy()
        if self.validity is None:
            return vals, None
        val = self.validity.cpu().numpy()
        if val.all():
            return vals, None
        return vals, val
