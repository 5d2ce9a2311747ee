"""Fixed-width row encoding of small join keys (the port of
``polars_tpu/kernels/rowencode.py``: ``key_bit_width`` and ``pack_keys_64``).

A multi-column join key whose encoded columns fit 63 bits together packs into
one exact int64 word, so the join needs no hash and no verification. The
order-preserving word of one key (the JAX package's ``total_order_key``) is
``engine/cast.order_word``.
"""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt

_WIDTHS = {
    "Boolean": 2, "Int8": 9, "UInt8": 9, "Int16": 17, "UInt16": 17,
    "Int32": 33, "UInt32": 33, "Date": 33, "Float32": 33,
}


def key_bit_width(dtype: dt.DataType, table_size: int | None = None) -> int | None:
    """Upper bound on the encoded key width in bits, or None if 64 needed."""
    if isinstance(dtype, (dt.String, dt.Categorical, dt.Enum, dt.Binary)):
        n = max(table_size or 0, 1)
        return max(int(n + 1).bit_length(), 1) + 1  # +1 for null sentinel headroom
    return _WIDTHS.get(type(dtype).__name__)


def pack_keys_64(keys: list[torch.Tensor], validities: list, widths: list[int]) -> torch.Tensor:
    """Pack several small order-encoded keys (+ null sentinels) into one int64.

    The caller guarantees ``sum(widths) + len(keys) <= 63``. Each key is biased
    into the unsigned range of its width; slot 0 is null, so nulls sort first.
    """
    out = torch.zeros(keys[0].shape, dtype=torch.int64, device=keys[0].device)
    for k, v, w in zip(keys, validities, widths):
        slot = k.to(torch.int64) + ((1 << (w - 1)) + 1)
        if v is not None:
            slot = torch.where(v, slot, 0)
        out = (out << (w + 1)) | slot
    return out
