from polars_tpu_torch.functions.lazy import col, len, lit  # noqa: A004

__all__ = ["col", "len", "lit"]
