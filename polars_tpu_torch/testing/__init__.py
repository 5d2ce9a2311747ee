"""Data generators, reference queries and the frame and Series asserts."""

from polars_tpu_torch.testing.asserts import (
    assert_frame_equal,
    assert_frame_not_equal,
    assert_series_equal,
    assert_series_not_equal,
)

__all__ = ["assert_frame_equal", "assert_frame_not_equal", "assert_series_equal", "assert_series_not_equal"]
