"""Serving: the compiled runtime (`ServingRuntime`) and row buckets."""
from .runtime import DEFAULT_MAX_BATCH_ROWS, ServingRuntime, bucket_rows

__all__ = ["DEFAULT_MAX_BATCH_ROWS", "ServingRuntime", "bucket_rows"]
