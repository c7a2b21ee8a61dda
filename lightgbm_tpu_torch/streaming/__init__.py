"""Shard-streamed training (the JAX package's `lightgbm_tpu/streaming/`):
trees grown from the shard store without the [F, N] bin matrix on the
device (`engine.py`)."""
from .engine import (StreamingWaveGrower, stream_shard_plan,
                     streaming_downgrade_reasons, streaming_spec)

__all__ = ["StreamingWaveGrower", "stream_shard_plan",
           "streaming_downgrade_reasons", "streaming_spec"]
