"""External memory: a binned Dataset spilled to checksummed row shards on
disk, and assembled back into the training matrix on the device (the
port's copy of `lightgbm_tpu/datastore/`).

`ShardWriter` spills a binned Dataset, or the two_round ingest's chunks,
into shards; `ShardStore` reads them back through memory maps, each
shard's crc32 checked on its first read; `ShardPrefetcher` reads ahead
on a thread; `assemble_feature_major` (assemble.py) copies the shards
into the [F|G, N] matrix on the training device.  The on-disk format is
the JAX package's, byte for byte, so either package reads the other's
store.  The shard-streamed grower, which trains without assembling,
reads the store through the same prefetcher (`streaming/engine.py`).
"""
from .format import (FORMAT_NAME, FORMAT_VERSION, MANIFEST_NAME, PAYLOADS,
                     read_manifest)
from .prefetch import PrefetchRunStats, ShardPrefetcher
from .store import PIPELINE_SLACK_BLOCKS, ShardStore, ShardWriter, \
    auto_shard_rows

__all__ = [
    "FORMAT_NAME", "FORMAT_VERSION", "MANIFEST_NAME", "PAYLOADS",
    "PIPELINE_SLACK_BLOCKS", "PrefetchRunStats", "ShardPrefetcher",
    "ShardStore", "ShardWriter", "auto_shard_rows", "read_manifest",
]
