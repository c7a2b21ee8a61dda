"""The serving plane (the port's `lightgbm_tpu/serving/`):

  runtime.py  — `ServingRuntime`: the rung ladder, chosen by the model
                and the options; requests padded to power-of-two row
                buckets; every exact rung byte-identical to the JAX
                package's same rung.
  batcher.py  — `MicroBatcher`: bounded queue, max-rows/max-wait flush,
                deadline-based load shedding, worker restart.
  registry.py — `ModelRegistry`: multi-model, warm-up-on-load, atomic
                hot-swap, device-memory budget with LRU demotion.
  sharded.py  — `ShardedServingRuntime`: a runtime replica a device,
                requests striped by least outstanding work.
  client.py / http.py — the in-process `ServingClient` and the stdlib
                HTTP endpoint (`make_server`): /predict, /healthz,
                /metrics, /debug/requests.
"""
from .batcher import MicroBatcher, ServingClosedError, ServingOverloadError
from .client import ServingClient
from .http import make_server
from .registry import ModelRegistry, ServingModel
from .runtime import (DEFAULT_MAX_BATCH_ROWS, ServingDeviceError,
                      ServingRuntime, ServingUnavailableError, bucket_rows)
from .sharded import ShardedServingRuntime, resolve_shard_devices

__all__ = [
    "DEFAULT_MAX_BATCH_ROWS", "MicroBatcher", "ModelRegistry",
    "ServingClient", "ServingClosedError", "ServingDeviceError",
    "ServingModel", "ServingOverloadError", "ServingRuntime",
    "ServingUnavailableError", "ShardedServingRuntime", "bucket_rows",
    "make_server", "resolve_shard_devices",
]
