"""The training matrix assembled on the device from the shard store (the
JAX package's `datastore/assemble.py`, in torch).

The growers read one feature-major [F, N] (or bundled [G, N]) matrix;
the store holds it as row shards.  `assemble_feature_major` allocates
the matrix on the device once and copies each shard into its column
slice as the prefetcher delivers it: the shard's block into a pinned
staging buffer, then an asynchronous copy to the device.  Two staging
buffers alternate; a CUDA event recorded after each copy is waited on
before its buffer is filled again, so a buffer is never rewritten under
a copy still reading it.  On the CPU the blocks are copied in directly.
The codes are the in-memory matrix's, so the growers train the same
trees.

Telemetry, under the JAX package's names: a `train.shard` span a shard,
the `datastore.prefetch.hit` / `.stall` counters and the
`datastore.peak_resident_mb` gauge (the host bytes the prefetch pipeline
held at its widest).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from ..utils.log import LightGBMError
from .prefetch import ShardPrefetcher

#: staging buffers that alternate between shards
STAGING_BUFFERS = 2


def assemble_feature_major(store, device, payload: str = "bins",
                           prefetch_depth: int = 2,
                           run_stats=None) -> torch.Tensor:
    """`payload`'s shards of `store` as one [F|G, N] uint8 or uint16
    tensor (the manifest's dtype) on `device`.  `run_stats`, a
    `PrefetchRunStats`, adds this pass's hits and stalls to the run's
    and makes the gauge the run's largest residency."""
    n_cols = store.payload_cols(payload)
    if n_cols <= 0:
        raise LightGBMError(
            f"datastore has no '{payload}' payload to assemble")
    device = torch.device(device)
    out = torch.from_numpy(np.zeros(0, store.dtype)).to(device).new_empty(
        (n_cols, store.n_rows))
    # the copies move uint16 codes as int16, the same bytes
    carrier = np.int16 if store.dtype == np.uint16 else np.uint8
    out_c = out.view(torch.from_numpy(np.zeros(0, carrier)).dtype)
    cuda = device.type == "cuda"
    staging = []
    if cuda:
        cells = n_cols * max(store.rows_of(k) for k in range(store.n_shards)) \
            if store.n_shards else 0
        staging = [(torch.empty(cells, dtype=out_c.dtype, pin_memory=True),
                    None) for _ in range(STAGING_BUFFERS)]
    hit = telemetry.REGISTRY.counter("datastore.prefetch.hit")
    stall = telemetry.REGISTRY.counter("datastore.prefetch.stall")

    def on_hit():
        hit.inc()
        if run_stats is not None:
            run_stats.hit()

    def on_stall():
        stall.inc()
        if run_stats is not None:
            run_stats.stall()

    if run_stats is not None:
        run_stats.start_pass()
    pf = ShardPrefetcher(store, payload=payload, depth=prefetch_depth,
                         on_hit=on_hit, on_stall=on_stall)
    try:
        for i, (k, row0, block) in enumerate(pf):
            rows = int(block.shape[-1])
            with telemetry.span("train.shard", shard=k, rows=rows,
                                payload=payload):
                src = torch.from_numpy(block.view(carrier))
                if not cuda:
                    out_c[:, row0:row0 + rows].copy_(src)
                    continue
                buf, done = staging[i % STAGING_BUFFERS]
                if done is not None:
                    done.synchronize()   # its last copy has read it
                host = buf[:n_cols * rows].view(n_cols, rows)
                host.copy_(src)
                dev = torch.empty((n_cols, rows), dtype=out_c.dtype,
                                  device=device)
                dev.copy_(host, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                staging[i % STAGING_BUFFERS] = (buf, done)
                out_c[:, row0:row0 + rows].copy_(dev)
        for _, done in staging:
            if done is not None:
                done.synchronize()
    finally:
        pf.close()
        peak = pf.peak_resident_bytes
        if run_stats is not None:
            run_stats.absorb(pf)
            peak = run_stats.peak_resident_bytes
        telemetry.REGISTRY.gauge("datastore.peak_resident_mb").set(
            round(peak / (1024.0 * 1024.0), 3))
    return out
