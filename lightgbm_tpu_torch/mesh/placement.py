"""Row and feature blocks of the ranks, and their placement.

The port's counterpart of `lightgbm_tpu/mesh/placement.py`
(`padded_feature_count` `:37`, `padded_row_count` `:41`,
`collective_span` `:98`, `emit_collective_round` `:122`,
`stream_shard_plan` `:142`, `place_from_datastore` `:181`).

Rows: rank p of S holds the block [p * R, min((p + 1) * R, N)) with
R = ceil(N / S), the reference's shard of its padded row count; the
last block is short and needs no pad rows, since a rank may hold fewer
rows than another.  Features (the block modes): rank p searches
[p * B, min((p + 1) * B, F)) with B = ceil(F / S), the reference's
blocks without its never-allowed pad columns.

A rank places on its device only its own rows' bins (`place_rows`);
a spilled set's rank reads only the store shards that hold its rows
(`place_from_datastore`), so no rank assembles the whole matrix.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..utils.log import LightGBMError


def padded_feature_count(num_feature: int, shards: int) -> int:
    return -(-num_feature // shards) * shards


def padded_row_count(num_data: int, shards: int) -> int:
    return -(-num_data // shards) * shards


def row_block(num_data: int, shards: int, pos: int) -> Tuple[int, int]:
    """[lo, hi) of rank `pos`'s rows."""
    per = padded_row_count(num_data, shards) // shards
    return min(pos * per, num_data), min((pos + 1) * per, num_data)


def row_counts(num_data: int, shards: int) -> List[int]:
    """Rows of each rank's block."""
    return [hi - lo for lo, hi in (row_block(num_data, shards, p)
                                   for p in range(shards))]


def feature_block(num_feature: int, shards: int,
                  pos: int) -> Tuple[int, int]:
    """[lo, hi) of rank `pos`'s feature block."""
    per = padded_feature_count(num_feature, shards) // shards
    return min(pos * per, num_feature), min((pos + 1) * per, num_feature)


def collective_span(name: str, **attrs):
    """The `mesh.collective.<name>` span of a host-driven phase
    (placement, replication)."""
    return telemetry.span(f"mesh.collective.{name}", **attrs)


def place_rows(bins_nf: np.ndarray, lo: int, hi: int,
               device) -> torch.Tensor:
    """Rows [lo, hi) of an [N, F] host bin matrix as [F, hi - lo] on
    `device` (the reference's `place_training_data` for one rank)."""
    with collective_span("place", rows=hi - lo, cols=bins_nf.shape[1]):
        block = np.ascontiguousarray(np.asarray(bins_nf)[lo:hi].T)
        return torch.from_numpy(block).to(device)


def stream_shard_plan(store, lo: int = 0,
                      hi: Optional[int] = None) -> List[tuple]:
    """(shard, shard-relative row selection or None) of the store shards
    that hold rows [lo, hi), ascending (the reference's
    `stream_shard_plan` for one device)."""
    hi = store.n_rows if hi is None else hi
    plan = []
    for k in range(store.n_shards):
        row0, rk = store.row0_of(k), store.rows_of(k)
        a, b = max(row0, lo), min(row0 + rk, hi)
        if b <= a:
            continue
        rel = None if (a == row0 and b == row0 + rk) \
            else np.arange(a - row0, b - row0)
        plan.append((k, rel))
    return plan


def place_from_datastore(store, lo: int, hi: int, device,
                         payload: str = "bins", prefetch_depth: int = 2,
                         run_stats=None) -> torch.Tensor:
    """Rows [lo, hi) of `payload` as [F|G, hi - lo] on `device`, read
    from only the store shards that hold them, through the bounded
    prefetcher (the reference's `place_from_datastore` for this rank):
    the host never holds more than the read-ahead window."""
    from ..datastore.prefetch import ShardPrefetcher
    f = store.payload_cols(payload)
    if f <= 0:
        raise LightGBMError(f"datastore has no '{payload}' payload to place")
    dtype = np.uint16 if store.dtype == np.uint16 else np.uint8
    host = np.zeros((f, hi - lo), dtype=dtype)
    plan = stream_shard_plan(store, lo, hi)
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
                         plan=plan, on_hit=on_hit, on_stall=on_stall)
    t0 = time.perf_counter()
    with collective_span("place", rows=hi - lo, cols=f, shards=len(plan),
                         payload=payload):
        try:
            for (k, rel), (_, row0, block) in zip(plan, pf):
                a = row0 if rel is None else row0 + int(rel[0])
                host[:, a - lo:a - lo + block.shape[1]] = block
        finally:
            pf.close()
            if run_stats is not None:
                run_stats.absorb(pf)
        out = torch.from_numpy(host).to(device)
    telemetry.REGISTRY.timing("mesh.collective.place").observe(
        time.perf_counter() - t0)
    telemetry.MEMLEDGER.assign("datastore.place", [out])
    return out
