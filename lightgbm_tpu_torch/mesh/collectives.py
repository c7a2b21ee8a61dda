"""The collectives of the distributed growers, counted and timed.

Where the reference's sharded growers call a JAX collective inside one
SPMD program (`lightgbm_tpu/ops/grow.py:520-670`, `:730-794`;
`ops/grow_wave.py:244-340`), the port's host-driven growers call these:

  psum                      -> `all_reduce_sum`
  ppermute (ring hops)      -> `ring_fold`: `recv_tensors`, the fold,
                               `send_tensors`, in rank order
  all_gather(...)[S - 1]    -> `broadcast_last`
  pmax / pmin split merge   -> `merge_split`: an all_gather of each
                               rank's packed split record, then the
                               highest gain, ties to the lowest rank
  psum_scatter              -> `all_reduce_sum`, then this rank's block
  all_gather (leaf ids)     -> `all_gather_rows`

Under gloo a collective over CUDA tensors goes through pinned host
buffers: the device-to-host copy, the collective, the host-to-device
copy, each timed as its own stage.  Under NCCL the CUDA tensors go to
the collective directly.  `STATS[name]` counts each collective's calls
and payload bytes and sums the three stages' seconds (host clock; the
copies are synchronous, so the device work queued before a collective
lands in its d2h stage).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from .topology import backend

#: per collective: calls, payload bytes (one rank's send), and the
#: seconds of the D2H copy, the collective itself and the H2D copy
STATS: Dict[str, Dict[str, float]] = {}


def reset_stats() -> None:
    STATS.clear()


def _stat(name: str) -> Dict[str, float]:
    s = STATS.get(name)
    if s is None:
        s = STATS[name] = {"calls": 0, "bytes": 0, "d2h_s": 0.0,
                           "comm_s": 0.0, "h2d_s": 0.0}
    return s


def _staged(t: torch.Tensor) -> bool:
    """Whether `t` goes through the host: a CUDA tensor under gloo."""
    return t.is_cuda and backend() != "nccl"


def _down(t: torch.Tensor, st) -> torch.Tensor:
    if not _staged(t):
        return t
    t0 = time.perf_counter()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    st["d2h_s"] += time.perf_counter() - t0
    return host


def _up(dst: torch.Tensor, host: torch.Tensor, st) -> None:
    if host is dst:
        return
    t0 = time.perf_counter()
    dst.copy_(host)
    st["h2d_s"] += time.perf_counter() - t0


def _comm(st, fn) -> None:
    t0 = time.perf_counter()
    fn()
    st["comm_s"] += time.perf_counter() - t0


def all_reduce_sum(t: torch.Tensor, group, name: str = "all_reduce"
                   ) -> torch.Tensor:
    """`t` summed over `group`'s ranks, in place (the reference's
    `psum`).  With two ranks every element is one add, so the result is
    the reference's bit for bit."""
    st = _stat(name)
    st["calls"] += 1
    st["bytes"] += t.numel() * t.element_size()
    h = _down(t, st)
    _comm(st, lambda: dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group))
    _up(t, h, st)
    return t


def broadcast(t: torch.Tensor, src: int, group,
              name: str = "broadcast") -> torch.Tensor:
    """`t` from global rank `src` on every rank of `group`, in place."""
    st = _stat(name)
    st["calls"] += 1
    st["bytes"] += t.numel() * t.element_size()
    h = _down(t, st)
    _comm(st, lambda: dist.broadcast(h, src=int(src), group=group))
    _up(t, h, st)
    return t


def broadcast_last(t: torch.Tensor, ranks: Sequence[int], group,
                   name: str = "broadcast_last") -> torch.Tensor:
    """The last rank's `t` on every rank (the reference's
    `all_gather(x)[S - 1]`)."""
    return broadcast(t, ranks[-1], group, name)


def all_gather(t: torch.Tensor, group, n: int,
               name: str = "all_gather") -> torch.Tensor:
    """[n, ...] every rank's `t` (the same shape on each), in rank
    order."""
    st = _stat(name)
    st["calls"] += 1
    st["bytes"] += t.numel() * t.element_size()
    h = _down(t.contiguous(), st)
    out = [torch.empty_like(h) for _ in range(n)]
    _comm(st, lambda: dist.all_gather(out, h, group=group))
    res = torch.stack(out)
    if res.device != t.device:
        dst = torch.empty(res.shape, dtype=res.dtype, device=t.device)
        _up(dst, res, st)
        return dst
    return res


def all_gather_rows(t: torch.Tensor, counts: Sequence[int], group,
                    name: str = "all_gather_rows") -> torch.Tensor:
    """The ranks' row blocks of `t` (rank r holds counts[r] rows, the
    blocks ascending) as one tensor of sum(counts) rows: each block
    padded to the largest, gathered, the padding dropped."""
    m = max(int(c) for c in counts)
    pad = m - t.shape[0]
    tp = t if pad == 0 else torch.cat(
        [t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    got = all_gather(tp, group, len(counts), name)
    return torch.cat([got[r, :int(c)] for r, c in enumerate(counts)])


def send_tensors(ts: List[torch.Tensor], dst: int, group,
                 name: str = "ring_fold") -> None:
    """Each of `ts` to global rank `dst` (one hop of the ring)."""
    st = _stat(name)
    st["calls"] += 1
    for t in ts:
        st["bytes"] += t.numel() * t.element_size()
        h = _down(t.contiguous(), st)
        _comm(st, lambda: dist.send(h, dst=int(dst), group=group))


def recv_tensors(ts: List[torch.Tensor], src: int, group,
                 name: str = "ring_fold") -> None:
    """`ts` in place from global rank `src`, in the order sent."""
    st = _stat(name)
    for t in ts:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) \
            if _staged(t) else t
        _comm(st, lambda: dist.recv(h, src=int(src), group=group))
        _up(t, h, st)


def ring_fold(state: List[torch.Tensor], fold: Callable[[], None],
              ranks: Sequence[int], pos: int, group) -> None:
    """One pass of the ring in rank order (the reference's chain of
    `ppermute`s, `ops/grow.py:592-670`): the carry `state` is received in
    place from the rank before (all but the first rank), `fold()` adds
    this rank's rows to it, and it is sent on (all but the last).  Only
    the last rank then holds the sum over every rank."""
    if pos > 0:
        recv_tensors(state, ranks[pos - 1], group)
    fold()
    if pos < len(ranks) - 1:
        send_tensors(state, ranks[pos + 1], group)


def merge_split(packed: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, C] the winning rows of the ranks' packed split records
    (`SplitResult.pack`, gain in column 0): per row the highest gain,
    ties to the lowest rank (the reference's
    `_merge_split_across_shards`: pmax, then pmin of the rank whose gain
    reaches it)."""
    got = all_gather(packed, group, n, "merge_split")      # [n, B, C]
    gains = got[:, :, 0]
    best = gains.max(dim=0).values
    win = torch.argmax((gains >= best[None]).to(torch.int32), dim=0)
    rows = torch.arange(packed.shape[0], device=packed.device)
    return got[win, rows]
