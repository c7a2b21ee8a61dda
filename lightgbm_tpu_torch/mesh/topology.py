"""Process groups and meshes over `torch.distributed`.

The port's counterpart of `lightgbm_tpu/mesh/topology.py` (`init` `:35`,
`get_mesh` `:62`, `get_mesh_2level` `:75`, `parse_mesh_shape` `:100`,
`build_mesh` `:128`, `describe` `:147`).  The reference runs one
controller a host over a JAX device mesh; the port runs one process a
rank (the reference's multi-controller path, `tests/mh_worker.py`):

 - `init` joins the process group: a TCP coordinator
   (`tcp://host:port`) or a file store (`file:///path`) that every rank
   names, the world size and this process's rank.  The backend is NCCL
   only where every rank has a GPU of its own, else gloo (CPU ranks, and
   ranks that share one GPU).  Every collective times out after
   `timeout_ms` (`mesh_collective_timeout_ms`; 60 s when unset), so a
   lost rank raises on the others instead of hanging them.
 - A `Mesh` is a process group, its global ranks and its axes: one axis
   ("data",) over the first S ranks, or two ("dcn", "ici") over an
   [n_dcn, n_ici] grid of them, with one group a row (an ICI slice) and
   one a column (the same position in every slice).
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils import log
from ..utils.log import LightGBMError

#: collective timeout when `mesh_collective_timeout_ms` is unset
DEFAULT_TIMEOUT_MS = 60_000.0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the process group (1 without one)."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if initialized() else 0


def backend() -> str:
    """The group's backend ("gloo", "nccl"), or "none"."""
    return str(dist.get_backend()) if initialized() else "none"


def default_backend(num_processes: int) -> str:
    """NCCL when every rank can have a GPU of its own on this host, else
    gloo: NCCL refuses two ranks on one device."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= max(int(num_processes), 1):
        return "nccl"
    return "gloo"


def rank_device(r: Optional[int] = None) -> torch.device:
    """The GPU of rank `r` (this rank by default): GPU r mod the GPUs
    visible, so ranks that outnumber the GPUs share them."""
    if not torch.cuda.is_available():
        raise LightGBMError("rank_device: torch sees no CUDA device")
    r = rank() if r is None else int(r)
    return torch.device("cuda", r % torch.cuda.device_count())


def _init_method(coordinator_address: str) -> str:
    a = str(coordinator_address)
    if "://" in a:
        return a
    if os.path.sep in a or a.startswith("."):
        return "file://" + os.path.abspath(a)
    return "tcp://" + a


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, *,
         backend: Optional[str] = None,
         timeout_ms: float = 0.0) -> None:
    """Join the process group (the reference's `init`; upstream's
    `machines` / `local_listen_port`).  `coordinator_address` is
    `host:port` or `tcp://host:port` (rank 0 listens there), or a file
    store path (`file:///path` or a path); every rank gives the same one,
    the world size `num_processes` and its own `process_id`.  Without an
    address the torch launcher's environment (`MASTER_ADDR`, `WORLD_SIZE`,
    `RANK`) is read.  Idempotent.  A rank whose peers are lost raises
    after `timeout_ms` (0: `DEFAULT_TIMEOUT_MS`)."""
    if initialized():
        return
    if not dist.is_available():
        raise LightGBMError("torch.distributed is not available")
    n = int(num_processes if num_processes is not None
            else os.environ.get("WORLD_SIZE", 1))
    r = int(process_id if process_id is not None
            else os.environ.get("RANK", 0))
    be = backend or default_backend(n)
    timeout = datetime.timedelta(
        milliseconds=float(timeout_ms) if timeout_ms and timeout_ms > 0
        else DEFAULT_TIMEOUT_MS)
    kw = dict(backend=be, world_size=n, rank=r, timeout=timeout)
    if coordinator_address is not None:
        kw["init_method"] = _init_method(coordinator_address)
    else:
        kw["init_method"] = "env://"
    if be == "nccl":
        torch.cuda.set_device(rank_device(r))
    dist.init_process_group(**kw)
    log.info(f"mesh.init: rank {r} of {n}, backend {be}")


def shutdown() -> None:
    """Leave the process group (the reference's `free_network`)."""
    if initialized():
        dist.destroy_process_group()


class Mesh:
    """Ranks of the process group laid out on named axes.  `ranks` [n]
    or [n_dcn, n_ici] holds global ranks; `group` spans all of them;
    `axis_groups[a]` is this rank's group along axis a (for one axis the
    whole mesh; for ("dcn", "ici"): its column and its row).  A rank not
    in the mesh has `pos` -1 and no axis groups."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, ...],
                 group, axis_groups: dict):
        self.ranks = np.asarray(ranks, np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(axis_names,
                                                self.ranks.shape)}
        self.group = group
        self.axis_groups = axis_groups
        flat = self.ranks.reshape(-1).tolist()
        me = rank()
        self.pos = flat.index(me) if me in flat else -1

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def member(self) -> bool:
        return self.pos >= 0

    def coords(self) -> Tuple[int, ...]:
        """This rank's index along each axis."""
        return tuple(int(i) for i in np.unravel_index(self.pos,
                                                      self.ranks.shape))

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's group along `axis`, in axis
        order."""
        k = self.axis_names.index(axis)
        idx = list(self.coords())
        idx[k] = slice(None)
        return [int(v) for v in self.ranks[tuple(idx)].reshape(-1)]


def _new_group(ranks: Sequence[int]):
    """A process group over `ranks` (every rank of the world must call
    this with the same list); the world group when it is the world."""
    ranks = [int(r) for r in ranks]
    if ranks == list(range(world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks=ranks)


def get_mesh(num_shards: int = 0, axis: str = "data",
             ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 1-D mesh over the first `num_shards` ranks (0: all).  Every rank
    of the world calls it, members or not."""
    rk = list(ranks) if ranks is not None else list(range(world_size()))
    if num_shards and num_shards > 0:
        if num_shards > len(rk):
            raise ValueError(f"num_shards={num_shards} exceeds visible "
                             f"ranks ({len(rk)})")
        rk = rk[:num_shards]
    g = _new_group(rk) if initialized() else None
    arr = np.array(rk, np.int64)
    mesh = Mesh(arr, (axis,), g, {})
    if mesh.member:
        mesh.axis_groups[axis] = g
    return mesh


def get_mesh_2level(n_dcn: int, n_ici: int = 0,
                    ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A ("dcn", "ici") mesh over [n_dcn, n_ici] ranks, slice-major: one
    group a slice (a row, the ICI axis) and one a position (a column, the
    DCN axis).  Every rank of the world calls it."""
    rk = list(ranks) if ranks is not None else list(range(world_size()))
    if n_ici <= 0:
        if len(rk) % n_dcn:
            raise ValueError(f"{len(rk)} ranks not divisible by "
                             f"n_dcn={n_dcn}")
        n_ici = len(rk) // n_dcn
    need = n_dcn * n_ici
    if need > len(rk):
        raise ValueError(f"mesh {n_dcn}x{n_ici} exceeds visible ranks "
                         f"({len(rk)})")
    arr = np.array(rk[:need], np.int64).reshape(n_dcn, n_ici)
    g = _new_group(arr.reshape(-1).tolist())
    rows = [_new_group(arr[i].tolist()) for i in range(n_dcn)]
    cols = [_new_group(arr[:, j].tolist()) for j in range(n_ici)]
    mesh = Mesh(arr, ("dcn", "ici"), g, {})
    if mesh.member:
        i, j = mesh.coords()
        mesh.axis_groups["ici"] = rows[i]
        mesh.axis_groups["dcn"] = cols[j]
    return mesh


def parse_mesh_shape(value: Union[str, int, None]
                     ) -> Optional[Tuple[int, ...]]:
    """The `mesh_shape` param: "8" -> (8,), "2x4" -> (2, 4), empty, None,
    0 or "auto" -> None (the reference's `parse_mesh_shape`)."""
    if value is None:
        return None
    if isinstance(value, int):
        return (value,) if value > 0 else None
    s = str(value).strip().lower()
    if not s or s in ("0", "auto", "none"):
        return None
    for sep in ("x", "*", ","):
        s = s.replace(sep, " ")
    try:
        dims = tuple(int(p) for p in s.split())
    except ValueError:
        raise ValueError(f"mesh_shape={value!r} is not of the form "
                         f"'N' or 'DxI'")
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"mesh_shape={value!r} must use positive dims")
    if len(dims) > 2:
        raise ValueError(f"mesh_shape={value!r}: at most 2 mesh levels "
                         f"(dcn x ici) are supported")
    return dims


def build_mesh(mesh_shape: Union[str, int, None] = None,
               num_shards: int = 0, dcn_slices: int = 0) -> Mesh:
    """One resolver for every mesh (the reference's `build_mesh`): an
    explicit `mesh_shape` wins, then `dcn_slices > 1` a 2-level mesh,
    else a 1-D mesh of `num_shards` ranks (0: all)."""
    dims = parse_mesh_shape(mesh_shape)
    if dims is not None:
        if len(dims) == 2:
            return get_mesh_2level(dims[0], dims[1])
        return get_mesh(dims[0])
    if dcn_slices and dcn_slices > 1:
        return get_mesh_2level(dcn_slices)
    return get_mesh(num_shards)


def describe(mesh: Mesh) -> dict:
    """A telemetry summary of a mesh."""
    return {"axes": dict(mesh.shape), "n_ranks": mesh.size,
            "backend": backend(), "ranks": mesh.ranks.reshape(-1).tolist()}
