"""A data-parallel boosting step over the ranks of a mesh.

The port's counterpart of `lightgbm_tpu/parallel/data_parallel.py`
(`shard_dataset` `:38`, `make_sharded_train_step` `:71`; ref:
data_parallel_tree_learner.cpp).  The reference runs one iteration as
one SPMD program; here every rank runs the same host-driven step: the
gradients of the replicated scores, the distributed grower over this
rank's rows (`learner.py`), the replicated score update.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..mesh.placement import place_rows, row_block
from ..ops.grow import GrowerSpec
from .learner import make_distributed_grower


def shard_dataset(bins_nf: np.ndarray, label: np.ndarray, mesh,
                  weight: Optional[np.ndarray] = None, device="cpu"):
    """(this rank's bins [F, rows] on `device`, label [N] f32, weight [N]
    f32, 0): the rank's row block of the bins, the [N] vectors
    replicated; no pad rows, since the blocks may be uneven."""
    n = bins_nf.shape[0]
    lo, hi = row_block(n, mesh.size, mesh.pos)
    w = weight if weight is not None else np.ones(n, np.float32)
    return (place_rows(bins_nf, lo, hi, device),
            torch.from_numpy(np.asarray(label, np.float32)).to(device),
            torch.from_numpy(np.asarray(w, np.float32)).to(device), 0)


def make_sharded_train_step(spec: GrowerSpec, mesh, grad_fn: Callable,
                            learning_rate: float, det_reduce: bool = True,
                            num_data: int = 0, num_feature: int = 0,
                            kind: str = "data"):
    """step(score, label, weight, bins_fm, feat, allowed) -> (new_score,
    DeviceTree): `grad_fn(score, label) -> (grad, hess)` elementwise and
    unweighted (the grower weights the payload once), the tree grown
    over the ranks, `score + leaf_value[leaf_id] * learning_rate`."""
    grow = make_distributed_grower(spec, mesh, kind, num_feature, num_data,
                                   det_reduce=det_reduce)

    def step(score, label, weight, bins_fm, feat, allowed):
        grad, hess = grad_fn(score, label)
        dev = grow(bins_fm, grad.to(torch.float32), hess.to(torch.float32),
                   weight, feat, allowed)
        return score + dev.values[dev.leaf_id.long()] * learning_rate, dev

    return step
