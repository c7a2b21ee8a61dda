"""Carry a trained model or a constructed dataset across from plain
numpy arrays.

Model text is one route into the port (`Booster(model_str=...)`); this
is the other.  `booster_from_numpy` takes each tree as a dict of the
numpy arrays a JAX `lightgbm_tpu` `Booster.trees[i]` holds;
`dataset_from_numpy` takes a constructed JAX `Dataset`'s bin matrix,
bin-mapper dicts, label and weight.  A caller that has both packages can
so hand a model or identical bins over, without this package importing
the other.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .basic import Dataset, _feature_names_from
from .booster import Booster
from .objectives import parse_objective
from .tree import Tree
from .utils.binning import BinMapper

#: per-tree fields read, with the dtype `tree.Tree` stores them in
_TREE_FIELDS = {
    "split_feature": np.int32, "threshold": np.float64,
    "decision_type": np.int32, "left_child": np.int32,
    "right_child": np.int32, "leaf_value": np.float64,
    "cat_boundaries": np.int64, "cat_threshold": np.uint32,
    "threshold_bin": np.int32,
}


def booster_from_numpy(trees: Sequence[Dict], num_tree_per_iteration: int,
                       objective: str, average_output: bool = False
                       ) -> Booster:
    """Build the port's `Booster` from per-tree numpy arrays.

    `trees[i]` holds `split_feature`, `threshold`, `decision_type`,
    `left_child`, `right_child`, `leaf_value`, `num_leaves`, `num_cat`,
    `cat_boundaries`, `cat_threshold` and `threshold_bin` (for a
    categorical node, its index into `cat_boundaries`).  `objective`
    is the model text's objective string, e.g. `"binary sigmoid:1"`.
    The booster's feature count is one past the largest split feature.
    """
    out: List[Tree] = []
    for d in trees:
        t = Tree(int(d["num_leaves"]))
        t.num_cat = int(d.get("num_cat", 0))
        for name, dt in _TREE_FIELDS.items():
            if name in d:
                setattr(t, name, np.array(d[name], dtype=dt))
        out.append(t)
    # an empty model text gives a booster with every field at its
    # default; the trees and the header fields are then set directly
    bst = Booster(model_str="")
    bst.trees = out
    bst.num_tree_per_iteration = int(num_tree_per_iteration)
    bst.objective_ = parse_objective(objective)
    bst._average_output = bool(average_output)
    nfeat = max((int(np.max(t.split_feature[:t.num_leaves - 1])) + 1
                 for t in out if t.num_leaves > 1), default=0)
    bst._loaded_feature_names = [f"Column_{i}" for i in range(nfeat)]
    return bst


def dataset_from_numpy(bin_data: np.ndarray, bin_mappers: Sequence[Dict],
                       label: Optional[np.ndarray] = None,
                       weight: Optional[np.ndarray] = None,
                       feature_names: Optional[Sequence[str]] = None,
                       params: Optional[Dict] = None,
                       group: Optional[np.ndarray] = None,
                       position: Optional[np.ndarray] = None) -> Dataset:
    """A constructed port `Dataset` from another package's binning.

    `bin_data` is the [N, F] uint8/uint16 bin matrix, `bin_mappers` the
    mappers as `BinMapper.to_dict()` dicts (the JAX package's
    `[m.to_dict() for m in ds.bin_mappers]`); `group` the query sizes
    (the JAX `ds.get_group()`) and `position` the per-row positions
    (`ds.get_position()`).  No binning runs and no bundle search: the
    dataset trains on exactly these bins."""
    bins = np.ascontiguousarray(bin_data)
    if bins.ndim != 2 or bins.dtype not in (np.uint8, np.uint16):
        raise ValueError("bin_data must be a 2-D uint8 or uint16 matrix")
    n, f = bins.shape
    mappers = [BinMapper.from_dict(d) for d in bin_mappers]
    if len(mappers) != f:
        raise ValueError(f"{len(mappers)} bin mappers for {f} features")
    ds = Dataset(None, label=label, weight=weight, group=group,
                 position=position,
                 feature_name=(list(feature_names) if feature_names
                               is not None else "auto"),
                 params=params)
    ds.bin_data = bins
    ds.bin_mappers = mappers
    ds.num_total_bin = sum(m.num_bin for m in mappers)
    ds._num_data, ds._num_feature = n, f
    ds._feature_names = _feature_names_from(None, f, ds.feature_name)
    ds._set_fields()
    ds._handle_constructed = True
    return ds
