"""Carry a trained model across from plain numpy arrays.

Model text is one route into the port (`Booster(model_str=...)`); this
is the other.  Each tree is a dict of the numpy arrays a JAX
`lightgbm_tpu` `Booster.trees[i]` holds, so a caller that has both
packages can hand a model over without a text round trip, and without
this package importing the other.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .booster import Booster
from .objectives import parse_objective
from .tree import Tree

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
