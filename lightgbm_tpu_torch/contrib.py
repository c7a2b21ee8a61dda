"""TreeSHAP feature contributions (`pred_contrib=True`).

The port's copy of `lightgbm_tpu/contrib.py`, on the port's `Tree`: the
reference's SHAP path (ref: src/boosting/gbdt_prediction.cpp
`GBDT::PredictContrib` -> src/io/tree.cpp `Tree::TreeSHAP` /
`TreeSHAPByMap`, the Lundberg & Lee polynomial-time path algorithm with
EXTEND/UNWIND over the unique-feature path).  Output layout matches the
reference: [n_rows, (n_features+1) * num_class] with the per-class bias
(expected value) in the last column of each class block.

Host-side numpy: SHAP is an analysis tool, not the training hot loop.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .tree import K_CATEGORICAL_MASK, Tree


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, f=-1, z=0.0, o=0.0, w=0.0):
        self.feature_index = f
        self.zero_fraction = z
        self.one_fraction = o
        self.pweight = w

    def copy(self):
        return _PathElement(self.feature_index, self.zero_fraction,
                            self.one_fraction, self.pweight)


def _extend(path: List[_PathElement], unique_depth: int, zero_fraction: float,
            one_fraction: float, feature_index: int) -> None:
    path[unique_depth].feature_index = feature_index
    path[unique_depth].zero_fraction = zero_fraction
    path[unique_depth].one_fraction = one_fraction
    path[unique_depth].pweight = 1.0 if unique_depth == 0 else 0.0
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1) \
            / (unique_depth + 1)
        path[i].pweight = zero_fraction * path[i].pweight \
            * (unique_depth - i) / (unique_depth + 1)


def _unwind(path: List[_PathElement], unique_depth: int, path_index: int) -> None:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction \
                * (unique_depth - i) / (unique_depth + 1)
        else:
            path[i].pweight = path[i].pweight * (unique_depth + 1) \
                / (zero_fraction * (unique_depth - i))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction


def _unwound_sum(path: List[_PathElement], unique_depth: int,
                 path_index: int) -> float:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction \
                * ((unique_depth - i) / (unique_depth + 1))
        else:
            total += path[i].pweight / (zero_fraction
                                        * ((unique_depth - i)
                                           / (unique_depth + 1)))
    return total


def _tree_shap(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int,
               unique_depth: int, parent_path: List[_PathElement],
               parent_zero_fraction: float, parent_one_fraction: float,
               parent_feature_index: int) -> None:
    """ref: src/io/tree.cpp `Tree::TreeSHAP` recursion."""
    path = [p.copy() for p in parent_path[:unique_depth]] + \
           [_PathElement() for _ in range(tree.num_leaves + 2 - unique_depth)]
    _extend(path, unique_depth, parent_zero_fraction, parent_one_fraction,
            parent_feature_index)

    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, unique_depth + 1):
            w = _unwound_sum(path, unique_depth, i)
            el = path[i]
            phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction) \
                * tree.leaf_value[leaf]
        return

    # internal node
    f = int(tree.split_feature[node])
    fval = x[f]
    if tree.decision_type[node] & K_CATEGORICAL_MASK:
        go_left = bool(tree._decide_left_cat(np.array([node]),
                                             np.array([fval]))[0])
    else:
        go_left = bool(tree._decide_left(np.array([node]),
                                         np.array([fval]))[0])
    hot = tree.left_child[node] if go_left else tree.right_child[node]
    cold = tree.right_child[node] if go_left else tree.left_child[node]

    def weight_of(child):
        if child < 0:
            return tree.leaf_weight[~child]
        return tree.internal_weight[child]

    node_weight = tree.internal_weight[node]
    hot_zero = weight_of(hot) / node_weight if node_weight > 0 else 0.0
    cold_zero = weight_of(cold) / node_weight if node_weight > 0 else 0.0
    incoming_zero, incoming_one = 1.0, 1.0
    path_index = 0
    while path_index <= unique_depth:
        if path[path_index].feature_index == f:
            break
        path_index += 1
    if path_index != unique_depth + 1:
        incoming_zero = path[path_index].zero_fraction
        incoming_one = path[path_index].one_fraction
        _unwind(path, unique_depth, path_index)
        unique_depth -= 1

    _tree_shap(tree, x, phi, hot, unique_depth + 1, path,
               hot_zero * incoming_zero, incoming_one, f)
    _tree_shap(tree, x, phi, cold, unique_depth + 1, path,
               cold_zero * incoming_zero, 0.0, f)


def _expected_value(tree: Tree) -> float:
    """Weighted average of leaf values (the SHAP bias term)."""
    if tree.num_leaves <= 1:
        return float(tree.leaf_value[0]) if len(tree.leaf_value) else 0.0
    w = tree.leaf_weight[:tree.num_leaves]
    tot = w.sum()
    if tot <= 0:
        return float(np.mean(tree.leaf_value[:tree.num_leaves]))
    return float(np.dot(tree.leaf_value[:tree.num_leaves], w) / tot)


def predict_contrib(X: np.ndarray, trees: List[Tree],
                    num_tree_per_iteration: int) -> np.ndarray:
    n, f = X.shape
    K = max(num_tree_per_iteration, 1)
    out = np.zeros((n, K * (f + 1)), dtype=np.float64)
    for ti, tree in enumerate(trees):
        k = ti % K
        base = k * (f + 1)
        ev = _expected_value(tree)
        out[:, base + f] += ev
        if tree.num_leaves <= 1:
            continue
        for r in range(n):
            phi = np.zeros(f + 1)
            _tree_shap(tree, X[r], phi, 0, 0, [], 1.0, 1.0, -1)
            out[r, base:base + f] += phi[:f]
            # local-accuracy correction is implicit: phi sums to
            # prediction - expected_value by construction
    return out
