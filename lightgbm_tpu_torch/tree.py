"""Flat-array decision tree + LightGBM model-text round-trip.

The port's copy of `lightgbm_tpu/tree.py`: the same flat arrays, text
format and host walk; `from_device` builds a tree from the port's
growers, numerical and categorical splits.

TPU-native re-design of the reference's tree container
(ref: include/LightGBM/tree.h `Tree` [flat arrays split_feature_/threshold_/
left_child_/right_child_/leaf_value_, negative child = ~leaf]; src/io/tree.cpp
`Tree::ToString`, `Tree(const char*)`; src/boosting/gbdt_model_text.cpp).

The same flat encoding as the reference is kept on purpose: the text model
format serializes these arrays directly, so keeping the layout makes the
format byte-level compatible and makes device-side traversal a simple gather
walk.  Child encoding: >= 0 → internal node index, < 0 → leaf index ~child.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .utils.binning import BinMapper
from .utils.log import LightGBMError

# decision_type bit layout (ref: include/LightGBM/tree.h kCategoricalMask /
# kDefaultLeftMask / GetMissingType)
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
# missing type in bits 2..3: 0=None, 1=Zero, 2=NaN

K_ZERO_THRESHOLD = 1e-35


def _fmt(x: float) -> str:
    """Number formatting for model text (ref: Common::ArrayToString with
    high precision for doubles)."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def _fmt_g(x: float) -> str:
    return f"{x:.17g}"


class Tree:
    """One decision tree, host-side numpy arrays."""

    def __init__(self, num_leaves: int):
        self.num_leaves = num_leaves
        ni = max(num_leaves - 1, 0)
        self.split_feature = np.zeros(ni, dtype=np.int32)
        self.threshold_bin = np.zeros(ni, dtype=np.int32)
        self.threshold = np.zeros(ni, dtype=np.float64)
        self.decision_type = np.zeros(ni, dtype=np.int32)
        self.left_child = np.zeros(ni, dtype=np.int32)
        self.right_child = np.zeros(ni, dtype=np.int32)
        self.split_gain = np.zeros(ni, dtype=np.float64)
        self.internal_value = np.zeros(ni, dtype=np.float64)
        self.internal_weight = np.zeros(ni, dtype=np.float64)
        self.internal_count = np.zeros(ni, dtype=np.float64)
        self.leaf_value = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_weight = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(num_leaves, dtype=np.float64)
        self.shrinkage = 1.0
        self.num_cat = 0
        # categorical split storage (ref: tree.h cat_boundaries_/cat_threshold_)
        self.cat_boundaries: np.ndarray = np.zeros(1, dtype=np.int64)
        self.cat_threshold: np.ndarray = np.zeros(0, dtype=np.uint32)
        # bin-level left-subset masks per cat split (training-side view used
        # by the device traversal; rebuilt from the bitset on model load)
        self.cat_bin_masks: np.ndarray = np.zeros((0, 0), dtype=bool)
        # linear trees (ref: tree.h is_linear_ / LinearTreeLearner):
        # leaf output = leaf_const + Σ leaf_coeff·x over leaf_features;
        # rows with NaN in any leaf feature fall back to leaf_value
        self.is_linear = False
        self.leaf_const = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_features: list = [[] for _ in range(num_leaves)]
        self.leaf_coeff: list = [[] for _ in range(num_leaves)]

    # ------------------------------------------------------------ construct
    @classmethod
    def from_device(cls, dev, bin_mappers: List[BinMapper],
                    shrinkage: float) -> "Tree":
        """Build a host Tree from a grown `ops.grow.DeviceTree` (the JAX
        package's `tree.py:81 Tree.from_device`).

        Child pointers are fixed up here: the grower records only
        (step -> split leaf); the reference's `Tree::Split` pointer
        surgery (the split leaf keeps its index as the left child, the
        new leaf step + 1 is the right child) is reproduced on the host.
        Real thresholds come from the bin mappers (`bin_to_value`), leaf
        values are the f32 outputs times the shrinkage, in f32.  A
        categorical split (`tree.py:143-177`) gets decision_type
        K_CATEGORICAL_MASK, its cat index as threshold, and the bitset
        of the raw categories of its left bins (`bin_2_categorical`)
        in `cat_threshold`, bounded by `cat_boundaries` (ref: tree.h
        `Tree::Split`, categorical overload)."""
        ns = int(dev.n_splits)
        nl = ns + 1
        t = cls(nl)
        t.shrinkage = shrinkage
        cat_masks = np.asarray(dev.split_cat_mask)[:ns]
        t.cat_bin_masks = np.zeros((0, cat_masks.shape[1] if ns else 0),
                                   dtype=bool)
        cat_bounds = [0]
        cat_words: List[np.ndarray] = []
        leaf_pos = {0: (-1, False)}
        for i in range(ns):
            leaf = int(dev.split_leaf[i])
            p, is_right = leaf_pos[leaf]
            if p >= 0:
                if is_right:
                    t.right_child[p] = i
                else:
                    t.left_child[p] = i
            t.left_child[i] = ~leaf
            t.right_child[i] = ~(i + 1)
            leaf_pos[leaf] = (i, False)
            leaf_pos[i + 1] = (i, True)
            f = int(dev.split_feature[i])
            m = bin_mappers[f]
            t.split_feature[i] = f
            if bool(dev.split_is_cat[i]):
                cats = [m.bin_2_categorical[b - 1]
                        for b in np.nonzero(cat_masks[i])[0] if b >= 1]
                n_words = (max(cats) // 32 + 1) if cats else 1
                words = np.zeros(n_words, dtype=np.uint32)
                for c in cats:
                    words[c // 32] |= np.uint32(1 << (c % 32))
                t.threshold_bin[i] = t.num_cat
                t.threshold[i] = float(t.num_cat)
                cat_words.append(words)
                cat_bounds.append(cat_bounds[-1] + n_words)
                t.cat_bin_masks = np.concatenate(
                    [t.cat_bin_masks, cat_masks[i][None, :]])
                t.num_cat += 1
                dt = K_CATEGORICAL_MASK
            else:
                t.threshold_bin[i] = int(dev.threshold_bin[i])
                t.threshold[i] = m.bin_to_value(int(dev.threshold_bin[i]))
                dt = (m.missing_type & 3) << 2
                if bool(dev.default_left[i]):
                    dt |= K_DEFAULT_LEFT_MASK
            t.decision_type[i] = dt
            t.split_gain[i] = float(dev.split_gain[i])
            ih = dev.internal_h[i]
            denom = ih if ih != 0 else 1.0
            t.internal_value[i] = float(-dev.internal_g[i] / denom) \
                * shrinkage
            t.internal_weight[i] = float(ih)
            t.internal_count[i] = float(dev.internal_cnt[i])
        if t.num_cat > 0:
            t.cat_boundaries = np.asarray(cat_bounds, dtype=np.int64)
            t.cat_threshold = np.concatenate(cat_words).astype(np.uint32)
        lv = np.asarray(dev.leaf_value, np.float32)[:nl]
        t.leaf_value = (lv * shrinkage).astype(np.float64)
        t.leaf_weight = np.asarray(dev.leaf_h)[:nl].astype(np.float64)
        t.leaf_count = np.asarray(dev.leaf_cnt)[:nl].astype(np.float64)
        return t

    def leaf_path_features(self) -> list:
        """Per-leaf NUMERICAL features on the root path, in path order
        (ref: linear_tree_learner.cpp gathers the branch features)."""
        paths = [[] for _ in range(self.num_leaves)]
        if not self.num_internal():
            return paths
        # iterative traversal — leaf-wise trees can be num_leaves deep,
        # which would blow Python's recursion limit
        stack = [(0, [])]
        while stack:
            node, feats = stack.pop()
            if node < 0:
                paths[~node] = feats
                continue
            f = int(self.split_feature[node])
            is_cat = (self.decision_type[node] & K_CATEGORICAL_MASK) != 0
            nf = feats if (is_cat or f in feats) else feats + [f]
            stack.append((int(self.left_child[node]), nf))
            stack.append((int(self.right_child[node]), nf))
        return paths

    def linear_predict(self, X: np.ndarray, leaf_idx: np.ndarray
                       ) -> np.ndarray:
        """Linear-leaf outputs for rows routed to `leaf_idx`
        (NaN in any leaf feature → constant fallback, ref: tree.cpp
        linear prediction path)."""
        out = np.empty(len(leaf_idx), dtype=np.float64)
        for leaf in range(self.num_leaves):
            rows = np.nonzero(leaf_idx == leaf)[0]
            if not len(rows):
                continue
            feats = self.leaf_features[leaf]
            if not feats:
                out[rows] = self.leaf_const[leaf]
                continue
            Xl = X[np.ix_(rows, feats)].astype(np.float64)
            ok = ~np.isnan(Xl).any(axis=1)
            vals = self.leaf_const[leaf] + \
                Xl @ np.asarray(self.leaf_coeff[leaf], np.float64)
            out[rows] = np.where(ok, vals, self.leaf_value[leaf])
        return out

    def add_bias(self, val: float) -> None:
        """ref: tree.h `Tree::AddBias` — folds boost_from_average init score
        into the (first) tree so the saved model is self-contained."""
        self.leaf_value = self.leaf_value + val
        if self.num_leaves > 1:
            self.internal_value = self.internal_value + val
        if self.is_linear:
            self.leaf_const = self.leaf_const + val

    # -------------------------------------------------------------- predict
    def _decide_left(self, node: np.ndarray, fval: np.ndarray) -> np.ndarray:
        """Vectorized NumericalDecision (ref: tree.h `Tree::NumericalDecision`)."""
        dt = self.decision_type[node]
        missing_type = (dt >> 2) & 3
        default_left = (dt & K_DEFAULT_LEFT_MASK) != 0
        thr = self.threshold[node]
        isnan = np.isnan(fval)
        fv = np.where(isnan & (missing_type != 2), 0.0, fval)
        is_missing = ((missing_type == 1) & (np.abs(fv) <= K_ZERO_THRESHOLD)) | \
                     ((missing_type == 2) & isnan)
        return np.where(is_missing, default_left, fv <= thr)

    def _decide_left_cat(self, node: np.ndarray, fval: np.ndarray) -> np.ndarray:
        """Vectorized CategoricalDecision (ref: tree.h `Tree::CategoricalDecision`:
        int category in the node's bitset → left)."""
        out = np.zeros(len(node), dtype=bool)
        # range-check in double space before narrowing: casting ±inf /
        # 1e300 to int64 is implementation-defined (numpy warns, C is UB)
        # — anything at or beyond int64 range can never be in a bitset,
        # so map it to the right-child sentinel first.  The lower bound
        # is EXCLUSIVE -1, not 0: the reference truncates toward zero
        # ((int)(-0.5) == 0, tree.h CategoricalDecision), so fractional
        # values in (-1, 0) test category 0.  Mirrors libnative.cpp.
        with np.errstate(invalid="ignore"):
            in_range = (fval > -1.0) & (fval < 2.0 ** 62)
        ival = np.where(in_range, fval, -1).astype(np.int64)
        for u in np.unique(node):
            sel = node == u
            cat_idx = self.threshold_bin[u]  # index into cat_boundaries
            lo = self.cat_boundaries[cat_idx]
            hi = self.cat_boundaries[cat_idx + 1]
            if hi <= lo:
                continue   # empty bitset span (loader-accepted): no
                # category can be in-set — every row routes right
            bitset = self.cat_threshold[lo:hi]
            v = ival[sel]
            ok = (v >= 0) & (v < (hi - lo) * 32)
            word = np.clip(v // 32, 0, hi - lo - 1)
            bit = v % 32
            inset = ok & ((bitset[word] >> bit) & 1).astype(bool)
            out[sel] = inset
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Batch raw-value prediction, vectorized over rows."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.full(n, self.leaf_value[0] if len(self.leaf_value) else 0.0)
        if self.is_linear:
            return self.linear_predict(X, self.predict_leaf_index(X))
        node = np.zeros(n, dtype=np.int64)
        out = np.zeros(n, dtype=np.float64)
        active = np.ones(n, dtype=bool)
        for _ in range(self.num_leaves):  # depth bound
            idx = np.nonzero(active)[0]
            if len(idx) == 0:
                break
            nd = node[idx]
            fv = X[idx, self.split_feature[nd]].astype(np.float64)
            is_cat = (self.decision_type[nd] & K_CATEGORICAL_MASK) != 0
            left = np.empty(len(idx), dtype=bool)
            if is_cat.any():
                left[is_cat] = self._decide_left_cat(nd[is_cat], fv[is_cat])
            ncat = ~is_cat
            if ncat.any():
                left[ncat] = self._decide_left(nd[ncat], fv[ncat])
            child = np.where(left, self.left_child[nd], self.right_child[nd])
            leaf = child < 0
            if leaf.any():
                li = idx[leaf]
                out[li] = self.leaf_value[~child[leaf]]
                active[li] = False
            node[idx[~leaf]] = child[~leaf]
        return out

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int64)
        res = np.zeros(n, dtype=np.int32)
        active = np.ones(n, dtype=bool)
        for _ in range(self.num_leaves):
            idx = np.nonzero(active)[0]
            if len(idx) == 0:
                break
            nd = node[idx]
            fv = X[idx, self.split_feature[nd]].astype(np.float64)
            is_cat = (self.decision_type[nd] & K_CATEGORICAL_MASK) != 0
            left = np.empty(len(idx), dtype=bool)
            if is_cat.any():
                left[is_cat] = self._decide_left_cat(nd[is_cat], fv[is_cat])
            if (~is_cat).any():
                left[~is_cat] = self._decide_left(nd[~is_cat], fv[~is_cat])
            child = np.where(left, self.left_child[nd], self.right_child[nd])
            leaf = child < 0
            if leaf.any():
                res[idx[leaf]] = ~child[leaf]
                active[idx[leaf]] = False
            node[idx[~leaf]] = child[~leaf]
        return res

    # ---------------------------------------------------------- model text
    def to_string(self, tree_idx: int) -> str:
        """ref: src/io/tree.cpp `Tree::ToString` field order."""
        lines = [f"Tree={tree_idx}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={self.num_cat}"]

        def arr(name, a, fmt=_fmt_g):
            lines.append(f"{name}=" + " ".join(fmt(v) for v in a))

        if self.num_leaves > 1:
            arr("split_feature", self.split_feature, str)
            arr("split_gain", self.split_gain)
            arr("threshold", self.threshold)
            arr("decision_type", self.decision_type, str)
            arr("left_child", self.left_child, str)
            arr("right_child", self.right_child, str)
            arr("leaf_value", self.leaf_value)
            arr("leaf_weight", self.leaf_weight)
            arr("leaf_count", self.leaf_count, lambda v: str(int(v)))
            arr("internal_value", self.internal_value)
            arr("internal_weight", self.internal_weight)
            arr("internal_count", self.internal_count, lambda v: str(int(v)))
            if self.num_cat > 0:
                arr("cat_boundaries", self.cat_boundaries, str)
                arr("cat_threshold", self.cat_threshold, str)
        else:
            arr("leaf_value", self.leaf_value)
        lines.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear:
            # ref: tree.cpp linear-model serialization (leaf_const +
            # per-leaf feature/coefficient lists, flattened)
            arr("leaf_const", self.leaf_const)
            arr("num_features", [len(f) for f in self.leaf_features], str)
            arr("leaf_features",
                [f for fs in self.leaf_features for f in fs], str)
            arr("leaf_coeff",
                [c for cs in self.leaf_coeff for c in cs])
        lines.append(f"shrinkage={_fmt_g(self.shrinkage)}")
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, s: str) -> "Tree":
        """ref: src/io/tree.cpp `Tree::Tree(const char* str, ...)`."""
        kv = {}
        for line in s.splitlines():
            line = line.strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            kv[k] = v
        nl = int(kv["num_leaves"])
        t = cls(nl)
        t.num_cat = int(kv.get("num_cat", 0))

        def get(name, dtype, size):
            if name not in kv or kv[name] == "":
                return np.zeros(size, dtype=dtype)
            return np.array(kv[name].split(), dtype=np.float64).astype(dtype)

        ni = max(nl - 1, 0)
        if nl > 1:
            t.split_feature = get("split_feature", np.int32, ni)
            t.split_gain = get("split_gain", np.float64, ni)
            t.threshold = get("threshold", np.float64, ni)
            t.decision_type = get("decision_type", np.int32, ni)
            t.left_child = get("left_child", np.int32, ni)
            t.right_child = get("right_child", np.int32, ni)
            t.leaf_value = get("leaf_value", np.float64, nl)
            t.leaf_weight = get("leaf_weight", np.float64, nl)
            t.leaf_count = get("leaf_count", np.float64, nl)
            t.internal_value = get("internal_value", np.float64, ni)
            t.internal_weight = get("internal_weight", np.float64, ni)
            t.internal_count = get("internal_count", np.float64, ni)
            if t.num_cat > 0:
                t.cat_boundaries = get("cat_boundaries", np.int64,
                                       t.num_cat + 1)
                t.cat_threshold = get("cat_threshold", np.uint32, 0)
                # categorical nodes store their cat index in `threshold`
                # (ref: tree.cpp — threshold_ doubles as cat_idx for
                # categorical splits); recover the integer view
                cat_nodes = (t.decision_type & K_CATEGORICAL_MASK) != 0
                t.threshold_bin[cat_nodes] = \
                    t.threshold[cat_nodes].astype(np.int32)
        else:
            t.leaf_value = get("leaf_value", np.float64, nl)
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        t.is_linear = bool(int(kv.get("is_linear", 0)))
        if t.is_linear:
            t.leaf_const = get("leaf_const", np.float64, nl)
            counts = get("num_features", np.int64, nl)
            flat_f = get("leaf_features", np.int64,
                         int(counts.sum())).tolist()
            flat_c = get("leaf_coeff", np.float64,
                         int(counts.sum())).tolist()
            pos = 0
            for leaf, c in enumerate(counts):
                c = int(c)
                t.leaf_features[leaf] = [int(v) for v in flat_f[pos:pos + c]]
                t.leaf_coeff[leaf] = list(flat_c[pos:pos + c])
                pos += c
        return t

    def recompute_threshold_bins(self, bin_mappers: List[BinMapper]) -> None:
        """Re-derive bin-level thresholds from raw-value thresholds after a
        model-text load (thresholds are the inclusive upper bounds of their
        bins, so value_to_bin(threshold) recovers the bin exactly).  Also
        rebuilds the per-cat-split bin masks from the category bitsets."""
        mb = max((m.num_bin for m in bin_mappers), default=1)
        if self.num_cat > 0:
            self.cat_bin_masks = np.zeros((self.num_cat, mb), dtype=bool)
        for i in range(self.num_internal()):
            m = bin_mappers[int(self.split_feature[i])]
            if self.decision_type[i] & K_CATEGORICAL_MASK:
                cat_idx = int(self.threshold_bin[i])
                lo = int(self.cat_boundaries[cat_idx])
                hi = int(self.cat_boundaries[cat_idx + 1])
                bitset = self.cat_threshold[lo:hi]
                for b, cat in enumerate(m.bin_2_categorical, start=1):
                    if cat < (hi - lo) * 32 and \
                            (bitset[cat // 32] >> (cat % 32)) & 1:
                        self.cat_bin_masks[cat_idx, b] = True
                continue
            self.threshold_bin[i] = m.value_to_bin(float(self.threshold[i]))

    # ----------------------------------------------------------- utilities
    def num_internal(self) -> int:
        return max(self.num_leaves - 1, 0)

    def feature_importance_split(self, out: np.ndarray) -> None:
        for f in self.split_feature[:self.num_internal()]:
            out[f] += 1

    def feature_importance_gain(self, out: np.ndarray) -> None:
        ni = self.num_internal()
        for f, g in zip(self.split_feature[:ni], self.split_gain[:ni]):
            out[f] += g
