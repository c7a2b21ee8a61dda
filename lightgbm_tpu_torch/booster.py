"""Model-loading `Booster`: model text in and out, host prediction, and
the export the serving runtime compiles.

The port's counterpart of `lightgbm_tpu/booster.py`, for the serving
slice.  It loads LightGBM model text (ref: gbdt_model_text.cpp
`GBDT::LoadModelFromString` / `SaveModelToString`), predicts with the
host f64 tree walk (`tree.py`, the same per-tree, boosting-order sum as
the JAX package's host path), and exports the stacked traversal planes
plus the f64 leaf-value table (`export_predict_arrays`).  Training is
not ported yet: the training entry points raise.
"""
from __future__ import annotations

import io
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from .objectives import Objective, parse_objective
from .tree import Tree
from .utils.log import LightGBMError

_TRAINING_SLICE = ("training is not ported to lightgbm_tpu_torch yet "
                   "(it is the next slice of the port: the leaf-wise "
                   "grower on the histogram kernel); use lightgbm_tpu "
                   "to train and load the model text here")


def _to_2d_float(data) -> np.ndarray:
    """Request matrix as C-contiguous 2-D f64 numpy (1-D = one row)."""
    X = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
    if X.ndim == 1:
        X = X.reshape(1, -1)
    if X.ndim != 2:
        raise LightGBMError(f"expected a 2-D feature matrix, got "
                            f"{X.ndim} dimensions")
    return X


class Booster:
    """A trained model, loaded from LightGBM model text.

    `Booster(model_file=path)` or `Booster(model_str=text)`.  Passing
    `train_set` raises: this package serves models, it does not train
    them yet."""

    def __init__(self, params: Optional[Dict] = None, train_set=None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params: Dict = dict(params) if params else {}
        self.best_iteration = -1
        self.trees: List[Tree] = []
        self.num_tree_per_iteration = 1
        self.objective_: Optional[Objective] = None
        self.pandas_categorical = None
        self._average_output = False
        self._loaded_feature_names: List[str] = []
        self._loaded_feature_infos: List[str] = []
        self._export_cache = None
        if train_set is not None:
            raise LightGBMError(_TRAINING_SLICE)
        if model_file is not None:
            with open(model_file, "r") as f:
                self.model_from_string(f.read())
        elif model_str is not None:
            self.model_from_string(model_str)
        else:
            raise TypeError("Need a model file or model string to create "
                            "a Booster instance")

    # ------------------------------------------------------- training
    def update(self, *args, **kwargs):
        raise LightGBMError(_TRAINING_SLICE)

    train = refit = rollback_one_iter = add_valid = eval = update

    # ------------------------------------------------------ model text
    def model_from_string(self, model_str: str) -> "Booster":
        """ref: gbdt_model_text.cpp `GBDT::LoadModelFromString`."""
        lines = model_str.split("\n")
        header: Dict[str, str] = {}
        i = 0
        while i < len(lines):
            ln = lines[i].strip()
            if ln.startswith("Tree="):
                break
            if "=" in ln:
                k, v = ln.split("=", 1)
                header[k] = v
            i += 1
        self.num_tree_per_iteration = int(
            header.get("num_tree_per_iteration", 1))
        self._average_output = "average_output" in lines[:i]
        self._loaded_feature_names = header.get("feature_names", "").split()
        self._loaded_feature_infos = header.get("feature_infos", "").split()
        # the parameters section round-trips (ref: SaveModelToString
        # writes the config block), which keeps save -> load -> save
        # byte-stable
        in_params = False
        for ln in lines:
            ln = ln.strip()
            if ln == "parameters:":
                in_params = True
                continue
            if ln == "end of parameters":
                break
            if in_params and ln.startswith("[") and ":" in ln:
                k, v = ln[1:-1].split(":", 1)
                self.params.setdefault(k.strip(), v.strip())
        self.objective_ = parse_objective(
            header.get("objective", "regression"), self.params)
        self._export_cache = None
        text = "\n".join(lines[i:])
        self.trees = []
        for section in text.split("Tree=")[1:]:
            section = section.split("\nend of trees")[0]
            self.trees.append(Tree.from_string("Tree=" + section))
        for ln in reversed(lines):
            if ln.startswith("pandas_categorical:"):
                try:
                    self.pandas_categorical = json.loads(
                        ln[len("pandas_categorical:"):])
                except json.JSONDecodeError:
                    pass
                break
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        """ref: gbdt_model_text.cpp `GBDT::SaveModelToString`; the same
        text the JAX package writes for a loaded model."""
        trees = self._slice_trees(start_iteration, num_iteration)
        fnames = self._loaded_feature_names
        buf = io.StringIO()
        buf.write("tree\n")
        buf.write("version=v4\n")
        buf.write(f"num_class={max(self.num_tree_per_iteration, 1)}\n")
        buf.write(f"num_tree_per_iteration={self.num_tree_per_iteration}\n")
        buf.write("label_index=0\n")
        buf.write(f"max_feature_idx={len(fnames) - 1}\n")
        obj = self.objective_.to_string() if self.objective_ else "custom"
        buf.write(f"objective={obj}\n")
        if self._average_output:
            buf.write("average_output\n")
        buf.write("feature_names=" + " ".join(fnames) + "\n")
        infos = self._loaded_feature_infos or ["none"] * len(fnames)
        buf.write("feature_infos=" + " ".join(infos) + "\n")
        tree_strs = [t.to_string(i) for i, t in enumerate(trees)]
        buf.write("tree_sizes=" + " ".join(str(len(s) + 1)
                                           for s in tree_strs) + "\n")
        buf.write("\n")
        for s in tree_strs:
            buf.write(s + "\n")
        buf.write("end of trees\n\n")
        imp = self.feature_importance(importance_type)
        pairs = sorted([(v, n) for n, v in zip(fnames, imp) if v > 0],
                       reverse=True)
        buf.write("feature_importances:\n")
        for v, n in pairs:
            buf.write(f"{n}={v:g}\n")
        buf.write("\nparameters:\n")
        for k, v in self.params.items():
            if callable(v):
                continue
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            buf.write(f"[{k}: {v}]\n")
        buf.write("end of parameters\n")
        buf.write("\npandas_categorical:" +
                  json.dumps(self.pandas_categorical) + "\n")
        return buf.getvalue()

    # -------------------------------------------------------- queries
    def num_feature(self) -> int:
        return len(self._loaded_feature_names)

    def num_trees(self) -> int:
        return len(self.trees)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """ref: gbdt.cpp `GBDT::FeatureImportance`."""
        out = np.zeros(self.num_feature(), dtype=np.float64)
        for t in self._slice_trees(0, iteration):
            if importance_type == "split":
                t.feature_importance_split(out)
            elif importance_type == "gain":
                t.feature_importance_gain(out)
            else:
                raise LightGBMError(
                    f"Unknown importance type: {importance_type}")
        return out.astype(np.int32) if importance_type == "split" else out

    def _slice_trees(self, start_iteration: int,
                     num_iteration: Optional[int]) -> List[Tree]:
        K = self.num_tree_per_iteration
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        if num_iteration <= 0:
            end = len(self.trees)
        else:
            end = min((start_iteration + num_iteration) * K, len(self.trees))
        return self.trees[start_iteration * K: end]

    # ------------------------------------------------------ prediction
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        """Host prediction: the f64 tree walk, summed tree by tree in
        boosting order (ref: gbdt_prediction.cpp `GBDT::PredictRaw`).
        Converted outputs pass the f32 downcast of the raw sum through
        the objective's link on the CPU."""
        X = _to_2d_float(data)
        K = self.num_tree_per_iteration
        trees = self._slice_trees(start_iteration, num_iteration)
        raw = np.zeros((X.shape[0], K), dtype=np.float64)
        for i, t in enumerate(trees):
            raw[:, i % K] += t.predict(X)
        if self._average_output and len(trees) >= K:
            raw /= max(len(trees) // K, 1)
        if K == 1:
            raw = raw[:, 0]
        if raw_score or self.objective_ is None:
            return raw
        return self.objective_.convert_output(
            torch.from_numpy(raw).to(torch.float32)).numpy()

    def _stack_for_device(self, trees: List[Tree], device) -> Optional[Dict]:
        """Pad the trees into stacked [T, NI] / [T, NL] planes, built in
        numpy and then put on `device` (the JAX package's
        `Booster._stack_for_device`).  Categorical ensembles add
        `cat_words` [T, NI, MW] (the u32 bitsets as int32 bit patterns)
        and `cat_nwords` [T, NI]; multiclass adds `cls` [T], tree i's
        class i % K.  None for linear trees, which the device path does
        not serve."""
        if not trees or any(t.is_linear for t in trees):
            return None
        ni = max(max(t.num_leaves - 1, 1) for t in trees)
        T = len(trees)
        feat = np.zeros((T, ni), np.int32)
        thr = np.zeros((T, ni), np.float32)
        dtype_ = np.zeros((T, ni), np.int32)
        # pad nodes route to leaf 0 (~0 = -1): a single-leaf tree's root
        # terminates immediately with its constant value
        left = np.full((T, ni), -1, np.int32)
        right = np.full((T, ni), -1, np.int32)
        value = np.zeros((T, ni + 1), np.float32)
        has_cat = any(t.num_cat > 0 for t in trees)
        if has_cat:
            mw = 1
            for t in trees:
                if t.num_cat > 0 and len(t.cat_boundaries) > 1:
                    mw = max(mw, int(np.max(np.diff(t.cat_boundaries))))
            cat_words = np.zeros((T, ni, mw), np.uint32)
            cat_nwords = np.zeros((T, ni), np.int32)
        for i, t in enumerate(trees):
            k = t.num_leaves - 1
            feat[i, :k] = t.split_feature[:k]
            thr[i, :k] = t.threshold[:k]
            dtype_[i, :k] = t.decision_type[:k]
            left[i, :k] = t.left_child[:k]
            right[i, :k] = t.right_child[:k]
            value[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            if has_cat and t.num_cat > 0:
                for nd in range(k):
                    if t.decision_type[nd] & 1:
                        cb = int(t.threshold_bin[nd])
                        lo = int(t.cat_boundaries[cb])
                        hi = int(t.cat_boundaries[cb + 1])
                        cat_nwords[i, nd] = hi - lo
                        cat_words[i, nd, :hi - lo] = t.cat_threshold[lo:hi]
        planes = dict(feat=feat, thr=thr, dtype=dtype_, left=left,
                      right=right, value=value)
        if has_cat:
            planes["cat_words"] = cat_words.view(np.int32)
            planes["cat_nwords"] = cat_nwords
        K = self.num_tree_per_iteration
        if K > 1:
            planes["cls"] = np.arange(T, dtype=np.int32) % K
        out = {k: torch.from_numpy(v).to(device) for k, v in planes.items()}
        out["min_features"] = int(feat.max()) + 1 if feat.size else 0
        return out

    def export_predict_arrays(self, start_iteration: int = 0,
                              num_iteration: Optional[int] = None,
                              device="cpu") -> Dict:
        """Model export for the serving runtime, cached per tree slice
        and device (the JAX package's `export_predict_arrays`).

        Returns a dict:
          stacked        — tensors on `device` (see `_stack_for_device`)
                           plus `min_features`, or None for linear trees
          leaf_values    — [T, NL] f64 numpy leaf outputs, tree-padded
          value_f64      — the same table as an f64 tensor on `device`
                           (the JAX package carries it as two u32 bit
                           planes, `value_hi`/`value_lo`, because the
                           TPU has no f64); None when stacked is None
          trees          — the resolved host Tree slice
          num_class      — trees per iteration (K)
          average_factor — RF averaging divisor (1 = plain sum)
        """
        trees = self._slice_trees(start_iteration, num_iteration)
        device = torch.device(device)
        key = (start_iteration, num_iteration, len(self.trees), str(device))
        if self._export_cache is not None and self._export_cache[0] == key:
            return self._export_cache[1]
        stacked = self._stack_for_device(trees, device)
        nl = max((t.num_leaves for t in trees), default=1)
        leaf_values = np.zeros((len(trees), nl), np.float64)
        for i, t in enumerate(trees):
            leaf_values[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        value_f64 = torch.from_numpy(leaf_values).to(device) \
            if stacked is not None else None
        K = self.num_tree_per_iteration
        avg = max(len(trees) // K, 1) \
            if self._average_output and len(trees) >= K else 1
        export = {"stacked": stacked, "leaf_values": leaf_values,
                  "value_f64": value_f64, "trees": trees, "num_class": K,
                  "average_factor": avg}
        self._export_cache = (key, export)
        return export
