"""Model -> standalone if-else scorer.

The port's copy of `lightgbm_tpu/convert.py`, on the port's `Tree`
(ref: src/application/application.cpp `Application::ConvertModel`;
src/io/tree.cpp `Tree::ToIfElse` emits one nested-if C++ function per tree
plus `PredictRaw`, written to `convert_model=gbdt_prediction.cpp`).  The
command line's `task=convert_model` comes with the port's CLI (ROADMAP
Queue 1 item 5g); `convert_model(booster, path, language)` is its entry.

Two target languages (`convert_model_language`):
 - "cpp" (default, reference parity): a self-contained C file exposing
   `double score_raw(const double* features)` (and
   `void score_raw_multi(const double*, double*)` for multiclass) —
   compiles with `gcc -c -lm`, no headers beyond <math.h>.
 - "python": an importable module exposing
   `score_raw(features) -> float` / `score_raw_multi(features) -> list`.
   Note: CPython's parser caps nesting at ~100 indentation levels, so
   chain-shaped trees deeper than that import-fail in the python target;
   use the C target (no such limit) for unbounded-depth models.

Like the reference's generated code, the scorer returns RAW scores: the
objective's `ConvertOutput` (sigmoid/softmax/exp) is the caller's business.
Missing handling reproduces `Tree::NumericalDecision` exactly (NaN vs
zero-as-missing routes, default_left) and categorical nodes test the same
uint32 bitsets (`Tree::CategoricalDecision`).
"""
from __future__ import annotations

import contextlib
import io
import sys
from typing import List

import numpy as np

from .tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK,
                   K_ZERO_THRESHOLD, Tree)
from .utils import log
from .utils.log import LightGBMError


def _check_convertible(trees: List[Tree]) -> None:
    if any(t.is_linear for t in trees):
        raise LightGBMError(
            "convert_model does not support linear trees "
            "(leaf models need the raw feature matrix)")


@contextlib.contextmanager
def _recursion_headroom(trees: List[Tree]):
    """The emitters recurse once per tree level; a chain-shaped tree
    (large num_leaves, no max_depth) can exceed CPython's default 1000
    frames — reserve depth for the deepest possible tree."""
    need = sys.getrecursionlimit() + \
        8 * max((t.num_leaves for t in trees), default=1)
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, need))
    try:
        yield
    finally:
        sys.setrecursionlimit(old)


def _node_condition_c(tree: Tree, node: int, cats: list) -> str:
    """C boolean expression: row goes LEFT at `node`."""
    j = int(tree.split_feature[node])
    dt = int(tree.decision_type[node])
    fv = f"f[{j}]"
    if dt & K_CATEGORICAL_MASK:
        cat_idx = int(tree.threshold_bin[node])
        lo = int(tree.cat_boundaries[cat_idx])
        hi = int(tree.cat_boundaries[cat_idx + 1])
        bits = [int(w) for w in tree.cat_threshold[lo:hi]]
        k = len(cats)
        cats.append(bits)
        return f"in_bitset({fv}, cat_{k}, {hi - lo})"
    thr = repr(float(tree.threshold[node]))
    default_left = "1" if dt & K_DEFAULT_LEFT_MASK else "0"
    missing_type = (dt >> 2) & 3
    if missing_type == 0:      # none: NaN coerces to 0.0 before compare
        return f"((isnan({fv}) ? 0.0 : {fv}) <= {thr})"
    if missing_type == 1:      # zero-as-missing
        return (f"(fabs(isnan({fv}) ? 0.0 : {fv}) <= {K_ZERO_THRESHOLD!r} "
                f"? {default_left} : (isnan({fv}) ? 0.0 : {fv}) <= {thr})")
    # NaN-as-missing
    return f"(isnan({fv}) ? {default_left} : {fv} <= {thr})"


def _node_condition_py(tree: Tree, node: int, cats: list) -> str:
    j = int(tree.split_feature[node])
    dt = int(tree.decision_type[node])
    fv = f"f[{j}]"
    if dt & K_CATEGORICAL_MASK:
        cat_idx = int(tree.threshold_bin[node])
        lo = int(tree.cat_boundaries[cat_idx])
        hi = int(tree.cat_boundaries[cat_idx + 1])
        bits = [int(w) for w in tree.cat_threshold[lo:hi]]
        k = len(cats)
        cats.append(bits)
        return f"_in_bitset({fv}, _CAT_{k})"
    thr = repr(float(tree.threshold[node]))
    default_left = str(bool(dt & K_DEFAULT_LEFT_MASK))
    missing_type = (dt >> 2) & 3
    if missing_type == 0:
        return f"(0.0 if _isnan({fv}) else {fv}) <= {thr}"
    if missing_type == 1:
        return (f"({default_left} if "
                f"abs(0.0 if _isnan({fv}) else {fv}) <= "
                f"{K_ZERO_THRESHOLD!r} "
                f"else (0.0 if _isnan({fv}) else {fv}) <= {thr})")
    return f"({default_left} if _isnan({fv}) else {fv} <= {thr})"


def _emit_tree(tree: Tree, buf: io.StringIO, node: int, indent: int,
               cond_fn, cats: list, ret: str, lang: str) -> None:
    pad = " " * indent
    if tree.num_leaves <= 1:
        v = float(tree.leaf_value[0]) if len(tree.leaf_value) else 0.0
        buf.write(f"{pad}{ret} {v!r}{';' if lang == 'c' else ''}\n")
        return

    def emit(node: int, indent: int) -> None:
        pad = " " * indent
        if node < 0:          # leaf (encoded as ~leaf_index)
            v = float(tree.leaf_value[~node])
            buf.write(f"{pad}{ret} {v!r}{';' if lang == 'c' else ''}\n")
            return
        cond = cond_fn(tree, node, cats)
        if lang == "c":
            buf.write(f"{pad}if ({cond}) {{\n")
            emit(int(tree.left_child[node]), indent + 2)
            buf.write(f"{pad}}} else {{\n")
            emit(int(tree.right_child[node]), indent + 2)
            buf.write(f"{pad}}}\n")
        else:
            buf.write(f"{pad}if {cond}:\n")
            emit(int(tree.left_child[node]), indent + 4)
            buf.write(f"{pad}else:\n")
            emit(int(tree.right_child[node]), indent + 4)

    emit(node, indent)


def to_if_else_c(booster) -> str:
    """The reference's `Tree::ToIfElse` output, re-targeted to plain C."""
    trees: List[Tree] = booster.trees
    _check_convertible(trees)
    K = max(int(getattr(booster, "num_tree_per_iteration", 1)), 1)
    avg = bool(getattr(booster, "_average_output", False))
    buf = io.StringIO()
    buf.write(
        "/* generated by lightgbm_tpu_torch task=convert_model "
        "(ref: Tree::ToIfElse / Application::ConvertModel).\n"
        " * score_raw returns the RAW model score; apply the objective's\n"
        " * output transform (sigmoid/softmax/exp) yourself if needed. */\n"
        "#include <math.h>\n\n")
    cats: list = []
    bodies = io.StringIO()
    with _recursion_headroom(trees):
        for i, t in enumerate(trees):
            bodies.write(f"static double tree_{i}(const double* f) {{\n")
            _emit_tree(t, bodies, 0, 2, _node_condition_c, cats, "return",
                       "c")
            bodies.write("}\n\n")
    if cats:
        buf.write(
            "static int in_bitset(double fval, const unsigned int* bits,"
            " int n_words) {\n"
            "  long v;\n"
            "  if (isnan(fval)) return 0;\n"
            "  v = (long)fval;\n"
            "  if (v < 0 || v >= (long)n_words * 32) return 0;\n"
            "  return (bits[v / 32] >> (v % 32)) & 1U;\n"
            "}\n\n")
        for k, bits in enumerate(cats):
            words = ", ".join(f"{w}U" for w in bits)
            buf.write(f"static const unsigned int cat_{k}[] = "
                      f"{{{words}}};\n")
        buf.write("\n")
    buf.write(bodies.getvalue())
    n = len(trees)
    per_class = [list(range(k, n, K)) for k in range(K)]
    scale = [f" / {len(ts)}.0" if avg and ts else "" for ts in per_class]
    if K == 1:
        terms = " + ".join(f"tree_{i}(f)" for i in per_class[0]) or "0.0"
        buf.write("double score_raw(const double* f) {\n"
                  f"  return ({terms}){scale[0]};\n}}\n")
    else:
        buf.write(f"#define NUM_CLASS {K}\n"
                  "void score_raw_multi(const double* f, double* out) {\n")
        for k, ts in enumerate(per_class):
            terms = " + ".join(f"tree_{i}(f)" for i in ts) or "0.0"
            buf.write(f"  out[{k}] = ({terms}){scale[k]};\n")
        buf.write("}\n")
    return buf.getvalue()


def to_if_else_python(booster) -> str:
    trees: List[Tree] = booster.trees
    _check_convertible(trees)
    K = max(int(getattr(booster, "num_tree_per_iteration", 1)), 1)
    avg = bool(getattr(booster, "_average_output", False))
    buf = io.StringIO()
    buf.write(
        '"""generated by lightgbm_tpu_torch task=convert_model '
        '(convert_model_language=python).\n\n'
        'score_raw returns the RAW model score; apply the objective\'s\n'
        'output transform (sigmoid/softmax/exp) yourself if needed."""\n'
        "import math\n\n"
        "_isnan = math.isnan\n\n\n"
        "def _in_bitset(fval, bits):\n"
        "    if _isnan(fval):\n"
        "        return False\n"
        "    v = int(fval)\n"
        "    if v < 0 or v >= len(bits) * 32:\n"
        "        return False\n"
        "    return bool((bits[v // 32] >> (v % 32)) & 1)\n\n\n")
    cats: list = []
    bodies = io.StringIO()
    with _recursion_headroom(trees):
        for i, t in enumerate(trees):
            bodies.write(f"def tree_{i}(f):\n")
            _emit_tree(t, bodies, 0, 4, _node_condition_py, cats, "return",
                       "py")
            bodies.write("\n\n")
    for k, bits in enumerate(cats):
        buf.write(f"_CAT_{k} = {tuple(bits)!r}\n")
    if cats:
        buf.write("\n\n")
    buf.write(bodies.getvalue())
    n = len(trees)
    per_class = [list(range(k, n, K)) for k in range(K)]
    scale = [f" / {len(ts)}" if avg and ts else "" for ts in per_class]
    if K == 1:
        terms = " + ".join(f"tree_{i}(f)" for i in per_class[0]) or "0.0"
        buf.write(f"def score_raw(f):\n    return ({terms}){scale[0]}\n")
    else:
        buf.write(f"NUM_CLASS = {K}\n\n\n"
                  "def score_raw_multi(f):\n    return [\n")
        for k, ts in enumerate(per_class):
            terms = " + ".join(f"tree_{i}(f)" for i in ts) or "0.0"
            buf.write(f"        ({terms}){scale[k]},\n")
        buf.write("    ]\n")
    return buf.getvalue()


def convert_model(booster, out_path: str, language: str = "") -> None:
    """CLI `task=convert_model` entry (ref: Application::ConvertModel;
    `convert_model=<file>` names the output,
    `convert_model_language` picks the target)."""
    lang = (language or "cpp").lower()
    if lang in ("cpp", "c", "c++"):
        text = to_if_else_c(booster)
    elif lang in ("python", "py"):
        text = to_if_else_python(booster)
    else:
        raise LightGBMError(
            f"convert_model_language={language!r} is not supported "
            f"(use cpp or python)")
    with open(out_path, "w") as fh:
        fh.write(text)
    log.info(f"Finished converting model; scorer saved to {out_path}")
