#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

  env     torch and CUDA versions, the card (nvidia-smi), the kernel build
          time and the compiler's register report.
  golden  the five model files under tests/data/, and two wide synthetic
          models (64 and 300 features, for the traverse kernel's
          shared-memory opt-in and global-memory launch branches),
          through a GPU ServingRuntime with small tiles: the traverse
          and accumulate kernels against their plain versions on the
          card, bitwise, on the runtime's probe rows plus adversarial
          rows (NaN, +-inf, +-0, subnormals, values at thresholds,
          categorical edge values, f64 values that saturate in the f32
          cast); raw scores against the port's CPU path, bitwise.
  main    the full-width model: 500 trees x 255 leaves x 28 features,
          binary, built from --seed by `synthetic_forest_text` (the
          Higgs shape of upstream LightGBM's docs/Experiments.rst).
          ServingRuntime on the GPU answers 1, 37, 256, 1000, 4096 and
          10000 rows; each answer equals the plain versions on the card
          and the f64 host walk, bitwise.  Kernel launch counts are read
          around this phase alone.  Then latencies, the kernels' times
          against their plain versions and their bounds.
  kernels one line per kernel: launches on the main phase, parity,
          times and bound.

Then the card's name and power limit as nvidia-smi prints them, and as
the last line `{"ok": true, "device": {...}}`.  Any failure exits
non-zero without that line.  Needs one CUDA card; imports nothing of
JAX and nothing of `lightgbm_tpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = ("binary", "categorical", "goss_bagging", "multiclass",
          "regression_l2")

# H100 SXM peaks at the 700 W limit (NVIDIA data sheet and Hopper white
# paper): HBM3 bandwidth; 67 TFLOP/s f32 outside the tensor cores is
# 132 SMs x 128 f32 lanes x 2 (FMA) x 1.98 GHz.  An SM has 64 INT32
# lanes and 64 FP64 lanes, so one-operation instructions (an integer op,
# an f64 add) peak at 132 x 64 x 1.98 GHz = 16.7e12 per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F64_ADDS_PER_S = 132 * 64 * 1.98e9
#: wide synthetic models of the golden phase, (name, features): 64
#: features put a 256-row block's rows above the 48 KB of shared memory
#: a launch gets by default (the kernel opts in to more), 300 features
#: above the 227 KB a block can have (rows are read from global memory)
WIDE = (("wide_64", 64), ("wide_300", 300))


# ----------------------------------------------------------- model + data
def _feature_kind(f: int) -> int:
    """Higgs-like feature families: 0 momenta/masses (log-normal,
    positive), 1 pseudorapidities (normal), 2 azimuths (uniform on
    [-pi, pi]), 3 b-tags (three discrete values, mostly zero)."""
    return f % 4


def request_rows(rng: np.random.RandomState, n: int,
                 num_features: int = 28) -> np.ndarray:
    """Request rows from the synthetic model's input distribution, with
    about 2% NaN in the azimuth features.  Values are f32-representable,
    so the f32 staging is exact and the f64 host walk routes them as the
    card does."""
    X = np.empty((n, num_features), np.float64)
    for f in range(num_features):
        kind = _feature_kind(f)
        if kind == 0:
            col = rng.lognormal(0.0, 0.5, n)
        elif kind == 1:
            col = rng.normal(0.0, 1.0, n)
        elif kind == 2:
            col = rng.uniform(-np.pi, np.pi, n)
            col[rng.rand(n) < 0.02] = np.nan
        else:
            col = rng.choice([0.0, 1.0865, 2.1731], n, p=[0.6, 0.2, 0.2])
        X[:, f] = col
    return X.astype(np.float32).astype(np.float64)


def _grow_tree(rng, num_leaves, num_features, grids):
    """One leaf-wise tree: each step splits the leaf holding the most
    simulated rows, by a random fraction, so depths come out uneven as
    in real leaf-wise growth.  Child encoding as LightGBM's
    `Tree::Split`: the split leaf keeps its index as the left child and
    the new leaf (step + 1) becomes the right child."""
    ni = num_leaves - 1
    feat = np.zeros(ni, np.int64)
    thr = np.zeros(ni, np.float64)
    dtype = np.zeros(ni, np.int64)
    left = np.zeros(ni, np.int64)
    right = np.zeros(ni, np.int64)
    counts = [1.0]
    owner = {0: (-1, 0)}             # leaf -> (parent node, side)
    for i in range(ni):
        leaf = int(np.argmax(counts))
        frac = rng.uniform(0.05, 0.95)
        f = rng.randint(num_features)
        feat[i] = f
        thr[i] = grids[f][rng.randint(len(grids[f]))]
        missing_type = rng.randint(3)         # None, Zero, NaN
        default_left = rng.randint(2)
        dtype[i] = (missing_type << 2) | (default_left << 1)
        left[i] = ~leaf
        right[i] = ~(i + 1)
        parent, side = owner[leaf]
        if parent >= 0:
            (left if side == 0 else right)[parent] = i
        owner[leaf] = (i, 0)
        owner[i + 1] = (i, 1)
        c = counts[leaf]
        counts[leaf] = c * frac
        counts.append(c * (1.0 - frac))
    leaf_value = rng.normal(0.0, 0.05, num_leaves)
    return feat, thr, dtype, left, right, leaf_value, np.asarray(counts)


def synthetic_forest_text(seed: int = 0, num_trees: int = 500,
                          num_leaves: int = 255,
                          num_features: int = 28) -> str:
    """LightGBM model text of a binary (`sigmoid:1`) forest made from
    `seed`.  Thresholds are drawn from per-feature 255-bin quantile
    grids of `request_rows`' distribution; missing types None, Zero
    and NaN are mixed with default_left both ways; leaf values are
    full-precision f64."""
    rng = np.random.RandomState(seed)
    sample = request_rows(rng, 100_000, num_features)
    grids = []
    for f in range(num_features):
        col = sample[:, f][~np.isnan(sample[:, f])]
        q = np.quantile(col, np.linspace(0.0, 1.0, 256)[1:-1])
        grids.append(np.unique(q.astype(np.float32)).astype(np.float64))

    def fmt(a):
        return " ".join(f"{float(v):.17g}" for v in a)

    def ints(a):
        return " ".join(str(int(v)) for v in a)

    trees = []
    for t in range(num_trees):
        feat, thr, dtype, left, right, lv, cnt = _grow_tree(
            rng, num_leaves, num_features, grids)
        ni = num_leaves - 1
        trees.append("\n".join([
            f"Tree={t}", f"num_leaves={num_leaves}", "num_cat=0",
            f"split_feature={ints(feat)}",
            f"split_gain={fmt(np.ones(ni))}",
            f"threshold={fmt(thr)}", f"decision_type={ints(dtype)}",
            f"left_child={ints(left)}", f"right_child={ints(right)}",
            f"leaf_value={fmt(lv)}", f"leaf_weight={fmt(cnt * 1e3)}",
            f"leaf_count={ints(np.maximum(cnt * 1e6, 1))}",
            f"internal_value={fmt(np.zeros(ni))}",
            f"internal_weight={fmt(np.ones(ni))}",
            f"internal_count={ints(np.ones(ni))}",
            "is_linear=0", "shrinkage=1", "", ""]))
    names = " ".join(f"Column_{i}" for i in range(num_features))
    header = "\n".join([
        "tree", "version=v4", "num_class=1", "num_tree_per_iteration=1",
        "label_index=0", f"max_feature_idx={num_features - 1}",
        "objective=binary sigmoid:1", f"feature_names={names}",
        "feature_infos=" + " ".join(["none"] * num_features),
        "tree_sizes=" + " ".join(str(len(s) + 1) for s in trees), "", ""])
    footer = ("end of trees\n\nparameters:\n[objective: binary]\n"
              f"[num_leaves: {num_leaves}]\n[num_iterations: {num_trees}]\n"
              "[max_bin: 255]\nend of parameters\n\npandas_categorical:null\n")
    return header + "\n".join(trees) + footer


def adversarial_rows(trees, num_features: int, seed: int = 0) -> np.ndarray:
    """f64 rows that stress routing: every feature at NaN, +-inf, +-0,
    f32 subnormals, the f32 zero threshold 1e-35 and its neighbours,
    categorical edge values (-0.5, -1, 31.9, 32, 1e9), and f64 values
    that saturate to +-inf in the f32 cast; then rows whose features sit
    exactly at the model's thresholds (the f64 value, its f32 rounding
    and the next f32 values up and down), sprinkled with the specials."""
    f32 = np.float32
    z = f32(1e-35)
    specials = np.array([
        np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45,
        float(np.nextafter(f32(1.1754944e-38), f32(0))), float(z),
        float(np.nextafter(z, f32(1))), float(np.nextafter(z, f32(0))),
        -float(z), -0.5, -1.0, -1.5, 0.5, 31.9, 32.0, 63.0, 64.0, 1e9,
        1e39, -1e39, 3.5e38, 1e300, -1e300], np.float64)
    rows = [np.full(num_features, v) for v in specials]
    thr = [np.asarray(t.threshold[:max(t.num_leaves - 1, 0)], np.float64)
           for t in trees]
    feats = [np.asarray(t.split_feature[:max(t.num_leaves - 1, 0)])
             for t in trees]
    thr = np.concatenate(thr) if thr else np.zeros(0)
    feats = np.concatenate(feats) if feats else np.zeros(0, np.int64)
    rng = np.random.RandomState(seed)
    n_thr = 128
    X = rng.randn(n_thr, num_features)
    for f in np.unique(feats):
        v = thr[feats == f]
        t32 = v.astype(f32)
        cand = np.concatenate([
            v, t32.astype(np.float64),
            np.nextafter(t32, f32(np.inf)).astype(np.float64),
            np.nextafter(t32, f32(-np.inf)).astype(np.float64)])
        X[:, f] = cand[rng.randint(len(cand), size=n_thr)]
    mask = rng.rand(n_thr, num_features) < 0.1
    X[mask] = specials[rng.randint(len(specials), size=int(mask.sum()))]
    return np.ascontiguousarray(np.vstack(rows + [X]))


# --------------------------------------------------------------- helpers
class Failure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise Failure(msg)


def _emit(obj):
    print(json.dumps(obj, sort_keys=False), flush=True)


def _cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` runs, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bits_equal(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {8: np.uint64, 4: np.uint32}[a.dtype.itemsize]
    return bool(np.array_equal(a.view(view), b.view(view)))


def _traverse(rt, Xd, fn):
    """Xd through every depth bucket of rt's plan with `fn`, the traverse
    kernel's wrapper or its plain version: the per-bucket slots."""
    st = rt._state
    return [fn(Xd, w, k, p, c, d, m)
            for (w, k, p, c), (d, m) in zip(st.planes, st.meta)]


def _plain_predict(rt, Xd):
    """The compiled path with the plain versions, on Xd's device:
    (slots, raw f64 sums)."""
    from lightgbm_tpu_torch.compiler.kernel import traverse_bucket_plain
    from lightgbm_tpu_torch.ops.predict import accumulate_slots_exact_plain
    import torch
    st = rt._state
    slots = torch.cat(_traverse(rt, Xd, traverse_bucket_plain))
    acc = accumulate_slots_exact_plain(slots, st.gidx,
                                       st.export["value_f64"],
                                       st.export["num_class"], st.cls)
    return slots, acc


def _traverse_branch(b: int, f: int) -> str:
    """Which launch branch csrc/traverse.cu takes for a [b, f] batch:
    rows in shared memory within the default 48 KB, rows in shared
    memory past it (opt-in), or rows read from global memory."""
    from lightgbm_tpu_torch.compiler.kernel import (SMEM_DEFAULT,
                                                    row_smem_bytes)
    smem = row_smem_bytes(b, f)
    if smem == 0:
        return "global"
    return "smem" if smem <= SMEM_DEFAULT else "smem_optin"


def _leaf_depths(trees, nl):
    """[T, NL] number of internal nodes on the path to each leaf."""
    out = np.zeros((len(trees), nl), np.int64)
    for i, t in enumerate(trees):
        k = t.num_leaves - 1
        if k <= 0:
            continue
        stack = [(0, 1)]
        while stack:
            nd, d = stack.pop()
            for c in (int(t.left_child[nd]), int(t.right_child[nd])):
                if c < 0:
                    out[i, ~c] = d
                else:
                    stack.append((c, d + 1))
    return out


# ---------------------------------------------------------------- phases
def phase_env():
    import torch
    from lightgbm_tpu_torch.compiler import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    _emit({"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count(),
           "nvidia_smi": smi.stdout.strip(), "build_s": build_s,
           "ptxas": ptxas})
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def phase_golden(seed):
    """The five golden models, then the WIDE synthetic models, which
    drive the traverse kernel's other two launch branches."""
    import torch
    from lightgbm_tpu_torch import Booster, ServingRuntime
    from lightgbm_tpu_torch.compiler.kernel import traverse_bucket
    from lightgbm_tpu_torch.ops.predict import accumulate_slots_exact
    report = {"phase": "golden", "models": {}}
    models = [(name, Booster(model_file=os.path.join(
        ROOT, "tests", "data", f"golden_{name}.model.txt")))
        for name in GOLDEN]
    models += [(name, Booster(model_str=synthetic_forest_text(
        seed, num_trees=20, num_leaves=63, num_features=f)))
        for name, f in WIDE]
    branches = set()
    for name, bst in models:
        rt = ServingRuntime(bst, tile_vmem_kb=1)
        cpu = ServingRuntime(bst, tile_vmem_kb=1, device="cpu")
        ex = rt._state.export
        nf = max(bst.num_feature(), ex["stacked"]["min_features"])
        X = np.vstack([rt._probe_batch(ex, 256),
                       adversarial_rows(ex["trees"], nf)])
        Xd = rt._stage32(X, rt._chunk_rows(X.shape[0]))
        st = rt._state
        slots = torch.cat(_traverse(rt, Xd, traverse_bucket))
        slots_p, acc_p = _plain_predict(rt, Xd)
        _check(torch.equal(slots, slots_p), f"{name}: kernel slots != plain")
        K = ex["num_class"]
        acc_k = accumulate_slots_exact(slots, st.gidx, ex["value_f64"],
                                       K, st.cls).cpu().numpy()
        _check(_bits_equal(acc_k, acc_p.cpu().numpy()),
               f"{name}: kernel accumulation != plain")
        raw = rt.predict(X, raw_score=True)
        raw_cpu = cpu.predict(X, raw_score=True)
        _check(_bits_equal(raw, raw_cpu),
               f"{name}: GPU raw scores != CPU plain path")
        conv = rt.predict(X)
        conv_cpu = cpu.predict(X)
        ulp = int(np.max(np.abs(conv.view(np.int32).astype(np.int64)
                                - conv_cpu.view(np.int32).astype(np.int64))))
        mw = max(m for _, m in st.meta)
        if name == "categorical":
            _check(mw > 0, "categorical model did not run the bitset branch")
        if name == "multiclass":
            _check(K == 3, "multiclass model is not K=3")
        branch = _traverse_branch(*Xd.shape)
        branches.add(branch)
        report["models"][name] = {
            "rows": int(X.shape[0]), "features": int(Xd.shape[1]),
            "branch": branch, "tiles": st.plan.num_tiles(),
            "buckets": [int(d) for d, _ in st.meta], "mw": int(mw),
            "K": int(K), "slots_equal": True, "accumulate_equal": True,
            "raw_equal_cpu": True, "converted_max_ulp_vs_cpu": ulp}
    _check(branches == {"smem", "smem_optin", "global"},
           f"golden phase missed a traverse launch branch: {branches}")
    _emit(report)


def phase_main(seed, kernel_module, predict_module):
    import torch
    from lightgbm_tpu_torch import Booster, ServingRuntime
    text = synthetic_forest_text(seed)
    bst = Booster(model_str=text)
    rng = np.random.RandomState(seed + 1)
    sizes = (1, 37, 256, 1000, 4096, 10000)
    reqs = {n: request_rows(rng, n) for n in sizes}
    repeats = {1: 30, 37: 30, 256: 30, 1000: 20, 4096: 20, 10000: 10}

    # ---- the main path, alone between the counter reads
    kernel_module.TRAVERSE_LAUNCHES = 0
    predict_module.ACCUMULATE_LAUNCHES = 0
    t0 = time.perf_counter()
    rt = ServingRuntime(bst)
    setup_s = time.perf_counter() - t0
    answers, conv, lat = {}, {}, {}
    for n in sizes:
        answers[n] = rt.predict(reqs[n], raw_score=True)
        conv[n] = rt.predict(reqs[n])
        times = []
        for _ in range(repeats[n]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rt.predict(reqs[n])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        lat[n] = float(np.median(times)) * 1e3
    launches = {"traverse": kernel_module.TRAVERSE_LAUNCHES,
                "accumulate": predict_module.ACCUMULATE_LAUNCHES}
    _check(launches["traverse"] > 0 and launches["accumulate"] > 0,
           f"main path did not launch every kernel: {launches}")

    # ---- answers against the plain versions on the card and the host
    st = rt._state
    for n in sizes:
        X = reqs[n]
        want = []
        for lo in range(0, n, rt.max_batch_rows):
            Xc = X[lo:lo + rt.max_batch_rows]
            Xd = rt._stage32(Xc, rt._chunk_rows(Xc.shape[0]))
            want.append(_plain_predict(rt, Xd)[1][:Xc.shape[0]]
                        .cpu().numpy())
        want = np.concatenate(want)
        _check(_bits_equal(answers[n], want),
               f"main: {n} rows: raw scores != plain versions")
        _check(bool(np.all(np.isfinite(conv[n]))
                    and np.all((conv[n] > 0) & (conv[n] < 1))),
               f"main: {n} rows: converted scores not finite in (0, 1)")
    host = bst.predict(reqs[1000], raw_score=True)
    _check(_bits_equal(answers[1000], host),
           "main: raw scores != f64 host walk on 1000 rows")

    # ---- kernel times at B = 4096 against the plain versions
    from lightgbm_tpu_torch.compiler.kernel import (traverse_bucket,
                                                    traverse_bucket_plain)
    from lightgbm_tpu_torch.ops.predict import (
        accumulate_slots_exact, accumulate_slots_exact_plain)
    Xd = rt._stage32(reqs[4096], 4096)
    slots_k = torch.cat(_traverse(rt, Xd, traverse_bucket))
    slots_p, acc_p = _plain_predict(rt, Xd)
    slot_err = int((slots_k - slots_p).abs().max())
    _check(slot_err == 0, "main: kernel slots != plain")
    ex = st.export
    acc_k = accumulate_slots_exact(slots_k, st.gidx, ex["value_f64"], 1,
                                   None)
    _check(_bits_equal(acc_k.cpu().numpy(), acc_p.cpu().numpy()),
           "main: kernel accumulation != plain")
    trav_ms = _cuda_ms(lambda: _traverse(rt, Xd, traverse_bucket))
    trav_plain_ms = _cuda_ms(
        lambda: _traverse(rt, Xd, traverse_bucket_plain), iters=3, warmup=1)
    acc_ms = _cuda_ms(lambda: accumulate_slots_exact(
        slots_k, st.gidx, ex["value_f64"], 1, None))
    acc_plain_ms = _cuda_ms(lambda: accumulate_slots_exact_plain(
        slots_k, st.gidx, ex["value_f64"], 1, None), iters=3, warmup=1)

    # ---- bounds from this run's inputs
    b = 4096
    n_trees, nl = ex["leaf_values"].shape
    plane_bytes = sum(int(a.numel() * a.element_size())
                      for pl in st.planes for a in pl if a is not None)
    rows_slots = int(slots_k.shape[0])
    trav_bytes = Xd.numel() * 4 + plane_bytes + rows_slots * b * 4
    depth = _leaf_depths(ex["trees"], nl)
    gathered = slots_k[st.gidx.long()].cpu().numpy()
    visits = int(np.take_along_axis(depth, gathered, axis=1).sum())
    trav_ops = visits              # at least one integer operation each
    trav_bound = max(trav_bytes / HBM_BYTES_PER_S,
                     trav_ops / INT32_OPS_PER_S) * 1e3
    acc_bytes = (n_trees * b * 4 + n_trees * 4 + n_trees * nl * 8
                 + b * 8)
    adds = n_trees * b
    acc_bound = max(acc_bytes / HBM_BYTES_PER_S, adds / F64_ADDS_PER_S) * 1e3
    tree_depths = [int(depth[i].max()) for i in range(n_trees)]
    _emit({"phase": "main", "seed": seed, "trees": n_trees,
           "num_leaves": nl, "features": int(Xd.shape[1]),
           "max_depth": max(tree_depths),
           "depth_buckets": {str(bk.depth): sum(len(t) for t in bk.tiles)
                             for bk in st.plan.buckets},
           "tiles": st.plan.num_tiles(),
           "tile_kb": rt._tile_vmem_kb, "setup_s": setup_s,
           "p50_ms": {str(n): lat[n] for n in sizes},
           "rows_per_s_4096": 4096 / (lat[4096] / 1e3),
           "traverse_ms_4096": trav_ms, "traverse_plain_ms_4096":
           trav_plain_ms, "accumulate_ms_4096": acc_ms,
           "accumulate_plain_ms_4096": acc_plain_ms,
           "node_visits_4096": visits, "traverse_bytes_4096": trav_bytes,
           "accumulate_bytes_4096": acc_bytes, "library_ms": None,
           "launches": launches})
    return [
        {"name": "traverse", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/traverse.cu",
         "replaces": "lightgbm_tpu/compiler/kernel.py:60",
         "launches": launches["traverse"], "max_abs_err": slot_err,
         "ms": trav_ms, "plain_ms": trav_plain_ms, "bound_ms": trav_bound,
         "bound_by": "bytes" if trav_bytes / HBM_BYTES_PER_S
         >= trav_ops / INT32_OPS_PER_S else "operations",
         "library_ms": None},
        {"name": "accumulate_exact", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/accumulate.cu",
         "replaces": "lightgbm_tpu/ops/predict.py:501",
         "launches": launches["accumulate"],
         "max_abs_err": float(np.max(np.abs(acc_k.cpu().numpy()
                                            - acc_p.cpu().numpy()))),
         "ms": acc_ms, "plain_ms": acc_plain_ms, "bound_ms": acc_bound,
         "bound_by": "bytes" if acc_bytes / HBM_BYTES_PER_S
         >= adds / F64_ADDS_PER_S else "operations",
         "library_ms": None},
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import lightgbm_tpu_torch.compiler.kernel as kernel_module
        import lightgbm_tpu_torch.ops.predict as predict_module
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    try:
        smi = phase_env()
        phase_golden(args.seed)
        kernels = phase_main(args.seed, kernel_module, predict_module)
        _emit({"phase": "kernels", "kernels": [
            {"name": k["name"], "launches": k["launches"],
             "parity": "bitwise" if k["max_abs_err"] == 0 else "differs"}
            for k in kernels]})
        _emit({"kernels": kernels})
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
