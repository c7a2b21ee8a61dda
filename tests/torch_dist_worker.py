"""One rank of a gloo process group for the distributed tests of the
PyTorch port (`test_torch_dist_train.py`, `test_torch_dist_serving.py`).

    python tests/torch_dist_worker.py RANK WORLD STORE_FILE JOB_JSON

Joins the group through a file store, then runs every case of the job:
`lightgbm_tpu_torch.train` with the case's params on the case's Dataset
(a `save_binary` file that every rank loads, or, for a spilled set, the
arrays of an npz file spilled into a directory of this rank's own), and
writes `<out>/<case>.r<rank>.txt` (the model text) and
`<out>/<case>.r<rank>.json` (the collectives' counts and the warnings the
rank logged).  One thread a rank; every collective times out after the
job's `timeout_ms`, so a lost rank fails its peers instead of hanging
them.  Prints `rank R: OK` at the end.
"""
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _dataset(lt, case, job, rank):
    src = case.get("data", "base")
    path = job["data"][src]
    if path.endswith(".npz"):
        import numpy as np
        z = np.load(path)
        params = dict(case.get("dataset_params", {}),
                      datastore_dir=os.path.join(job["out"],
                                                 f"store-{case['name']}-r"
                                                 f"{rank}"))
        return lt.Dataset(z["X"], label=z["y"], params=params)
    return lt.Dataset.load_binary(path)


#: the distributed tests' base parameters and rounds
BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
        "min_data_in_leaf": 20, "tree_learner": "data"}
ROUNDS = 5

#: the deterministic cases, (dataset, extra params): `tree_learner=data`
#: with `deterministic_reduce` on, strict and wave; f32 (K1's family, and
#: segment_sum's), quantized (K4's family) and packed; the block mode
#: `data_rs` on the plain set and the full-histogram `data` mode on the
#: bundled one
QUANT = {"use_quantized_grad": True}
PACKED = {"use_quantized_grad": True, "hist_impl": "packed"}
WAVE = {"tree_grow_policy": "wave"}
DET = {
    "rs_strict_f32": ("base", {}),
    "rs_wave_f32": ("base", WAVE),
    "rs_strict_plain": ("base", {"hist_impl": "segment_sum"}),
    "rs_strict_quant": ("base", QUANT),
    "rs_wave_quant": ("base", dict(QUANT, **WAVE)),
    "rs_strict_packed": ("base", PACKED),
    "rs_wave_packed": ("base", dict(PACKED, **WAVE)),
    "efb_strict_f32": ("efb", {}),
    "efb_wave_f32": ("efb", WAVE),
    "efb_strict_quant": ("efb", QUANT),
    "efb_wave_packed": ("efb", dict(PACKED, **WAVE)),
}


def make_sets(dirpath):
    """The tests' Datasets, written once: `base` (1001 rows x 7 features,
    neither divisible by 2 or 4), `efb` (3 numerical and 6 one-hot
    columns, which bundle), `weighted` (base with fractional weights) as
    `save_binary` files, and `arrays` (base's raw matrix, for a spilled
    set).  Returns {name: path}."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    rng = np.random.RandomState(0)
    n = 1001
    X = rng.randn(n, 7)
    y = (X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) - 0.5 * X[:, 3]
         + 0.5 * rng.randn(n) > 0).astype(np.float64)
    cat = rng.randint(0, 6, n)
    oh = np.eye(6)[cat]
    Xe = np.hstack([rng.randn(n, 3), oh])
    ye = (Xe[:, 0] + 1.5 * oh[:, 1] - oh[:, 3] + 0.3 * rng.randn(n)
          > 0).astype(np.float64)
    w = rng.uniform(0.2, 1.7, n)
    paths = {k: os.path.join(dirpath, f"{k}.bin")
             for k in ("base", "efb", "weighted")}
    lt.Dataset(X, label=y).construct().save_binary(paths["base"])
    lt.Dataset(Xe, label=ye).construct().save_binary(paths["efb"])
    lt.Dataset(X, label=y, weight=w).construct().save_binary(
        paths["weighted"])
    paths["arrays"] = os.path.join(dirpath, "arrays.npz")
    np.savez(paths["arrays"], X=X, y=y)
    return paths


def run_cluster(dirpath, world, job, timeout_s=300.0):
    """Run `job` (its "cases", "data" paths) on `world` ranks of this
    script, each a subprocess joined through a file store under
    `dirpath`; every child is killed when `timeout_s` passes.  Returns
    {(case, rank): (model text, {"stats", "warnings"})} and raises with
    the ranks' output when one fails."""
    import subprocess
    import time
    out = os.path.join(dirpath, f"out{world}")
    os.makedirs(out, exist_ok=True)
    job = dict(job, out=out)
    job_path = os.path.join(dirpath, f"job{world}.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    store = os.path.join(dirpath, f"store{world}")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    # each rank's output to a file: a full pipe would stall a rank that
    # its peers wait on
    log_paths = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(log_paths[r], "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r),
                 str(world), store, job_path], stdout=lf,
                stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = []
        for r, lp in enumerate(log_paths):
            with open(lp) as f:
                logs.append(f"--- rank {r} ---\n{f.read()[-3000:]}")
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(logs))
    res = {}
    for case in job["cases"]:
        if case.get("world", world) != world:
            continue
        for r in range(world):
            base = os.path.join(out, f"{case['name']}.r{r}")
            with open(base + ".txt") as f:
                text = f.read()
            with open(base + ".json") as f:
                res[(case["name"], r)] = (text, json.load(f))
    return res


def two_shard_cluster(tmp, cases):
    """Each of `cases` ({name: extra params}) on two ranks with
    `num_machines=2`, on the base set: (results, data paths)."""
    data = make_sets(str(tmp))
    job = [{"name": k, "data": "base", "rounds": ROUNDS,
            "params": dict(BASE, num_machines=2, **e)}
           for k, e in cases.items()]
    return run_cluster(str(tmp), 2, {"data": data, "cases": job,
                                     "timeout_ms": 60000}), data


def assert_reference_two_shard(run, name, extra):
    """Both ranks' model text of case `name` is the reference's own
    two-shard model (`num_machines=2` on this process's virtual CPU
    devices) byte for byte, parameter lines included."""
    import lightgbm_tpu as lgb
    got, data = run
    text = got[(name, 0)][0]
    assert got[(name, 1)][0] == text
    # the workers' order of parameters, which the model text echoes
    p = dict(BASE, num_machines=2, **extra, device_type="cpu")
    ref = lgb.train(p, lgb.Dataset.load_binary(data["base"]), ROUNDS)
    assert ref._mesh is not None           # the reference did shard
    assert text == ref.model_to_string()


def strip_params(text):
    """A model text less its `[key: value]` parameter lines."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("["))


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, job_path = sys.argv[3], sys.argv[4]
    import torch
    torch.set_num_threads(1)
    with open(job_path) as f:
        job = json.load(f)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import mesh
    from lightgbm_tpu_torch.utils import log
    handler = _Warnings()
    logger = logging.getLogger("lightgbm_tpu_torch.dist_worker")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    log.register_logger(logger)
    mesh.init(f"file://{store}", world, rank, backend="gloo",
              timeout_ms=float(job.get("timeout_ms", 60000)))
    for case in job["cases"]:
        if case.get("world", world) != world:
            continue
        if case.get("exit_rank") == rank:
            os._exit(3)                 # a lost rank, for the tests
        handler.lines = []
        mesh.reset_stats()
        params = dict(case["params"], device_type="cpu")
        bst = lt.train(params, _dataset(lt, case, job, rank),
                       num_boost_round=case["rounds"])
        base = os.path.join(job["out"], f"{case['name']}.r{rank}")
        with open(base + ".txt", "w") as f:
            f.write(bst.model_to_string())
        with open(base + ".json", "w") as f:
            json.dump({"stats": mesh.STATS, "warnings": handler.lines}, f)
    mesh.shutdown()
    print(f"rank {rank}: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
