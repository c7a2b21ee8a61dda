"""The port's distributed learners on the CPU: two gloo ranks, subprocesses
of `torch_dist_worker.py`, train every case of one job on one
`save_binary` file, and each model is held byte for byte (less its
parameter lines) to the port's serial model and, where the reference
makes the sharded model serial, the reference's serial model
(`tests/test_distributed.py`'s gates; test_torch_dist_serial_ref.py
holds the port's serial models of these cases to the reference's).

* DETERMINISTIC — `tree_learner=data` with `deterministic_reduce` on,
  strict and wave, f32, quantized and packed: the reduce-scatter block
  mode (`data_rs`) on the plain set, the full-histogram `data` mode on
  the bundled one; the plain segment_sum family too
  (`torch_dist_worker.DET`).  1001 rows and 7 features: neither divides
  the 2 ranks.
* CONSTRAINTS and MODES — CEGB with interaction constraints (wave),
  forced splits, fractional weights, bagging: the serial model.
* DOWNGRADES — feature with the wave policy (strict, warned), feature
  under EFB (data, warned), `streaming_train=on` (the placed matrix,
  warned), each rank's rows read from a spilled set's shards.
* The collectives are counted: ring hops, the broadcast, the leaf ids'
  all_gather once a tree, the split merge, the integer carries' sums.
* One process with `tree_learner=data` trains with the serial learner
  and says so.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.booster import learner_topology, refusals  # noqa
from lightgbm_tpu_torch.mesh import (feature_block,  # noqa: E402
                                     parse_mesh_shape, row_block,
                                     row_counts)
from lightgbm_tpu_torch.parallel.learner import unpack_split  # noqa: E402
from lightgbm_tpu_torch.utils.config import Config  # noqa: E402
from torch_dist_worker import (BASE, DET, ROUNDS, make_sets,  # noqa: E402
                               run_cluster, strip_params)

#: cases held to the port's serial model only: (dataset, extra params,
#: the serial run's params where they differ, a warning the ranks log)
MORE = {
    "cegb_ic_wave": ("base", {
        "tree_grow_policy": "wave", "cegb_tradeoff": 0.5,
        "cegb_penalty_split": 0.01,
        "cegb_penalty_feature_coupled": [2.0] * 7,
        "interaction_constraints": [[0, 1, 2, 3], [3, 4, 5, 6]]},
        None, None),
    "forced_strict": ("base", {"forcedsplits_filename": "FORCED"},
                      None, None),
    "weighted_wave": ("weighted", {"tree_grow_policy": "wave"}, None, None),
    "bagged_strict": ("base", {"bagging_fraction": 0.7,
                               "bagging_freq": 1}, None, None),
    "feature_wave": ("base", {"tree_learner": "feature",
                              "tree_grow_policy": "wave"},
                     {"tree_grow_policy": "leafwise"},
                     "wave supports serial and data-parallel"),
    "feature_efb": ("efb", {"tree_learner": "feature"}, None,
                    "falls back to the data-parallel strategy"),
    "spilled_stream": ("arrays", {"streaming_train": "on"},
                       {"streaming_train": "off"},
                       "streaming_train=on is not supported with "
                       "tree_learner=data"),
}
SPILL = {"external_memory": True, "datastore_shard_rows": 128}


def _params(extra, forced):
    p = dict(BASE, **extra)
    if p.get("forcedsplits_filename") == "FORCED":
        p["forcedsplits_filename"] = forced
    return p


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case on two ranks, once, and the port's serial models."""
    tmp = tmp_path_factory.mktemp("dist_train")
    data = make_sets(str(tmp))
    forced = str(tmp / "forced.json")
    with open(forced, "w") as f:
        json.dump({"feature": 1, "threshold": 0.0,
                   "left": {"feature": 0, "threshold": -0.5}}, f)
    cases = [{"name": k, "data": d, "params": _params(e, forced),
              "rounds": ROUNDS} for k, (d, e) in DET.items()]
    cases += [{"name": k, "data": d, "params": _params(e, forced),
               "rounds": ROUNDS, "dataset_params": SPILL}
              for k, (d, e, _, _) in MORE.items()]
    got = run_cluster(str(tmp), 2, {"data": data, "cases": cases,
                                    "timeout_ms": 60000})
    serial = {}
    for c in cases:
        extra = dict(MORE[c["name"]][2] or {}) if c["name"] in MORE else {}
        p = dict(c["params"], tree_learner="serial", device_type="cpu",
                 **extra)
        path = data["base" if c["data"] == "arrays" else c["data"]]
        serial[c["name"]] = lt.train(p, lt.Dataset.load_binary(path),
                                     ROUNDS).model_to_string()
    return {"got": got, "serial": serial, "data": data, "cases": cases}


def _ranks_agree(run, name):
    t0 = run["got"][(name, 0)][0]
    assert run["got"][(name, 1)][0] == t0, name
    return t0


@pytest.mark.parametrize("name", sorted(DET))
def test_deterministic_models_are_serial(run, name):
    """Byte for byte the port's serial model (which
    test_torch_dist_serial_ref.py holds to the reference's)."""
    text = _ranks_agree(run, name)
    assert strip_params(text) == strip_params(run["serial"][name])


@pytest.mark.parametrize("name", sorted(MORE))
def test_constraints_modes_and_downgrades_are_serial(run, name):
    text = _ranks_agree(run, name)
    assert strip_params(text) == strip_params(run["serial"][name])
    warn = MORE[name][3]
    if warn is not None:
        for r in (0, 1):
            lines = run["got"][(name, r)][1]["warnings"]
            assert any(warn in ln for ln in lines), (r, lines)


def test_collectives_are_counted(run):
    """One all_gather of the leaf ids a tree; the ring's hops and the
    last rank's broadcast a histogram; the split merge a search; the
    integer carries summed with one all_reduce."""
    st = run["got"][("rs_strict_f32", 0)][1]["stats"]
    assert st["leaf_ids"]["calls"] == ROUNDS
    assert st["leaf_ids"]["bytes"] == ROUNDS * 501 * 4   # rank 0's block
    assert st["broadcast_last"]["calls"] > 0
    assert st["merge_split"]["calls"] > 0
    hops0 = run["got"][("rs_strict_f32", 0)][1]["stats"]["ring_fold"]
    hops1 = run["got"][("rs_strict_f32", 1)][1]["stats"]
    assert hops0["calls"] == st["broadcast_last"]["calls"] and \
        hops0["bytes"] > 0                   # rank 0 sends every carry
    assert hops1["ring_fold"]["calls"] == 0  # the last rank only receives
    assert run["got"][("rs_strict_quant", 0)][1]["stats"][
        "hist_psum_int"]["calls"] > 0
    # CPU tensors: no host staging under gloo
    assert st["broadcast_last"]["d2h_s"] == 0.0


@pytest.mark.parametrize("n,s", [(1001, 2), (1001, 4), (5, 4), (8, 3)])
def test_row_and_feature_blocks(n, s):
    """Blocks of ceil(n / s), ascending, the last short (or empty)."""
    blocks = [row_block(n, s, p) for p in range(s)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert row_counts(n, s) == [hi - lo for lo, hi in blocks]
    assert max(row_counts(n, s)) == -(-n // s)
    assert [feature_block(n, s, p) for p in range(s)] == blocks


def test_unpack_split_round_trips():
    rng = np.random.RandomState(0)
    from lightgbm_tpu_torch.ops.split import SplitResult
    b, mb = 3, 30
    res = SplitResult(
        gain=torch.tensor([1.5, float("-inf"), 0.25]),
        feature=torch.tensor([4, -1, 0]), threshold_bin=torch.tensor([7, 0,
                                                                     2]),
        default_left=torch.tensor([True, False, True]),
        **{k: torch.from_numpy(rng.randn(b).astype(np.float32))
           for k in ("left_sum_g", "left_sum_h", "left_cnt", "right_sum_g",
                     "right_sum_h", "right_cnt")},
        is_cat=torch.tensor([True, False, False]),
        cat_mask=torch.from_numpy(rng.rand(b, mb) > 0.5))
    back = unpack_split(res.pack(), mb)
    for a, c in zip(res, back):
        assert torch.equal(a, c)


def test_parse_mesh_shape_and_topology():
    assert parse_mesh_shape("2x4") == (2, 4)
    assert parse_mesh_shape("8") == (8,)
    assert parse_mesh_shape("auto") is None
    with pytest.raises(ValueError):
        parse_mesh_shape("2x2x2")
    # without a process group: one rank
    assert learner_topology(Config({"tree_learner": "data_parallel",
                                    "num_machines": 2}))[:3] == \
        ("data", 1, 1)
    assert learner_topology(Config({"tree_learner": "feature"}),
                            bundled=True)[0] == "data"


def test_refusals_name_no_distributed_setting():
    import lightgbm_tpu_torch.booster as booster
    for p in ({"tree_learner": "voting"}, {"tree_learner": "feature"},
              {"num_machines": 4, "tree_learner": "data"}):
        assert refusals(Config(p)) == []
    assert not hasattr(booster, "DISTRIBUTED")


def test_one_rank_trains_with_the_serial_learner(caplog):
    rng = np.random.RandomState(3)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "device_type": "cpu", "num_leaves": 7}
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        dist = lt.train(dict(p, tree_learner="voting"),
                        lt.Dataset(X, label=y), 3)
    assert any("using the serial learner" in r.getMessage()
               for r in caplog.records)
    serial = lt.train(p, lt.Dataset(X, label=y), 3)
    assert strip_params(dist.model_to_string()) == \
        strip_params(serial.model_to_string())


def test_sharded_train_step_on_a_one_rank_group(tmp_path):
    """`parallel.make_sharded_train_step` over a one-rank gloo group (in
    this process): `shard_dataset` places every row, the summed
    histograms and the merge are the identity, and three steps' trees
    and scores are the serial grower's bit for bit."""
    from lightgbm_tpu_torch import mesh
    from lightgbm_tpu_torch.ops.grow import GrowerSpec, make_grower
    from lightgbm_tpu_torch.parallel import (make_sharded_train_step,
                                             shard_dataset)
    rng = np.random.RandomState(5)
    ds = lt.Dataset(rng.randn(600, 5), label=(rng.rand(600) > 0.5)
                    .astype(float)).construct()
    spec = GrowerSpec(num_leaves=7, max_depth=-1,
                      max_bin=max(m.num_bin for m in ds.bin_mappers),
                      lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20.0,
                      min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                      max_delta_step=0.0)
    nb = np.array([m.num_bin for m in ds.bin_mappers], np.int32)
    miss = np.array([m.missing_type for m in ds.bin_mappers], np.int32)
    feat = dict(nb=torch.from_numpy(nb), missing=torch.from_numpy(miss),
                default=torch.from_numpy(np.array(
                    [m.default_bin for m in ds.bin_mappers], np.int32)),
                is_cat=torch.zeros(5, dtype=torch.bool), nb_np=nb,
                missing_np=miss)
    allowed = torch.ones(5, dtype=torch.bool)

    def grad_fn(score, label):
        p = torch.sigmoid(score)
        return p - label, p * (1 - p)

    mesh.init(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo",
              timeout_ms=30000)
    try:
        m1 = mesh.get_mesh()
        bins, label, w, n_pad = shard_dataset(ds.bin_data, ds.get_label(),
                                              m1)
        assert n_pad == 0 and bins.shape == (5, 600)
        step = make_sharded_train_step(spec, m1, grad_fn, 0.1,
                                       num_data=600, num_feature=5)
        grow = make_grower(spec)
        s_dist = s_ser = torch.zeros(600)
        for _ in range(3):
            s_dist, t_dist = step(s_dist, label, w, bins, feat, allowed)
            g, h = grad_fn(s_ser, label)
            t_ser = grow(bins, g, h, w, feat, allowed)
            s_ser = s_ser + t_ser.values[t_ser.leaf_id.long()] * 0.1
            assert t_dist.n_splits == t_ser.n_splits
            assert np.array_equal(t_dist.split_feature, t_ser.split_feature)
            assert np.array_equal(t_dist.leaf_value, t_ser.leaf_value)
            assert torch.equal(s_dist, s_ser)
    finally:
        mesh.shutdown()
