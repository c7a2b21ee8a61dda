"""Four gloo ranks (subprocesses of `torch_dist_worker.py`): a 2 x 2
("dcn", "ici") mesh (`tpu_dcn_slices=2`), held to the reference's 2-level
run on four of this process's virtual CPU devices within the
reference's own tolerance (`tests/test_distributed.py:339`: split
features equal, raw scores within rtol 2e-4 / atol 2e-5), and
`num_machines=2` in a group of four: a two-rank mesh whose model is the
serial one, while the two ranks outside it train with the serial
learner.  And a lost rank: its peers raise within the collective
timeout instead of carrying on or hanging."""
import sys
from pathlib import Path

import time

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from torch_dist_worker import (BASE, ROUNDS, make_sets,  # noqa: E402
                               run_cluster, strip_params)

CASES = {"mesh_2x2": {"tpu_dcn_slices": 2},
         "mesh_2x2_wave": {"tpu_dcn_slices": 2, "tree_grow_policy": "wave"},
         "num_machines_2": {"num_machines": 2}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_mesh")
    data = make_sets(str(tmp))
    cases = [{"name": k, "data": "base", "rounds": ROUNDS,
              "params": dict(BASE, **e)} for k, e in CASES.items()]
    got = run_cluster(str(tmp), 4, {"data": data, "cases": cases,
                                    "timeout_ms": 60000})
    return got, data


@pytest.mark.parametrize("name", ["mesh_2x2", "mesh_2x2_wave"])
def test_two_level_mesh_within_the_reference_tolerance(run, name):
    got, data = run
    text = got[(name, 0)][0]
    assert all(got[(name, r)][0] == text for r in range(4))
    p = dict(BASE, num_machines=4, device_type="cpu", **CASES[name])
    ref = lgb.train(p, lgb.Dataset.load_binary(data["base"]), ROUNDS)
    assert ref._mesh is not None and len(ref._mesh.axis_names) == 2
    port = lt.Booster(model_str=text)
    assert port.num_trees() == ref.num_trees()
    for a, b in zip(port.trees, ref.trees):
        ni = b.num_internal()
        assert np.array_equal(a.split_feature[:ni], b.split_feature[:ni])
    X = np.load(data["arrays"])["X"]
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True),
                               rtol=2e-4, atol=2e-5)


def test_num_machines_below_the_world_is_serial(run):
    got, data = run
    p = dict(BASE, tree_learner="serial", device_type="cpu")
    serial = lt.train(p, lt.Dataset.load_binary(data["base"]), ROUNDS)
    for r in range(4):
        assert strip_params(got[("num_machines_2", r)][0]) == \
            strip_params(serial.model_to_string()), r
    # ranks 0 and 1 form the mesh; 2 and 3 gather nothing
    assert got[("num_machines_2", 0)][1]["stats"]["leaf_ids"]["calls"] \
        == ROUNDS
    assert "leaf_ids" not in got[("num_machines_2", 2)][1]["stats"]


def test_a_lost_rank_fails_its_peers(tmp_path):
    """Rank 1 exits before its first tree: rank 0's first collective
    raises (the peer's closed connection, or the 5 s timeout), so the
    cluster fails fast and names it."""
    data = make_sets(str(tmp_path))
    case = {"name": "lost", "data": "base", "rounds": ROUNDS,
            "params": dict(BASE), "exit_rank": 1}
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] failed"):
        run_cluster(str(tmp_path), 2, {"data": data, "cases": [case],
                                       "timeout_ms": 5000}, timeout_s=120)
    assert time.monotonic() - t0 < 100
