"""The port's two-rank learners against the reference's own two-shard
runs (`lgb.train` with `num_machines=2` on the 8 virtual CPU devices of
this process), model text byte for byte, parameters included: the
deterministic data learner (strict and wave), whose models are also the
serial ones, and the learners whose models the reference does not make
serial (feature, and data with `deterministic_reduce` off), where a
sum of two ranks is one add on both sides.  The ranks are subprocesses of `torch_dist_worker.py` on one
`save_binary` file."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from torch_dist_worker import (assert_reference_two_shard,  # noqa: E402
                               strip_params, two_shard_cluster)

#: (the voting cases and the nondeterministic wave are in
#: test_torch_dist_vote.py, which runs beside this file)
CASES = {
    "data_strict": {},
    "data_wave": {"tree_grow_policy": "wave"},
    "feature": {"tree_learner": "feature"},
    "data_nondet": {"deterministic_reduce": False},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return two_shard_cluster(tmp_path_factory.mktemp("dist_ref"), CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_are_the_reference_two_shard_model(run, name):
    assert_reference_two_shard(run, name, CASES[name])


def test_nondeterministic_data_model_is_not_the_serial_one(run):
    """With `deterministic_reduce` off, the summed histograms add in
    another order than the serial ones: on this set the model differs
    from the deterministic (serial) model, as the reference's does."""
    got, _ = run
    assert strip_params(got[("data_nondet", 0)][0]) != \
        strip_params(got[("data_strict", 0)][0])
