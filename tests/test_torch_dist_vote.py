"""The port's two-rank voting learner, and the data learner's wave with
`deterministic_reduce` off, against the reference's own two-shard runs
(`num_machines=2` on this process's virtual CPU devices), model text
byte for byte, parameters included (beside test_torch_dist_ref.py).
Voting with `top_k` below F / 2 elects a subset and sums only its
histograms; with extra_trees every search has a candidate grid, and the
whole histograms are summed, as the reference does."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from torch_dist_worker import (assert_reference_two_shard,  # noqa: E402
                               two_shard_cluster)

CASES = {
    "voting": {"tree_learner": "voting", "top_k": 2},
    "voting_extra_trees": {"tree_learner": "voting", "top_k": 2,
                           "extra_trees": True},
    "data_nondet_wave": {"deterministic_reduce": False,
                         "tree_grow_policy": "wave"},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return two_shard_cluster(tmp_path_factory.mktemp("dist_vote"), CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_are_the_reference_two_shard_model(run, name):
    assert_reference_two_shard(run, name, CASES[name])


def test_voting_elects_and_sums_only_the_elected(run):
    """Votes are summed a search; the histograms summed are the 2 top_k
    = 4 elected features' of the 7, while extra_trees sums all 7."""
    got, _ = run
    st = got[("voting", 0)][1]["stats"]
    assert st["votes"]["calls"] > 0
    per = st["hist_psum"]["bytes"] / st["hist_psum"]["calls"]
    st_x = got[("voting_extra_trees", 0)][1]["stats"]
    per_x = st_x["hist_psum"]["bytes"] / st_x["hist_psum"]["calls"]
    assert "votes" not in st_x
    assert per * 7 <= per_x * 4 * 2   # at most 4 of 7 features a child
