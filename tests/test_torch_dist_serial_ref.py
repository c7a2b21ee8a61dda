"""The serial models that test_torch_dist_train.py holds the port's
two-rank deterministic models to, held byte for byte (less their
parameter lines) to the reference's serial models of the same cases
(`torch_dist_worker.DET`): so the sharded models are the reference's
serial ones, as `tests/test_distributed.py` requires of its own."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from torch_dist_worker import (BASE, DET, ROUNDS, make_sets,  # noqa: E402
                               strip_params)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_sets(str(tmp_path_factory.mktemp("dist_serial_ref")))


@pytest.mark.parametrize("name", sorted(DET))
def test_serial_models_are_the_reference_serial_models(data, name):
    d, extra = DET[name]
    p = dict(BASE, **extra, device_type="cpu", tree_learner="serial")
    port = lt.train(p, lt.Dataset.load_binary(data[d]), ROUNDS)
    ref = lgb.train(p, lgb.Dataset.load_binary(data[d]), ROUNDS)
    assert strip_params(port.model_to_string()) == \
        strip_params(ref.model_to_string())
