"""The chunk entries (`dispatch_chunk_eval`, `harvest_chunk_eval`,
`update_chunk_eval`) against the live JAX package on the CPU.

A chunk is 16 boosting iterations with the scores after each.  Held:
the model texts equal the reference's chunk (which runs the rounds as
one fused device program), the snapshots equal the reference's and the
port's serial loop's per-round scores bitwise, a harvest out
of dispatch order raises, and a rollback after a chunk replays as the
reference's does.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """ROADMAP Queue 3 (f): one intra-op thread for the links."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _data(name, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(700, 5)
    if name == "multiclass":
        y = (X[:, 0] > 0.3).astype(float) + (X[:, 1] > 0).astype(float)
    else:
        y = (X[:, 0] - 0.5 * X[:, 1] + 0.4 * rng.randn(700) > 0
             ).astype(float)
    return X, y


def _params(name):
    p = {"objective": name, "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 5, "learning_rate": 0.2}
    if name == "multiclass":
        p["num_class"] = 3
    return p


def _booster(pkg, name, valid=True):
    X, y = _data(name, 4)
    params = _params(name)
    if pkg is lt:
        params["device_type"] = "cpu"
    ds = pkg.Dataset(X, label=y)
    bst = pkg.Booster(params=params, train_set=ds)
    if valid:
        Xv, yv = _data(name, 5)
        bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "v")
    return bst


def _text(bst):
    return bst.model_to_string().replace("[device_type: cpu]\n", "")


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_update_chunk_eval_matches_reference_and_serial_loop(name):
    ref = _booster(lgb, name)
    ours = _booster(lt, name)
    r_fin, r_train, r_valid = ref.update_chunk_eval(True)
    fin, train, valid = ours.update_chunk_eval(True)
    assert ours.current_iteration() == ref.current_iteration() == 16
    assert _text(ours) == _text(ref)
    assert fin == r_fin
    # the reference's fused chunk gives the same snapshots, bitwise
    assert _bits(train, np.asarray(r_train))
    assert len(valid) == len(r_valid) == 1
    assert _bits(valid[0], np.asarray(r_valid[0]))
    # the serial loop's scores after each round, bitwise
    serial = _booster(lt, name)
    for j in range(16):
        serial.update()
        assert _bits(train[j], serial._train_score.numpy())
        assert _bits(valid[0][j], serial._valid_scores[0].numpy())
    # a second chunk continues the model as the reference's does
    ref.update_chunk_eval(False)
    fin, train, valid = ours.update_chunk_eval(False)
    assert train is None and valid[0].shape[0] == 16
    assert _text(ours) == _text(ref)


def test_chunk_snapshots_feed_eval_with_scores():
    """The engine's use: metrics from each snapshot equal the serial
    loop's `eval_valid` after that round."""
    ours = _booster(lt, "binary")
    serial = _booster(lt, "binary")
    _, _, valid = ours.update_chunk_eval(False)
    for j in range(16):
        serial.update()
        got = ours.eval_with_scores(valid[0][j], ours.valid_sets[0], "v",
                                    None, j + 1)
        assert got == serial.eval_valid()


def test_harvest_out_of_dispatch_order_raises():
    ours = _booster(lt, "binary", valid=False)
    p1 = ours.dispatch_chunk_eval(False)
    p2 = ours.dispatch_chunk_eval(True)
    with pytest.raises(lt.LightGBMError, match="dispatch order"):
        ours.harvest_chunk_eval(p2)
    fin, train, valid = ours.harvest_chunk_eval(p1)
    assert train is None and valid == []
    fin, train, valid = ours.harvest_chunk_eval(p2)
    assert train.shape == (16, 700)
    assert ours.current_iteration() == 2 * ours._BULK_CHUNK
    with pytest.raises(lt.LightGBMError, match="dispatch order"):
        ours.harvest_chunk_eval(p2)


def test_rollback_after_a_chunk_replays_as_the_reference():
    ref = _booster(lgb, "binary")
    ours = _booster(lt, "binary")
    ref.update_chunk_eval(True)
    ours.update_chunk_eval(True)
    ref.rollback_one_iter()
    ours.rollback_one_iter()
    assert _text(ours) == _text(ref)
    assert _bits(ours._train_score.numpy(), np.asarray(ref._train_score))
    assert _bits(ours._valid_scores[0].numpy(),
                 np.asarray(ref._valid_scores[0]))
