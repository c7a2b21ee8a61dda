"""The port's threefry2x32 (`lightgbm_tpu_torch/ops/threefry.py`) against
`jax.random`, on the CPU, bit for bit (integer arithmetic: no
tolerance).

  * `prng_key` against `jax.random.PRNGKey` over seeds up to 2^31 - 1;
  * `fold_in` against `jax.random.fold_in` for data up to 2^32 - 1;
  * `split` against `jax.random.split`;
  * `uniform` against `jax.random.uniform` at shapes of 0, 1, 7, 2100
    and 65,537 elements (past 2^16, where the counters' words matter)
    and a 2-D shape (row-major flat counters);
  * the state the two packages must share: a booster's `_rng_key0` for
    a `bagging_seed`, and the quantizer's per-iteration key.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.ops import threefry  # noqa: E402

SEEDS = [0, 1, 3, 42, 123456789, 2 ** 31 - 1]


def _jax_words(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.uint32
    return a.astype(np.int64)


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    return x.view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    got = threefry.prng_key(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    assert np.array_equal(got.numpy(), _jax_words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_fold_in_matches(seed, data):
    got = threefry.fold_in(threefry.prng_key(seed), data)
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert np.array_equal(got.numpy(), _jax_words(want))


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_split_matches(seed, num):
    got = threefry.split(threefry.prng_key(seed), num)
    want = jax.random.split(jax.random.PRNGKey(seed), num)
    assert got.shape == (num, 2)
    assert np.array_equal(got.numpy(), _jax_words(want))


@pytest.mark.parametrize("shape", [(0,), (1,), (7,), (2100,), (65537,),
                                   (300, 7)],
                         ids=["0", "1", "7", "2100", "65537", "300x7"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 - 1])
def test_uniform_matches(seed, shape):
    kp = threefry.fold_in(threefry.prng_key(seed), 9)
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    got = threefry.uniform(kp, shape)
    want = jax.random.uniform(kj, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    if got.numel():
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_uniform_of_a_split_key_matches():
    """The quantizer's draw: `uniform(split(key)[i])` of the key
    `fold_in(key0, 2 it + 1)`."""
    kp = threefry.fold_in(threefry.prng_key(3), 2 * 4 + 1)
    kj = jax.random.fold_in(jax.random.PRNGKey(3), 2 * 4 + 1)
    for i in range(2):
        got = threefry.uniform(threefry.split(kp)[i], (4099,))
        want = jax.random.uniform(jax.random.split(kj)[i], (4099,))
        assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_seed_outside_the_range_raises():
    with pytest.raises(ValueError):
        threefry.prng_key(2 ** 31)
    with pytest.raises(ValueError):
        threefry.fold_in(threefry.prng_key(0), -1)


@pytest.mark.parametrize("bagging_seed", [3, 2 ** 31 + 5])
def test_booster_key_state_matches(bagging_seed):
    """`bagging_seed` gives the same `_rng_key0` bits in both packages."""
    rng = np.random.RandomState(0)
    X = rng.randn(200, 4)
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "verbosity": -1,
              "use_quantized_grad": True, "bagging_seed": bagging_seed}
    bj = lgb.Booster(dict(params), lgb.Dataset(X, label=y))
    bp = lt.Booster(dict(params, device_type="cpu"), lt.Dataset(X, label=y))
    assert np.array_equal(bp._rng_key0.numpy(), _jax_words(bj._rng_key0))
