"""The port's threefry2x32 (`lightgbm_tpu_torch/ops/threefry.py`) against
`jax.random`, on the CPU, bit for bit (integer arithmetic: no
tolerance).

  * `prng_key` against `jax.random.PRNGKey` over seeds up to 2^31 - 1;
  * `fold_in` against `jax.random.fold_in` for data up to 2^32 - 1;
  * `split` against `jax.random.split`;
  * `uniform` against `jax.random.uniform` at shapes of 0, 1, 7, 2100
    and 65,537 elements (past 2^16, where the counters' words matter)
    and a 2-D shape (row-major flat counters);
  * `random_bits` against `jax.random.bits` and `permutation` against
    `jax.random.permutation` at n = 1, 2, 6, 28, 1000 and 5000 (two sort
    rounds);
  * the batched keys: `fold_in` over R keys or R data words, `split`,
    `random_bits`, `uniform` and `permutation` over [R, 2] keys, each
    equal to R separate calls;
  * `lax.sort_key_val` on forced ties keeps the input order, which the
    port's stable `torch.sort` reproduces;
  * the wrapper's dispatch: CPU draws run the plain version (no kernel
    launch), other devices without the kernel raise;
  * the state the two packages must share: a booster's `_rng_key0` for
    a `bagging_seed`, and the quantizer's per-iteration key.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.ops import threefry  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402

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


DRAW_SIZES = [1, 2, 6, 28, 1000, 5000]


@pytest.mark.parametrize("n", DRAW_SIZES)
@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_random_bits_and_permutation_match(seed, n):
    kp = threefry.fold_in(threefry.prng_key(seed), 17)
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    bits = threefry.random_bits(kp, (n,))
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (n,)
    assert np.array_equal(bits.numpy().view(np.uint32),
                          np.asarray(jax.random.bits(kj, (n,), np.uint32)))
    perm = threefry.permutation(kp, n)
    assert np.array_equal(perm.numpy(), np.asarray(
        jax.random.permutation(kj, n)))
    assert sorted(perm.tolist()) == list(range(n))


def test_permutation_rounds_follow_the_reference():
    """0 rounds at n = 1, 1 up to about 1600, 2 at 5000."""
    assert [threefry.permutation_rounds(n) for n in (1, 2, 1600, 1700,
                                                     5000)] == [0, 1, 1, 2, 2]


def test_batched_keys_equal_per_key_loops():
    key = threefry.prng_key(5)
    data = [0, 1, 7, 2 ** 24 + 3, 2 ** 32 - 1]
    keys = threefry.fold_in(key, data)
    assert keys.shape == (5, 2)
    for i, d in enumerate(data):
        assert torch.equal(keys[i], threefry.fold_in(key, d))
    assert torch.equal(threefry.fold_in(keys, 9),
                       torch.stack([threefry.fold_in(k, 9) for k in keys]))
    assert torch.equal(threefry.fold_in(keys, torch.arange(5)), torch.stack(
        [threefry.fold_in(k, i) for i, k in enumerate(keys)]))
    pairs = threefry.split(keys, 3)
    assert pairs.shape == (5, 3, 2)
    for i, k in enumerate(keys):
        assert torch.equal(pairs[i], threefry.split(k, 3))
        kj = jnp.asarray(k.numpy().astype(np.uint32))
        assert np.array_equal(
            threefry.random_bits(keys, (4, 7))[i].numpy().view(np.uint32),
            np.asarray(jax.random.bits(kj, (4, 7), np.uint32)))
        assert torch.equal(threefry.uniform(keys, (31,))[i],
                           threefry.uniform(k, (31,)))
        assert torch.equal(threefry.permutation(keys, 2000)[i],
                           threefry.permutation(k, 2000))


def test_sort_key_val_is_stable_on_forced_ties():
    """`permutation` sorts with `lax.sort_key_val`, stable in jax 0.9:
    tied keys keep their input order, as `torch.sort(stable=True)`
    keeps them; `argsort_unsigned` sorts the int32 bits as uint32."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        keys = rng.randint(0, 4, 300).astype(np.uint32)
        keys[rng.rand(300) < 0.3] = 0xFFFFFFFF           # unsigned top
        vals = rng.permutation(300).astype(np.int32)
        _, want = jax.lax.sort_key_val(jnp.asarray(keys), jnp.asarray(vals))
        order = threefry.argsort_unsigned(
            torch.from_numpy(keys.view(np.int32)))
        assert np.array_equal(vals[order.numpy()], np.asarray(want))


def test_cpu_draws_run_the_plain_version():
    keys = threefry.fold_in(threefry.prng_key(8), [1, 2, 3])
    before = threefry.THREEFRY_LAUNCHES
    for uni in (False, True):
        got = threefry.draw(keys, 1001, uni, "cpu")
        want = threefry.draw_plain(keys, 1001, uni, "cpu")
        assert got.dtype == (torch.float32 if uni else torch.int32)
        assert torch.equal(got, want)
    assert threefry.THREEFRY_LAUNCHES == before
    with pytest.raises(LightGBMError, match="no threefry kernel"):
        threefry.draw(keys, 8, False, "meta")


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
