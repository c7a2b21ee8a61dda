"""The threefry2x32 counter-based generator, as `jax.random` runs it.

The port's copy of the four primitives the quantized path draws from
(JAX 0.9 with `jax_threefry_partitionable=True`, its default):

  * `prng_key(seed)`: `jax.random.PRNGKey` (`jax/_src/prng.py`
    `threefry_seed`): the seed's high and low 32-bit words;
  * `fold_in(key, data)`: `_threefry_fold_in`: the hash of the count
    pair (0, data) under `key`;
  * `split(key, num)`: `_threefry_split_foldlike`: key i is the hash of
    the 64-bit count i, split into (hi, lo) words (`iota_2x32_shape`);
  * `uniform(key, shape, device)`: `random.py _uniform` over
    `_threefry_random_bits_partitionable`: 32 bits per element (the two
    hash words XORed) for the row-major flat index, shifted right by 9,
    ORed with 1.0's exponent, bitcast to f32, minus 1.0.

The hash (`_threefry2x32_lowering`): 20 rounds of add, rotate, XOR in
five groups of four, with the key schedule (k1, k2, k1 ^ k2 ^
0x1BD11BDA) injected after each group.

Keys are [2] int64 tensors holding uint32 values: torch's uint32 lacks
shifts and rotations on every device, so every word is int64 masked to
32 bits after each add or shift.  `fold_in` and `split` run on the
key's device; `uniform` runs on `device` and reads the key's two words
as Python integers, so a key kept on the CPU costs the card no sync.
Integer arithmetic only: the same key gives the same bits on every
device, and the same bits as `jax.random`.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _hash(k1: Word, k2: Word, x0: torch.Tensor,
          x1: torch.Tensor) -> tuple:
    """threefry2x32 of the count words (x0, x1) under the key words
    (k1, k2): two int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2^31): the key
    (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for data in [0, 2^32)."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data {data} outside [0, 2^32)")
    x = torch.tensor([0, data], dtype=torch.int64, device=key.device)
    b0, b1 = _hash(key[0], key[1], x[:1], x[1:])
    return torch.cat([b0, b1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [num, 2] keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = _hash(key[0], key[1], lo >> 32, lo & _MASK)
    return torch.stack([b0, b1], dim=1)


def uniform(key: torch.Tensor, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: f32 in [0, 1) on `device`
    (default: the key's)."""
    device = key.device if device is None else torch.device(device)
    shape = tuple(int(s) for s in shape)
    k1, k2 = (int(v) for v in key.tolist())
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _hash(k1, k2, idx >> 32, idx & _MASK)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
