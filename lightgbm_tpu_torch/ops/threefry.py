"""The threefry2x32 counter-based generator, as `jax.random` runs it.

The port's copy of the primitives the quantizer and the samplers draw
from (JAX 0.9 with `jax_threefry_partitionable=True`, its default):

  * `prng_key(seed)`: `jax.random.PRNGKey` (`jax/_src/prng.py`
    `threefry_seed`): the seed's high and low 32-bit words;
  * `fold_in(key, data)`: `_threefry_fold_in`: the hash of the count
    pair (0, data) under `key`;
  * `split(key, num)`: `_threefry_split_foldlike`: key i is the hash of
    the 64-bit count i, split into (hi, lo) words (`iota_2x32_shape`);
  * `random_bits(key, shape, device)`: `_random_bits` at 32 bits over
    `_threefry_random_bits_partitionable`: for the row-major flat index
    i, the two hash words of the count (i >> 32, i & 0xFFFFFFFF),
    XORed, as int32 (the uint32's two's complement);
  * `uniform(key, shape, device)`: `random.py _uniform`: those bits
    shifted right by 9, ORed with 1.0's exponent, bitcast to f32, minus
    1.0;
  * `permutation(key, n, device)`: `permutation(key, n)`, which is
    `_shuffle(key, arange(n))`: ceil(3 ln(max(1, n)) / ln(2^32 - 1))
    rounds (0 at n = 1, 1 up to about 1600, 2 at 5000), each `key,
    subkey = split(key)`, then a stable sort of the current order by
    `random_bits(subkey, (n,))` read as unsigned (`lax.sort_key_val`
    is stable in jax 0.9; `argsort_unsigned`).

The hash (`_threefry2x32_lowering`): 20 rounds of add, rotate, XOR in
five groups of four, with the key schedule (k1, k2, k1 ^ k2 ^
0x1BD11BDA) injected after each group.

Keys are int64 tensors of uint32 values, [2] for one key or [R, 2] for
R keys (torch's uint32 lacks shifts and rotations on every device, so
every word is int64 masked to 32 bits after each add or shift).  Drawn
bits leave as int32, the kernel's format, on every device.
`fold_in` and `split` run on the key's device, which is the host for
every key the port makes, and take a batch: R keys, or one key and R
data words, in one set of ops.  `random_bits`, `uniform` and
`permutation` draw on `device` and take one key or R keys ([R, ...]
out, row r equal to a call with key r alone).

The draws run through `draw`: on a CUDA device one launch of the
hand-written kernel `csrc/threefry.cu` (the keys' words as arguments
for one key, an uploaded [R, 2] table for more), counted in
THREEFRY_LAUNCHES; on the CPU its plain version `draw_plain`, the hash
as torch ops.  Integer arithmetic only: the same key gives the same
bits on every device, and the same bits as `jax.random`.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Union

import numpy as np
import torch

from ..utils.log import LightGBMError

_MASK = 0xFFFFFFFF
_SIGN = -2 ** 31                 # int32 with only the sign bit set
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: launches of the threefry kernel made by `draw`
THREEFRY_LAUNCHES = 0

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _hash(k1: Word, k2: Word, x0: torch.Tensor,
          x1: torch.Tensor) -> tuple:
    """threefry2x32 of the count words (x0, x1) under the key words
    (k1, k2): int64 tensors of uint32 values, broadcast together."""
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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for data in [0, 2^32): [2] for one
    key and one word; [R, 2] for R keys ([R, 2]) and one word, one key
    and R words (a sequence or [R] tensor), or R keys and R words."""
    d = torch.as_tensor(data, dtype=torch.int64).to(key.device)
    if d.device.type == "cpu" and d.numel() and not (
            0 <= int(d.min()) and int(d.max()) <= _MASK):
        raise ValueError(f"fold_in data outside [0, 2^32): {data}")
    k = key.reshape(-1, 2)
    b0, b1 = _hash(k[:, 0], k[:, 1], torch.zeros_like(d.reshape(-1)),
                   d.reshape(-1))
    out = torch.stack([b0, b1], dim=-1)
    return out[0] if key.dim() == 1 and d.dim() == 0 else out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [num, 2] keys, or [R, num, 2] for
    [R, 2] keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    k = key.reshape(-1, 1, 2)
    b0, b1 = _hash(k[..., 0], k[..., 1], lo >> 32, lo & _MASK)
    out = torch.stack([b0, b1], dim=-1)
    return out[0] if key.dim() == 1 else out


def _count(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def draw_plain(keys: torch.Tensor, n: int, uniform: bool,
               device) -> torch.Tensor:
    """Plain version of `draw`: torch ops on `device`."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    k = keys.to(device)
    b0, b1 = _hash(k[:, 0:1], k[:, 1:2], idx >> 32, idx & _MASK)
    bits = b0 ^ b1                                            # [R, n]
    if not uniform:
        return ((bits ^ 0x80000000) - 0x80000000).to(torch.int32)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _words(keys: torch.Tensor, device) -> torch.Tensor:
    """[R, 2] uint32 key words as int32 (two's complement) on `device`,
    from the host without a sync: pinned memory and an asynchronous
    copy."""
    w = keys.to("cpu").numpy().astype(np.uint32).view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(w))
    return t.pin_memory().to(device, non_blocking=True)


def draw(keys: torch.Tensor, n: int, uniform: bool = False,
         device=None) -> torch.Tensor:
    """[R, n] draws on `device` (default: the keys') under R keys ([R, 2]
    int64 words): row r, column i is the XOR of the two threefry2x32
    words of the count (i >> 32, i & 0xFFFFFFFF) under key r, as int32
    (the uint32's two's complement); with `uniform`, the f32 `(bits >>
    9 | 0x3F800000) - 1.0` instead.  The plain version for the CPU, else one launch of
    `csrc/threefry.cu` (or an error)."""
    global THREEFRY_LAUNCHES
    device = keys.device if device is None else torch.device(device)
    keys = keys.reshape(-1, 2)
    rows = int(keys.shape[0])
    if device.type == "cpu":
        return draw_plain(keys, n, uniform, device)
    if device.type != "cuda":
        raise LightGBMError(f"no threefry kernel for {device}")
    dtype = torch.float32 if uniform else torch.int32
    out = torch.empty((rows, n), dtype=dtype, device=device)
    if rows and n:
        if rows == 1:
            k0, k1 = (int(v) for v in keys[0].tolist())
            table = None
        else:
            k0 = k1 = 0
            table = _words(keys, device)
        from ..compiler import _build
        lib = _build.load("threefry")
        rc = _build.on_stream(out.device, lambda stream: (
            lib.lgbt_threefry(None if table is None else table.data_ptr(),
                              k0, k1, rows, n, int(uniform), out.data_ptr(),
                              ctypes.c_void_p(stream))))
        if rc != 0:
            raise LightGBMError(f"threefry kernel launch failed: CUDA error "
                                f"{rc}")
        THREEFRY_LAUNCHES += 1
    return out


def _batched(key: torch.Tensor, shape: Sequence[int], out: torch.Tensor):
    shape = tuple(int(s) for s in shape)
    return out.reshape(shape) if key.dim() == 1 \
        else out.reshape((out.shape[0],) + shape)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` as int32 (the uint32's
    two's complement) on `device` (default: the key's); [R, *shape] for
    [R, 2] keys."""
    return _batched(key, shape, draw(key, _count(shape), False, device))


def uniform(key: torch.Tensor, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: f32 in [0, 1) on `device`
    (default: the key's); [R, *shape] for [R, 2] keys."""
    return _batched(key, shape, draw(key, _count(shape), True, device))


def permutation_rounds(n: int) -> int:
    """`_shuffle`'s sort rounds for n elements."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def argsort_unsigned(bits: torch.Tensor) -> torch.Tensor:
    """The stable argsort of int32 `bits` along the last axis, read as
    uint32: flipping the sign bit maps unsigned order onto signed."""
    return torch.sort(bits ^ _SIGN, dim=-1, stable=True).indices


def permutation(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: [n] int64 on `device` (default:
    the key's), or [R, n] for [R, 2] keys."""
    device = key.device if device is None else torch.device(device)
    keys = key.reshape(-1, 2)
    x = torch.arange(n, dtype=torch.int64, device=device)\
        .expand(keys.shape[0], n)
    for _ in range(permutation_rounds(n)):
        pair = split(keys)                                 # [R, 2, 2]
        keys = pair[:, 0]
        order = argsort_unsigned(random_bits(pair[:, 1], (n,), device))
        x = x.gather(1, order)
    return x[0] if key.dim() == 1 else x
