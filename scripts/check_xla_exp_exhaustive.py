#!/usr/bin/env python3
"""Hold the port's `xla_exp_f32` against `jnp.exp` over every f32 input.

    JAX_PLATFORMS=cpu python3 scripts/check_xla_exp_exhaustive.py \
        [--chunk-bits 24] [--threads 8] [--no-exact] [--start 0] [--stop 2^32]

Walks the 2^32 f32 bit patterns in chunks of 2^chunk-bits, computes
`jax.jit(jnp.exp)` (XLA's CPU) and `lightgbm_tpu_torch.ops.xla_math.
xla_exp_f32` (torch on the CPU; each fused multiply-add an f64
multiply-add rounded twice, f64 then f32) of each chunk, and counts the
inputs whose results differ in any bit; two NaNs count as equal
whatever their payloads.  Unless `--no-exact`, it also runs the same
polynomial with a correctly rounded fma (`fma_f32` below) and counts
where that differs from XLA: the twice-rounded sums are used only
because neither count is above zero.  Prints one JSON
line a 2^28 patterns and a last JSON line with the totals, the first
differing inputs and the seconds taken.  Not part of the test suite: the
whole range takes tens of minutes on eight CPU cores.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lightgbm_tpu_torch.ops.xla_math import _exp, xla_exp_f32  # noqa: E402


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add a * b + c, rounded once, for f32 tensors or
    f32-exact Python floats `b`, `c` (at least one operand a tensor).

    a * b is exact in f64 (24 + 24 bits); s = p + c is rounded there and
    TwoSum gives its error e exactly.  Rounding s to odd (its last bit set
    when e != 0) keeps the information the second rounding needs, so
    casting to f32 gives the correctly rounded a * b + c, as the card's
    fma instruction rounds it."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else c
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (e > 0) == (s > 0)            # the exact sum lies beyond |s|
    bits = torch.where(inexact, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).float()


def differ(ref: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Mask of inputs whose results differ (NaN equals NaN)."""
    same = ref.view(np.uint32) == got.view(np.uint32)
    return ~(same | (np.isnan(ref) & np.isnan(got)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunk-bits", type=int, default=24)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--no-exact", action="store_true")
    ap.add_argument("--start", type=lambda v: int(v, 0), default=0)
    ap.add_argument("--stop", type=lambda v: int(v, 0), default=1 << 32)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    jexp = jax.jit(jnp.exp)
    step = 1 << args.chunk_bits
    t0 = time.time()
    bad, bad_exact, first, first_exact = 0, 0, [], []
    for lo in range(args.start, args.stop, step):
        hi = min(lo + step, args.stop)
        x = np.arange(lo, hi, dtype=np.uint64).astype(np.uint32).view(
            np.float32)
        ref = np.asarray(jexp(x))
        tx = torch.from_numpy(x)
        d = differ(ref, xla_exp_f32(tx).numpy())
        bad += int(d.sum())
        first += [hex(int(v)) for v in x[d][:8].view(np.uint32)]
        if not args.no_exact:
            de = differ(ref, _exp(tx, fma_f32).numpy())
            bad_exact += int(de.sum())
            first_exact += [hex(int(v)) for v in x[de][:8].view(np.uint32)]
        if hi % (1 << 28) == 0 or hi == args.stop:
            print(json.dumps({"done": hi - args.start, "differ": bad,
                              "differ_exact_fma": (None if args.no_exact
                                                   else bad_exact),
                              "seconds": round(time.time() - t0, 1)}),
                  flush=True)
    print(json.dumps({
        "inputs": args.stop - args.start, "start": hex(args.start),
        "stop": hex(args.stop), "differ": bad, "first_differing": first[:8],
        "differ_exact_fma": None if args.no_exact else bad_exact,
        "first_differing_exact_fma": first_exact[:8],
        "jax": jax.__version__, "torch": torch.__version__,
        "seconds": round(time.time() - t0, 1)}))
    return 0 if bad == 0 and bad_exact == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
