#!/usr/bin/env python3
"""Witness for a CPU-torch rounding fault the port's CPU tests avoid.

    python3 scripts/torch_cpu_first_call.py [--procs 80] [--jobs 4]

Starts `--procs` fresh Python processes per f32 link op (exp, sigmoid,
softmax).  Each imports jax and both packages, as a test process does,
then applies the op twice to the same 2100 values drawn from a seed and
reports the largest difference between the two calls in units in the
last place and the range of indices that differ.  A correct library
gives 0.  A process whose first call differs shows the fault: the
second call is the correctly rounded one.

It also counts a process's OS threads before and after one op, in a
process per op that imports torch alone: that shows which ops start
torch's intra-op thread pool at this size.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("exp", "sigmoid", "softmax")
N = 2100


def _values(seed):
    import numpy as np
    import torch
    x = np.random.RandomState(seed).uniform(-20, 20, N).astype(np.float32)
    return torch.from_numpy(x)


def _apply(op, x):
    import torch
    if op == "softmax":
        return torch.softmax(x.reshape(-1, 3), dim=-1).reshape(-1)
    return getattr(torch, op)(x)


def child_calls(op, seed):
    sys.path.insert(0, ROOT)
    import jax  # noqa: F401
    import lightgbm_tpu  # noqa: F401
    import lightgbm_tpu_torch  # noqa: F401
    import numpy as np
    x = _values(seed)
    first = _apply(op, x).numpy().view(np.int32).astype(np.int64)
    second = _apply(op, x).numpy().view(np.int32).astype(np.int64)
    bad = np.nonzero(first != second)[0]
    out = {"op": op, "max_ulp": int(np.abs(first - second).max())}
    if bad.size:
        out.update(lo=int(bad.min()), hi=int(bad.max()))
    print(json.dumps(out))


def child_threads(op):
    x = _values(0)
    before = len(os.listdir("/proc/self/task"))
    _apply(op, x)
    print(json.dumps([before, len(os.listdir("/proc/self/task"))]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=80)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--child", nargs="+")
    args = ap.parse_args()
    if args.child:
        if len(args.child) == 2:
            child_calls(args.child[0], int(args.child[1]))
        else:
            child_threads(args.child[0])
        return
    me = os.path.abspath(__file__)
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def run(cmd):
        return subprocess.run([sys.executable, me, "--child"] + cmd,
                              capture_output=True, text=True, env=env,
                              check=True).stdout.strip()

    print(json.dumps({"threads_before_after": {
        op: json.loads(run([op])) for op in OPS}}))
    for op in OPS:
        with ThreadPoolExecutor(args.jobs) as pool:
            rows = [json.loads(r) for r in pool.map(
                run, [[op, str(s)] for s in range(args.procs)])]
        faulty = [r for r in rows if r["max_ulp"]]
        print(json.dumps({"op": op, "procs": len(rows),
                          "first_call_differs": len(faulty),
                          "cases": faulty}))


if __name__ == "__main__":
    main()
