"""Serving compiler: tree-tile planes and the traverse kernel.

  plan.py     — cluster trees into tiles (depth buckets, greedy
                bin-packing by node count), recording the permutation
                and its inverse so the f64 accumulation stays in
                boosting order.
  quantize.py — pack each node into an int32 node word plus an int32
                child word, with a per-tile f32 threshold palette.
  kernel.py   — the traverse kernel's wrapper and its plain version,
                and `compiled_predict`, the whole device program.
  _build.py   — builds the CUDA sources in `csrc/` on first use.
"""
from .plan import (CompiledPlan, PlanNotCompilable, build_plan,
                   plan_summary)

__all__ = ["CompiledPlan", "PlanNotCompilable", "build_plan",
           "plan_summary"]
