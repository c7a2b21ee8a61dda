"""Serving compiler: tree-tile planes and the traverse kernel.

  plan.py     — cluster trees into tiles (depth buckets, greedy
                bin-packing by node count), recording the permutation
                and its inverse so the f64 accumulation stays in
                boosting order.
  quantize.py — pack each node into an int32 node word plus an int32
                child word, with a per-tile f32 threshold palette;
                `pack_bounded`, the bounded tier's quantized leaf values.
  kernel.py   — the serving kernels' wrappers and plain versions, and
                `compiled_predict` / `compiled_predict_bounded`, the
                device programs over the plan.
  _build.py   — builds the CUDA sources in `csrc/` on first use.
"""
from .plan import (CompiledPlan, PlanNotCompilable, build_plan,
                   plan_summary)

__all__ = ["CompiledPlan", "PlanNotCompilable", "build_plan",
           "plan_summary"]
