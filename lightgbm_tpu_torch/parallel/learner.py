"""The tree learner factory: serial, data, feature and voting learners
over the ranks of a process group.

The port's counterpart of `lightgbm_tpu/parallel/learner.py`
(`resolve_tree_learner` `:56`, `make_distributed_grower` `:83`,
`place_training_data` `:209`; ref: tree_learner.cpp
`TreeLearner::CreateTreeLearner`).  One process a rank: every rank calls
`train` with the same parameters and Dataset, so the trees, the scores,
the gradients and each tree's leaf ids are the same on every rank, and
objectives, metrics, bagging, GOSS and early stopping run the serial
code.  Only the grower's per-row work is sharded (`Sharding`):

  data (`data_rs`)  rows sharded; the histograms summed over the ranks,
                    each rank searches its feature block, the best split
                    of the blocks is merged (ref:
                    data_parallel_tree_learner.cpp; under EFB the
                    full-histogram `data` mode, which every rank searches
                    whole);
  feature           bins replicated; each rank builds and searches only
                    its feature block, the blocks' best merged (ref:
                    feature_parallel_tree_learner.cpp);
  voting            rows sharded; each rank votes its local top_k
                    features (size constraints over the ranks), the 2
                    top_k with the most votes are elected, and only
                    their histograms are summed (ref:
                    voting_parallel_tree_learner.cpp, PV-Tree).

`deterministic_reduce` (data and data_rs on one axis) sums the
histograms in the serial order: rank 0 folds its rows into a zero carry
and sends it on, each rank folds its rows onto what it received, the
last finalizes and broadcasts (the reference's ring,
`ops/grow.py:592-670`).  The f32 carry is the K1 carry kernel's
(`ops/hist_kernel.py histogram_carry_*`) on a CUDA device, the plain
carry on the CPU, so the result is the serial histogram bit for bit;
the integer carries (K4's, the packed ones) are association-free and are
summed with one all_reduce.  The root sums are the serial expression
over the replicated payload, which every rank holds.  Each tree's leaf
ids are all-gathered once at its end.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..mesh import collectives as coll
from ..mesh.placement import feature_block, row_block, row_counts
from ..ops.grow import GrowerSpec, make_grower, tree_histograms
from ..ops.hist_kernel import (histogram_carry_finalize, histogram_carry_init,
                               histogram_carry_update)
from ..ops.hist_kernel_q import (histogram_carry_q_finalize,
                                 histogram_carry_q_init,
                                 histogram_carry_q_update)
from ..ops.histogram import (hist_stream_finalize, hist_stream_init,
                             hist_stream_packed_finalize,
                             hist_stream_packed_init,
                             hist_stream_packed_update, hist_stream_update)
from ..ops.reduce import tree_sum
from ..ops.split import (MASK_BITS, NEG_INF, PACK_COLS, SplitResult,
                         find_best_split)
from ..utils import log

TREE_LEARNER_ALIASES = {
    "serial": "serial",
    "feature": "feature", "feature_parallel": "feature",
    "data": "data", "data_parallel": "data",
    "voting": "voting", "voting_parallel": "voting",
}


def resolve_tree_learner(name: str, bundled: bool = False,
                         two_level: bool = False,
                         quiet: bool = False) -> str:
    """The canonical `tree_learner` (ref: config.cpp
    `GetTreeLearnerType`), with the reference's downgrades: feature falls
    back to data under EFB (bundle columns do not align with feature
    blocks) and on a 2-level mesh."""
    kind = TREE_LEARNER_ALIASES.get(str(name).lower())
    if kind is None:
        raise ValueError(f"Unknown tree learner type {name}")
    if bundled and kind == "feature":
        if not quiet:
            log.warning("tree_learner=feature with EFB bundling falls "
                        "back to the data-parallel strategy")
        kind = "data"
    if two_level and kind == "feature":
        if not quiet:
            log.warning("tree_learner=feature over a 2-level mesh falls "
                        "back to the data-parallel strategy")
        kind = "data"
    return kind


def unpack_split(packed: torch.Tensor, max_bin: int) -> SplitResult:
    """The SplitResult of [B, C] rows of `SplitResult.pack` (bit for bit
    the record packed)."""
    p = packed
    res = dict(gain=p[:, 0], feature=p[:, 1].to(torch.int64),
               threshold_bin=p[:, 2].to(torch.int64),
               default_left=p[:, 3] > 0, left_sum_g=p[:, 4],
               left_sum_h=p[:, 5], left_cnt=p[:, 6], right_sum_g=p[:, 7],
               right_sum_h=p[:, 8], right_cnt=p[:, 9])
    if p.shape[1] > PACK_COLS:
        words = p[:, PACK_COLS + 1:].to(torch.int64)
        bits = (words[:, :, None] >> torch.arange(
            MASK_BITS, device=p.device)) & 1
        res["is_cat"] = p[:, PACK_COLS] > 0
        res["cat_mask"] = bits.reshape(p.shape[0], -1)[:, :max_bin] > 0
    return SplitResult(**res)


class Sharding:
    """One rank's part of a distributed grower: its rows, its feature
    block, how its histograms are reduced, and the merge of the blocks'
    splits.  `mode` is the reference's grower mode ("data", "data_rs",
    "feature", "voting").  Feature blocks are cut over the last mesh
    axis (`n_last` ranks), rows over all `n_total` ranks, by which the
    voting learner's size constraints are divided.  Under gloo on a GPU
    every collective goes through host buffers (`mesh/collectives.py`)."""

    def __init__(self, mesh, mode: str, num_data: int, num_feature: int,
                 det: bool = True, top_k: int = 20):
        axes = mesh.axis_names
        self.mesh, self.mode = mesh, mode
        self.num_data, self.num_feature = int(num_data), int(num_feature)
        self.top_k = int(top_k)
        self.two_level = len(axes) == 2
        self.n_total = mesh.size
        self.last_ranks = mesh.axis_ranks(axes[-1])
        self.n_last = len(self.last_ranks)
        self.last_group = mesh.axis_groups[axes[-1]]
        self.dcn_group = mesh.axis_groups.get("dcn")
        self.group = mesh.group
        if mode == "feature":
            self.lo, self.hi = 0, self.num_data
        else:
            self.lo, self.hi = row_block(self.num_data, self.n_total,
                                         mesh.pos)
        self.counts = row_counts(self.num_data, self.n_total)
        self.block = mode in ("data_rs", "feature")
        self.f0, self.f1 = feature_block(
            self.num_feature, self.n_last, mesh.coords()[-1]) \
            if self.block else (0, self.num_feature)
        self.det = bool(det) and not self.two_level \
            and mode in ("data", "data_rs") and self.n_total > 1

    # ---- rows ----
    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a replicated [N, ...] tensor."""
        return t if self.mode == "feature" else t[self.lo:self.hi]

    def root_sums(self, payload: torch.Tensor):
        """The root's (g, h, count) sums of the replicated payload [N, 3]:
        the serial expression where the reference makes them serial (the
        deterministic reduction, the feature learner, which holds every
        row), else each rank's block summed over the reference's padded
        shard length and summed over the ranks (its psum)."""
        if self.det or self.mode == "feature":
            return tree_sum(payload.t())
        per = -(-self.num_data // self.n_total)
        local = payload[self.lo:self.hi]
        if local.shape[0] < per:
            local = torch.cat([local, local.new_zeros(
                (per - local.shape[0], 3))])
        s = coll.all_reduce_sum(tree_sum(local.t()).contiguous(),
                                self.group, "root_sums")
        return s[0], s[1], s[2]

    def finish(self, leaf_id: torch.Tensor) -> torch.Tensor:
        """Every row's leaf id from this rank's block of them."""
        if self.mode == "feature":
            return leaf_id
        return coll.all_gather_rows(leaf_id, self.counts, self.group,
                                    "leaf_ids")

    # ---- histograms ----
    def hist_cols(self, cols: int) -> int:
        """Columns of the histograms the grower keeps: its feature block
        in the block modes."""
        return self.f1 - self.f0 if self.block else cols

    def histograms(self, spec: GrowerSpec, bins_fm: torch.Tensor,
                   payload: torch.Tensor, feat: Dict):
        """(hist(leaf_id, slots) -> [S, F|G|block, HB, 3], lattice or
        None): `ops/grow.py tree_histograms` over this rank's rows,
        reduced as the mode says.  `payload` is this rank's rows."""
        if self.mode == "feature":
            return tree_histograms(spec, bins_fm[self.f0:self.f1], payload,
                                   feat, plan_features=bins_fm.shape[0])
        fn, pw3 = tree_histograms(spec, bins_fm, payload, feat)
        if self.mode == "voting":
            return fn, pw3
        if self.det:
            return self._ring(spec, bins_fm, payload, feat, pw3), pw3

        def reduced(leaf_id, slots):
            h = fn(leaf_id, slots)
            if self.mode == "data":
                return coll.all_reduce_sum(h, self.group, "hist_psum")
            if self.two_level:
                coll.all_reduce_sum(h, self.last_group, "hist_psum")
                b = h[:, self.f0:self.f1].contiguous()
                return coll.all_reduce_sum(b, self.dcn_group, "hist_psum")
            coll.all_reduce_sum(h, self.group, "hist_psum")
            return h[:, self.f0:self.f1].contiguous()

        return reduced, pw3

    def _cut_block(self, h: torch.Tensor) -> torch.Tensor:
        return h[:, self.f0:self.f1].contiguous() if self.block else h

    def _ring(self, spec, bins_fm, payload, feat, pw3) -> Callable:
        """The deterministic histogram: a ring of carries in rank order,
        or for the integer carries one all_reduce."""
        impl, mb = spec.hist_impl, \
            spec.bundle_max_bin if spec.bundled else spec.max_bin
        fh = bins_fm.shape[0]
        ranks, pos = self.last_ranks, self.mesh.pos
        last = pos == self.n_total - 1
        group = self.group
        qs = feat.get("qscales")

        def f32_kernel(leaf_id, slots):
            dev = payload.device
            lengths = None
            if dev.type == "cuda":
                # each slot's row count among all N: K1's order hangs on it
                counts = (leaf_id[None, :] == slots[:, None]).sum(
                    dim=1, dtype=torch.int32)
                lengths = coll.all_reduce_sum(counts, group, "lengths")
            carry = histogram_carry_init(self.num_data, fh, slots, mb,
                                         lengths)
            if carry.acc is not None:
                state = [carry.acc]
            else:
                par = torch.tensor([g["parity"] for g in carry.groups],
                                   dtype=torch.int32, device=dev)
                state = [t for g in carry.groups for t in (
                    g["work"], g["rank"], g["pend_bin"], g["pend_pay"])] \
                    + [par]

            def fold():
                if carry.acc is None:
                    for g, p in zip(carry.groups, par.tolist()):
                        g["parity"] = int(p)
                histogram_carry_update(carry, bins_fm, payload, leaf_id)
                if carry.acc is None:
                    par.copy_(torch.tensor([g["parity"] for g in
                                            carry.groups], dtype=torch.int32))

            coll.ring_fold(state, fold, ranks, pos, group)
            s = slots.shape[0]
            h = histogram_carry_finalize(carry) if last else torch.empty(
                (s, fh, mb, 3), dtype=torch.float32, device=dev)
            return coll.broadcast_last(h, ranks, group)

        def f32_plain(leaf_id, slots):
            s = slots.shape[0]
            acc = hist_stream_init(fh, s, mb, device=payload.device)
            coll.ring_fold([acc], lambda: hist_stream_update(
                acc, bins_fm, payload, leaf_id, slots, mb), ranks, pos, group)
            h = hist_stream_finalize(acc, s, mb) if last else torch.empty(
                (s, fh, mb, 3), dtype=torch.float32, device=payload.device)
            return coll.broadcast_last(h, ranks, group)

        def int_kernel(leaf_id, slots):
            carry = histogram_carry_q_init(fh, slots, mb)
            histogram_carry_q_update(carry, bins_fm, pw3, leaf_id)
            coll.all_reduce_sum(carry.acc, group, "hist_psum_int")
            return histogram_carry_q_finalize(carry, qs[0], qs[1])

        def int_packed(leaf_id, slots):
            s, chl = slots.shape[0], spec.packed_const_hess_level
            acc = hist_stream_packed_init(fh, s, mb, chl,
                                          device=payload.device)
            hist_stream_packed_update(acc, bins_fm, payload, leaf_id, slots,
                                      mb, qs[0], qs[1], chl)
            for v in acc.values():
                coll.all_reduce_sum(v, group, "hist_psum_int")
            return hist_stream_packed_finalize(acc, s, mb, qs[0], qs[1], chl)

        fam = {"kernel": f32_kernel, "plain": f32_plain,
               "kernel_q": int_kernel, "packed": int_packed}[impl]
        return lambda leaf_id, slots: self._cut_block(fam(leaf_id, slots))

    # ---- the searches ----
    def block_feat(self, feat: Dict) -> Dict:
        """`feat` with its per-feature search arrays cut to the block."""
        if not self.block:
            return feat
        out = dict(feat)
        for k in ("nb", "missing", "default", "is_cat", "mono"):
            if feat.get(k) is not None:
                out[k] = feat[k][self.f0:self.f1]
        return out

    def cut(self, x: Optional[torch.Tensor], axis: int = -1):
        """[..., F] (axis -1) or [..., F, MB] (axis -2) cut to the block."""
        if x is None or not self.block:
            return x
        return x.narrow(x.dim() + axis, self.f0, self.f1 - self.f0)

    @property
    def empty_block(self) -> bool:
        return self.block and self.f1 <= self.f0

    def merge(self, res: Optional[SplitResult], rows: int, max_bin: int,
              cols: int, device) -> SplitResult:
        """The best of the ranks' block splits (`res` None for an empty
        block), each rank's feature ids rebased to the global ones."""
        if res is None:
            packed = torch.zeros((rows, cols), dtype=torch.float32,
                                 device=device)
            packed[:, 0] = NEG_INF
            packed[:, 1] = -1.0
        else:
            res = res._replace(feature=torch.where(
                res.feature >= 0, res.feature + self.f0, res.feature))
            packed = res.pack().reshape(rows, -1)
        win = coll.merge_split(packed.contiguous(), self.last_group,
                               self.n_last)
        return unpack_split(win, max_bin)

    def vote(self, hist: torch.Tensor, allowed: torch.Tensor, cand,
             feat: Dict, spec: GrowerSpec, has_cat_kw: Dict):
        """The voting learner's election over a batch of local
        histograms [B, F, MB, 3] (the reference's `ops/grow.py:730-752`):
        the local vote's top_k features a rank, the 2 top_k with the most
        votes (ties to the lower feature), and only their histograms
        summed.  Returns (hist, allowed) for the search.  A candidate
        grid (forced splits, extra_trees) sums the whole histogram, as
        the reference does."""
        if cand is not None:
            # a copy: `hist` may be a view of the grower's local cache
            return coll.all_reduce_sum(hist.clone(), self.group,
                                       "hist_psum"), allowed
        b, f, mb, _ = hist.shape
        dev = hist.device
        ltot = tree_sum(hist[:, 0].transpose(1, 2))       # [B, 3] local
        s = max(self.n_total, 1)
        fg = find_best_split(
            hist, ltot[:, 0], ltot[:, 1], ltot[:, 2], feat["nb"],
            feat["missing"], feat["default"], allowed, spec.lambda_l1,
            spec.lambda_l2, spec.min_data_in_leaf / s,
            spec.min_sum_hessian_in_leaf / s, spec.min_gain_to_split,
            spec.max_delta_step, spec.path_smooth, mono=feat.get("mono"),
            xla_fused=True, feature_gains=True, **has_cat_kw)
        k = min(self.top_k, f)
        # jax.lax.top_k's order: descending, the lower index first on ties
        top = torch.sort(fg, dim=1, descending=True, stable=True)[1][:, :k]
        votes = torch.zeros((b, f), dtype=torch.float32, device=dev)
        votes.scatter_(1, top, 1.0)
        coll.all_reduce_sum(votes, self.group, "votes")
        key = votes * (f + 1.0) - torch.arange(f, dtype=torch.float32,
                                               device=dev)
        elected = torch.sort(key, dim=1, descending=True,
                             stable=True)[1][:, :min(2 * k, f)]
        idx = elected[:, :, None, None].expand(-1, -1, mb, 3)
        sel = coll.all_reduce_sum(hist.gather(1, idx).contiguous(),
                                  self.group, "hist_psum")
        out = torch.zeros_like(hist).scatter_(1, idx, sel)
        emask = torch.zeros((b, f), dtype=torch.bool, device=dev)
        emask.scatter_(1, elected, True)
        return out, allowed & emask


def make_sharding(spec: GrowerSpec, mesh, kind: str, num_feature: int,
                  num_data: int, det_reduce: bool = True,
                  top_k: int = 20) -> Sharding:
    """The rank's `Sharding` for learner `kind` (the reference's mode
    choice in `make_distributed_grower`): data runs the reduce-scatter
    block mode `data_rs`, EFB the full-histogram `data`."""
    mode = {"data": "data_rs", "voting": "voting", "feature": "feature"}[kind]
    if spec.bundled:
        if kind == "feature":
            raise ValueError("feature kind must be downgraded before "
                             "placement (EFB)")
        mode = "data"
    if kind == "feature" and len(mesh.axis_names) > 1:
        raise ValueError("feature kind must be downgraded before "
                         "placement (2-level mesh)")
    sh = Sharding(mesh, mode, num_data, num_feature, det_reduce, top_k)
    if det_reduce and not sh.det:
        log.info(f"deterministic_reduce: unsupported topology (mode="
                 f"{mode}, axes={mesh.axis_names}, ranks={mesh.size}) — "
                 "keeping the summed reduction")
    return sh


def make_distributed_grower(spec: GrowerSpec, mesh, kind: str,
                            num_feature: int, num_data: int,
                            wave: bool = False, det_reduce: bool = True,
                            top_k: int = 20) -> Callable:
    """A grower with the serial contract, `grow(bins_fm, grad, hess,
    sample_weight, feat, allowed) -> DeviceTree`, over `mesh`: `bins_fm`
    is this rank's placed block (`place_training_data`), the [N] vectors
    are replicated, and the tree's `leaf_id` covers all N rows.  `wave`
    takes the wave grower, data-parallel only."""
    sh = make_sharding(spec, mesh, kind, num_feature, num_data, det_reduce,
                       top_k)
    if wave:
        if kind != "data":
            raise ValueError("the wave policy must be downgraded for "
                             "non-data learners")
        from ..ops.grow_wave import make_wave_grower
        grow = make_wave_grower(spec, dist=sh)
    else:
        grow = make_grower(spec, dist=sh)
    grow.sharding = sh
    return grow


def place_training_data(bins_nf, sharding: Sharding, device,
                        store=None, payload: str = "bins",
                        prefetch_depth: int = 2,
                        run_stats=None) -> torch.Tensor:
    """This rank's bin block [F|G, rows] on `device`: its rows for the
    row-sharded modes, every row for the feature learner; from the [N, F]
    host matrix `bins_nf`, or for a spilled set from the shard store
    (only the shards that hold the rows)."""
    from ..mesh.placement import place_from_datastore, place_rows
    lo, hi = sharding.lo, sharding.hi
    if store is not None:
        return place_from_datastore(store, lo, hi, device, payload=payload,
                                    prefetch_depth=prefetch_depth,
                                    run_stats=run_stats)
    return place_rows(bins_nf, lo, hi, device)

