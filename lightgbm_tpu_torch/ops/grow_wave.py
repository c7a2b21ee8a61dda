"""Wave-batched leaf-wise growth, driven from the host.

The port's counterpart of `lightgbm_tpu/ops/grow_wave.py` (`wave_sizes`
`:81`, `make_wave_grower` `:94`, `prune_wave_tail` `:937`), for
numerical and categorical features, on the plain or the EFB-bundled bin
matrix, on one device.  The wave policy changes the order of
growth, not the split math: each wave splits every ready leaf (one that
existed when the wave began) whose cached best gain is positive,
best-first, up to the wave's width; then the new smaller children's
histograms come from ONE batched pass, the larger children are parent
minus smaller, and all the new children are searched at once.  A
31-leaf tree costs 7 histogram passes at width 6 without a strict tail
(19 with the bench's 16-split tail) instead of the strict policy's 30
(`ops/grow.py`).

The reference compiles the whole tree into nested XLA `while_loop`s;
here a Python loop drives tensors on the device, and the per-leaf
records the pick loop reads live on the host:

  * **pick loop** (the reference's `ibody`, `grow_wave.py:552-776`), on
    host numpy over the records of the last copy: the `ready` mask, the
    width cap `wcap` with the strict tail (`:584-592`), the
    capacity-aware gain floor `g_floor` = f32(ratio) x the wave's first
    gain x fullness (`:603-613`, `:718-719`, in f32 and that order), a
    first-wins argmax.  The children's outputs are computed here with
    the same torch functions the strict grower runs on the device
    (`ops/split.py leaf_output`, `smooth_output`), on CPU tensors;
  * **partition**: one `torch.where` per pick on the dense `leaf_id`.
    The picks are distinct leaves that existed at the wave's start, so
    their order cannot change a row's leaf;
  * **histograms**: one launch over the live smaller children only.
    Fused (`spec.fused`): K2 (`ops/fused_kernel.py fused_hist_split`)
    gives their histograms and split candidates, or K5
    (`fused_hist_split_quantized`) over the int8 lattice made once per
    tree with quantized gradients; unfused: the strict grower's
    histogram function (`ops/grow.py tree_histograms`: K1, or K4 or the
    packed histogram with quantized gradients).  The reference pads to [W]
    slots to keep one XLA shape; here every slot is a grid slice that
    reads all N rows, so no pad slot is launched;
  * **larger children**: f32 parent minus smaller (`:793-799`), then one K3
    launch on them (fused, `split_scan`) or one batched
    `find_best_split` over all 2w children (unfused; under EFB on their
    histograms expanded from the bundle columns, `:413-416`); the
    candidates are routed to the left and new children as at
    `:816-822`;
  * **decide and copy**: a batched `decide_from_candidates` over the 2w
    children with the `max_depth` gate (`:828-832`); with categorical
    features the numerical features only, then the categorical search
    (`find_best_split(..., numerical=False)`) over the children's carried
    histograms (K2's, K5's dequantized ones, or parent minus child) and
    `merge_split_results` (`split_of_fused`, `:417-441`); then one packed
    device-to-host copy per wave, counted in `ops/grow.py HOST_SYNCS`;
  * **tree full**: when the picks reach LB - 1 splits, the histogram and
    find phase is skipped (`:856-863`): that wave makes no copy;
  * **per-node sampling**: the strict grower's node masks
    (`ops/grow.py make_node_samplers`, node ids 2k + 1 and 2k + 2 for
    split k, as `:824`), gathered by the children's ids uploaded with
    the wave's indices; bynode gates `decide_from_candidates` on the
    fused path (`:430`), extra_trees runs unfused (`:383-387`).

The constraints (the reference's `:207-242`, `:369-395`, `:542-620`):
monotone basic in the pick loop (`ops/grow.py child_bounds_basic`, on
CPU tensors; the booster runs it unfused), each child's bounds uploaded
with the wave's values; interaction constraints and CEGB from each
leaf's root-path features on the host (`ic_allowed_from_used`,
`make_cegb_penalty`, the model's `cegb_used` frozen within a tree);
forced splits as a prefix of width-1 waves, each evaluated on its leaf's
stored histogram after the previous wave's search and read with its
host copy, the wave that commits the last one going on at full width.

Grow-then-prune (`wave_overgrow > 1`) grows to LB > num_leaves leaves
and prunes back on the host (`prune_wave_tail`; forced splits are never
pruned).  Each call to the
grower counts its waves in WAVES and the waves that built histograms in
HIST_WAVES.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

from ..utils.log import LightGBMError
from .fused_kernel import (fused_hist_split, fused_hist_split_quantized,
                           split_scan)
from .grow import (DeviceTree, GrowerSpec, cegb_scale, child_bounds_basic,
                   forced_cand, ic_allowed_from_used, make_bundled_expander,
                   make_cegb_penalty, make_node_samplers, node_arrays,
                   search_kwargs, split_go_left, to_device, to_host,
                   tracks_used, tree_histograms)
from .reduce import tree_sum
from .split import (NEG_INF, PACK_COLS, decide_from_candidates,
                    find_best_split, leaf_output, merge_split_results,
                    pack_cols, smooth_output, unpack_cat)

#: the reference's accuracy-sweep default width (`grow_wave.py:77`); the
#: booster resolves `tpu_wave_width=0` to it
WAVE_WIDTH_DEFAULT = 6

#: waves run by the wave growers (every pick loop), and those of them
#: that built histograms (all but a tree's capacity-full last wave)
WAVES = 0
HIST_WAVES = 0


def wave_sizes(spec: GrowerSpec):
    """(LB, W): the grow size (overgrow x num_leaves, pruned back after
    growth) and the wave width (the reference's `wave_sizes`)."""
    L = spec.num_leaves
    LB = L if spec.wave_overgrow <= 1.0 else \
        max(L, int(math.ceil(spec.wave_overgrow * L)))
    return LB, max(1, min(spec.wave_width or WAVE_WIDTH_DEFAULT, LB - 1))


def prune_wave_tail(nodes: Dict[str, np.ndarray], n: int,
                    leaves: Dict[str, np.ndarray], *, LB: int, L: int,
                    clamp_output: Callable, forced_n: int = 0):
    """Prune an LB-leaf wave tree back to L leaves (the reference's
    `prune_wave_tail`, on host numpy): remove the lowest-gain split whose
    children are both leaves, restore the parent's leaf record from its
    node sums (output `clamp_output(g, h)`), until L leaves are left;
    then compact the split log to [L - 1], renumbering slots so that the
    right child of split k is still leaf slot k + 1.  The `forced_n`
    forced splits of the prefix are never removed.  Returns (nodes,
    leaves, new_slot [LB] old slot -> final slot, n_splits)."""
    idx = np.arange(LB - 1)
    sl = nodes["split_leaf"].astype(np.int64)
    target = min(n, L - 1)
    forced_floor = min(forced_n, target)
    alive = idx < n
    lv = {k: v.copy() for k, v in leaves.items()}
    n_alive = n
    while n_alive > target:
        later = alive[None, :] & (idx[None, :] > idx[:, None])
        hit = (sl[None, :] == sl[:, None]) \
            | (sl[None, :] == idx[:, None] + 1)
        removable = alive & ~np.any(later & hit, axis=1) \
            & (idx >= forced_floor)
        cand = np.where(removable, nodes["split_gain"], np.float32(np.inf))
        r = int(np.argmin(cand))
        b = sl[r]
        alive[r] = False
        n_alive -= 1
        lv["out"][b] = clamp_output(nodes["internal_g"][r],
                                    nodes["internal_h"][r])
        lv["g"][b] = nodes["internal_g"][r]
        lv["h"][b] = nodes["internal_h"][r]
        lv["c"][b] = nodes["internal_cnt"][r]

    new_idx = np.cumsum(alive.astype(np.int64)) - 1             # [LB-1]
    old_of_new = np.zeros(L - 1, np.int64)
    old_of_new[new_idx[alive]] = idx[alive]
    # slot s survives iff s == 0 or its creating split is alive; otherwise
    # its rows belong to the nearest surviving ancestor
    slot_alive = np.concatenate([[True], alive])
    parent_slot = np.concatenate([[0], sl])
    anc = np.arange(LB)
    for _ in range(LB):
        anc = np.where(slot_alive[anc], anc, parent_slot[anc])
    new_slot = np.concatenate([[0], new_idx + 1])[anc]          # [LB]

    valid = np.arange(L - 1) < target
    out_nodes = {}
    for k, v in nodes.items():
        picked = new_slot[sl[old_of_new]] if k == "split_leaf" \
            else v[old_of_new]
        keep = valid.reshape((-1,) + (1,) * (v.ndim - 1))
        out_nodes[k] = np.where(keep, picked, np.zeros((), v.dtype)) \
            .astype(v.dtype)
    big_of = np.zeros(L, np.int64)
    big_of[new_idx[alive] + 1] = idx[alive] + 1
    out_leaves = {k: v[big_of] for k, v in lv.items()}
    return out_nodes, out_leaves, new_slot, target


class MemoryRows:
    """The rows of one tree in device memory: the [F, N] (bundled: [G,
    N]) bin matrix, read by the wave grower's two bin passes,
    `partition` and `hist`.  The shard-streamed grower gives the same
    two from the shard store (`streaming/engine.py StreamedRows`)."""

    def __init__(self, spec: GrowerSpec, bins_fm: torch.Tensor,
                 payload: torch.Tensor, feat: Dict, scan_kw: Dict):
        self.spec, self.bins_fm, self.payload = spec, bins_fm, payload
        self.feat, self.scan_kw = feat, scan_kw
        self.n_rows = payload.shape[0]
        self.hist_fn, self.pw3 = tree_histograms(spec, bins_fm, payload,
                                                 feat)
        self.bundle_of = make_bundled_expander(spec, feat)[1] \
            if spec.bundled else (lambda f: None)

    def hist_cache(self, leaves: int, hb: int) -> torch.Tensor:
        """The tree's per-leaf histograms as built, [leaves, F|G, hb,
        3]."""
        return torch.empty((leaves, self.bins_fm.shape[0], hb, 3),
                           dtype=torch.float32, device=self.payload.device)

    def hist(self, leaf_id: torch.Tensor, slots: torch.Tensor,
             parent: torch.Tensor):
        """(hist [S, F, MB, 3], candidates or None) of the leaves
        `slots`: fused, K2's (K5's over the lattice) with `parent` [S, 3]
        their sums; unfused, the spec's histogram function's."""
        spec, feat = self.spec, self.feat
        if not spec.fused:
            return self.hist_fn(leaf_id, slots), None
        if self.pw3 is None:
            return fused_hist_split(self.bins_fm, self.payload, leaf_id,
                                    slots, feat["nb"], feat["missing"],
                                    parent, spec.max_bin, **self.scan_kw)
        return fused_hist_split_quantized(
            self.bins_fm, self.pw3, leaf_id, slots, feat["nb"],
            feat["missing"], parent, spec.max_bin, feat["qscales"][0],
            feat["qscales"][1], **self.scan_kw)

    def partition(self, leaf_id: torch.Tensor, picks: List[tuple],
                  mask_dev, slots: torch.Tensor) -> torch.Tensor:
        """`leaf_id` after the wave's picks: each pick's rows that go
        right move to its new leaf (one `torch.where` a pick)."""
        return partition_rows(self.bins_fm, leaf_id, picks, mask_dev, slots,
                              self.feat, self.bundle_of)


class ShardedRows(MemoryRows):
    """One rank's rows of a distributed tree (`parallel/learner.py
    Sharding`): its block of the bin matrix on its device and its rows of
    the payload; `hist` reduces the histograms over the ranks (the ring
    of carries, or the summed histograms, cut to the rank's feature block
    under data_rs) and, with the fused spec, scans them with K3 for the
    candidates, which are K2's bit for bit (the reference runs its base
    histogram family under a mesh, `grow_wave.py:169-175`); `partition`
    is `MemoryRows`'s over the rank's rows."""

    def __init__(self, spec: GrowerSpec, dist, bins_fm: torch.Tensor,
                 payload: torch.Tensor, feat: Dict, scan_kw: Dict):
        self.spec, self.dist, self.bins_fm = spec, dist, bins_fm
        self.payload = dist.rows(payload).contiguous()
        self.n_rows = self.payload.shape[0]
        self.feat, self.scan_kw = feat, scan_kw
        self.bfeat = dist.block_feat(feat)
        self.hist_fn, self.pw3 = dist.histograms(spec, bins_fm,
                                                 self.payload, feat)
        self.bundle_of = make_bundled_expander(spec, feat)[1] \
            if spec.bundled else (lambda f: None)

    def hist_cache(self, leaves: int, hb: int) -> torch.Tensor:
        return torch.empty((leaves, self.dist.hist_cols(
            self.bins_fm.shape[0]), hb, 3), dtype=torch.float32,
            device=self.payload.device)

    def hist(self, leaf_id: torch.Tensor, slots: torch.Tensor,
             parent: torch.Tensor):
        h = self.hist_fn(leaf_id, slots)
        if not self.spec.fused or self.dist.empty_block:
            return h, None
        return h, split_scan(h, self.bfeat["nb"], self.bfeat["missing"],
                             parent, **self.scan_kw)


def partition_rows(bins_fm, leaf_id, picks, mask_dev, slots, feat,
                   bundle_of=lambda f: None):
    """The rows of `bins_fm` [F|G, n] with leaf ids `leaf_id` [n] after
    the picks (best, new, small, f, t, dl, is_cat): the picks are
    distinct leaves that existed at the wave's start, so their order
    cannot change a row's leaf."""
    missing, nb = feat["missing_np"], feat["nb_np"]
    for best, new, _, f, t, dl, node_cat in picks:
        go_left = split_go_left(
            bins_fm, f, t, dl, int(missing[f]), int(nb[f]), bundle_of(f),
            mask_dev[best] if node_cat else None)
        leaf_id = torch.where((leaf_id == best) & ~go_left, slots[new],
                              leaf_id)
    return leaf_id


def make_wave_grower(spec: GrowerSpec, rows: Callable = None,
                     dist=None) -> Callable:
    """The wave grow function of a spec, with the strict grower's
    contract (`ops/grow.py make_grower`): `grow(bins_fm, grad, hess,
    sample_weight, feat, allowed) -> DeviceTree`.  `rows(payload, feat,
    scan_kw)`, when given, makes each tree's row source in place of
    `MemoryRows` over `bins_fm` (the shard-streamed grower's, which
    takes `bins_fm=None`).  `dist`, a `parallel/learner.py Sharding` in
    mode data or data_rs, makes it one rank's part of the data-parallel
    learner (the reference's `:244-340`): the row source is this rank's
    `ShardedRows`, the data_rs searches cover the rank's feature block
    and merge the ranks' splits, and `leaf_id` covers every row."""
    L = spec.num_leaves
    MB = spec.max_bin
    LB, W = wave_sizes(spec)
    l1, l2, mds = spec.lambda_l1, spec.lambda_l2, spec.max_delta_step
    ps = spec.path_smooth
    fused = spec.fused
    if fused and (spec.hist_impl not in ("kernel", "kernel_q")
                  or ps > 0.0 or spec.extra_trees or spec.bundled):
        raise LightGBMError("the fused wave path needs hist_impl 'kernel' "
                            "or 'kernel_q', no path smoothing, no "
                            "extra_trees and no EFB bundles "
                            "(booster.fused_split_of decides it)")
    HB = spec.bundle_max_bin if spec.bundled else MB
    PC = pack_cols(MB, spec.has_cat)
    scan_kw = dict(l1=l1, l2=l2, min_data_in_leaf=spec.min_data_in_leaf,
                   min_sum_hessian=spec.min_sum_hessian_in_leaf,
                   min_gain_to_split=spec.min_gain_to_split)
    tail = min(spec.wave_strict_tail, LB - 1) \
        if spec.wave_strict_tail > 0 else 0
    ratio = np.float32(spec.wave_gain_ratio)
    forced = spec.forced_splits
    pen_scale = cegb_scale(spec)

    def out_of(g, h, c, parent_out):
        """Outputs of leaves from their f32 sums, on CPU tensors: the
        strict grower's expression (leaf_output, then path smoothing)."""
        t = [torch.from_numpy(np.asarray(a, np.float32))
             for a in (g, h, c, parent_out)]
        return smooth_output(leaf_output(t[0], t[1], l1, l2, mds), t[2],
                             t[3], ps, xla_fused=True).numpy()

    def clamp_output(g, h):
        return leaf_output(torch.from_numpy(np.asarray(g, np.float32)),
                           torch.from_numpy(np.asarray(h, np.float32)),
                           l1, l2, mds).numpy()

    block = dist is not None and dist.block

    def search_one(hist, sums, allowed, p_out, feat, cand=None,
                   expand=None, numerical=True, bounds=None, penalty=None):
        """The unfused search over [B] histograms (expanded from the
        bundle columns under EFB), with the rows' output `bounds` (lb,
        ub) and CEGB `penalty`; `numerical=False` is the fused path's
        categorical search."""
        if expand is not None:
            hist = expand(hist, sums)
        lb, ub = bounds if bounds is not None else (None, None)
        return find_best_split(
            hist, sums[:, 0], sums[:, 1], sums[:, 2], feat["nb"],
            feat["missing"], feat["default"], allowed, l1, l2,
            spec.min_data_in_leaf, spec.min_sum_hessian_in_leaf,
            spec.min_gain_to_split, mds, ps, p_out, cand,
            numerical=numerical, mono=feat.get("mono"), out_lb=lb,
            out_ub=ub, gain_penalty=penalty, xla_fused=True,
            penalty_scale=pen_scale, **search_kwargs(spec, feat))

    def search(hist, sums, allowed, p_out, feat, cand=None, expand=None,
               bounds=None, penalty=None):
        """`search_one`; under data_rs over this rank's feature block
        (its masks, candidate grid and penalty cut to it), the ranks'
        splits merged."""
        if not block:
            return search_one(hist, sums, allowed, p_out, feat, cand, expand,
                              bounds=bounds, penalty=penalty)
        if dist.empty_block:
            return dist.merge(None, sums.shape[0], MB, PC, sums.device)
        res = search_one(hist, sums, dist.cut(allowed), p_out,
                         dist.block_feat(feat), dist.cut(cand, -2), expand,
                         bounds=bounds, penalty=dist.cut(penalty))
        return dist.merge(res, sums.shape[0], MB, PC, sums.device)

    def fused_one(cand, hist, sums, allowed, p_out, feat, penalty=None):
        """`split_of_fused` (the reference's `grow_wave.py:417-441`):
        the numerical features' decisions from the kernels' candidates;
        with categorical features, those over the numerical features
        only, merged with the categorical search on the carried
        histograms.  Monotone constraints never take this path (the
        booster turns fusion off), so the bounds are infinite."""
        if not spec.has_cat:
            return decide_from_candidates(
                cand, sums[:, 0], sums[:, 1], sums[:, 2], feat["missing"],
                feat["default"], allowed, penalty, pen_scale, True)
        is_cat = feat["is_cat"][None, :]
        num = decide_from_candidates(
            cand, sums[:, 0], sums[:, 1], sums[:, 2], feat["missing"],
            feat["default"], allowed & ~is_cat, penalty, pen_scale, True)
        cat = search_one(hist, sums, allowed & is_cat, p_out, feat,
                         numerical=False, penalty=penalty)
        return merge_split_results(num, cat)

    def fused_split(cand, hist, sums, allowed, p_out, feat, penalty=None):
        """`fused_one`; under data_rs on this rank's block (the
        candidates already are), the ranks' splits merged."""
        if not block:
            return fused_one(cand, hist, sums, allowed, p_out, feat, penalty)
        if dist.empty_block:
            return dist.merge(None, sums.shape[0], MB, PC, sums.device)
        res = fused_one(cand, hist, sums, dist.cut(allowed), p_out,
                        dist.block_feat(feat), dist.cut(penalty))
        return dist.merge(res, sums.shape[0], MB, PC, sums.device)

    def grow(bins_fm: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
             sample_weight: torch.Tensor, feat: Dict,
             allowed: torch.Tensor) -> DeviceTree:
        global WAVES, HIST_WAVES
        dev = grad.device
        f_count = int(feat["nb"].shape[0])
        payload = torch.stack([grad * sample_weight, hess * sample_weight,
                               sample_weight], dim=1).contiguous()
        if dist is not None:
            src = ShardedRows(spec, dist, bins_fm, payload, feat, scan_kw)
        elif rows is not None:
            src = rows(payload, feat, scan_kw)
        else:
            src = MemoryRows(spec, bins_fm, payload, feat, scan_kw)
        n = src.n_rows
        expand = make_bundled_expander(spec, feat)[0] if spec.bundled \
            else None
        # node ids as the strict grower's: the root 0, the children of
        # split k 2k + 1 (the left) and 2k + 2
        masks = make_node_samplers(spec, feat, f_count, 2 * LB - 1, dev)
        penalty_fn = make_cegb_penalty(spec, feat)
        mono_np = feat.get("mono_np")
        groups = feat["ic_groups_np"] if spec.n_ic_groups else None
        if groups is not None:
            # only features inside some group may ever split
            allowed = allowed & feat["ic_groups"].any(dim=0)
        track = tracks_used(spec)
        slots = torch.arange(LB, dtype=torch.int32, device=dev)
        leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
        # the leaf cache holds the histograms as built: [G, HB] under EFB
        hist = src.hist_cache(LB, HB)

        # ---- root: sums, output, histogram and split, one host copy ----
        root_g, root_h, root_c = tree_sum(payload.t()) if dist is None \
            else dist.root_sums(payload)
        root_out = leaf_output(root_g, root_h, l1, l2, mds)
        root_sums = torch.stack([root_g, root_h, root_c])[None]   # [1, 3]
        root_pen = None if penalty_fn is None else penalty_fn(
            root_c[None], torch.zeros((1, f_count), dtype=torch.bool,
                                      device=dev))
        inf1 = torch.full((1,), float("inf"), device=dev)
        root_bounds = None if mono_np is None else (-inf1, inf1)
        h0, c0 = src.hist(leaf_id, slots[:1], root_sums)
        if fused:
            s0 = fused_split(c0, h0, root_sums, masks.allowed(0, allowed)
                             [None], root_out[None], feat, root_pen)
        else:
            s0 = search(h0, root_sums, masks.allowed(0, allowed),
                        root_out[None], feat, masks.cand(0, MB), expand,
                        bounds=root_bounds, penalty=root_pen)
        hist[0] = h0[0]
        if spec.has_cat:
            # each leaf's categorical mask on the device, for the partition
            mask_dev = torch.zeros((LB, MB), dtype=torch.bool, device=dev)
            mask_dev[0] = s0.cat_mask[0]
        forced_mask = None

        def eval_forced(idx: int, leaf: torch.Tensor) -> torch.Tensor:
            """The packed record of forced split `idx` on its leaf's
            stored histogram (the reference's `grow_wave.py:643-654`): its
            one (feature, bin) cell, sampling and penalties bypassed;
            `leaf` [6] f32 holds the leaf's g, h, count, output and
            bounds."""
            nonlocal forced_mask
            fl, ff, fb = forced[idx]
            a = allowed.clone()
            a[ff] = True
            fs = search(hist[fl:fl + 1], leaf[None, :3], a, leaf[3:4], feat,
                        forced_cand(ff, fb, f_count, MB, dev), expand,
                        bounds=None if mono_np is None
                        else (leaf[4:5], leaf[5:6]))
            forced_mask = fs.cat_mask[0] if spec.has_cat else None
            return fs.pack()[0]

        forced_n = len(forced)
        tail_dev = [eval_forced(0, torch.cat([root_sums[0], root_out[None],
                                              -inf1, inf1]))] \
            if forced_n else []
        host = to_host(torch.cat([root_sums[0], root_out[None],
                                  s0.pack().reshape(-1)] + tail_dev))

        # per-leaf records: the cached best split (`pack_cols`: gain,
        # feature, threshold, default_left, left g/h/count, right g/h/
        # count, with categoricals is_cat and the mask words), the leaf's
        # sums, output, bounds, depth and root-path features
        rec = np.zeros((LB, PC), np.float32)
        rec[:, 0] = NEG_INF
        rec[0] = host[4:4 + PC]
        frec = host[4 + PC:]
        leaf_g = np.zeros(LB, np.float32)
        leaf_h = np.zeros(LB, np.float32)
        leaf_c = np.zeros(LB, np.float32)
        leaf_out = np.zeros(LB, np.float32)
        leaf_lb = np.full(LB, -np.inf, np.float32)
        leaf_ub = np.full(LB, np.inf, np.float32)
        leaf_depth = np.zeros(LB, np.int64)
        used = np.zeros((LB, f_count), bool) if track else None
        leaf_g[0], leaf_h[0], leaf_c[0], leaf_out[0] = host[:4]
        nodes = node_arrays(LB - 1, MB)

        step, nl = 0, 1
        while step < LB - 1 and (rec[:, 0].max() > 0.0 or step < forced_n):
            WAVES += 1
            # ---- pick loop: best-first among the leaves ready at the
            # wave's start, up to the width cap ----
            ready = np.arange(LB) < nl
            remaining = LB - nl
            if tail > 0:
                wcap = 1 if remaining <= tail else min(W, remaining - tail)
            else:
                wcap = W
            fullness = np.float32(nl) / np.float32(LB)
            g_floor = np.float32(0.0)
            picks: List[tuple] = []
            while len(picks) < wcap and step < LB - 1:
                ready_gain = np.where(ready, rec[:, 0], np.float32(NEG_INF))
                forced_ok = False
                if step < forced_n:
                    # a pending forced split is the wave's first pick
                    # only (the reference's `:615-628`)
                    if picks:
                        break
                    forced_ok = bool(np.isfinite(frec[0]))
                    if not forced_ok:
                        forced_n = step      # abandon the forced prefix
                if forced_ok:
                    best = forced[step][0]
                    row = frec
                    if spec.has_cat:
                        mask_dev[best] = forced_mask
                else:
                    if not ready_gain.max() > np.maximum(g_floor,
                                                         np.float32(0.0)):
                        break
                    best = int(np.argmax(ready_gain))
                    row = rec[best]
                new = step + 1                     # nl == step + 1
                gain_s, f, t, dl, lg, lh, lc, rg, rh, rc = row[:PACK_COLS]
                f, t, dl = int(f), int(t), bool(dl)
                node_cat, node_mask = unpack_cat(row[PACK_COLS:], MB) \
                    if spec.has_cat else (False, None)
                if node_cat:
                    nodes["split_cat_mask"][step] = node_mask
                for key, v in (("split_leaf", best), ("split_feature", f),
                               ("threshold_bin", t), ("default_left", dl),
                               ("split_is_cat", node_cat),
                               ("split_gain", gain_s),
                               ("internal_g", leaf_g[best]),
                               ("internal_h", leaf_h[best]),
                               ("internal_cnt", leaf_c[best])):
                    nodes[key][step] = v
                l_out, r_out = out_of([lg, rg], [lh, rh], [lc, rc],
                                      [leaf_out[best]] * 2)
                if mono_np is not None:
                    # the basic method's clip and midpoint bounds
                    mono_f = 0 if node_cat else int(mono_np[f])
                    b = child_bounds_basic(
                        mono_f, *(torch.tensor(np.float32(v)) for v in (
                            l_out, r_out, leaf_lb[best], leaf_ub[best])))
                    l_out, r_out = b[0].numpy(), b[1].numpy()
                    leaf_lb[best], leaf_ub[best] = b[2].numpy(), b[3].numpy()
                    leaf_lb[new], leaf_ub[new] = b[4].numpy(), b[5].numpy()
                small = best if lc <= rc else new
                if not picks and not forced_ok:
                    g_floor = ratio * gain_s * fullness
                if track:
                    used[new] = used[best]
                    used[new, f] = used[best, f] = True
                ready[best] = False
                rec[best, 0] = rec[new, 0] = NEG_INF
                leaf_g[best], leaf_g[new] = lg, rg
                leaf_h[best], leaf_h[new] = lh, rh
                leaf_c[best], leaf_c[new] = lc, rc
                leaf_out[best], leaf_out[new] = l_out, r_out
                leaf_depth[best] = leaf_depth[new] = leaf_depth[best] + 1
                picks.append((best, new, small, f, t, dl, node_cat))
                step, nl = step + 1, nl + 1
            if not picks:
                break              # an infeasible forced split, no gain

            # ---- partition ----
            leaf_id = src.partition(leaf_id, picks, mask_dev if spec.has_cat
                                    else None, slots)
            if step >= LB - 1:
                break              # tree full: the children never split
            HIST_WAVES += 1

            # ---- what the device needs of the wave, in two uploads ----
            w = len(picks)
            p_left = [p[0] for p in picks]
            p_new = [p[1] for p in picks]
            p_small = [p[2] for p in picks]
            small_is_left = [s == b for s, b in zip(p_small, p_left)]
            p_large = [nw if sl else b for b, nw, sl in
                       zip(p_left, p_new, small_is_left)]
            # children in the reference's order: every left, then every new
            child = np.array(p_left + p_new, np.int64)
            # candidate rows: [small..., large...] -> [left..., new...]
            route = [i if sl else w + i for i, sl in enumerate(small_is_left)]
            route += [w + i if sl else i
                      for i, sl in enumerate(small_is_left)]
            # node ids: split k = new - 1 made children 2k + 1 and 2k + 2
            nids = [2 * nw - 1 for nw in p_new] + [2 * nw for nw in p_new]
            idx = to_device(np.array(p_left + p_small + p_large + route
                                   + child.tolist() + nids, np.int64), dev)
            stats = np.stack([leaf_g, leaf_h, leaf_c], axis=1)     # [LB, 3]
            # each child's features: the depth gate and, with interaction
            # constraints, its path's groups
            keep = np.repeat(((spec.max_depth <= 0) | (
                leaf_depth[child] < spec.max_depth))[:, None], f_count, 1)
            if groups is not None:
                keep &= ic_allowed_from_used(groups, used[child])
            vals = to_device(np.concatenate([
                stats[p_small].ravel(), stats[p_large].ravel(),
                stats[child].ravel(), leaf_out[child], leaf_lb[child],
                leaf_ub[child], keep.ravel(),
                used[child].ravel() if track else []]).astype(np.float32),
                dev)
            left_t, small_t, large_t = idx[:w], idx[w:2 * w], idx[2 * w:3 * w]
            route_t, child_t = idx[3 * w:5 * w], idx[5 * w:7 * w]
            nid_t = idx[7 * w:9 * w]
            par_small = vals[:3 * w].view(w, 3)
            par_large = vals[3 * w:6 * w].view(w, 3)
            sums = vals[6 * w:12 * w].view(2 * w, 3)
            child_out = vals[12 * w:14 * w]
            bounds = None if mono_np is None else (vals[14 * w:16 * w],
                                                   vals[16 * w:18 * w])
            o = 18 * w + 2 * w * f_count
            child_allowed = masks.allowed(nid_t, allowed[None, :] & (
                vals[18 * w:o].view(2 * w, f_count) > 0))
            pen = None if penalty_fn is None else penalty_fn(
                sums[:, 2], (vals[o:].view(2 * w, f_count) > 0)
                if track else None)

            # ---- histograms: the smaller children in one pass, the
            # larger by subtraction (the parent's histogram is still in
            # the left child's slot) ----
            parents = hist.index_select(0, left_t)
            small_h, cand_small = src.hist(leaf_id, small_t.to(torch.int32),
                                           par_small)
            large_h = parents - small_h
            hist.index_copy_(0, small_t, small_h)
            hist.index_copy_(0, large_t, large_h)

            # ---- find: every new child's best split, one host copy ----
            if fused:
                sfeat = src.bfeat if block else feat
                cand_large = None if block and dist.empty_block else \
                    split_scan(large_h, sfeat["nb"], sfeat["missing"],
                               par_large, **scan_kw)
                cand = None if cand_large is None else torch.cat(
                    [cand_small, cand_large]).index_select(0, route_t)
                res = fused_split(cand, hist.index_select(0, child_t)
                                  if spec.has_cat else None, sums,
                                  child_allowed, child_out, feat, pen)
            else:
                res = search(hist.index_select(0, child_t), sums,
                             child_allowed, child_out, feat,
                             masks.cand(nid_t, MB), expand, bounds=bounds,
                             penalty=pen)
            if spec.has_cat:
                mask_dev.index_copy_(0, child_t, res.cat_mask)
            if step < forced_n:
                fl = forced[step][0]
                tail_dev = [eval_forced(step, to_device(np.array(
                    [*stats[fl], leaf_out[fl], leaf_lb[fl], leaf_ub[fl]],
                    np.float32), dev))]
            else:
                tail_dev = []
            host = to_host(torch.cat([res.pack().reshape(-1)] + tail_dev))
            rec[child] = host[:2 * w * PC].reshape(2 * w, PC)
            frec = host[2 * w * PC:]

        leaves = dict(out=leaf_out, g=leaf_g, h=leaf_h, c=leaf_c)
        if LB > L:
            nodes, leaves, new_slot, step = prune_wave_tail(
                nodes, step, leaves, LB=LB, L=L, clamp_output=clamp_output,
                forced_n=forced_n)
            leaf_id = to_device(new_slot.astype(np.int32), dev)[leaf_id.long()]
        if dist is not None:
            leaf_id = dist.finish(leaf_id)
        # a single-leaf tree predicts 0 (ref: GBDT "no more leaves that
        # meet the split requirements"); slots past the tree stay zero
        nl = step + 1
        values = np.where((np.arange(L) < nl) & (nl > 1), leaves["out"],
                          np.float32(0.0)).astype(np.float32)
        return DeviceTree(n_splits=step, leaf_value=values,
                          leaf_g=leaves["g"], leaf_h=leaves["h"],
                          leaf_cnt=leaves["c"], leaf_id=leaf_id,
                          values=to_device(values, dev), **nodes)

    return grow
