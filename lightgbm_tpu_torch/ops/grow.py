"""Strict leaf-wise (best-first) tree growth, driven from the host.

The port's counterpart of `lightgbm_tpu/ops/grow.py` `make_grower`
(ref: src/treelearner/serial_tree_learner.cpp `SerialTreeLearner::Train`
/ `FindBestSplits` / `Split`), for numerical and categorical features,
on the plain or the EFB-bundled bin matrix.  The reference
compiles the whole best-first loop (`grow.py:887-1175`) into one XLA
`while_loop`; here a Python loop drives tensors on the device:

  * rows are never reordered: a dense per-row `leaf_id` is updated with
    a `where` at each split (`split_go_left`);
  * only the smaller child is histogrammed (`ops/hist_kernel.py`, the
    K1 kernel on a CUDA device; with quantized gradients
    `ops/hist_kernel_q.py`, the K4 kernel, over the int8 lattice made
    once per tree), the larger is parent minus smaller; histograms are
    kept one slot per leaf;
  * both children are searched in one batched `find_best_split` call,
    and the two decisions, with the children's outputs, come to the
    host in one copy.  That copy is the loop's one host sync per split
    (plus one for the root): the host picks the next leaf with a
    first-wins argmax over the cached gains, as `jnp.argmax` does;
  * per-node sampling (`feature_fraction_bynode`, `extra_trees`) reads
    masks drawn for every node id of the tree when it starts
    (`make_node_samplers`), indexed on the device: no sync a node;
  * categorical splits (`spec.has_cat`): the search adds the reference's
    cases 2-4, the host copy carries each decision's bin mask
    (`SplitResult.pack`), and a device copy of each leaf's mask routes
    the rows of a categorical split by a gather (`split_go_left`);
  * EFB (`spec.bundled`): bins_fm holds the G bundle columns, the
    histograms are [G, HB] and stay so in the leaf cache (parent minus
    child is taken there); `make_bundled_expander` expands them to the
    features' [F, MB] grid for the search only, and decodes a split
    feature's bins from its bundle column for the partition;
  * the constraints (`make_grower`'s docstring): monotone bounds,
    interaction groups, CEGB prices, forced splits and the LRU pool,
    without another host sync a split.

Root sums, leaf sums, gains and outputs stay f32, as the reference
computes them (it never enables x64).  The root sums and the split
scan's prefix sums add in the order XLA's CPU backend gives the
reference (`ops/reduce.py`), on every device.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.log import LightGBMError
from .hist_kernel import histogram_multi, histogram_multi_plain
from .hist_kernel_q import histogram_multi_quantized, quantized_lattice_rows
from .histogram import leaf_histogram_packed_multi
from .reduce import tree_sum
from .split import (MISSING_NAN, NEG_INF, PACK_COLS, find_best_split,
                    leaf_output, pack_cols, smooth_output, unpack_cat)
from .threefry import fold_in, permutation, uniform

#: blocking device-to-host copies made by the growers (the strict grower:
#: one for the root of each tree and one per split; the wave grower: one
#: for the root and one per wave that builds histograms)
HOST_SYNCS = 0


def to_host(t: torch.Tensor) -> np.ndarray:
    """A grower's blocking device-to-host copy, counted in HOST_SYNCS."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return t.cpu().numpy()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without a host sync: pinned memory and
    an asynchronous copy on a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class GrowerSpec(NamedTuple):
    """Static configuration of one grower (the fields of the reference's
    `GrowerSpec` that the port's growers read)."""
    num_leaves: int
    max_depth: int        # <= 0 means unlimited
    max_bin: int          # padded bin-axis size MB
    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    max_delta_step: float
    path_smooth: float = 0.0
    #: "kernel": `histogram_multi` (the K1 kernel on a CUDA device, the
    #: plain version on the CPU); "plain": `histogram_multi_plain`;
    #: quantized gradients, with their scales in `feat["qscales"]`:
    #: "kernel_q": `histogram_multi_quantized` (K4 on a CUDA device, the
    #: plain version on the CPU); "packed": `leaf_histogram_packed_multi`
    #: (plain PyTorch on any device)
    hist_impl: str = "kernel"
    #: "packed" only: a declared unit hessian at this level derives the
    #: counts from the hessian field (0: counted)
    packed_const_hess_level: int = 0
    #: check the lattice's w in {0, 1} precondition on the host
    #: (`tpu_debug_nans`)
    debug_checks: bool = False
    #: the wave grower (`ops/grow_wave.py`; the reference's fields of the
    #: same names, `lightgbm_tpu/ops/grow.py:111-133`): smaller-child
    #: histograms per batched pass (0: `WAVE_WIDTH_DEFAULT`), the
    #: capacity-aware gain floor, grow-then-prune factor (<= 1: off), and
    #: the strict endgame (splits of capacity left at which waves collapse
    #: to width 1; 0: off).  The strict grower ignores them.
    wave_width: int = 0
    wave_gain_ratio: float = 0.0
    wave_overgrow: float = 0.0
    wave_strict_tail: int = 0
    #: the wave grower's fused path: the smaller children's histograms and
    #: split candidates from one K2 launch (K5 with hist_impl
    #: "kernel_q"), the larger children's candidates from K3
    #: (`ops/fused_kernel.py`; kernels on a CUDA device, plain versions on
    #: the CPU).  Needs hist_impl "kernel" or "kernel_q" and no path
    #: smoothing; the strict grower ignores it.
    fused: bool = False
    #: per-node sampling (`make_node_samplers`, the reference's fields of
    #: the same names): the share of features each node may split on
    #: (< 1: `feature_fraction_bynode`) and one random threshold a
    #: feature and node (`extra_trees`).  Both draw from
    #: `feat["ff_key"]`, the tree's key.
    feature_fraction_bynode: float = 1.0
    extra_trees: bool = False
    #: categorical splits (the reference's fields of the same names,
    #: `lightgbm_tpu/ops/grow.py:62-65`, `:136`): False promises every
    #: feature is numerical, and the search skips the categorical cases
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    has_cat: bool = False
    #: EFB: bins_fm holds the bundle columns [G, N], whose largest bin
    #: count is `bundle_max_bin` (HB); `feat` carries `bundle_col`,
    #: `bundle_off` and `bundle_identity` [F] (`make_bundled_expander`)
    bundled: bool = False
    bundle_max_bin: int = 0
    #: the grower's constraints (the reference's fields of the same names,
    #: `lightgbm_tpu/ops/grow.py:72-97`, `:143-151`): the bounded LRU
    #: histogram pool (slots; 0: one a leaf), the interaction-constraint
    #: groups (their [K, F] masks in `feat["ic_groups"]`), the BFS-order
    #: forced splits ((leaf, feature, threshold_bin) tuples), CEGB (0
    #: tradeoff: off; the vectors in `feat["cegb_coupled"]`,
    #: `feat["cegb_lazy"]` and `feat["cegb_used"]`) and the intermediate
    #: monotone method (strict grower, no pool).  The monotone directions
    #: ride in `feat["mono"]`; the wave grower reads no pool and no
    #: intermediate method.
    hist_pool_slots: int = 0
    n_ic_groups: int = 0
    forced_splits: tuple = ()
    cegb_tradeoff: float = 0.0
    cegb_penalty_split: float = 0.0
    cegb_coupled: bool = False
    cegb_lazy: bool = False
    monotone_intermediate: bool = False


#: the hist_impl values whose payload is a quantized gradient lattice
QUANTIZED_IMPLS = ("kernel_q", "packed")


class DeviceTree(NamedTuple):
    """One grown tree (the reference's `ops/grow.py:158 DeviceTree`).
    Node arrays are [L-1] (`split_cat_mask` [L-1, MB], the left bins of
    a categorical split) and leaf arrays [L] host numpy; `n_splits`
    gives the populated prefix.  Node i's left child
    keeps leaf slot `split_leaf[i]`, its right child is leaf slot i + 1
    (ref: tree.h `Tree::Split`).  `leaf_id` [N] i32 (the final row to
    leaf map) and `values` [L] f32 (the leaf outputs, zero past the
    tree's leaves) stay on the device for the score update."""
    n_splits: int
    split_leaf: np.ndarray
    split_feature: np.ndarray
    threshold_bin: np.ndarray
    default_left: np.ndarray
    split_is_cat: np.ndarray
    split_cat_mask: np.ndarray
    split_gain: np.ndarray
    internal_g: np.ndarray
    internal_h: np.ndarray
    internal_cnt: np.ndarray
    leaf_value: np.ndarray
    leaf_g: np.ndarray
    leaf_h: np.ndarray
    leaf_cnt: np.ndarray
    leaf_id: torch.Tensor
    values: torch.Tensor


def feature_bins(bins_fm: torch.Tensor, f: int,
                 bundle: Optional[tuple] = None) -> torch.Tensor:
    """[N] i32 bins of feature `f`: its row of bins_fm, or with `bundle`
    = (col, off, nb) decoded from its bundle column (the reference's
    `decode_bins`, `ops/grow.py:287`): column values off .. off + nb - 2
    are the feature's bins 1 .. nb - 1, any other value its bin 0."""
    if bundle is None:
        return bins_fm[f].to(torch.int32)
    col, off, nb = bundle
    raw = bins_fm[col].to(torch.int32)
    return torch.where((raw >= off) & (raw < off + nb - 1), raw - off + 1, 0)


def split_go_left(bins_fm: torch.Tensor, f: int, t: int, dl: bool,
                  missing: int, nb: int, bundle: Optional[tuple] = None,
                  cat_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] left/right routing of one split (the reference's
    `split_go_left`, `ops/grow.py:335`): bins from `feature_bins`; a
    categorical split (`cat_mask`, its [MB] bool left bins on the
    device, given only for a categorical node: the host knows which
    from the split's copy) gathers the mask at the bins; a numerical
    one sends bin <= t left, and the NaN bin of a NaN-missing feature
    follows `dl`."""
    fbins = feature_bins(bins_fm, f, bundle)
    if cat_mask is not None:
        return cat_mask[fbins.long()]
    go_left = fbins <= t
    if missing == MISSING_NAN:
        go_left = torch.where(fbins == nb - 1, dl, go_left)
    return go_left


def tree_histograms(spec: GrowerSpec, bins_fm: torch.Tensor,
                    payload: torch.Tensor, feat: Dict,
                    plan_features: int = 0):
    """One tree's histogram function `hist(leaf_id, slots) -> [S, F,
    MB, 3]` ([S, G, HB, 3] over bundle columns) for `spec.hist_impl`,
    and the int8 lattice it reads ("kernel_q", else None).  The lattice
    is made once per tree (the reference's `ops/grow.py:583-589`), with
    the scales of `feat["qscales"]`.  `plan_features`: K1's pieces as
    for that many features (`histogram_multi`)."""
    MB = spec.bundle_max_bin if spec.bundled else spec.max_bin
    impl = spec.hist_impl
    if impl == "kernel":
        return (lambda lid, sl: histogram_multi(bins_fm, payload, lid, sl,
                                                MB, plan_features)), None
    if impl == "plain":
        return (lambda lid, sl: histogram_multi_plain(bins_fm, payload, lid,
                                                      sl, MB)), None
    if impl not in QUANTIZED_IMPLS:
        raise LightGBMError(f"unknown grower hist_impl {impl!r}")
    s_g, s_h = feat["qscales"][0], feat["qscales"][1]
    if impl == "packed":
        chl = spec.packed_const_hess_level
        return (lambda lid, sl: leaf_histogram_packed_multi(
            bins_fm, payload, lid, sl, MB, s_g, s_h, chl)), None
    pw3 = quantized_lattice_rows(payload, s_g, s_h, debug=spec.debug_checks)
    return (lambda lid, sl: histogram_multi_quantized(
        bins_fm, pw3, lid, sl, MB, s_g, s_h)), pw3


class NodeMasks(NamedTuple):
    """One tree's per-node samples, drawn when the tree starts for every
    node id it can reach (`make_node_samplers`), on the device; a node
    id indexes them there, so reading a node's mask costs no sync."""
    bynode: Optional[torch.Tensor]    # [R, F] bool, or None
    pick: Optional[torch.Tensor]      # [R, F] i64 extra_trees bin, or None
    is_cat: Optional[torch.Tensor] = None   # [F] bool with categoricals

    def allowed(self, nid, allowed: torch.Tensor) -> torch.Tensor:
        """`allowed` and the bynode mask of `nid` (an int, a slice or an
        index tensor of node ids)."""
        return allowed if self.bynode is None else allowed & self.bynode[nid]

    def cand(self, nid, mb: int) -> Optional[torch.Tensor]:
        """The extra_trees candidate grid [..., F, MB] of `nid`: each
        numerical feature's one drawn threshold, every candidate of a
        categorical feature (the reference's `m | is_cat[:, None]`,
        `ops/grow.py:326`); None without extra_trees."""
        if self.pick is None:
            return None
        bins = torch.arange(mb, device=self.pick.device)
        m = bins == self.pick[nid][..., None]
        return m if self.is_cat is None else m | self.is_cat[:, None]


def make_node_samplers(spec: GrowerSpec, feat: Dict, f_count: int,
                       n_nodes: int, device) -> NodeMasks:
    """The per-node column sampling (ref: col_sampler.hpp `GetByNode`)
    and extra_trees thresholds of one tree, the reference's
    `make_node_samplers` (`lightgbm_tpu/ops/grow.py:298`) drawn for node
    ids 0 .. n_nodes - 1 at once: node `nid`'s bynode mask is the first
    max(1, int(feature_fraction_bynode F + 1e-9)) of
    `permutation(fold_in(ff_key, nid), F)`, F the feat arrays' length
    (under EFB still the features, not the bundle columns), and its
    extra_trees threshold of feature f is int32(u_f x f32(max(nb_f - 2,
    0) + 1)), clipped to [0, MB), with u = `uniform(fold_in(ff_key,
    2^24 + nid), (F,))`; a categorical feature keeps every candidate
    (`NodeMasks.cand`).  The node keys come from one batched `fold_in`
    on the host; the draws are one threefry launch each on the card
    ([n_nodes, F] bits, [n_nodes, F] uniforms), the permutations one
    batched sort there."""
    bynode_on = spec.feature_fraction_bynode < 1.0
    if not bynode_on and not spec.extra_trees:
        return NodeMasks(None, None)
    key = feat.get("ff_key")
    if key is None:
        raise LightGBMError("feature_fraction_bynode and extra_trees draw "
                            "from feat['ff_key'], the tree's key")
    nids = torch.arange(n_nodes, dtype=torch.int64)
    bynode = pick = None
    if bynode_on:
        n_pick = max(1, int(spec.feature_fraction_bynode * f_count + 1e-9))
        perm = permutation(fold_in(key, nids), f_count, device)
        bynode = torch.zeros((n_nodes, f_count), dtype=torch.bool,
                             device=device)
        bynode.scatter_(1, perm[:, :n_pick], True)
    if spec.extra_trees:
        r = uniform(fold_in(key, nids + (1 << 24)), (f_count,), device)
        t_max = torch.clamp(feat["nb"] - 2, min=0)
        pick = (r * (t_max + 1).to(torch.float32)).to(torch.int32)
        pick = torch.clamp(pick, 0, spec.max_bin - 1).to(torch.int64)
    return NodeMasks(bynode, pick, feat["is_cat"] if spec.has_cat else None)


def make_bundled_expander(spec: GrowerSpec, feat: Dict):
    """(expand_bundled, bundle_of) for an EFB bundle matrix (the
    reference's `make_bundled_expander`, `ops/grow.py:257`).

    expand_bundled(hist [B, G, HB, 3], parent [B, 3]) -> [B, F, MB, 3]:
    a feature's bins 1 .. nb - 1 are a gather from its bundle column at
    offset `bundle_off` - 1; its bin 0 is the column's bin 0 for a
    feature alone in its column, else parent minus the sum of its other
    bins (XLA's CPU order, `ops/reduce.py tree_sum`), the sparse-bin
    identity the reference uses.  bundle_of(f) is the (col, off, nb)
    that `feature_bins` decodes feature f's bins with."""
    MB, HB = spec.max_bin, spec.bundle_max_bin
    bcol, boff = feat["bundle_col"], feat["bundle_off"]
    bident = feat["bundle_identity"]
    ar = torch.arange(MB, device=bcol.device)
    src = torch.clamp(boff[:, None] + ar[None, :] - 1, 0, HB - 1)
    valid = (ar[None, :] >= 1) & (ar[None, :] < feat["nb"][:, None])
    col_np, off_np, nb_np = (feat["bundle_col_np"], feat["bundle_off_np"],
                             feat["nb_np"])

    def expand_bundled(histg: torch.Tensor,
                       parent: torch.Tensor) -> torch.Tensor:
        hist = torch.where(valid[None, :, :, None],
                           histg[:, bcol[:, None], src], 0.0)
        rest = tree_sum(hist.transpose(2, 3))                    # [B, F, 3]
        hist[:, :, 0, :] = torch.where(bident[None, :, None],
                                       histg[:, bcol, 0, :],
                                       parent[:, None, :] - rest)
        return hist

    def bundle_of(f: int) -> tuple:
        return int(col_np[f]), int(off_np[f]), int(nb_np[f])

    return expand_bundled, bundle_of


def search_kwargs(spec: GrowerSpec, feat: Dict) -> Dict:
    """`find_best_split`'s categorical arguments for a spec: none when
    every feature is numerical."""
    if not spec.has_cat:
        return {}
    return dict(is_cat=feat["is_cat"], cat_smooth=spec.cat_smooth,
                cat_l2=spec.cat_l2, max_cat_threshold=spec.max_cat_threshold,
                max_cat_to_onehot=spec.max_cat_to_onehot, has_cat=True)


def cegb_on(spec: GrowerSpec) -> bool:
    """Whether CEGB prices candidates (the reference's `cegb_on`,
    `ops/grow.py:378`)."""
    return spec.cegb_tradeoff > 0.0 and (
        spec.cegb_penalty_split > 0.0 or spec.cegb_coupled
        or spec.cegb_lazy)


def tracks_used(spec: GrowerSpec) -> bool:
    """Whether a grower keeps each leaf's root-path features: interaction
    constraints and CEGB's lazy costs read them (`ops/grow.py:867`)."""
    return spec.n_ic_groups > 0 or (cegb_on(spec) and spec.cegb_lazy)


def cegb_scale(spec: GrowerSpec) -> float:
    """The factor the searches scale `make_cegb_penalty`'s penalty by:
    `cegb_tradeoff`, or with split costs alone the f32 product tradeoff x
    split, the penalty then being the counts.  XLA's CPU code folds the
    two constant factors of tradeoff x (split x n) into one and contracts
    gain - (tradeoff split) n into fma(-(tradeoff split), n, gain),
    which `find_best_split`'s `penalty_scale` repeats."""
    if not (spec.cegb_coupled or spec.cegb_lazy):
        return float(np.float32(spec.cegb_tradeoff)
                     * np.float32(spec.cegb_penalty_split))
    return spec.cegb_tradeoff


def make_cegb_penalty(spec: GrowerSpec, feat: Dict):
    """The CEGB candidate penalty of a tree (the reference's
    `make_cegb_penalty`, `ops/grow.py:368`; ref:
    cost_effective_gradient_boosting.hpp `DetlaGain`): `penalty(n,
    path_used) -> [B, F] f32` for the leaves' counts n [B] f32 and their
    root paths' features path_used [B, F] bool (None without lazy
    costs), or None when CEGB is off.  split x n + coupled x (1 - used) +
    lazy x n x (1 - path_used), in f32 in the reference's order (n alone
    with split costs alone, see `cegb_scale`), to be scaled by
    `cegb_scale(spec)` where it
    is subtracted from the gains (`find_best_split`'s `penalty_scale`:
    XLA contracts the scaling into the subtraction); `feat["cegb_used"]`
    (the model's used features) is frozen for the tree, so the price of
    a candidate does not depend on the growth order."""
    if not cegb_on(spec):
        return None
    f = feat["nb"].shape[0]
    if not (spec.cegb_coupled or spec.cegb_lazy):
        return lambda n, path_used: n[:, None].expand(-1, f)
    coupled = None
    if spec.cegb_coupled:
        coupled = feat["cegb_coupled"] * (
            1.0 - feat["cegb_used"].to(torch.float32))

    def penalty(n: torch.Tensor, path_used) -> torch.Tensor:
        p = (n * spec.cegb_penalty_split)[:, None].expand(-1, f)
        if coupled is not None:
            p = p + coupled[None]
        if spec.cegb_lazy:
            p = p + feat["cegb_lazy"][None] * n[:, None] * (
                1.0 - path_used.to(torch.float32))
        return p

    return penalty


def ic_allowed_from_used(groups: np.ndarray, used: np.ndarray) -> np.ndarray:
    """[B, F] features allowed under interaction constraints for nodes
    whose root paths used `used` [B, F] (the reference's
    `ic_allowed_from_used`, `ops/grow.py:417`): the union of the groups
    [K, F] that hold the whole used set."""
    ok = ~np.any(used[:, None, :] & ~groups[None], axis=2)      # [B, K]
    return np.any(groups[None] & ok[:, :, None], axis=1)


def child_bounds_basic(mono_f: int, l_sm: torch.Tensor, r_sm: torch.Tensor,
                       lb: torch.Tensor, ub: torch.Tensor):
    """The basic monotone method at one split (the reference's
    `child_bounds_basic`, `ops/grow.py:352`; ref: monotone_constraints.hpp
    `BasicLeafConstraints`): both outputs clipped to the parent's bounds,
    their f32 midpoint bounds the children on the feature's direction,
    each child clipped to its own bounds.  Returns (l_fin, r_fin, l_lb,
    l_ub, r_lb, r_ub)."""
    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)
    mid = 0.5 * (clip(l_sm, lb, ub) + clip(r_sm, lb, ub))
    l_lb, l_ub, r_lb, r_ub = lb, ub, lb, ub
    if mono_f == 1:
        l_ub, r_lb = torch.minimum(ub, mid), torch.maximum(lb, mid)
    elif mono_f == -1:
        l_lb, r_ub = torch.maximum(lb, mid), torch.minimum(ub, mid)
    return (clip(l_sm, l_lb, l_ub), clip(r_sm, r_lb, r_ub),
            l_lb, l_ub, r_lb, r_ub)


def forced_cand(feature: int, threshold_bin: int, f_count: int, mb: int,
                device) -> torch.Tensor:
    """[1, F, MB] candidate grid of one forced split: only its (feature,
    bin) cell competes (the reference's `ops/grow.py:922-923`)."""
    m = torch.zeros((1, f_count, mb), dtype=torch.bool, device=device)
    m[0, feature, threshold_bin] = True
    return m


def node_arrays(n: int, mb: int) -> Dict[str, np.ndarray]:
    """The host split log of a grower: [n] per node, [n, MB] masks."""
    return dict(
        split_leaf=np.zeros(n, np.int32),
        split_feature=np.zeros(n, np.int32),
        threshold_bin=np.zeros(n, np.int32),
        default_left=np.zeros(n, bool),
        split_is_cat=np.zeros(n, bool),
        split_cat_mask=np.zeros((n, mb), bool),
        split_gain=np.zeros(n, np.float32),
        internal_g=np.zeros(n, np.float32),
        internal_h=np.zeros(n, np.float32),
        internal_cnt=np.zeros(n, np.float32))


def make_grower(spec: GrowerSpec, dist=None) -> Callable:
    """The grow function of a spec: `grow(bins_fm, grad, hess,
    sample_weight, feat, allowed) -> DeviceTree`.

    `dist`, a `parallel/learner.py Sharding`, makes it one rank's part
    of a distributed learner: `bins_fm` holds this rank's rows (the
    feature learner's: every row), grad, hess and sample_weight are
    replicated, the histograms are reduced as the mode says, the block
    modes search this rank's features and merge the ranks' splits, the
    voting learner elects the features it sums, and the returned
    `leaf_id` covers every row.

    bins_fm [F, N] (bundled: [G, N]) u8/u16, grad/hess/sample_weight
    [N] f32 and allowed [F] bool lie on one device; `feat` holds the
    per-feature metadata as device tensors (`nb`, `missing`, `default`,
    [F] i32; `is_cat` [F] bool with categoricals; the bundle maps under
    EFB; `mono` [F] i32 with monotone constraints; `ic_groups` [K, F]
    bool with interaction constraints; the CEGB vectors) and host numpy
    copies (`nb_np`, `missing_np`, `mono_np`, `ic_groups_np`, ...).

    The constraints, as the reference's `ops/grow.py:714-1171` applies
    them, all on the device between the host copies:
      * monotone, basic: each split's children are bounded at the
        midpoint of their outputs (`child_bounds_basic`) and searched
        with their bounds;
      * monotone, intermediate (`spec.monotone_intermediate`): the
        children are clipped to the parent's bounds, then every leaf's
        bounds are recomputed from the current outputs of the opposite
        subtrees of its monotone ancestors (`anc_left`/`anc_right`
        incidence over the splits), and the leaves whose bounds moved
        are searched again with their own node ids' samples.  The
        re-search and the children's search are one batched search over
        every leaf of the tree, so a split still costs one host copy;
      * interaction constraints: only features of some group may split,
        a node only those of the groups holding its root path's features;
      * CEGB: every candidate of a node is priced by `make_cegb_penalty`;
      * forced splits: the BFS prefix is evaluated one step ahead, on
        the target leaf's stored histogram with only the designated
        (feature, bin) cell, bypassing sampling and penalties, and rides
        the previous split's host copy; an infeasible one abandons the
        rest of the prefix;
      * the pool (`hist_pool_slots`): the histograms live in that many
        LRU slots; a parent that was evicted is recomputed from its rows
        (K1 or K4 at one slot on the card)."""
    L = spec.num_leaves
    MB = spec.max_bin
    HB = spec.bundle_max_bin if spec.bundled else MB
    PC = pack_cols(MB, spec.has_cat)
    l1, l2, mds = spec.lambda_l1, spec.lambda_l2, spec.max_delta_step
    ps = spec.path_smooth
    interm = spec.monotone_intermediate
    pooled = 0 < spec.hist_pool_slots < L
    if interm and pooled:
        raise LightGBMError("monotone intermediate requires the un-pooled "
                            "histogram layout")
    P = max(2, spec.hist_pool_slots) if pooled else L
    forced = spec.forced_splits
    track = tracks_used(spec)

    def out_of(g, h, c, parent_out):
        """A node's output: leaf_output, then path smoothing (the
        monotone clip comes after, `child_bounds_basic`)."""
        return smooth_output(leaf_output(g, h, l1, l2, mds), c, parent_out,
                             ps, xla_fused=True)

    def search(hist, g, h, c, allowed, p_out, feat, cand, expand, lb=None,
               ub=None, penalty=None):
        if dist is not None and dist.mode == "voting":
            hist, allowed = dist.vote(hist, allowed, cand, feat, spec,
                                      search_kwargs(spec, feat))
        if expand is not None:
            hist = expand(hist, torch.stack([g, h, c], dim=-1))
        block = dist is not None and dist.block
        if block:
            if dist.empty_block:
                return dist.merge(None, hist.shape[0], MB, PC, hist.device)
            feat = dist.block_feat(feat)
            allowed, cand = dist.cut(allowed), dist.cut(cand, -2)
            penalty = dist.cut(penalty)
        res = find_best_split(
            hist, g, h, c, feat["nb"], feat["missing"], feat["default"],
            allowed, l1, l2, spec.min_data_in_leaf,
            spec.min_sum_hessian_in_leaf, spec.min_gain_to_split, mds, ps,
            p_out, cand, mono=feat.get("mono"), out_lb=lb, out_ub=ub,
            gain_penalty=penalty, xla_fused=True,
            penalty_scale=cegb_scale(spec), **search_kwargs(spec, feat))
        return dist.merge(res, hist.shape[0], MB, PC, hist.device) \
            if block else res

    def grow(bins_fm: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
             sample_weight: torch.Tensor, feat: Dict,
             allowed: torch.Tensor) -> DeviceTree:
        dev = bins_fm.device
        n = bins_fm.shape[1]
        f_count = int(feat["nb"].shape[0])
        payload = torch.stack([grad * sample_weight, hess * sample_weight,
                               sample_weight], dim=1).contiguous()
        hist_fn = tree_histograms(spec, bins_fm, payload, feat)[0] \
            if dist is None else dist.histograms(
                spec, bins_fm, dist.rows(payload).contiguous(), feat)[0]
        expand, bundle_of = make_bundled_expander(spec, feat) \
            if spec.bundled else (None, lambda f: None)
        # node ids: the root 0, the children of split k 2k + 1 and 2k + 2
        masks = make_node_samplers(spec, feat, f_count, 2 * L - 1, dev)
        penalty_fn = make_cegb_penalty(spec, feat)
        mono_np = feat.get("mono_np")
        groups = feat["ic_groups_np"] if spec.n_ic_groups else None
        if groups is not None:
            # only features inside some group may ever split
            allowed = allowed & feat["ic_groups"].any(dim=0)
        slots = torch.arange(L, dtype=torch.int32, device=dev)
        no_feature = torch.zeros_like(allowed)
        leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
        # the histograms as built ([G, HB] under EFB), a slot a leaf or
        # the pool's slots
        cols = bins_fm.shape[0] if dist is None \
            else dist.hist_cols(bins_fm.shape[0])
        hist = torch.empty((P, cols, HB, 3), dtype=torch.float32, device=dev)
        hist[0] = hist_fn(leaf_id, slots[:1])[0]
        owner = np.full(P, -1, np.int64)      # the leaf in each pool slot
        touched = np.full(P, -1, np.int64)    # the step of its last use
        owner[0] = touched[0] = 0

        def leaf_hist(leaf: int):
            """(histogram, slot or -1) of a leaf's rows: its slot, or a
            pool miss recomputed from the rows (the reference's
            `fetch_hist`)."""
            if not pooled:
                return hist[leaf], leaf
            hit = np.nonzero(owner == leaf)[0]
            if len(hit):
                return hist[int(hit[0])], int(hit[0])
            return hist_fn(leaf_id, slots[leaf:leaf + 1])[0], -1

        def gate(nids: torch.Tensor, deep: np.ndarray, used) -> torch.Tensor:
            """[B, F] features each node may split on: the tree's
            `allowed`, the depth gate, the interaction groups of its
            path, its bynode sample."""
            keep = np.repeat(deep[:, None], f_count, axis=1)
            if groups is not None:
                keep &= ic_allowed_from_used(groups, used)
            return masks.allowed(nids, allowed[None] & to_device(keep, dev))

        # ---- root: sums, output, split, all in one host copy ----
        root_g, root_h, root_c = tree_sum(payload.t()) if dist is None \
            else dist.root_sums(payload)
        root_out = leaf_output(root_g, root_h, l1, l2, mds)
        stat_dev = torch.zeros((L, 3), dtype=torch.float32, device=dev)
        stat_dev[0] = torch.stack([root_g, root_h, root_c])
        lb_dev = ub_dev = None
        if mono_np is not None:
            lb_dev = torch.full((L,), float("-inf"), device=dev)
            ub_dev = torch.full((L,), float("inf"), device=dev)
        used_np = np.zeros((L, f_count), bool) if track else None
        pen = None if penalty_fn is None else penalty_fn(
            root_c[None], torch.zeros((1, f_count), dtype=torch.bool,
                                      device=dev))
        s0 = search(hist[:1], root_g[None], root_h[None], root_c[None],
                    masks.allowed(0, allowed), root_out[None], feat,
                    masks.cand(0, MB), expand,
                    None if lb_dev is None else lb_dev[:1],
                    None if ub_dev is None else ub_dev[:1], pen)
        # device mirror of the per-leaf records the children read:
        # the cached split (pack_cols), its categorical mask, the output
        rec_dev = torch.zeros((L, PC), dtype=torch.float32, device=dev)
        out_dev = torch.zeros(L, dtype=torch.float32, device=dev)
        rec_dev[0] = s0.pack()[0]
        out_dev[0] = root_out
        if spec.has_cat:
            mask_dev = torch.zeros((L, MB), dtype=torch.bool, device=dev)
            mask_dev[0] = s0.cat_mask[0]
        if interm:
            # anc_left[leaf, s]: the leaf lies in the left subtree of
            # split s (the reference's `ops/grow.py:877-885`)
            anc_left = torch.zeros((L, max(L - 1, 1)), dtype=torch.bool,
                                   device=dev)
            anc_right = torch.zeros_like(anc_left)
            signs = torch.zeros(max(L - 1, 1), dtype=torch.int32,
                                device=dev)
            leaf_nid = np.zeros(L, np.int64)
        forced_rec = None

        def eval_forced(idx: int) -> torch.Tensor:
            """The packed record of forced split `idx` on its leaf now
            (the reference's `eval_forced`, `ops/grow.py:919-932`)."""
            nonlocal forced_rec
            fl, ff, fb = forced[idx]
            ph, _ = leaf_hist(fl)
            a = allowed.clone()
            a[ff] = True
            st = stat_dev[fl:fl + 1]
            fs = search(ph[None], st[:, 0], st[:, 1], st[:, 2], a,
                        out_dev[fl:fl + 1], feat,
                        forced_cand(ff, fb, f_count, MB, dev), expand,
                        None if lb_dev is None else lb_dev[fl:fl + 1],
                        None if ub_dev is None else ub_dev[fl:fl + 1])
            forced_rec = (fs.pack()[0], fs.cat_mask[0]
                          if spec.has_cat else None)
            return forced_rec[0]

        forced_n = len(forced)
        tail = [eval_forced(0)] if forced_n else []
        host = to_host(torch.cat([torch.stack([root_g, root_h, root_c,
                                               root_out]), rec_dev[0]]
                                 + tail))

        rec = np.zeros((L, PC), np.float32)
        rec[:, 0] = NEG_INF
        rec[0] = host[4:4 + PC]
        frec = host[4 + PC:]
        leaf_g = np.zeros(L, np.float32)
        leaf_h = np.zeros(L, np.float32)
        leaf_c = np.zeros(L, np.float32)
        leaf_out = np.zeros(L, np.float32)
        leaf_depth = np.zeros(L, np.int64)
        leaf_g[0], leaf_h[0], leaf_c[0], leaf_out[0] = host[:4]
        nodes = node_arrays(L - 1, MB)
        missing = feat["missing_np"]
        nb = feat["nb_np"]

        step, nl = 0, 1
        while step < L - 1 and (rec[:, 0].max() > 0.0 or step < forced_n):
            best = int(np.argmax(rec[:, 0]))
            row, row_dev = rec[best], rec_dev[best]
            mrow_dev = mask_dev[best] if spec.has_cat else None
            if step < forced_n:
                if np.isfinite(frec[0]):
                    best = forced[step][0]
                    row, (row_dev, mrow_dev) = frec, forced_rec
                else:
                    # infeasible: abandon the rest of the forced prefix
                    forced_n = step
                    if not row[0] > 0.0:
                        break
            gain_s, f, t, dl, lg, lh, lc, rg, rh, rc = row[:PACK_COLS]
            f, t, dl = int(f), int(t), bool(dl)
            node_cat, node_mask = unpack_cat(row[PACK_COLS:], MB) \
                if spec.has_cat else (False, None)
            new = nl
            parent_hist, pslot = leaf_hist(best)

            # ---- partition: dense leaf_id update ----
            go_left = split_go_left(
                bins_fm, f, t, dl, int(missing[f]), int(nb[f]), bundle_of(f),
                mrow_dev if node_cat else None)
            leaf_id = torch.where((leaf_id == best) & ~go_left,
                                  slots[new], leaf_id)

            for key, v in (("split_leaf", best), ("split_feature", f),
                           ("threshold_bin", t), ("default_left", dl),
                           ("split_is_cat", node_cat),
                           ("split_gain", gain_s),
                           ("internal_g", leaf_g[best]),
                           ("internal_h", leaf_h[best]),
                           ("internal_cnt", leaf_c[best])):
                nodes[key][step] = v
            if node_cat:
                nodes["split_cat_mask"][step] = node_mask

            # ---- histograms: the smaller child scanned, the larger by
            # subtraction ----
            left_smaller = lc <= rc
            small = best if left_smaller else new
            small_hist = hist_fn(leaf_id, slots[small:small + 1])[0]
            large_hist = parent_hist - small_hist
            lhist, rhist = (small_hist, large_hist) if left_smaller \
                else (large_hist, small_hist)
            if pooled:
                # both children placed, evicting the least recently used
                slot_l = pslot if pslot >= 0 else int(np.argmin(touched))
                touched[slot_l] = step + 1
                slot_r = int(np.argmin(touched))
                touched[slot_r] = step + 1
                hist[slot_l], hist[slot_r] = lhist, rhist
                owner[slot_l], owner[slot_r] = best, new
                kid_hist = torch.stack([lhist, rhist])
            else:
                hist[best], hist[new] = lhist, rhist

            # ---- the children's outputs and bounds ----
            sums = row_dev[4:PACK_COLS].reshape(2, 3)  # left, right
            stat_dev[best], stat_dev[new] = sums[0], sums[1]
            child_out = out_of(sums[:, 0], sums[:, 1], sums[:, 2],
                               out_dev[best])
            depth = int(leaf_depth[best]) + 1
            leaf_depth[best] = leaf_depth[new] = depth
            if track:
                used_np[new] = used_np[best]
                used_np[new, f] = used_np[best, f] = True
            mono_f = 0 if node_cat or mono_np is None else int(mono_np[f])
            if interm:
                lb_b, ub_b = lb_dev[best], ub_dev[best]
                child_out = torch.minimum(torch.maximum(child_out, lb_b),
                                          ub_b)
            elif lb_dev is not None:
                bounds = child_bounds_basic(mono_f, child_out[0],
                                            child_out[1], lb_dev[best],
                                            ub_dev[best])
                child_out = torch.stack(bounds[:2])
                b4 = torch.stack(bounds[2:])
                lb_dev[best], ub_dev[best] = b4[0], b4[1]
                lb_dev[new], ub_dev[new] = b4[2], b4[3]
            out_dev[best], out_dev[new] = child_out[0], child_out[1]
            if interm:
                moved = update_bounds(anc_left, anc_right, signs, out_dev,
                                      lb_dev, ub_dev, best, new, step,
                                      mono_f)
                leaf_nid[best], leaf_nid[new] = 2 * step + 1, 2 * step + 2

            # ---- the searches: both children (intermediate: every leaf,
            # the moved ones' records replaced), one host copy ----
            if interm:
                rows = slice(0, new + 1)
                nid_t = to_device(leaf_nid[:new + 1], dev)
                deep = (spec.max_depth <= 0) | \
                    (leaf_depth[:new + 1] < spec.max_depth)
                st = stat_dev[rows]
                a = gate(nid_t, deep, used_np[rows] if track else None)
                pen = None if penalty_fn is None else penalty_fn(
                    st[:, 2], to_device(used_np[rows], dev) if track
                    else None)
                res = search(hist[rows], st[:, 0], st[:, 1], st[:, 2], a,
                             out_dev[rows], feat, masks.cand(nid_t, MB),
                             expand, lb_dev[rows], ub_dev[rows], pen)
                moved[best] = moved[new] = True
                rec_dev[rows] = torch.where(moved[:, None], res.pack(),
                                            rec_dev[rows])
                if spec.has_cat:
                    mask_dev[rows] = torch.where(moved[:, None],
                                                 res.cat_mask, mask_dev[rows])
                packed = rec_dev[rows]
            else:
                deep_ok = spec.max_depth <= 0 or depth < spec.max_depth
                kids = slice(2 * step + 1, 2 * step + 3)
                if groups is None:
                    a = masks.allowed(kids, allowed if deep_ok
                                      else no_feature)
                else:
                    a = gate(torch.arange(2 * step + 1, 2 * step + 3,
                                          device=dev),
                             np.array([deep_ok, deep_ok]),
                             used_np[[best, new]])
                pen = None if penalty_fn is None else penalty_fn(
                    sums[:, 2], to_device(used_np[[best, new]], dev)
                    if track else None)
                res = search(kid_hist if pooled else hist[[best, new]],
                             sums[:, 0], sums[:, 1], sums[:, 2], a,
                             child_out, feat, masks.cand(kids, MB), expand,
                             None if lb_dev is None else lb_dev[[best, new]],
                             None if ub_dev is None else ub_dev[[best, new]],
                             pen)
                packed = res.pack()
                rec_dev[best], rec_dev[new] = packed[0], packed[1]
                if spec.has_cat:
                    mask_dev[best], mask_dev[new] = res.cat_mask[0], \
                        res.cat_mask[1]
            step, nl = step + 1, nl + 1
            tail = [eval_forced(step)] if step < forced_n else []
            host = to_host(torch.cat([packed.reshape(-1), child_out]
                                     + tail))
            k = packed.shape[0] * PC
            if interm:
                rec[:new + 1] = host[:k].reshape(-1, PC)
            else:
                rec[best], rec[new] = host[:PC], host[PC:k]
            leaf_out[best], leaf_out[new] = host[k:k + 2]
            frec = host[k + 2:]
            leaf_g[best], leaf_h[best], leaf_c[best] = lg, lh, lc
            leaf_g[new], leaf_h[new], leaf_c[new] = rg, rh, rc

        # a single-leaf tree predicts 0 (ref: GBDT "no more leaves that
        # meet the split requirements"); slots >= nl stay zero
        active = np.arange(L) < nl
        values = np.where(active & (nl > 1), leaf_out, np.float32(0.0))
        values_dev = torch.where(
            (torch.arange(L, device=dev) < nl) & (nl > 1), out_dev, 0.0)
        if dist is not None:
            leaf_id = dist.finish(leaf_id)
        return DeviceTree(n_splits=step, leaf_value=values,
                          leaf_g=leaf_g, leaf_h=leaf_h, leaf_cnt=leaf_c,
                          leaf_id=leaf_id, values=values_dev, **nodes)

    return grow


def update_bounds(anc_left, anc_right, signs, out_dev, lb_dev, ub_dev,
                  best: int, new: int, step: int,
                  mono_f: int) -> torch.Tensor:
    """The intermediate monotone method's bounds after split `step` (the
    reference's `ops/grow.py:1004-1038`), in place on the device: the
    ancestry of the two children, then for each of the leaves 0 .. new
    the tightest bound that its monotone ancestors' opposite subtrees
    give.  Returns the [new + 1] mask of the leaves whose bounds moved."""
    anc_left[new] = anc_left[best]
    anc_left[best, step] = True
    anc_right[new] = anc_right[best]
    anc_right[new, step] = True
    signs[step] = mono_f
    inf = float("inf")
    ml, mr = anc_left[:new + 1], anc_right[:new + 1]       # [n, S]
    outs = out_dev[:new + 1, None]
    left_max = torch.where(ml, outs, -inf).amax(dim=0)
    left_min = torch.where(ml, outs, inf).amin(dim=0)
    right_max = torch.where(mr, outs, -inf).amax(dim=0)
    right_min = torch.where(mr, outs, inf).amin(dim=0)
    pos, neg = signs == 1, signs == -1
    new_ub = torch.minimum(
        torch.where(ml & pos, right_min, inf).amin(dim=1),
        torch.where(mr & neg, left_min, inf).amin(dim=1))
    new_lb = torch.maximum(
        torch.where(mr & pos, left_max, -inf).amax(dim=1),
        torch.where(ml & neg, right_max, -inf).amax(dim=1))
    moved = (new_lb != lb_dev[:new + 1]) | (new_ub != ub_dev[:new + 1])
    lb_dev[:new + 1] = new_lb
    ub_dev[:new + 1] = new_ub
    return moved
