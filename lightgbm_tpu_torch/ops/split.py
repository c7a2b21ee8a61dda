"""Best-split search over (feature, threshold) grids.

The port's counterpart of `lightgbm_tpu/ops/split.py` (ref:
src/treelearner/feature_histogram.hpp `FindBestThresholdNumerical`
[the two missing-direction scans], `FindBestThresholdCategorical`
[one-vs-rest for few categories, sorted many-vs-rest by the
grad / (hess + cat_smooth) ratio otherwise], `GetSplitGains`,
`CalculateSplittedLeafOutput`, `GetLeafGain`): `find_best_split`
(`split.py:137-364`) with its decide stage, on torch tensors; the fused
path's per-feature reduction `fused_numerical_candidates`
(`split.py:420`, the plain version of the K2/K3 scan) with its decide
stage `decide_from_candidates` (`split.py:488`); and
`merge_split_results` (`split.py:535`), which joins the fused path's
numerical result with the categorical search.

All scans are one vectorized computation, as in the reference: prefix
sums along the bin axis give every candidate partition, the gain is
evaluated over the whole [case, F, MB] grid, and one flat argmax picks
the winner:

  case 0: numerical, missing right      case 3: categorical, ascending
  case 1: numerical, missing left               ratio prefix
  case 2: categorical one-vs-rest       case 4: categorical, descending

Ties go to the first candidate in (case, feature, threshold) order, as
`jnp.argmax` and `torch.argmax` both choose the first maximum; invalid
candidates hold -inf, never NaN.  The search takes a leading batch axis
[B, F, MB, 3], so the grower scans both children of a split in one
call; each batch row is searched on its own.  Categorical bin 0 (the
other/rare and missing bin) never joins the left subset, as in the
reference, so unseen categories and NaN always go right.

The prefix sums add in the order XLA's CPU backend gives `jnp.cumsum`
(`ops/reduce.py block_cumsum`), on every device, so from the same
histograms the port's sums, gains and decisions are the reference's
bits on the CPU.

The categorical orders are stable sorts (`torch.sort(stable=True)`,
as `jnp.argsort`), the descending one a stable ascending sort of the
negated ratios with invalid bins at -inf, as in the reference: invalid
bins tie at +-inf, and a descending sort would order those ties
differently.  Their prefix sums add in `block_cumsum`'s order too.

Constraints (`split.py:147-250`): a monotone direction `mono` [F] in
{-1, 0, +1}, a leaf's output bounds [`out_lb`, `out_ub`] or path
smoothing switch a candidate to the given-output gain: the children's
outputs (smoothed, then clipped to the bounds) scored by
`-(2 ThresholdL1(g) w + (h + l2) w^2)`, and a numerical candidate whose
clipped outputs break its feature's direction is rejected.  With no
constraint the closed form stays, so unconstrained searches are the
same bits.  CEGB's `gain_penalty` ([F] or [B, F]) is subtracted from
every candidate before the argmax (`:310-315`, `:374-375`, `:504`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .reduce import block_cumsum
from .xla_math import _fma as fma_f32

NEG_INF = float("-inf")

# missing_type codes (must match utils/binning.py)
MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2

#: columns of `SplitResult.pack` for a numerical search: the chosen split
#: of each batch row
PACK_COLS = 10
#: bits of the categorical mask a packed f32 column holds (exact integers)
MASK_BITS = 24


def pack_cols(max_bin: int, has_cat: bool) -> int:
    """Columns of `SplitResult.pack`: PACK_COLS, and with categorical
    features one for `is_cat` and ceil(MB / MASK_BITS) for the mask."""
    return PACK_COLS + (1 + math.ceil(max_bin / MASK_BITS) if has_cat else 0)


def unpack_cat(tail: np.ndarray, max_bin: int):
    """(is_cat, [MB] bool mask) from the columns past PACK_COLS of one
    host row of `SplitResult.pack`."""
    words = tail[1:].astype(np.int64)
    bits = (words[:, None] >> np.arange(MASK_BITS)) & 1
    return bool(tail[0]), bits.reshape(-1)[:max_bin].astype(bool)


class SplitResult(NamedTuple):
    """Best split of each leaf (ref: split_info.hpp `SplitInfo`), one
    entry per batch row (0-d tensors for an unbatched search).  A search
    over numerical features only leaves `is_cat` and `cat_mask` None."""
    gain: torch.Tensor           # f32; -inf when no valid split
    feature: torch.Tensor        # i64; -1 when no valid split
    threshold_bin: torch.Tensor  # i64; left iff bin <= threshold_bin
    default_left: torch.Tensor   # bool; missing direction
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_cnt: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_cnt: torch.Tensor
    is_cat: Optional[torch.Tensor] = None    # bool; categorical split
    cat_mask: Optional[torch.Tensor] = None  # [MB] bool; left iff mask[bin]

    def pack(self) -> torch.Tensor:
        """[B, pack_cols] f32: gain, feature, threshold, default_left,
        left g/h/count, right g/h/count; with a categorical search then
        is_cat and the mask, MASK_BITS bins a column as an integer
        (`unpack_cat` reads them back).  Feature, threshold and the mask
        words are integers below 2^24, exact in f32; one copy brings a
        batch's decisions to the host."""
        cols = [self.gain, self.feature.to(torch.float32),
                self.threshold_bin.to(torch.float32),
                self.default_left.to(torch.float32),
                self.left_sum_g, self.left_sum_h, self.left_cnt,
                self.right_sum_g, self.right_sum_h, self.right_cnt]
        out = torch.stack(cols, dim=-1)
        if self.cat_mask is None:
            return out
        m = self.cat_mask
        nw = math.ceil(m.shape[-1] / MASK_BITS)
        m = torch.nn.functional.pad(m.to(torch.int32),
                                    (0, nw * MASK_BITS - m.shape[-1]))
        shifts = torch.arange(MASK_BITS, dtype=torch.int32, device=m.device)
        words = (m.reshape(*m.shape[:-1], nw, MASK_BITS) << shifts).sum(-1)
        return torch.cat([out, self.is_cat.to(torch.float32)[..., None],
                          words.to(torch.float32)], dim=-1)


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """ref: feature_histogram.hpp `ThresholdL1`."""
    return torch.sign(s) * torch.clamp_min(torch.abs(s) - l1, 0.0)


def leaf_gain(g: torch.Tensor, h: torch.Tensor, l1: float,
              l2: float) -> torch.Tensor:
    """ref: feature_histogram.hpp `GetLeafGain` (without smoothing)."""
    t = threshold_l1(g, l1)
    denom = h + l2
    pos = denom > 0
    return torch.where(pos, t * t / torch.where(pos, denom, 1.0), 0.0)


def leaf_output(g: torch.Tensor, h: torch.Tensor, l1: float, l2: float,
                max_delta_step: float = 0.0) -> torch.Tensor:
    """ref: feature_histogram.hpp `CalculateSplittedLeafOutput`."""
    denom = h + l2
    pos = denom > 0
    out = torch.where(pos, -threshold_l1(g, l1) / torch.where(pos, denom,
                                                              1.0), 0.0)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def smooth_output(out: torch.Tensor, cnt: torch.Tensor,
                  parent_out: torch.Tensor, path_smooth: float,
                  xla_fused: bool = False) -> torch.Tensor:
    """Path smoothing: shrink a node's output toward its parent's (ref:
    feature_histogram.hpp under USE_SMOOTHING).  `xla_fused` adds as
    the reference's growers do, where XLA's CPU code contracts the
    first product and the sum into one fused multiply-add."""
    if path_smooth <= 0.0:
        return out
    frac = cnt / (cnt + path_smooth)
    if xla_fused:
        return fma_f32(out, frac, parent_out * (1.0 - frac))
    return out * frac + parent_out * (1.0 - frac)


def size_constraints_ok(left: torch.Tensor, right: torch.Tensor,
                        min_data_in_leaf: float,
                        min_sum_hessian: float) -> torch.Tensor:
    """Child-size gate (ref: the min_data_in_leaf /
    min_sum_hessian_in_leaf guards of the threshold finders)."""
    return ((left[..., 2] >= min_data_in_leaf)
            & (right[..., 2] >= min_data_in_leaf)
            & (left[..., 1] >= min_sum_hessian)
            & (right[..., 1] >= min_sum_hessian))


def plain_split_gain(left: torch.Tensor, right: torch.Tensor, l1: float,
                     l2: float, shift: torch.Tensor) -> torch.Tensor:
    """`GetLeafGain(l) + GetLeafGain(r) - shift` (ref:
    feature_histogram.hpp `GetSplitGains` without constraints)."""
    return (leaf_gain(left[..., 0], left[..., 1], l1, l2)
            + leaf_gain(right[..., 0], right[..., 1], l1, l2)
            - shift)


def find_best_split(hist: torch.Tensor, parent_g: torch.Tensor,
                    parent_h: torch.Tensor, parent_c: torch.Tensor,
                    feat_nb: torch.Tensor, feat_missing: torch.Tensor,
                    feat_default: torch.Tensor, allowed: torch.Tensor,
                    l1: float, l2: float, min_data_in_leaf: float,
                    min_sum_hessian: float, min_gain_to_split: float,
                    max_delta_step: float = 0.0, path_smooth: float = 0.0,
                    parent_output: Optional[torch.Tensor] = None,
                    cand_mask: Optional[torch.Tensor] = None, *,
                    is_cat: Optional[torch.Tensor] = None,
                    cat_smooth: float = 10.0, cat_l2: float = 10.0,
                    max_cat_threshold: int = 32, max_cat_to_onehot: int = 4,
                    has_cat: bool = False, numerical: bool = True,
                    mono: Optional[torch.Tensor] = None,
                    out_lb: Optional[torch.Tensor] = None,
                    out_ub: Optional[torch.Tensor] = None,
                    gain_penalty: Optional[torch.Tensor] = None,
                    xla_fused: bool = False,
                    penalty_scale: Optional[float] = None,
                    feature_gains: bool = False) -> SplitResult:
    """Best split of each leaf.

    hist [F, MB, 3] f32 with 0-d parent sums, or [B, F, MB, 3] with [B]
    parent sums and `allowed` [F] or [B, F] bool.  Bins at or past a
    feature's `feat_nb` are masked out of the scan; a feature with NaN
    missing keeps its last bin out of both prefixes and tries it on
    each side (case 1: missing left).  `path_smooth` > 0 shrinks the
    candidate outputs toward `parent_output` and scores them with the
    given-output gain, as the reference does.  `cand_mask` [F, MB] or
    [B, F, MB] bool restricts the candidate grid (extra_trees: one
    threshold a numerical feature, every candidate of a categorical
    one, `ops/grow.py make_node_samplers`); a candidate outside it has
    gain -inf, as at the reference's `split.py:315-317`.

    `has_cat` (static, the reference's) with `is_cat` [F] bool adds the
    categorical cases 2-4 over the features `is_cat` marks, with
    `l2 + cat_l2` in their gains; False promises every feature is
    numerical and runs the numerical search alone, with `is_cat` and
    `cat_mask` None in the result.  `numerical=False` (with `has_cat`)
    searches the categorical cases only: the fused wave's categorical
    search, whose numerical candidates come from the kernels; it picks
    what the full search would among the categorical candidates, and a
    leaf with none has gain -inf (`merge_split_results` then keeps the
    numerical result).

    The constraints of the reference's `split.py:147-250`: `mono` [F]
    int (the monotone direction of each feature; None: all 0), `out_lb`
    and `out_ub` (each row's output bounds, 0-d or [B]; None: -inf and
    +inf).  Finite bounds, a nonzero direction or path smoothing score a
    candidate with the given-output gain of its clipped outputs; a
    numerical candidate whose clipped outputs break its feature's
    direction is rejected.  Categorical candidates are clipped but take
    no direction.  `gain_penalty` [F] or [B, F] (CEGB) is subtracted
    from every candidate of a feature; with `penalty_scale` it is
    unscaled, and `penalty_scale * gain_penalty` is subtracted.

    `xla_fused` adds as the reference's jitted growers do, where XLA's
    CPU code contracts `2 t w + (h + l2) w w` into fma(2 t, w, (h + l2)
    w w) and `gain - scale * penalty` into fma(-scale, penalty, gain)
    (an f64 multiply-add rounded to f32, `ops/xla_math.py _fma`); without
    it the adds are the reference's op-by-op ones.  The growers pass
    it.

    `feature_gains` returns each feature's best gain [B, F] (or [F])
    over its cases and bins instead of a decision: the voting learner's
    local vote (the reference's `want_feature_gains`)."""
    one = hist.dim() == 3
    if one:
        hist = hist[None]
        parent_g, parent_h, parent_c = (
            p.reshape(1) for p in (parent_g, parent_h, parent_c))
        if parent_output is not None:
            parent_output = parent_output.reshape(1)
        if gain_penalty is not None and gain_penalty.dim() == 1:
            gain_penalty = gain_penalty[None]
    b, f, mb, _ = hist.shape
    dev = hist.device
    if allowed.dim() == 1:
        allowed = allowed[None].expand(b, f)
    bin_ar = torch.arange(mb, device=dev)
    valid_bin = bin_ar[None, :] < feat_nb[:, None]              # [F, MB]
    h = torch.where(valid_bin[None, :, :, None], hist, 0.0)
    parent = torch.stack([parent_g, parent_h, parent_c], dim=-1)  # [B, 3]
    p_out = None
    if path_smooth > 0.0:
        p_out = (torch.zeros_like(parent_g) if parent_output is None
                 else parent_output)[:, None, None]
    lb = ub = bounded = None
    if out_lb is not None or out_ub is not None:
        inf = torch.full((b,), float("inf"), device=dev)
        lb = (-inf if out_lb is None else out_lb.reshape(-1).expand(b)
              )[:, None, None]
        ub = (inf if out_ub is None else out_ub.reshape(-1).expand(b)
              )[:, None, None]
        bounded = torch.isfinite(lb) | torch.isfinite(ub)      # [B, 1, 1]

    def gain_of(left, right, valid, l2_eff, shift, mono_f=None):
        """Split gains with `l2_eff`, -inf outside `valid` or the size
        gates; `mono_f` [F] is the numerical cases' direction."""
        if path_smooth > 0.0 or bounded is not None or mono_f is not None:
            def given(side):
                out = smooth_output(
                    leaf_output(side[..., 0], side[..., 1], l1, l2_eff,
                                max_delta_step), side[..., 2], p_out,
                    path_smooth)
                if lb is not None:
                    out = torch.minimum(torch.maximum(out, lb), ub)
                t = threshold_l1(side[..., 0], l1)
                hw = (side[..., 1] + l2_eff) * out
                if xla_fused:
                    return -fma_f32(2.0 * t, out, hw * out), out
                return -(2.0 * t * out + hw * out), out
            gl, l_out = given(left)
            gr, r_out = given(right)
            g = (gl + gr) - shift
            if mono_f is not None:
                m = mono_f[:, None]
                g = torch.where(((m > 0) & (l_out > r_out))
                                | ((m < 0) & (l_out < r_out)), NEG_INF, g)
            if path_smooth <= 0.0:
                on = bounded if bounded is not None else False
                if mono_f is not None:
                    on = (mono_f != 0)[:, None] | on
                g = torch.where(on, g, plain_split_gain(left, right, l1,
                                                        l2_eff, shift))
        else:
            g = plain_split_gain(left, right, l1, l2_eff, shift)
        ok = valid & size_constraints_ok(left, right, min_data_in_leaf,
                                         min_sum_hessian)
        return torch.where(ok, g, NEG_INF)

    gains, lefts = [], []
    if numerical:
        num_ok = allowed & ~is_cat[None] if has_cat else allowed
        cum = block_cumsum(h.transpose(2, 3)).transpose(2, 3)   # [B,F,MB,3]
        has_nan = feat_missing == MISSING_NAN                    # [F]
        nan_idx = torch.where(has_nan, feat_nb - 1, 0).long()
        nanv = h[:, torch.arange(f, device=dev), nan_idx, :]     # [B, F, 3]
        nanv = torch.where(has_nan[None, :, None], nanv, 0.0)
        t_max = feat_nb - 2 - has_nan.to(feat_nb.dtype)
        valid_t = (bin_ar[None, :] <= t_max[:, None])[None] \
            & num_ok[:, :, None]                                 # [B,F,MB]
        if cand_mask is not None:
            valid_t = valid_t & cand_mask
        shift = (leaf_gain(parent_g, parent_h, l1, l2)
                 + min_gain_to_split)[:, None, None]
        # case 0: missing right (the NaN bin is last; prefixes exclude it)
        left0 = cum
        gain0 = gain_of(left0, parent[:, None, None, :] - left0, valid_t,
                        l2, shift, mono)
        # case 1: missing left
        left1 = cum + nanv[:, :, None, :]
        gain1 = gain_of(left1, parent[:, None, None, :] - left1,
                        valid_t & has_nan[None, :, None], l2, shift, mono)
        if gain_penalty is not None:
            gain0 = _penalize(gain0, gain_penalty[:, :, None],
                              penalty_scale, xla_fused)
            gain1 = _penalize(gain1, gain_penalty[:, :, None],
                              penalty_scale, xla_fused)
        if feature_gains and not has_cat:
            fg = torch.maximum(gain0.amax(dim=-1), gain1.amax(dim=-1))
            return fg[0] if one else fg
        if not has_cat:
            res = _decide_numerical(gain0, gain1, left0, left1, parent,
                                    feat_missing, feat_default)
            return SplitResult(*(x[0] for x in res[:10])) if one else res
        gains += [gain0, gain1]
        lefts += [left0, left1]
    cat = _categorical_cases(h, parent, valid_bin, allowed & is_cat[None],
                             gain_of, l1, l2 + cat_l2, min_gain_to_split,
                             cat_smooth, max_cat_threshold,
                             max_cat_to_onehot)
    cat_gains, cat_lefts = cat[0], cat[1]
    if gain_penalty is not None:
        cat_gains = _penalize(cat_gains, gain_penalty[None, :, :, None],
                              penalty_scale, xla_fused)
    if cand_mask is not None:
        cat_gains = torch.where(cand_mask, cat_gains, NEG_INF)
    if feature_gains:
        fg = torch.stack(gains + list(cat_gains)).amax(dim=(0, 3))
        return fg[0] if one else fg
    res = _decide(gains + list(cat_gains), lefts + list(cat_lefts),
                  0 if numerical else 2, parent, feat_missing, feat_default,
                  cat[2:])
    if one:
        res = SplitResult(*(x[0] for x in res))
    return res


def _penalize(gain: torch.Tensor, penalty: torch.Tensor,
              scale: Optional[float], xla_fused: bool) -> torch.Tensor:
    """gain - penalty, or with `scale` gain - scale * penalty (contracted
    into one fma under `xla_fused`, as XLA's CPU code does)."""
    if scale is None:
        return gain - penalty
    if xla_fused:
        return fma_f32(penalty, -float(np.float32(scale)), gain)
    return gain - scale * penalty


def _categorical_cases(h, parent, valid_bin, cat_ok, gain_of, l1, l2c,
                       min_gain_to_split, cat_smooth, max_cat_threshold,
                       max_cat_to_onehot):
    """The categorical half of `find_best_split` (the reference's
    `split.py:252-329`) over masked histograms h [B, F, MB, 3]: (gains
    [3, B, F, MB] of cases 2, 3, 4, their left sums [3, B, F, MB, 3],
    cat_valid, order_asc, order_desc).  Case 2 is one-vs-rest, for
    features with at most `max_cat_to_onehot` used bins; cases 3 and 4
    are the prefixes of at most `max_cat_threshold` bins in ascending
    and descending order of g / (h + cat_smooth), leaving at least one
    used bin right.  The two orders and the three cases each run as one
    batch of torch ops (the same adds as one at a time)."""
    b, f, mb, _ = h.shape
    bin_ar = torch.arange(mb, device=h.device)
    shift = (leaf_gain(parent[:, 0], parent[:, 1], l1, l2c)
             + min_gain_to_split)[:, None, None]
    # bin 0 (other / missing) never joins the left subset
    cat_valid = (bin_ar >= 1)[None, None, :] & valid_bin[None] \
        & (h[..., 2] > 0) & cat_ok[:, :, None]                   # [B,F,MB]
    used = cat_valid.sum(dim=2)[:, :, None]                      # [B, F, 1]
    # the ratio is a tensor-by-tensor divide; cat_smooth is an f32 add
    ratio = torch.where(cat_valid, h[..., 0] / (h[..., 1] + cat_smooth),
                        float("inf"))
    ratio_desc = torch.where(cat_valid, ratio, NEG_INF)
    order = torch.sort(torch.stack([ratio, -ratio_desc]), dim=3,
                       stable=True).indices                  # [2, B, F, MB]
    hs = h[None].expand(2, b, f, mb, 3).gather(
        3, order[..., None].expand(2, b, f, mb, 3))
    cumk = block_cumsum(hs.transpose(3, 4)).transpose(3, 4)
    k = (bin_ar + 1)[None, None, :]
    okk = (k <= max_cat_threshold) & (k < used) \
        & (used > max_cat_to_onehot) & cat_ok[:, :, None]
    lefts = torch.cat([h[None], cumk])                       # [3,B,F,MB,3]
    valid = torch.stack([cat_valid & (used <= max_cat_to_onehot), okk, okk])
    gains = gain_of(lefts, parent[:, None, None, :] - lefts, valid, l2c,
                    shift)
    return gains, lefts, cat_valid, order[0], order[1]


def _decide(gains, lefts, case0, parent, feat_missing, feat_default,
            cat) -> SplitResult:
    """Decide stage of a search with categorical cases (the reference's
    `split.py:331-364`): one flat first-wins argmax per batch row over
    [case, F, MB], cases `case0` onwards; a categorical winner's left
    subset is the bins of its case, through the inverse permutation of
    its order for cases 3 and 4."""
    cat_valid, order_asc, order_desc = cat
    b, f, mb = gains[0].shape
    flat = torch.stack(gains, dim=1).reshape(b, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    ci = best // (f * mb)
    rem = best % (f * mb)
    feat = rem // mb
    thr = rem % mb
    case = ci + case0
    rows = torch.arange(b, device=flat.device)
    left = torch.stack([x[rows, feat, thr] for x in lefts], dim=1)[rows, ci]
    right = parent - left
    best_is_cat = case >= 2
    mtype = feat_missing[feat]
    dl = torch.where(mtype == MISSING_NAN, case == 1,
                     (mtype == MISSING_ZERO) & (feat_default[feat] <= thr)) \
        & ~best_is_cat
    ar = torch.arange(mb, device=flat.device).expand(b, mb)
    rank_asc = torch.empty_like(ar).scatter_(1, order_asc[rows, feat], ar)
    rank_desc = torch.empty_like(ar).scatter_(1, order_desc[rows, feat], ar)
    t = thr[:, None]
    mask = torch.where((case == 2)[:, None], ar == t,
                       torch.where((case == 3)[:, None], rank_asc <= t,
                                   rank_desc <= t))
    no_split = ~torch.isfinite(best_gain)
    mask = mask & cat_valid[rows, feat] & (best_is_cat & ~no_split)[:, None]
    return SplitResult(
        gain=torch.where(no_split, NEG_INF, best_gain),
        feature=torch.where(no_split, -1, feat),
        threshold_bin=thr, default_left=dl,
        left_sum_g=left[:, 0], left_sum_h=left[:, 1], left_cnt=left[:, 2],
        right_sum_g=right[:, 0], right_sum_h=right[:, 1],
        right_cnt=right[:, 2], is_cat=best_is_cat & ~no_split,
        cat_mask=mask)


def _decide_numerical(gain0, gain1, left0, left1, parent, feat_missing,
                      feat_default) -> SplitResult:
    """Decide stage (the reference's `_decide_numerical`): one flat
    first-wins argmax per batch row over [case, F, MB]."""
    b, f, mb = gain0.shape
    flat = torch.stack([gain0, gain1], dim=1).reshape(b, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    case = best // (f * mb)
    rem = best % (f * mb)
    feat = rem // mb
    thr = rem % mb
    rows = torch.arange(b, device=flat.device)
    left = torch.where((case == 0)[:, None], left0[rows, feat, thr],
                       left1[rows, feat, thr])
    right = parent - left
    mtype = feat_missing[feat]
    dl = torch.where(mtype == MISSING_NAN, case == 1,
                     (mtype == MISSING_ZERO) & (feat_default[feat] <= thr))
    no_split = ~torch.isfinite(best_gain)
    return SplitResult(
        gain=torch.where(no_split, NEG_INF, best_gain),
        feature=torch.where(no_split, -1, feat),
        threshold_bin=thr, default_left=dl,
        left_sum_g=left[:, 0], left_sum_h=left[:, 1], left_cnt=left[:, 2],
        right_sum_g=right[:, 0], right_sum_h=right[:, 1],
        right_cnt=right[:, 2])


# --------------------------------------------------------------------- fused
# The wave grower's fused path (ops/fused_kernel.py, the K2 and K3 kernels)
# scans each histogram once and keeps only a compact per-(slot, case,
# feature) candidate; the decide stage below turns candidates into the
# SplitResult `find_best_split` gives.  ref: `lightgbm_tpu/ops/split.py:
# 409-532`.

FUSED_CASES = 2        # case 0: missing right, case 1: missing left
FUSED_CAND_COLS = 8    # gain, thr, left_g, left_h, left_cnt + 3 pad lanes


def fused_numerical_candidates(hist: torch.Tensor, feat_nb: torch.Tensor,
                               feat_missing: torch.Tensor,
                               parent: torch.Tensor, *, l1: float, l2: float,
                               min_data_in_leaf: float,
                               min_sum_hessian: float,
                               min_gain_to_split: float) -> torch.Tensor:
    """Per-(feature, slot, case) reduction of `find_best_split`'s two
    numerical missing-direction scans (the reference's
    `split.py:420 fused_numerical_candidates`).

    hist [F, S, MB, 3] f32, feat_nb / feat_missing [F] int, parent [S, 3]
    f32 (each slot's g, h, count sums).  Returns [F, S, FUSED_CASES,
    FUSED_CAND_COLS] f32: each row is (gain, threshold_bin, left_g,
    left_h, left_cnt, 0, 0, 0) at the case's first-wins best threshold; a
    row with no valid threshold is (-inf, 0, the prefix at bin 0).  The
    prefix sums are `block_cumsum`'s (XLA's CPU order), the gain and the
    gates those of `find_best_split`, so on the same histogram the
    numbers are the reference's bits on the CPU.  Feature gates come
    later, in `decide_from_candidates`."""
    f, s, mb, _ = hist.shape
    dev = hist.device
    bins = torch.arange(mb, device=dev)[None, :]                 # [1, MB]
    valid_bin = bins < feat_nb[:, None]                          # [F, MB]
    h = torch.where(valid_bin[:, None, :, None], hist, 0.0)
    cum = block_cumsum(h.transpose(2, 3)).transpose(2, 3)       # [F,S,MB,3]
    has_nan = feat_missing == MISSING_NAN                        # [F]
    nan_idx = torch.where(has_nan, feat_nb - 1, 0).long().clamp_min(0)
    nanv = h.gather(2, nan_idx[:, None, None, None].expand(f, s, 1, 3))
    nanv = torch.where(has_nan[:, None, None], nanv[:, :, 0, :], 0.0)
    t_max = feat_nb - 2 - has_nan.to(feat_nb.dtype)
    valid_t = bins <= t_max[:, None]                             # [F, MB]

    shift = (leaf_gain(parent[:, 0], parent[:, 1], l1, l2)
             + min_gain_to_split)                                # [S]
    p4 = parent[None, :, None, :]

    def case_best(left, valid):
        right = p4 - left
        g = plain_split_gain(left, right, l1, l2, shift[None, :, None])
        ok = valid & size_constraints_ok(left, right, min_data_in_leaf,
                                         min_sum_hessian)
        g = torch.where(ok, g, NEG_INF)                          # [F, S, MB]
        thr = torch.argmax(g, dim=2)                             # first wins
        gb = g.gather(2, thr[..., None])
        lv = left.gather(2, thr[..., None, None].expand(f, s, 1, 3))[:, :, 0]
        pad = torch.zeros((f, s, FUSED_CAND_COLS - 5), dtype=hist.dtype,
                          device=dev)
        return torch.cat([gb, thr.to(hist.dtype)[..., None], lv, pad], -1)

    c0 = case_best(cum, valid_t[:, None, :])
    c1 = case_best(cum + nanv[:, :, None, :],
                   (valid_t & has_nan[:, None])[:, None, :])
    return torch.stack([c0, c1], dim=2)


def decide_from_candidates(cand: torch.Tensor, parent_g: torch.Tensor,
                           parent_h: torch.Tensor, parent_c: torch.Tensor,
                           feat_missing: torch.Tensor,
                           feat_default: torch.Tensor,
                           allowed_num: torch.Tensor,
                           gain_penalty: Optional[torch.Tensor] = None,
                           penalty_scale: Optional[float] = None,
                           xla_fused: bool = False) -> SplitResult:
    """SplitResult of each leaf from its fused candidates (the
    reference's `split.py:488 decide_from_candidates`, batched).

    cand [B, FUSED_CASES, F, FUSED_CAND_COLS] (the kernels' layout),
    parent sums [B], `allowed_num` [F] or [B, F] bool (the node's feature
    gate, applied after the per-feature reduction).  One flat first-wins
    argmax per leaf in case-major order, then the missing direction:
    since a gate is constant per feature, this is `find_best_split`'s
    flat argmax over [case, F, MB], ties included, field for field.  A
    leaf with no valid split has gain -inf and feature -1; its
    threshold and sums come from the (case 0, feature 0) candidate,
    which is `find_best_split`'s bin-0 prefix only when feature 0 is not
    gated.  `gain_penalty` [F] or [B, F] (CEGB) is subtracted after the
    gate, as in the reference (`penalty_scale` and `xla_fused` as in
    `find_best_split`)."""
    b, _, f, _ = cand.shape
    if allowed_num.dim() == 1:
        allowed_num = allowed_num[None].expand(b, f)
    gains = torch.where(allowed_num[:, None, :], cand[..., 0], NEG_INF)
    if gain_penalty is not None:
        gains = _penalize(gains, (gain_penalty if gain_penalty.dim() == 2
                                  else gain_penalty[None])[:, None, :],
                          penalty_scale, xla_fused)
    flat = gains.reshape(b, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    case = best // f
    feat = best % f
    row = cand[torch.arange(b, device=cand.device), case, feat]  # [B, 8]
    thr = row[:, 1].long()
    left = row[:, 2:5]
    right = torch.stack([parent_g, parent_h, parent_c], dim=-1) - left
    mtype = feat_missing[feat]
    dl = torch.where(mtype == MISSING_NAN, case == 1,
                     (mtype == MISSING_ZERO) & (feat_default[feat] <= thr))
    no_split = ~torch.isfinite(best_gain)
    return SplitResult(
        gain=torch.where(no_split, NEG_INF, best_gain),
        feature=torch.where(no_split, -1, feat),
        threshold_bin=thr, default_left=dl,
        left_sum_g=left[:, 0], left_sum_h=left[:, 1], left_cnt=left[:, 2],
        right_sum_g=right[:, 0], right_sum_h=right[:, 1],
        right_cnt=right[:, 2])


def merge_split_results(num: SplitResult, cat: SplitResult) -> SplitResult:
    """Winner between a numerical result (`decide_from_candidates`) and
    the categorical search (`find_best_split(..., numerical=False)`),
    the reference's `split.py:535`.  Ties go to `num`: the numerical
    cases precede the categorical ones in the flat argmax's order.  The
    numerical result's mask is all False."""
    pick = num.gain >= cat.gain
    n_is_cat = torch.zeros_like(cat.is_cat)
    n_mask = torch.zeros_like(cat.cat_mask)
    fields = list(num[:10]) + [n_is_cat, n_mask]
    return SplitResult(*(torch.where(pick[..., None] if a.dim() > pick.dim()
                                     else pick, a, c)
                         for a, c in zip(fields, cat)))
