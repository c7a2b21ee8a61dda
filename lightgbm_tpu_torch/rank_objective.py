"""Ranking objectives: LambdaRank NDCG and RankXENDCG, on torch tensors.

The port's counterpart of `lightgbm_tpu/rank_objective.py` (ref:
src/objective/rank_objective.hpp `LambdarankNDCG`, `RankXENDCG`).  The
queries are padded into at most three length buckets (`_bucket_queries`,
the reference's layout), and each bucket's pairs are one [Qb, T, Pb]
block of torch ops: every query sorted by score (a stable argsort, so
round 1's all-equal scores keep their order), the pairs of the top
`truncation_level` ranks with every later rank, the NDCG-weighted
sigmoid lambdas and hessians, their sums per document, and the
`lambdarank_norm` rescale.  RankXENDCG draws its gammas with threefry
(`ops/threefry.py uniform`, on the card `csrc/threefry.cu`), one draw a
bucket.

The reference's lambdas are an XLA program; these ops repeat its
arithmetic so that the same scores give its bits on the CPU:

* its log2 and exp2 are XLA's CPU code (`ops/xla_math.py
  xla_log2_f32`, `xla_exp2_f32`), its sigmoid and softmax too;
* the `discount` table 1 / log2(rank + 2) is a constant XLA folds at
  compile time, with the log it emits (`_discount`);
* lambdarank's per-document sums over a bucket's pairs add in the order
  of XLA's vectorised CPU loops (`_lane_sum`, the loop shapes read from
  the code XLA compiles), rank_xendcg's in its tree order
  (`ops/reduce.py tree_sum`);
* the scatters back to rows meet no duplicate but the pads' zeros at
  row 0 (`index_put_` with `accumulate`, any order); the propensity
  masses add their many duplicates in the flattened order on the CPU
  (`_position_mass`, XLA's order) and by sorted f64 prefix sums on the
  card, a fixed order, so two card runs give the same bits (the
  propensities may differ from the CPU's in the last bits).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .objectives import TrainObjective
from .ops.reduce import tree_sum
from .ops.threefry import fold_in, prng_key, uniform
from .ops.xla_math import (xla_exp2_f32, xla_log2_f32, xla_sigmoid,
                           xla_softmax)
from .utils.log import LightGBMError


def _bucket_queries(sizes: np.ndarray, max_buckets: int = 3,
                    min_saving: float = 0.2) -> List[np.ndarray]:
    """Queries grouped into at most `max_buckets` length buckets, each
    padded to its own longest query (the reference's
    `rank_objective.py:35`): cuts at the 50% and 90% length quantiles,
    buckets under 8 queries merged into their successor (the last one
    backward), and one flat bucket unless bucketing saves at least
    `min_saving` of the padded area.  Ascending-length index arrays."""
    Q = len(sizes)
    order = np.argsort(sizes, kind="stable")
    flat_area = Q * int(sizes[order[-1]])
    cuts = sorted({int(Q * 0.5), int(Q * 0.9)})
    cuts = [c for c in cuts if 0 < c < Q][:max_buckets - 1]
    groups = []
    prev = 0
    for c in cuts + [Q]:
        if c > prev:
            groups.append(order[prev:c])
            prev = c
    merged = []
    pending = None
    for g in groups:
        if pending is not None:
            g = np.concatenate([pending, g])
            pending = None
        if len(g) < 8:
            pending = g
        else:
            merged.append(g)
    if pending is not None:
        if merged:
            merged[-1] = np.concatenate([merged[-1], pending])
        else:
            merged.append(pending)
    area = sum(len(g) * int(sizes[g].max()) for g in merged)
    if len(merged) <= 1 or area > (1.0 - min_saving) * flat_area:
        return [np.arange(Q, dtype=np.int64)]
    return merged


def _build_buckets(qb: np.ndarray, sizes: np.ndarray) -> List[Dict]:
    """Each bucket's host gather map `idx_np` [Qb, Pb] (-1 padded), its
    queries `qidx`, the clipped map `gather` and the pad mask `mask` (the
    reference's `_build_buckets`, `rank_objective.py:84`)."""
    buckets = []
    for qidx in _bucket_queries(sizes):
        Pb = int(sizes[qidx].max())
        idx = np.full((len(qidx), Pb), -1, dtype=np.int64)
        for row, q in enumerate(qidx):
            idx[row, :sizes[q]] = np.arange(qb[q], qb[q + 1])
        buckets.append({"idx_np": idx, "qidx": qidx,
                        "gather": torch.from_numpy(np.maximum(idx, 0)),
                        "mask": torch.from_numpy(idx >= 0)})
    return buckets


def _discount(P: int) -> torch.Tensor:
    """1 / log2(rank + 2) for ranks 0..P-1 in f32, the reference's
    `1.0 / jnp.log2(jnp.arange(P) + 2.0)`: XLA folds it at compile time
    with the same log it emits (the tests hold the table's bits)."""
    lg = xla_log2_f32(torch.arange(P, dtype=torch.float32) + 2.0)
    return torch.ones(P, dtype=torch.float32) / lg


def _lanes_init(x: torch.Tensor, n: int, first) -> torch.Tensor:
    """An n-lane accumulator: `first` (+0.0, the reduce's init, or a
    partial sum) in lane 0, -0.0 (the identity of an add) in the rest."""
    acc = torch.full((*x.shape[:-1], n), -0.0, dtype=x.dtype,
                     device=x.device)
    acc[..., 0] = first
    return acc


def _tree(a: torch.Tensor) -> torch.Tensor:
    """A vector's lanes added by halves (LLVM's `vector.reduce.fadd`)."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def _vec_sum(x: torch.Tensor, vf: int, uf: int, evf: int = 0,
             fold: bool = False) -> torch.Tensor:
    """Sum over the last axis in the order of an LLVM-vectorised loop:
    `uf` accumulators of `vf` lanes (the first lane of the first from
    +0.0, the rest from -0.0) take the whole blocks of vf * uf elements,
    then add together, then a halving tree adds the lanes.  With
    `fold` the last block is partial (its missing lanes add nothing);
    else, with `evf`, whole blocks of the rest go to an `evf`-lane
    vector whose lane 0 starts from the sum, added by a halving tree
    too; the tail adds in order."""
    n = x.shape[-1]
    step = vf * uf
    if fold and n % step:
        x = torch.nn.functional.pad(x, (0, step - n % step), value=-0.0)
        n = x.shape[-1]
    main = n - n % step
    r = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    if main:
        blocks = x[..., :main].reshape(*x.shape[:-1], main // step, uf, vf)
        acc = [_lanes_init(x, vf, 0.0 if u == 0 else -0.0)
               for u in range(uf)]
        for k in range(main // step):
            for u in range(uf):
                acc[u] = acc[u] + blocks[..., k, u, :]
        a = acc[0]
        for u in range(1, uf):
            a = acc[u] + a
        r = _tree(a)
    k = main
    if evf and n - k >= evf:
        e = _lanes_init(x, evf, r)
        while n - k >= evf:
            e = e + x[..., k:k + evf]
            k += evf
        r = _tree(e)
    for i in range(k, n):
        r = r + x[..., i]
    return r


#: the loop shapes (lanes, accumulators, epilogue lanes, folded tail)
#: that XLA's CPU code (LLVM's loop vectoriser, its cost model on an
#: AVX-512 host) gives the lambdas' per-document sums of up to 32 terms,
#: by the sum's length: (first length, shape), each shape holding up to
#: the next entry's length; None is a plain loop.  Read from the LLVM IR
#: XLA dumps for jax 0.9.0's kernels at every length from 2 to 32 (and
#: 33, 40, 64); the gradients and hessians are then bitwise the jitted
#: reference's (tests/test_torch_ranking.py).  The sums along a row of
#: pairs:
_ROW_SHAPES = ((2, None), (11, (8, 1, 0, True)), (16, (8, 2, 0, False)),
               (18, (8, 2, 2, False)), (20, (4, 2, 0, False)),
               (24, (8, 1, 0, False)), (32, (8, 2, 0, False)))
#: the hessians' where positions are bound (the propensities fuse them
#: apart again):
_ROW_SHAPES_POS = tuple((n, (4, 4, 4, False) if n == 20 else sh)
                        for n, sh in _ROW_SHAPES)
#: the sums down the top ranks: the lambdas',
_COL_SHAPES = ((2, None), (16, (8, 2, 0, False)), (18, (8, 2, 2, False)),
               (20, (4, 2, 0, False)), (24, (8, 1, 0, False)))
#: and the hessians', also the lambdas' where `lambdarank_norm` or a
#: truncation under the bucket's width fuses them apart:
_COL_SHAPES_4X4 = ((2, None), (16, (8, 2, 0, False)),
                   (18, (8, 2, 2, False)), (20, (4, 4, 4, False)),
                   (24, (8, 1, 0, False)))


def _lane_sum(x: torch.Tensor, table) -> torch.Tensor:
    """A sum of the lambdas over the last axis in XLA's CPU order: the
    vectorised loop `table` gives its length, or (no table, past 32
    terms, or a plain loop) XLA's sequential windows (`ops/reduce.py
    tree_sum`, one window up to 32)."""
    n = x.shape[-1]
    shape = None
    for first, sh in (table or ()):
        if n >= first:
            shape = sh
    if n > 32 or shape is None:
        return tree_sum(x)
    return _vec_sum(x, *shape)


def _scatter_rows(n: int, buckets, values, device) -> torch.Tensor:
    """[N] f32: each bucket's [Qb, Pb] `values` added at its gather map,
    bucket after bucket, duplicates (the pads at row 0) in order."""
    out = torch.zeros(n, dtype=torch.float32, device=device)
    for b, v in zip(buckets, values):
        out.index_put_((b["gather"].reshape(-1),), v.reshape(-1),
                       accumulate=True)
    return out


def _position_mass(pos: torch.Tensor, mass: torch.Tensor,
                   k: int) -> torch.Tensor:
    """[k] f32: `mass` added at `pos`.  On the CPU in the flattened
    order, one f32 add after another (`np.add.at`, XLA's scatter order).
    On the card the pairs are sorted by position (stable) and their f64
    prefix sums differenced at each position's end, rounded to f32: a
    fixed order, so two card runs agree, the last bits not the CPU's (a
    scatter with this many duplicates a position serialises on the
    card)."""
    p = pos.reshape(-1)
    m = mass.reshape(-1)
    if m.device.type == "cpu":
        out = np.zeros(k, dtype=np.float32)
        np.add.at(out, p.numpy(), m.numpy())
        return torch.from_numpy(out)
    order = torch.sort(p, stable=True).indices
    csum = torch.cumsum(m[order].double(), 0)
    ends = torch.cumsum(torch.bincount(p, minlength=k), 0) - 1
    at_end = torch.where(ends >= 0, csum[ends.clamp(min=0)],
                         torch.zeros_like(csum[:k]))
    return (at_end - torch.nn.functional.pad(at_end[:-1], (1, 0))).float()


class _Ranking(TrainObjective):
    """Shared set-up of the two ranking objectives: query boundaries in,
    the bucket layout out, moved to the score's device on first use."""
    is_ranking = True

    def _init_buckets(self, label, weight, query_boundaries, what):
        super().init_meta(label, weight, query_boundaries)
        if query_boundaries is None:
            raise LightGBMError(f"{what} tasks require query information")
        qb = np.asarray(query_boundaries, dtype=np.int64)
        sizes = np.diff(qb)
        if len(sizes) == 0:
            raise LightGBMError("Ranking objective requires query "
                                "information (set group in the Dataset)")
        self._num_data = int(qb[-1])
        self._buckets = _build_buckets(qb, sizes)
        self._device = torch.device("cpu")
        return qb, sizes

    def _on(self, device) -> None:
        if self._device == device:
            return
        for b in self._buckets:
            for k, v in b.items():
                if torch.is_tensor(v):
                    b[k] = v.to(device)
        if hasattr(self, "gain_table"):
            self.gain_table = self.gain_table.to(device)
        self._device = device


class LambdarankNDCG(_Ranking):
    """ref: rank_objective.hpp `LambdarankNDCG` (the reference's
    `rank_objective.py:108`), with the unbiased-LambdaMART position
    correction when the Dataset has positions (`set_positions`): each
    pair's weight divided by the propensities t_plus[high] t_minus[low],
    re-estimated every iteration from the raw lambda masses."""
    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.truncation_level = config.lambdarank_truncation_level
        self.norm = config.lambdarank_norm
        self.bias_reg = config.lambdarank_position_bias_regularization
        label_gain = config.label_gain
        if not label_gain:
            label_gain = [float((1 << i) - 1) for i in range(31)]
        self.label_gain = np.asarray(label_gain, dtype=np.float64)
        self.has_state = False
        self.num_positions = 0

    def init_meta(self, label, weight, query_boundaries=None):
        if query_boundaries is None:
            raise LightGBMError("Lambdarank tasks require query information")
        if np.any(label < 0) or np.any(label != np.floor(label)):
            raise LightGBMError(
                "Ranking labels must be non-negative integers")
        if int(label.max()) >= len(self.label_gain):
            raise LightGBMError(
                f"Label {int(label.max())} exceeds label_gain size")
        qb, sizes = self._init_buckets(label, weight, query_boundaries,
                                       "Lambdarank")
        # the inverse max DCG of each query at the truncation level, in
        # f64, stored as f32
        gains = self.label_gain[label.astype(np.int64)]
        inv_max = np.zeros(len(sizes), dtype=np.float64)
        T = self.truncation_level
        for q in range(len(sizes)):
            g = np.sort(gains[qb[q]:qb[q + 1]])[::-1][:T]
            dcg = np.sum(g / np.log2(np.arange(2, len(g) + 2)))
            inv_max[q] = 1.0 / dcg if dcg > 0 else 0.0
        inv_max = inv_max.astype(np.float32)
        self.gain_table = torch.from_numpy(
            self.label_gain.astype(np.float32))
        for b in self._buckets:
            b["inv_max"] = torch.from_numpy(inv_max[b["qidx"]])
            b["discount"] = _discount(b["gather"].shape[1])
            b["pos"] = None
        self.has_state = False
        self.num_positions = 0

    def set_positions(self, position: np.ndarray) -> None:
        """Bind per-row positions after `init_meta`, remapped through
        their sorted unique values so that id 0, the propensities'
        anchor, is an observed position (the reference's
        `rank_objective.py:177`)."""
        pos = np.asarray(position, dtype=np.int64).reshape(-1)
        if len(pos) != self._num_data:
            raise LightGBMError(
                f"Length of position ({len(pos)}) does not match "
                f"number of data ({self._num_data})")
        if pos.min() < 0:
            raise LightGBMError("positions must be non-negative integers")
        uniq, inv = np.unique(pos, return_inverse=True)
        self.num_positions = len(uniq)
        pos_ids = inv.astype(np.int64)
        for b in self._buckets:
            grid = pos_ids[np.maximum(b["idx_np"], 0)]
            grid[b["idx_np"] < 0] = 0
            b["pos"] = torch.from_numpy(grid).to(self._device)
        self.has_state = True

    def init_state(self, device=None):
        """(t_plus, t_minus), the propensities, all 1 at the start."""
        k = max(self.num_positions, 1)
        return (torch.ones(k, dtype=torch.float32, device=device),
                torch.ones(k, dtype=torch.float32, device=device))

    def _bucket_lambdas(self, b, score, label, state):
        """One bucket's padded per-row lambdas and hessians [Qb, Pb] and,
        with positions, its raw propensity masses (lp, lm)."""
        mask = b["mask"]
        idx = b["gather"]
        P = idx.shape[1]
        T = min(self.truncation_level, P)
        sig = self.sigmoid
        dev = score.device
        neg_inf = torch.full(idx.shape, -float("inf"), device=dev)
        s = torch.where(mask, score[idx], neg_inf)
        y = torch.where(mask, label[idx].to(torch.int64),
                        torch.full_like(idx, -1))
        gains = torch.where(mask, self.gain_table[y.clamp(min=0)],
                            torch.zeros_like(s))
        order = torch.argsort(-s, dim=1, stable=True)
        s_sorted = s.gather(1, order)
        g_sorted = gains.gather(1, order)
        m_sorted = mask.gather(1, order)
        discount = b["discount"]

        si = s_sorted[:, :T, None]
        sj = s_sorted[:, None, :]
        gi = g_sorted[:, :T, None]
        gj = g_sorted[:, None, :]
        di = discount[None, :T, None]
        dj = discount[None, None, :]
        rank_i = torch.arange(T, device=dev)[None, :, None]
        rank_j = torch.arange(P, device=dev)[None, None, :]
        valid = (rank_j > rank_i) & m_sorted[:, :T, None] \
            & m_sorted[:, None, :] & (gi != gj)
        high_is_i = gi > gj
        s_high = torch.where(high_is_i, si, sj)
        s_low = torch.where(high_is_i, sj, si)
        delta = torch.abs(gi - gj) * torch.abs(di - dj) \
            * b["inv_max"][:, None, None]

        lp = lm = None
        if state is not None and b["pos"] is not None:
            t_plus, t_minus = state
            pos_sorted = b["pos"].gather(1, order)
            p_i = pos_sorted[:, :T, None].expand(valid.shape)
            p_j = pos_sorted[:, None, :].expand(valid.shape)
            pos_high = torch.where(high_is_i, p_i, p_j)
            pos_low = torch.where(high_is_i, p_j, p_i)
            prob = xla_sigmoid(-sig * (s_high - s_low))
            lam_mag = torch.where(valid, sig * prob * delta,
                                  torch.zeros_like(delta))
            k = max(self.num_positions, 1)
            lp = _position_mass(pos_high, lam_mag / t_minus[pos_low], k)
            lm = _position_mass(pos_low, lam_mag / t_plus[pos_high], k)
            delta = delta / (t_plus[pos_high] * t_minus[pos_low])

        p = xla_sigmoid(-sig * (s_high - s_low))
        zero = torch.zeros_like(delta)
        lam = torch.where(valid, -sig * p * delta, zero)
        hess = torch.where(valid, sig * sig * p * (1.0 - p) * delta, zero)

        if self.eager:          # each sum a reduce of its own
            rows = cols = h_rows = h_cols = None
        else:
            rows = _ROW_SHAPES
            cols = _COL_SHAPES_4X4 if self.norm or T < P else _COL_SHAPES
            h_rows = _ROW_SHAPES if lp is None else _ROW_SHAPES_POS
            # past 32 ranks XLA splits the row sums into windows, and the
            # hessians' sums down the top ranks become a plain loop
            h_cols = _COL_SHAPES_4X4 if P <= 32 else None
        lam_i = _lane_sum(torch.where(high_is_i, lam, -lam), rows)
        lam_j = _lane_sum(torch.where(high_is_i, -lam, lam).transpose(1, 2),
                          cols)
        h_i = _lane_sum(hess, h_rows)
        h_j = _lane_sum(hess.transpose(1, 2), h_cols)
        pad = (0, P - T)
        lam_sorted = torch.nn.functional.pad(lam_i + 0.0, pad) + lam_j
        h_sorted = torch.nn.functional.pad(h_i + 0.0, pad) + h_j

        if self.norm:
            sum_lam = _lane_sum(torch.abs(lam_sorted), None)[:, None]
            live = sum_lam > 0
            safe = torch.where(live, sum_lam, torch.ones_like(sum_lam))
            factor = torch.where(live, xla_log2_f32(1.0 + safe) / safe,
                                 torch.ones_like(sum_lam))
            lam_sorted = lam_sorted * factor
            h_sorted = h_sorted * factor

        inv_order = torch.argsort(order, dim=1)
        zero = torch.zeros_like(s)
        lam_q = torch.where(mask, lam_sorted.gather(1, inv_order), zero)
        h_q = torch.where(mask, h_sorted.gather(1, inv_order), zero)
        return lam_q, h_q, lp, lm

    def grad_hess(self, score, label, weight, state=None):
        """(grad, hess), and with `state` also the new propensities."""
        self._on(score.device)
        lams, hs = [], []
        lp_acc = lm_acc = None
        for b in self._buckets:
            lam_q, h_q, lp, lm = self._bucket_lambdas(b, score, label,
                                                      state)
            lams.append(lam_q)
            hs.append(h_q)
            if lp is not None:
                lp_acc = lp if lp_acc is None else lp_acc + lp
                lm_acc = lm if lm_acc is None else lm_acc + lm
        n = score.shape[0]
        grad = _scatter_rows(n, self._buckets, lams, score.device)
        hessian = _scatter_rows(n, self._buckets, hs, score.device)
        new_state = None
        if lp_acc is not None:
            new_state = (self._propensity(lp_acc),
                         self._propensity(lm_acc))
        if weight is not None:
            grad = grad * weight
            hessian = hessian * weight
        if state is not None:
            return grad, hessian, new_state
        return grad, hessian

    def _propensity(self, mass: torch.Tensor) -> torch.Tensor:
        """(mass / max(mass[0], 1e-20)) ** (1 / (1 + reg)) where the mass
        is positive, else 1.  With the default reg 0 the power is the
        identity (as XLA simplifies it); other exponents take torch's
        `pow`, within an ulp of XLA's in a few percent of values."""
        exponent = 1.0 / (1.0 + self.bias_reg)
        ratio = mass / torch.clamp(mass[0], min=1e-20)
        if exponent != 1.0:
            ratio = torch.pow(ratio, exponent)
        return torch.where(mass > 0, ratio, torch.ones_like(ratio))


class RankXENDCG(_Ranking):
    """ref: rank_objective.hpp `RankXENDCG` (the reference's
    `rank_objective.py:335`): the softmax of each query's scores against
    the target (2^label - gamma) / sum, gammas uniform from the
    iteration's key (the raw key with one bucket, `fold_in(key, k)` for
    bucket k)."""
    name = "rank_xendcg"
    needs_rng = True

    def init_meta(self, label, weight, query_boundaries=None):
        self._init_buckets(label, weight, query_boundaries, "Ranking")

    def grad_hess(self, score, label, weight, key=None):
        self._on(score.device)
        if key is None:
            key = prng_key(self.config.objective_seed)
        single = len(self._buckets) == 1
        gs, hs = [], []
        for k, b in enumerate(self._buckets):
            bkey = key if single else fold_in(key, k)
            idx = b["gather"]
            mask = b["mask"]
            zero = torch.zeros(idx.shape, dtype=torch.float32,
                               device=score.device)
            s = torch.where(mask, score[idx], zero - float("inf"))
            y = torch.where(mask, label[idx], zero)
            gammas = uniform(bkey, tuple(s.shape), device=score.device)
            phi = torch.where(mask, xla_exp2_f32(y) - gammas, zero)
            phi_sum = tree_sum(phi)[:, None]
            p_target = phi / torch.clamp(phi_sum, min=1e-20)
            rho = torch.where(mask, xla_softmax(s, dim=1), zero)
            gs.append(torch.where(mask, rho - p_target, zero))
            hs.append(torch.where(
                mask, torch.clamp(rho * (1.0 - rho), min=1e-16), zero))
        n = score.shape[0]
        grad = _scatter_rows(n, self._buckets, gs, score.device)
        hessian = _scatter_rows(n, self._buckets, hs, score.device)
        if weight is not None:
            grad = grad * weight
            hessian = hessian * weight
        return grad, hessian
