"""Exclusive Feature Bundling (EFB): the bundle search and the bundled
matrix.

A copy of the JAX package's `utils/efb.py` `BundleSpec`, `find_bundles`
and its greedy core (ref: src/io/dataset.cpp `Dataset::FindGroups`
[greedy conflict-bounded graph coloring over nonzero-row overlap]), on
numpy, so `Dataset.construct` decides bundling exactly as the reference
does: the same row sample under `np.random.RandomState(seed)`, the same
most-used-first order (an unstable `np.argsort`, whose tie order is part
of the reference's behaviour), the same budget and bin caps; and
`build_bundled` (`utils/efb.py:217`, ref: FastFeatureBundling), the
dense [N, G] matrix the growers train on (`ops/grow.py
make_bundled_expander` reads it back per feature).  Sparse input never
densifies: `find_bundles_sparse`, `build_bundled_sparse` and
`materialize_dense_bins` (`utils/efb.py:89, 238, 268`) read a binned
CSC matrix directly.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

MAX_BUNDLE_BINS = 255      # keep bundled columns uint8
MAX_SEARCH_BUNDLES = 100   # ref: FindGroups max_search_group
CONFLICT_SAMPLE_ROWS = 50_000


class BundleSpec(NamedTuple):
    """Static description of a bundling (shared train → valid/subset)."""
    col_of_feature: np.ndarray   # [F] i32 — bundle column of each feature
    off_of_feature: np.ndarray   # [F] i32 — bin offset inside the column
    identity: np.ndarray         # [F] bool — feature is alone in its column
    n_cols: int                  # G
    col_num_bin: np.ndarray      # [G] i32 — bins per bundle column
    bundles: tuple               # tuple of tuples of feature indices

    @property
    def max_bin(self) -> int:
        return int(self.col_num_bin.max()) if self.n_cols else 1

    def to_dict(self) -> dict:
        return {"col_of_feature": self.col_of_feature.tolist(),
                "off_of_feature": self.off_of_feature.tolist(),
                "identity": self.identity.tolist(),
                "n_cols": self.n_cols,
                "col_num_bin": self.col_num_bin.tolist(),
                "bundles": [list(b) for b in self.bundles]}

    @classmethod
    def from_dict(cls, d: dict) -> "BundleSpec":
        return cls(np.asarray(d["col_of_feature"], np.int32),
                   np.asarray(d["off_of_feature"], np.int32),
                   np.asarray(d["identity"], bool),
                   int(d["n_cols"]),
                   np.asarray(d["col_num_bin"], np.int32),
                   tuple(tuple(b) for b in d["bundles"]))


def find_bundles(bin_nf: np.ndarray, mappers, max_conflict_rate: float,
                 seed: int = 0) -> Optional[BundleSpec]:
    """Greedy conflict-bounded bundling (ref: Dataset::FindGroups).

    Returns None when bundling would not reduce the column count.
    """
    n, f = bin_nf.shape
    if f < 2:
        return None
    # row sample for conflict counting (the reference counts conflicts on
    # its bin_construct sample as well)
    if n > CONFLICT_SAMPLE_ROWS:
        rng = np.random.RandomState(seed)
        rows = np.sort(rng.choice(n, CONFLICT_SAMPLE_ROWS, replace=False))
        sample = bin_nf[rows]
    else:
        sample = bin_nf
    ns = sample.shape[0]
    nz = sample != 0                                   # [ns, F] nonzero mask
    return _greedy_bundle(lambda j: nz[:, j], nz.sum(axis=0), ns, f,
                          mappers, max_conflict_rate)



def find_bundles_sparse(binned_csc, mappers, max_conflict_rate: float,
                        seed: int = 0) -> Optional[BundleSpec]:
    """`find_bundles` fed straight from a binned CSC matrix (scipy-style:
    .indptr/.indices/.data) — never materializes an [N, F] dense matrix
    (ref: LGBM_DatasetCreateFromCSR feeding Dataset::FindGroups; the
    reference also works from per-feature nonzero iterators)."""
    n, f = binned_csc.shape
    if f < 2:
        return None
    indptr, indices, data = (binned_csc.indptr, binned_csc.indices,
                             binned_csc.data)
    if n > CONFLICT_SAMPLE_ROWS:
        rng = np.random.RandomState(seed)
        rows = np.sort(rng.choice(n, CONFLICT_SAMPLE_ROWS, replace=False))
        in_sample = np.zeros(n, bool)
        in_sample[rows] = True
        remap = np.cumsum(in_sample) - 1        # orig row -> sample row
        ns = len(rows)
    else:
        in_sample = None
        remap = None
        ns = n

    def col_mask(j: int) -> np.ndarray:
        r = indices[indptr[j]:indptr[j + 1]]
        v = data[indptr[j]:indptr[j + 1]]
        r = r[v != 0]                           # stored zero-bin ≡ implied
        if in_sample is not None:
            r = remap[r[in_sample[r]]]
        m = np.zeros(ns, bool)
        m[r] = True
        return m

    nz_cnt = np.empty(f, np.int64)
    for j in range(f):
        r = indices[indptr[j]:indptr[j + 1]]
        v = data[indptr[j]:indptr[j + 1]]
        r = r[v != 0]
        nz_cnt[j] = np.count_nonzero(in_sample[r]) if in_sample is not None \
            else len(r)
    return _greedy_bundle(col_mask, nz_cnt, ns, f, mappers,
                          max_conflict_rate)


def _greedy_bundle(col_mask, nz_cnt: np.ndarray, ns: int, f: int,
                   mappers, max_conflict_rate: float) -> Optional[BundleSpec]:
    """Shared greedy core over an abstract per-feature nonzero-mask getter
    (`col_mask(j) -> bool [ns]`), so the dense and CSC paths bundle
    identically given identical samples."""
    budget = int(max_conflict_rate * ns)
    nb = np.array([m.num_bin for m in mappers], np.int64)
    # a feature may only join a bundle if an ABSENT/zero value maps to bin
    # 0 — checked via value_to_bin(0.0), not default_bin: categorical
    # mappers pin default_bin = 0 but route category 0 to bin >= 1, so a
    # sparse categorical column whose implicit zeros mean "category 0"
    # would silently read "all members default" from the bundle
    eligible = np.array(
        [(m.value_to_bin(0.0) == 0) and (not m.is_trivial)
         and m.num_bin >= 2 and m.num_bin <= MAX_BUNDLE_BINS
         for m in mappers])
    # dense features cannot share a column under any reasonable budget —
    # skip the search for them (cheap pre-filter, not in the reference)
    eligible &= nz_cnt <= max(budget, int(0.5 * ns))

    order = np.argsort(-nz_cnt)                        # most-used first
    bundles: List[List[int]] = []
    bundle_used: List[np.ndarray] = []                 # [ns] bool per bundle
    bundle_conflicts: List[int] = []
    bundle_bins: List[int] = []
    singleton: List[int] = []
    for j in order:
        if not eligible[j]:
            singleton.append(int(j))
            continue
        col = col_mask(j)
        placed = False
        for gi in range(min(len(bundles), MAX_SEARCH_BUNDLES)):
            if bundle_bins[gi] + nb[j] - 1 > MAX_BUNDLE_BINS:
                continue
            cnt = int(np.count_nonzero(col & bundle_used[gi]))
            if bundle_conflicts[gi] + cnt <= budget:
                bundles[gi].append(int(j))
                bundle_used[gi] |= col
                bundle_conflicts[gi] += cnt
                bundle_bins[gi] += int(nb[j]) - 1
                placed = True
                break
        if not placed:
            bundles.append([int(j)])
            bundle_used.append(np.array(col, copy=True))
            bundle_conflicts.append(0)
            bundle_bins.append(1 + int(nb[j]) - 1)
            if len(bundles) > MAX_SEARCH_BUNDLES:
                # bundles past the search horizon never receive members —
                # drop their masks so memory stays O(search_horizon · ns)
                bundle_used[-1] = np.zeros(0, bool)
    # flatten single-member bundles into singletons
    real_bundles = [b for b in bundles if len(b) > 1]
    singleton += [b[0] for b in bundles if len(b) == 1]
    if not real_bundles:
        return None
    G = len(real_bundles) + len(singleton)
    if G >= f:
        return None

    col_of = np.zeros(f, np.int32)
    off_of = np.zeros(f, np.int32)
    identity = np.zeros(f, bool)
    col_nb = np.zeros(G, np.int32)
    gi = 0
    for b in real_bundles:
        off = 1
        for j in sorted(b):
            col_of[j] = gi
            off_of[j] = off
            off += int(nb[j]) - 1
        col_nb[gi] = off
        gi += 1
    for j in sorted(singleton):
        col_of[j] = gi
        off_of[j] = 1          # identity map: bin b (>=1) stores as b
        identity[j] = True
        col_nb[gi] = int(nb[j])
        gi += 1
    return BundleSpec(col_of, off_of, identity, G, col_nb,
                      tuple(tuple(sorted(b)) for b in real_bundles))


def build_bundled(bin_nf: np.ndarray, spec: BundleSpec) -> np.ndarray:
    """The bundled [N, G] matrix (the reference's `build_bundled`, ref:
    FastFeatureBundling): a feature alone in its column keeps its bins;
    a bundle member's nonzero bin b is stored as b + off - 1.  Where two
    members of a bundle are nonzero in one row, the last in feature
    order wins, as in the reference."""
    n, f = bin_nf.shape
    dtype = np.uint8 if spec.col_num_bin.max() <= 256 else np.uint16
    out = np.zeros((n, spec.n_cols), dtype=dtype)
    for j in range(f):
        g = spec.col_of_feature[j]
        col = bin_nf[:, j].astype(np.int64)
        if spec.identity[j]:
            out[:, g] = col.astype(dtype)
        else:
            nzr = col != 0
            out[nzr, g] = (col[nzr] + spec.off_of_feature[j] - 1) \
                .astype(dtype)
    return out


def build_bundled_sparse(binned_csc, spec: BundleSpec,
                         mappers) -> np.ndarray:
    """`build_bundled` fed straight from a binned CSC matrix — produces the
    [N, G] bundled matrix without an [N, F] dense intermediate.

    Rows absent from a column hold that feature's zero bin
    (`value_to_bin(0.0)`); identity columns are pre-filled with it, bundle
    members are by construction zero-defaulted.  Same last-writer-wins
    conflict rule as the dense path (feature-index order)."""
    n, f = binned_csc.shape
    indptr, indices, data = (binned_csc.indptr, binned_csc.indices,
                             binned_csc.data)
    dtype = np.uint8 if spec.col_num_bin.max() <= 256 else np.uint16
    out = np.zeros((n, spec.n_cols), dtype=dtype)
    for j in range(f):
        g = spec.col_of_feature[j]
        rows = indices[indptr[j]:indptr[j + 1]]
        bins = data[indptr[j]:indptr[j + 1]].astype(np.int64)
        if spec.identity[j]:
            zb = mappers[j].value_to_bin(0.0)
            if zb:
                out[:, g] = dtype(zb)
            out[rows, g] = bins.astype(dtype)
        else:
            nzr = bins != 0
            out[rows[nzr], g] = (bins[nzr] + spec.off_of_feature[j] - 1)\
                .astype(dtype)
    return out


def materialize_dense_bins(binned_csc, mappers) -> np.ndarray:
    """[N, F] dense bin matrix from a binned CSC — the no-EFB sparse path.
    Still never touches float64: each column is filled with its zero bin
    and overwritten at stored positions (uint8/16 throughout)."""
    n, f = binned_csc.shape
    indptr, indices, data = (binned_csc.indptr, binned_csc.indices,
                             binned_csc.data)
    max_nb = max((m.num_bin for m in mappers), default=1)
    dtype = np.uint8 if max_nb <= 256 else np.uint16
    out = np.empty((n, f), dtype=dtype)
    for j in range(f):
        out[:, j] = dtype(mappers[j].value_to_bin(0.0))
        rows = indices[indptr[j]:indptr[j + 1]]
        out[rows, j] = data[indptr[j]:indptr[j + 1]].astype(dtype)
    return out
