"""Feature binning (quantile-sketch bucketing).

TPU-native re-design of the reference's bin mapper
(ref: include/LightGBM/bin.h `BinMapper`; src/io/bin.cpp `GreedyFindBin`,
`FindBinWithZeroAsOneBin`, `BinMapper::FindBin`, `BinMapper::ValueToBin`,
`BinMapper::BinToValue`).

Binning is a one-time host-side preprocessing pass, so it stays in numpy — the
output is a compact uint8/uint16 bin matrix that is copied onto the device.
Numerical values map to bins through the port's host library
(`native/`, `values_to_bins`), as the JAX package's module maps them
through its own; the numpy search below serves the features the library
does not take (fewer than two numerical bins).  The boundary-finding algorithm is reproduced faithfully because bin
boundaries directly determine accuracy parity and the real-valued thresholds
written into the model text format.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import log

K_ZERO_THRESHOLD = 1e-35
K_SPARSE_THRESHOLD = 0.8
K_EPSILON = 1e-15

MISSING_TYPE_NONE = 0
MISSING_TYPE_ZERO = 1
MISSING_TYPE_NAN = 2

BIN_TYPE_NUMERICAL = 0
BIN_TYPE_CATEGORICAL = 1


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    num_distinct_values: int, max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Greedy quantile-ish bin boundary search (ref: src/io/bin.cpp `GreedyFindBin`).

    Returns upper bounds; last bound is +inf.
    """
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct_values <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct_values - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = (float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0
                if not bin_upper_bound or val > bin_upper_bound[-1] + K_EPSILON:
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
    else:
        if min_data_in_bin > 0:
            max_bin = min(max_bin, max(1, total_cnt // min_data_in_bin))
        mean_bin_size = total_cnt / max_bin
        # big-count values get their own bin
        rest_bin_cnt = max_bin
        rest_sample_cnt = total_cnt
        is_big = [bool(counts[i] >= mean_bin_size) for i in range(num_distinct_values)]
        for i in range(num_distinct_values):
            if is_big[i]:
                rest_bin_cnt -= 1
                rest_sample_cnt -= int(counts[i])
        mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        upper_bounds = [math.inf] * max_bin
        lower_bounds = [-math.inf] * max_bin
        lower_bounds[0] = float(distinct_values[0])
        bin_cnt = 0
        cur_cnt_inbin = 0
        for i in range(num_distinct_values - 1):
            if not is_big[i]:
                rest_sample_cnt -= int(counts[i])
            cur_cnt_inbin += int(counts[i])
            # need a new bin?
            if is_big[i] or cur_cnt_inbin >= mean_bin_size or \
                    (is_big[i + 1] and cur_cnt_inbin >= max(1.0, mean_bin_size * 0.5)):
                upper_bounds[bin_cnt] = float(distinct_values[i])
                bin_cnt += 1
                lower_bounds[bin_cnt] = float(distinct_values[i + 1])
                if not is_big[i]:
                    rest_bin_cnt -= 1
                    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
                cur_cnt_inbin = 0
                if bin_cnt >= max_bin - 1:
                    break
        bin_cnt += 1
        for i in range(bin_cnt - 1):
            val = (upper_bounds[i] + lower_bounds[i + 1]) / 2.0
            if not bin_upper_bound or val > bin_upper_bound[-1] + K_EPSILON:
                bin_upper_bound.append(val)
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  num_distinct_values: int, max_bin: int,
                                  total_sample_cnt: int, min_data_in_bin: int) -> List[float]:
    """Bin boundaries with a dedicated zero bin
    (ref: src/io/bin.cpp `FindBinWithZeroAsOneBin`)."""
    bin_upper_bound: List[float] = []
    left_cnt_data = 0
    cnt_zero = 0
    right_cnt_data = 0
    for i in range(num_distinct_values):
        v = float(distinct_values[i])
        c = int(counts[i])
        if v <= -K_ZERO_THRESHOLD:
            left_cnt_data += c
        elif v > K_ZERO_THRESHOLD:
            right_cnt_data += c
        else:
            cnt_zero += c

    # left part (negatives)
    left_cnt = 0
    for i in range(num_distinct_values):
        if float(distinct_values[i]) > -K_ZERO_THRESHOLD:
            left_cnt = i
            break
    else:
        left_cnt = num_distinct_values

    if left_cnt > 0:
        left_max_bin = max(1, int(left_cnt_data / max(total_sample_cnt - cnt_zero, 1)
                                  * (max_bin - 1)))
        bin_upper_bound = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                          left_cnt, left_max_bin, left_cnt_data,
                                          min_data_in_bin)
        bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    # right part (positives)
    right_start = -1
    for i in range(left_cnt, num_distinct_values):
        if float(distinct_values[i]) > K_ZERO_THRESHOLD:
            right_start = i
            break

    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        right_bounds = greedy_find_bin(distinct_values[right_start:],
                                       counts[right_start:],
                                       num_distinct_values - right_start,
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


class BinMapper:
    """Per-feature value→bin mapping (ref: include/LightGBM/bin.h `BinMapper`)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.bin_type: int = BIN_TYPE_NUMERICAL
        self.missing_type: int = MISSING_TYPE_NONE
        self.is_trivial: bool = True
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.categorical_2_bin: Dict[int, int] = {}
        self.bin_2_categorical: List[int] = []
        self.sparse_rate: float = 0.0
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------ fit
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int = 3, bin_type: int = BIN_TYPE_NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_upper_bounds: Optional[Sequence[float]] = None) -> None:
        """Fit bin boundaries on sampled values
        (ref: src/io/bin.cpp `BinMapper::FindBin`).

        ``values`` are the sampled *non-zero* or all values of one feature; NaN
        allowed.  ``total_sample_cnt`` is the total number of sampled rows (zeros
        implied by the difference, matching the reference's sparse sampling).
        """
        self.bin_type = bin_type
        values = np.asarray(values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        values = values[~np.isnan(values)]
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        if not use_missing:
            self.missing_type = MISSING_TYPE_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_TYPE_ZERO
        else:
            if na_cnt == 0:
                self.missing_type = MISSING_TYPE_NONE
            else:
                self.missing_type = MISSING_TYPE_NAN

        if bin_type == BIN_TYPE_NUMERICAL:
            self._find_bin_numerical(values, zero_cnt, na_cnt, total_sample_cnt,
                                     max_bin, min_data_in_bin, use_missing,
                                     zero_as_missing)
        else:
            self._find_bin_categorical(values, zero_cnt, na_cnt, total_sample_cnt,
                                       max_bin, min_data_in_bin, use_missing)

        cnt_in_default = zero_cnt if bin_type == BIN_TYPE_NUMERICAL else 0
        self.sparse_rate = cnt_in_default / max(total_sample_cnt, 1)

    def _find_bin_numerical(self, values: np.ndarray, zero_cnt: int, na_cnt: int,
                            total_sample_cnt: int, max_bin: int, min_data_in_bin: int,
                            use_missing: bool, zero_as_missing: bool) -> None:
        # add implied zeros back for distinct-value accounting
        if len(values):
            self.min_val = float(values.min()) if zero_cnt == 0 else min(float(values.min()), 0.0)
            self.max_val = float(values.max()) if zero_cnt == 0 else max(float(values.max()), 0.0)
        else:
            self.min_val = self.max_val = 0.0
        distinct, counts = np.unique(values, return_counts=True)
        if zero_cnt > 0:
            zero_pos = np.searchsorted(distinct, 0.0)
            in_range = zero_pos < len(distinct) and abs(distinct[zero_pos]) <= K_ZERO_THRESHOLD
            if in_range:
                counts = counts.copy()
                counts[zero_pos] += zero_cnt
            else:
                distinct = np.insert(distinct, zero_pos, 0.0)
                counts = np.insert(counts, zero_pos, zero_cnt)
        num_distinct = len(distinct)
        counted_total = total_sample_cnt - na_cnt

        n_effective_distinct = num_distinct
        if use_missing and self.missing_type == MISSING_TYPE_NAN and na_cnt > 0:
            n_effective_distinct += 1
        self.is_trivial = n_effective_distinct <= 1
        if num_distinct == 0:
            self.num_bin = 1
            self.bin_upper_bound = np.array([np.inf])
        else:
            eff_max_bin = max_bin
            if use_missing and self.missing_type == MISSING_TYPE_NAN:
                eff_max_bin = max_bin - 1
            bounds = find_bin_with_zero_as_one_bin(
                distinct, counts, num_distinct, max(eff_max_bin, 2), counted_total,
                min_data_in_bin)
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
        if use_missing and self.missing_type == MISSING_TYPE_NAN:
            self.num_bin += 1  # NaN bin is the last bin
        self.default_bin = self._numeric_bin(0.0)
        self.most_freq_bin = self.default_bin

    def _find_bin_categorical(self, values: np.ndarray, zero_cnt: int, na_cnt: int,
                              total_sample_cnt: int, max_bin: int,
                              min_data_in_bin: int, use_missing: bool) -> None:
        # categorical values are non-negative ints; negatives treated as NaN
        ints = values.astype(np.int64)
        neg_mask = ints < 0
        na_cnt += int(neg_mask.sum())
        ints = ints[~neg_mask]
        if zero_cnt > 0:
            ints = np.concatenate([ints, np.zeros(zero_cnt, dtype=np.int64)])
        cats, counts = np.unique(ints, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        cats, counts = cats[order], counts[order]
        # cut off infrequent categories (ref: BinMapper::FindBin categorical path:
        # keeps at most max_bin - 1 categories, drops count-1 tail when crowded)
        keep = min(len(cats), max_bin - 1)
        total_keep = counts[:keep].sum()
        cut = keep
        if len(cats) > keep:
            # drop categories covering < 1% cumulative like the reference's 99% rule
            cum = np.cumsum(counts[:keep])
            thresh = 0.99 * (total_keep + counts[keep:].sum())
            cut = int(np.searchsorted(cum, thresh)) + 1
            cut = min(cut, keep)
        self.categorical_2_bin = {}
        self.bin_2_categorical = []
        # bin 0 is the "other/missing" bin
        bin_idx = 1
        for i in range(cut):
            self.categorical_2_bin[int(cats[i])] = bin_idx
            self.bin_2_categorical.append(int(cats[i]))
            bin_idx += 1
        self.num_bin = bin_idx
        self.is_trivial = (cut + (1 if na_cnt > 0 else 0)) <= 1
        self.missing_type = MISSING_TYPE_NAN if use_missing else MISSING_TYPE_NONE
        self.default_bin = 0
        self.most_freq_bin = 0
        self.min_val = float(cats.min()) if len(cats) else 0.0
        self.max_val = float(cats.max()) if len(cats) else 0.0

    # ------------------------------------------------------------- transform
    def _numeric_bin(self, value: float) -> int:
        """Bin of a finite value via the upper-bound table, ignoring missing
        handling (used for both lookup and default_bin initialisation)."""
        n_numeric = self.num_bin - (1 if self.missing_type == MISSING_TYPE_NAN else 0)
        idx = int(np.searchsorted(self.bin_upper_bound[:n_numeric - 1], value,
                                  side="left"))
        # upper bounds are inclusive: value <= bound → that bin
        while idx < n_numeric - 1 and value > self.bin_upper_bound[idx]:
            idx += 1
        return idx

    def value_to_bin(self, value: float) -> int:
        """Map one raw value to its bin (ref: bin.h `BinMapper::ValueToBin`)."""
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            if value is None or (isinstance(value, float) and math.isnan(value)):
                return 0
            return self.categorical_2_bin.get(int(value), 0)
        if value is None or math.isnan(value):
            if self.missing_type == MISSING_TYPE_NAN:
                return self.num_bin - 1
            value = 0.0
        if self.missing_type == MISSING_TYPE_ZERO and \
                -K_ZERO_THRESHOLD <= value <= K_ZERO_THRESHOLD:
            return self.default_bin
        return self._numeric_bin(value)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value→bin for one feature column."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            out = np.zeros(len(values), dtype=np.int32)
            if self.categorical_2_bin:
                cats = np.array(self.bin_2_categorical, dtype=np.float64)
                bins = np.arange(1, len(cats) + 1, dtype=np.int32)
                finite = np.isfinite(values)
                vv = np.where(finite, values, -1).astype(np.int64)
                # map via sorted lookup
                order = np.argsort(cats)
                sc, sb = cats[order].astype(np.int64), bins[order]
                pos = np.searchsorted(sc, vv)
                pos_c = np.clip(pos, 0, len(sc) - 1)
                hit = (sc[pos_c] == vv) & finite
                out = np.where(hit, sb[pos_c], 0).astype(np.int32)
            return out
        n_numeric = self.num_bin - (1 if self.missing_type == MISSING_TYPE_NAN else 0)
        # the host library's binary search (the JAX package's
        # `utils/binning.py:338-346`, under the same condition): NaN to
        # the NaN bin or searched as 0.0, ±0 and ±1e-35 searched against
        # the zero bin's bounds
        if n_numeric >= 2 and len(self.bin_upper_bound) >= n_numeric:
            from ..native import values_to_bins as native_values_to_bins
            return native_values_to_bins(
                values, self.bin_upper_bound[:n_numeric], self.missing_type,
                self.num_bin - 1).astype(np.int32)
        nan_mask = np.isnan(values)
        vals = np.where(nan_mask, 0.0, values)
        idx = np.searchsorted(self.bin_upper_bound[:n_numeric - 1], vals, side="left")
        # inclusive upper bounds: if value exactly > bound move right (searchsorted
        # 'left' already places value==bound at that bin)
        gt = (idx < n_numeric - 1) & (vals > self.bin_upper_bound[np.minimum(idx, n_numeric - 2)])
        idx = idx + gt.astype(idx.dtype)
        idx = np.clip(idx, 0, n_numeric - 1).astype(np.int32)
        if self.missing_type == MISSING_TYPE_NAN:
            idx = np.where(nan_mask, self.num_bin - 1, idx)
        elif self.missing_type == MISSING_TYPE_ZERO:
            zm = np.abs(values) <= K_ZERO_THRESHOLD
            idx = np.where(nan_mask | zm, self.default_bin, idx)
        else:
            idx = np.where(nan_mask, self.default_bin, idx)
        return idx

    def bin_to_value(self, bin_idx: int) -> float:
        """Real-valued threshold for a bin — the model-text threshold
        (ref: bin.h `BinMapper::BinToValue`)."""
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            if 1 <= bin_idx <= len(self.bin_2_categorical):
                return float(self.bin_2_categorical[bin_idx - 1])
            return 0.0
        n_numeric = self.num_bin - (1 if self.missing_type == MISSING_TYPE_NAN else 0)
        if bin_idx >= n_numeric:
            return math.nan
        return float(self.bin_upper_bound[bin_idx])

    def max_cat_value(self) -> int:
        return max(self.categorical_2_bin.keys(), default=0)

    # --------------------------------------------------------------- persist
    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "bin_type": self.bin_type,
            "missing_type": self.missing_type,
            "is_trivial": self.is_trivial,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": self.bin_2_categorical,
            "sparse_rate": self.sparse_rate,
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = d["num_bin"]
        m.bin_type = d["bin_type"]
        m.missing_type = d["missing_type"]
        m.is_trivial = d["is_trivial"]
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = list(d["bin_2_categorical"])
        m.categorical_2_bin = {c: i + 1 for i, c in enumerate(m.bin_2_categorical)}
        m.sparse_rate = d["sparse_rate"]
        m.min_val = d["min_val"]
        m.max_val = d["max_val"]
        m.default_bin = d["default_bin"]
        return m

    def feature_info_str(self) -> str:
        """`feature_infos` model-text entry (ref: gbdt_model_text.cpp)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return ":".join(str(c) for c in self.bin_2_categorical)
        return f"[{self.min_val:g}:{self.max_val:g}]"
