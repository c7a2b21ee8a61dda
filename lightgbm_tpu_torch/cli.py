"""Data files: the data-file half of the JAX package's `cli.py`.

CSV, TSV, space-separated and LibSVM text files, detected as upstream
LightGBM's src/io/parser.cpp `Parser::CreateParser` detects them, read
through the port's host library (`native/`), and split into the
feature matrix, the label and the columns of the roles `label_column`,
`weight_column`, `group_column` and `ignore_column` (ref:
src/io/dataset_loader.cpp).  `Dataset(path)` and `Booster.predict(path)`
read their files here.  The command line itself (`main`, `run`,
`task=convert_model`) waits for ROADMAP Queue 1 item 5g.

A LibSVM file that the library's strict parser refuses (a `qid:` token)
is read by `read_svmlight`, this module's copy of the rules of
scikit-learn's `load_svmlight_file`, which the JAX package calls there;
a dense file with text cells mid-file is read by `np.genfromtxt`, as in
the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .utils.config import Config
from .utils.log import LightGBMError

__all__ = ["column_roles", "group_ids_to_sizes", "load_data_file",
           "load_data_file_full", "parse_column_spec", "read_svmlight"]


def _sniff_format(path: str) -> Tuple[str, bool]:
    """("csv" | "tsv" | "space" | "libsvm", whether the first line is a
    header) from the file's first line: the most frequent of ',', tab
    and space is the delimiter, an `idx:val` among its second and third
    tokens makes it LibSVM, a token that is no number a header."""
    with open(path) as f:
        first = f.readline()
    commas, tabs, spaces = (first.count(c) for c in (",", "\t", " "))
    if commas >= tabs and commas >= spaces:
        sep, fmt = ",", "csv"
    elif tabs >= spaces:
        sep, fmt = "\t", "tsv"
    else:
        sep, fmt = " ", "space"
    tokens = first.strip().split(sep)
    if any(":" in t for t in tokens[1:3] if t):
        return "libsvm", False

    def is_num(t):
        try:
            float(t)
            return True
        except ValueError:
            return False

    return fmt, not all(is_num(t) for t in tokens if t != "")


def parse_column_spec(spec: str, what: str) -> Optional[int]:
    """A column-role parameter as an index; a `name:` form raises (the
    header's names are not read)."""
    if spec == "":
        return None
    if spec.startswith("name:"):
        raise LightGBMError(
            f"{what}=name: requires header parsing; use column index "
            f"form (e.g. {what}=0)")
    return int(spec)


def column_roles(config: Config):
    """(label, weight, group, dropped) file columns from `config`:
    `label_column` counts every file column, `weight_column`,
    `group_column` and `ignore_column` do not count the label column
    (upstream docs/Parameters.rst).  `dropped` is the sorted set of file
    columns that are no feature, the one place both ingest routes take
    it from."""
    label = parse_column_spec(config.label_column, "label_column") or 0

    def skip_label(idx):
        return idx if idx is None or idx < label else idx + 1

    weight = skip_label(parse_column_spec(config.weight_column,
                                          "weight_column"))
    group = skip_label(parse_column_spec(config.group_column,
                                         "group_column"))
    drop = {label}
    if config.ignore_column:
        for tok in str(config.ignore_column).split(","):
            tok = tok.strip()
            if tok:
                drop.add(skip_label(parse_column_spec(tok,
                                                      "ignore_column")))
    if weight is not None:
        drop.add(weight)
    if group is not None:
        drop.add(group)
    return label, weight, group, sorted(drop)


def group_ids_to_sizes(ids: np.ndarray) -> np.ndarray:
    """Per-row query ids (each query's rows together) as query sizes."""
    if len(ids) == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(ids))[0] + 1
    return np.diff(np.concatenate([[0], change, [len(ids)]]))


def read_svmlight(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(dense f64 X, f64 labels) by the rules of scikit-learn's
    `load_svmlight_file(path)`: '#' starts a comment, tokens split on
    white space, a leading `qid:` token skipped, indices strictly
    increasing and not negative (ValueError otherwise), 1-based unless
    an index 0 occurs, as many columns as the largest index asks."""
    labels, rows, min_idx, max_idx = [], [], None, -1
    with open(path, "rb") as fh:
        for line in fh:
            parts = line.split(b"#", 1)[0].split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            feats = parts[1:]
            if feats and feats[0].startswith(b"qid"):
                feats[0].split(b":", 1)[1]   # no ':' raises, as sklearn
                feats = feats[1:]
            row, prev = [], -1
            for tok in feats:
                idx_s, value = tok.split(b":", 1)
                idx = int(idx_s)
                if idx < 0:
                    raise ValueError(f"Invalid index {idx} in SVMlight/"
                                     "LibSVM data file.")
                if idx <= prev:
                    raise ValueError("Feature indices in SVMlight/LibSVM "
                                     "data file should be sorted and "
                                     "unique.")
                row.append((idx, float(value)))
                prev = idx
                min_idx = idx if min_idx is None else min(min_idx, idx)
                max_idx = max(max_idx, idx)
            rows.append(row)
    shift = 1 if min_idx is not None and min_idx > 0 else 0
    X = np.zeros((len(rows), max(max_idx - shift, 0) + 1), np.float64)
    for r, row in enumerate(rows):
        for idx, v in row:
            X[r, idx - shift] = v
    return X, np.asarray(labels, np.float64)


def load_data_file(path: str, config: Config
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(X, label) of a data file; the roles' extras through
    `load_data_file_full`."""
    X, y, _ = load_data_file_full(path, config)
    return X, y


def load_data_file_full(path: str, config: Config):
    """(X, label, extras) of a data file: `extras` holds "weight" and
    "group" (query sizes) when their columns are configured; ignored
    columns leave X (the JAX package's `cli.py:152`)."""
    from .native import parse_dense, parse_libsvm
    fmt, has_header = _sniff_format(path)
    if config.header:
        has_header = True
    if fmt == "libsvm":
        try:
            data = parse_libsvm(path)
        except ValueError:
            X, y = read_svmlight(path)
            return X, y, {}
        return data[:, 1:].copy(), data[:, 0].copy(), {}
    try:
        data, skipped_header = parse_dense(path)
        if has_header and not skipped_header:
            # a declared header that parses as numbers
            data = data[1:]
    except ValueError:
        # text cells mid-file: genfromtxt reads them as NaN
        sep = {"tsv": "\t", "space": None}.get(fmt, ",")
        data = np.genfromtxt(path, delimiter=sep,
                             skip_header=1 if has_header else 0,
                             dtype=np.float64)
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    label_col, weight_col, group_col, drop = column_roles(config)
    y = data[:, label_col].copy()
    extras: Dict[str, np.ndarray] = {}
    if weight_col is not None:
        extras["weight"] = data[:, weight_col].copy()
    if group_col is not None:
        extras["group"] = group_ids_to_sizes(data[:, group_col])
    return np.delete(data, drop, axis=1), y, extras
