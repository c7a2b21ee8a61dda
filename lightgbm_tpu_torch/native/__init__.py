"""The port's host library: text parsing, value-to-bin mapping and the
host walk of a forest, in C++ (`libnative.cpp`) behind ctypes.

The counterpart of the JAX package's `native/` (ref: upstream LightGBM
src/io/parser.cpp, src/io/dataset_loader.cpp, bin.h `ValueToBin`,
src/application/predictor.hpp).  The library is built on first use with
the system `g++` (`-O3 -shared -fPIC -std=c++17`, with `-fopenmp` first
and without it when that build fails or does not load) into
`csrc/build/`, named by a hash of the source, the flags and the
compiler's version: an edited source, or a checkout copied to a host
with another compiler, rebuilds; an unchanged one loads the library
already there.  A file lock serialises the build across processes and
the library lands by an atomic rename, so concurrent first uses compile
it once.  There is no numpy fallback: a build that fails raises
`LightGBMError` with the compiler's output.

Beside each entry stands its plain numpy version (`*_plain`), which
states what the entry computes bit for bit; only the tests run them.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError

SRC = Path(__file__).resolve().parent / "libnative.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
#: the compiler; a library build needs it on the host
CXX = "g++"
#: the flags of every build; `-fopenmp` is tried first
BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
#: `lgbt_abi_version()` of the source this module binds
ABI_VERSION = 1

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: how the loaded library was built (`lib_info`)
_INFO: Dict = {}


def compiler_version() -> str:
    """The first line of `CXX --version`; raises OSError without the
    compiler."""
    if _INFO.get("compiler_of") != CXX:
        r = subprocess.run([CXX, "--version"], capture_output=True,
                           text=True, timeout=60)
        _INFO.update(compiler_of=CXX, compiler=(r.stdout or "").split(
            "\n", 1)[0])
    return _INFO["compiler"]


def library_path(flags) -> Path:
    """Where the library built from the current source with `flags` by
    the current compiler lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update("\n".join([CXX, compiler_version()] + list(flags)).encode())
    return BUILD_DIR / f"libnative-{h.hexdigest()[:16]}.so"


def build(flags, out: Path) -> float:
    """Compile the source with `flags` into `out` (through a temporary
    file and an atomic rename); the seconds it took.  Raises
    `LightGBMError` with the compiler's output when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX] + list(flags) + [str(SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise LightGBMError(f"{' '.join(cmd)} could not run: {e}") from e
    if r.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise LightGBMError(f"{' '.join(cmd)} failed (exit {r.returncode}):"
                            f"\n{r.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _built(flags) -> Tuple[Path, bool, float]:
    """The library for `flags`, compiled unless present: (path, whether
    this call compiled it, seconds).  A file lock keeps concurrent
    processes from compiling it twice."""
    import fcntl
    so = library_path(flags)
    if so.exists():
        return so, False, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libnative.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so, False, 0.0
        return so, True, build(flags, so)


def _register(lib: ctypes.CDLL) -> None:
    """Bind the entries' signatures; raises `AttributeError` for a
    library of another ABI."""
    lib.lgbt_abi_version.restype = ctypes.c_int32
    lib.lgbt_abi_version.argtypes = []
    if lib.lgbt_abi_version() != ABI_VERSION:
        raise AttributeError(f"ABI {lib.lgbt_abi_version()}, expected "
                             f"{ABI_VERSION}")
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    for name in ("lgbt_parse_dense", "lgbt_parse_libsvm"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, i64p, i64p, i32p]
    lib.lgbt_values_to_bins.restype = None
    lib.lgbt_values_to_bins.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    lib.lgbt_stream_open.restype = ctypes.c_void_p
    lib.lgbt_stream_open.argtypes = [ctypes.c_char_p, i64p, i32p]
    lib.lgbt_stream_next.restype = ctypes.c_int64
    lib.lgbt_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.lgbt_stream_close.restype = None
    lib.lgbt_stream_close.argtypes = [ctypes.c_void_p]
    lib.lgbt_predict_rows.restype = None
    lib.lgbt_predict_rows.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use: with `-fopenmp`, and
    without it when that build fails to compile or to load (a toolchain
    without libgomp).  Raises `LightGBMError` with every attempt's error
    when neither builds and loads."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        errors: List[str] = []
        for openmp in (True, False):
            flags = list(BASE_FLAGS) + (["-fopenmp"] if openmp else [])
            try:
                so, compiled, secs = _built(flags)
                lib = ctypes.CDLL(str(so))
                _register(lib)
            except (LightGBMError, OSError, AttributeError) as e:
                errors.append(str(e))
                continue
            _INFO.update(path=str(so), openmp=openmp, compiled=compiled,
                         build_s=secs, flags=flags)
            _LIB = lib
            return lib
        raise LightGBMError("the host library (lightgbm_tpu_torch/native/"
                            "libnative.cpp) did not build or load; it needs "
                            "g++:\n" + "\n".join(errors))


def lib_info() -> Dict:
    """How the loaded library was built: its path, its flags, whether
    OpenMP is on, whether this process compiled it and in how many
    seconds, and the compiler's version line."""
    get_lib()
    return {k: v for k, v in _INFO.items() if k != "compiler_of"}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ------------------------------------------------------------------ parsing
def parse_dense(path: str) -> Tuple[np.ndarray, bool]:
    """A CSV / TSV / space-separated file as (f64 [rows, cols], whether a
    header line was skipped).  Raises ValueError on a malformed file."""
    lib = get_lib()
    rows, cols = ctypes.c_int64(0), ctypes.c_int64(0)
    header = ctypes.c_int32(0)
    rc = lib.lgbt_parse_dense(path.encode(), None, ctypes.byref(rows),
                              ctypes.byref(cols), ctypes.byref(header))
    if rc != 0:
        raise ValueError(f"dense parse probe failed (rc={rc}): {path}")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    rc = lib.lgbt_parse_dense(path.encode(), _ptr(out), ctypes.byref(rows),
                              ctypes.byref(cols), ctypes.byref(header))
    if rc != 0:
        raise ValueError(f"dense parse failed (rc={rc}): {path}")
    return out, bool(header.value)


def parse_libsvm(path: str) -> np.ndarray:
    """A LibSVM file as dense f64 [rows, 1 + features], the label in
    column 0 (0- or 1-based indices detected).  Raises ValueError on a
    malformed file."""
    lib = get_lib()
    rows, cols = ctypes.c_int64(0), ctypes.c_int64(0)
    zero_based = ctypes.c_int32(0)
    rc = lib.lgbt_parse_libsvm(path.encode(), None, ctypes.byref(rows),
                               ctypes.byref(cols), ctypes.byref(zero_based))
    if rc != 0:
        raise ValueError(f"libsvm parse probe failed (rc={rc}): {path}")
    out = np.empty((rows.value, cols.value + 1), dtype=np.float64)
    rc = lib.lgbt_parse_libsvm(path.encode(), _ptr(out), ctypes.byref(rows),
                               ctypes.byref(cols), ctypes.byref(zero_based))
    if rc != 0:
        raise ValueError(f"libsvm parse failed (rc={rc}): {path}")
    return out


class StreamReader:
    """A dense text file read in chunks of `chunk_rows` rows (ref:
    utils/pipeline_reader.h `PipelineReader`): an iterator of f64
    [<= chunk_rows, n_cols] arrays, each a view of one reused buffer
    (copy what you keep).  Raises ValueError when the file cannot be
    read or a line mid-file does not parse."""

    def __init__(self, path: str, chunk_rows: int = 65536):
        self._lib = get_lib()
        cols = ctypes.c_int64(0)
        header = ctypes.c_int32(0)
        self._h = self._lib.lgbt_stream_open(path.encode(),
                                             ctypes.byref(cols),
                                             ctypes.byref(header))
        if not self._h:
            raise ValueError(f"cannot open or parse {path}")
        self.n_cols = int(cols.value)
        self.had_header = bool(header.value)
        self.chunk_rows = int(chunk_rows)
        self._buf = np.empty((self.chunk_rows, self.n_cols), np.float64)

    def next_chunk(self) -> Optional[np.ndarray]:
        """The next chunk, or None at the end of the file."""
        if self._h is None:
            return None
        n = self._lib.lgbt_stream_next(self._h, _ptr(self._buf),
                                       self.chunk_rows)
        if n < 0:
            self.close()
            raise ValueError(f"malformed row mid-stream (rc={n})")
        if n == 0:
            self.close()
            return None
        return self._buf[:n]

    def __iter__(self):
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                return
            yield chunk

    def close(self) -> None:
        if self._h is not None:
            self._lib.lgbt_stream_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# -------------------------------------------------------------- bin mapping
def values_to_bins(vals: np.ndarray, bounds: np.ndarray, missing_type: int,
                   nan_bin: int) -> np.ndarray:
    """uint16 bin of each value: the first inclusive upper bound it does
    not exceed; NaN to `nan_bin` when `missing_type` is 2, else searched
    as 0.0."""
    v = np.ascontiguousarray(vals, dtype=np.float64)
    b = np.ascontiguousarray(bounds, dtype=np.float64)
    out = np.empty(len(v), dtype=np.uint16)
    get_lib().lgbt_values_to_bins(_ptr(v), len(v), _ptr(b), len(b),
                                  int(missing_type), int(nan_bin),
                                  _ptr(out))
    return out


# ------------------------------------------------------------ the host walk
def predict_rows(flat: Dict, X: np.ndarray, k_classes: int = 1,
                 num_threads: int = 0) -> np.ndarray:
    """Raw scores [n, K] f64 of X [n, F] through the forest `flat`
    (`Booster._flatten_for_native`): tree t adds into class t % K, trees
    in boosting order; the rows spread over `num_threads` OpenMP threads
    (<= 0: the default)."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    out = np.empty((X.shape[0], k_classes), dtype=np.float64)
    get_lib().lgbt_predict_rows(
        _ptr(flat["feat"]), _ptr(flat["thr"]), _ptr(flat["dtype"]),
        _ptr(flat["left"]), _ptr(flat["right"]), _ptr(flat["thr_bin"]),
        _ptr(flat["leaf_value"]), _ptr(flat["node_off"]),
        _ptr(flat["leaf_off"]), _ptr(flat["cb_off"]),
        _ptr(flat["cat_bounds"]), _ptr(flat["bits_off"]),
        _ptr(flat["cat_bits"]), ctypes.c_int64(flat["n_trees"]),
        ctypes.c_int64(k_classes), ctypes.c_int32(int(num_threads)),
        _ptr(X), ctypes.c_int64(X.shape[0]), ctypes.c_int64(X.shape[1]),
        _ptr(out))
    return out


# ========================================================== plain versions
#: what glibc's strtod takes (C locale): leading white space, a sign, then
#: inf[inity], nan[(chars)], a hex float or a decimal float
_STRTOD = re.compile(
    r"[ \t\n\v\f\r]*([+-]?(?:inf(?:inity)?|nan(?:\([0-9a-z_]*\))?"
    r"|0x(?:[0-9a-f]+\.?[0-9a-f]*|\.[0-9a-f]+)(?:p[+-]?[0-9]+)?"
    r"|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:e[+-]?[0-9]+)?))", re.IGNORECASE)
_STRTOL = re.compile(r"[ \t\n\v\f\r]*([+-]?[0-9]+)")
_INT64 = (-(1 << 63), (1 << 63) - 1)


def _strtod(s: str, pos: int) -> Tuple[Optional[float], int]:
    """strtod at s[pos:]: (value, end), or (None, pos) when nothing
    converts."""
    m = _STRTOD.match(s, pos)
    if m is None:
        return None, pos
    t = m.group(1)
    body = t.lstrip("+-").lower()
    sign = -1.0 if t.startswith("-") else 1.0
    if body.startswith("nan"):
        v = math.copysign(math.nan, sign)
    elif body.startswith("inf"):
        v = sign * math.inf
    elif body.startswith("0x"):
        v = float.fromhex(t)
    else:
        v = float(t)
    return v, m.end()


def _strtol(s: str, pos: int) -> Tuple[Optional[int], int]:
    m = _STRTOL.match(s, pos)
    if m is None:
        return None, pos
    return min(max(int(m.group(1)), _INT64[0]), _INT64[1]), m.end()


def _lines(path: str) -> List[str]:
    """The file's lines as fgets gives them, without the '\\n' (bytes
    kept one to one as latin-1 characters)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    lines = raw.decode("latin-1").split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return lines


def _detect_delim(line: str) -> str:
    commas, tabs, spaces = (line.count(c) for c in (",", "\t", " "))
    if commas >= tabs and commas >= spaces:
        return ","
    return "\t" if tabs >= spaces else " "


def _field(line: str, s: int, end: int) -> Optional[float]:
    while s < end and line[s] in ' "':
        s += 1
    if s >= end:
        return math.nan
    if line[s:s + 2].lower() == "na" or line[s] == "?":
        return math.nan
    v, _ = _strtod(line, s)
    return v


def _split_fields(line: str, delim: str) -> Optional[List[float]]:
    vals, p, end = [], 0, len(line)
    while True:
        q = line.find(delim, p)
        q = end if q < 0 else q
        v = _field(line, p, q)
        if v is None:
            return None
        vals.append(v)
        if q >= end:
            return vals
        p = q + 1


def parse_dense_plain(path: str) -> Tuple[np.ndarray, bool]:
    """`parse_dense` in Python: the same delimiter, header, NaN and
    strtod rules, the same errors."""
    delim, rows, cols, header, first = None, [], 0, False, True
    for line in _lines(path):
        line = line.rstrip("\r\n")
        if not line:
            continue
        delim = delim or _detect_delim(line)
        vals = _split_fields(line, delim)
        if vals is None:
            if first:
                header, first = True, False
                continue
            raise ValueError(f"dense parse probe failed (rc=-2): {path}")
        first = False
        cols = cols or len(vals)
        if len(vals) != cols:
            raise ValueError(f"dense parse probe failed (rc=-3): {path}")
        rows.append(vals)
    return np.array(rows, dtype=np.float64).reshape(len(rows), cols), header


def parse_libsvm_plain(path: str) -> np.ndarray:
    """`parse_libsvm` in Python: the same tokens, index base and
    errors."""
    parsed, max_idx, saw_zero = [], -1, False
    for line in _lines(path):
        if not line.strip(" \t\r\n"):
            continue
        label, p = _strtod(line, 0)
        if label is None:
            raise ValueError(f"libsvm parse probe failed (rc=-2): {path}")
        pairs = []
        while p < len(line):
            while p < len(line) and line[p] in " \t":
                p += 1
            if p >= len(line) or line[p] in "\n\r#\0":
                break
            idx, q = _strtol(line, p)
            if idx is None or q >= len(line) or line[q] != ":":
                raise ValueError(f"libsvm parse probe failed (rc=-3): "
                                 f"{path}")
            v, p = _strtod(line, q + 1)
            if v is None:
                raise ValueError(f"libsvm parse probe failed (rc=-4): "
                                 f"{path}")
            saw_zero |= idx == 0
            max_idx = max(max_idx, idx)
            pairs.append((idx, v))
        parsed.append((label, pairs))
    cols = 0 if max_idx < 0 else max_idx + 1 if saw_zero else max_idx
    out = np.zeros((len(parsed), cols + 1), dtype=np.float64)
    for r, (label, pairs) in enumerate(parsed):
        out[r, 0] = label
        for idx, v in pairs:
            col = idx + (1 if saw_zero else 0)
            if 1 <= col <= cols:
                out[r, col] = v
    return out


def values_to_bins_plain(vals: np.ndarray, bounds: np.ndarray,
                         missing_type: int, nan_bin: int) -> np.ndarray:
    """`values_to_bins` with `np.searchsorted`."""
    v = np.array(vals, dtype=np.float64)
    b = np.asarray(bounds, dtype=np.float64)
    nan = np.isnan(v)
    v[nan] = 0.0
    out = np.minimum(np.searchsorted(b, v, side="left"),
                     max(len(b) - 1, 0)).astype(np.uint16)
    if missing_type == 2:
        out[nan] = nan_bin
    return out


def predict_rows_plain(flat: Dict, X: np.ndarray,
                       k_classes: int = 1) -> np.ndarray:
    """`predict_rows` in numpy: each tree walked for all rows at once, the
    leaf values added in boosting order."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    n = X.shape[0]
    out = np.zeros((n, k_classes), dtype=np.float64)
    for t in range(int(flat["n_trees"])):
        nb, ne = int(flat["node_off"][t]), int(flat["node_off"][t + 1])
        lb = int(flat["leaf_off"][t])
        if nb == ne:
            out[:, t % k_classes] += flat["leaf_value"][lb]
            continue
        nd = np.zeros(n, dtype=np.int64)
        leaf = np.zeros(n, dtype=np.int64)
        rows = np.arange(n)
        while len(rows):
            g = nb + nd[rows]
            fv = X[rows, flat["feat"][g]]
            dt = flat["dtype"][g]
            go = np.zeros(len(rows), dtype=bool)
            cat = (dt & 1) != 0
            if cat.any():
                c = np.nonzero(cat)[0]
                base = flat["cb_off"][t] + flat["thr_bin"][g[c]]
                lo = flat["cat_bounds"][base]
                span = ((flat["cat_bounds"][base + 1] - lo) * 32).astype(
                    np.float64)
                f = fv[c]
                with np.errstate(invalid="ignore"):
                    ok = ~(np.isnan(f) | (f <= -1.0) | (f >= span)
                           | (span <= 0.0))
                v = np.trunc(f[ok]).astype(np.int64)
                words = flat["cat_bits"][flat["bits_off"][t] + lo[ok]
                                         + v // 32]
                go[c[ok]] = ((words >> (v % 32).astype(np.uint32)) & 1) == 1
            num = ~cat
            if num.any():
                f = fv[num]
                d = dt[num]
                mt = (d >> 2) & 3
                isn = np.isnan(f)
                v = np.where(isn & (mt != 2), 0.0, f)
                miss = ((mt == 1) & (np.abs(v) <= 1e-35)) | ((mt == 2) & isn)
                with np.errstate(invalid="ignore"):
                    le = v <= flat["thr"][g[num]]
                go[num] = np.where(miss, (d & 2) != 0, le)
            child = np.where(go, flat["left"][g], flat["right"][g])
            done = child < 0
            leaf[rows[done]] = ~child[done]
            nd[rows[~done]] = child[~done]
            rows = rows[~done]
        out[:, t % k_classes] += flat["leaf_value"][lb + leaf]
    return out
