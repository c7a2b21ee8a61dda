"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library
with a plain C interface, loaded through `ctypes` — no PyTorch headers,
so a build takes seconds.  The library lands in `csrc/build/`, named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already there.  The compiler's output
(`-Xptxas=-v`: registers, shared memory, spills) is kept beside each
library, so `build_all` reports it whether or not it had to compile.

Flags: `-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC -Xptxas=-v`, and never `--use_fast_math`, `-ftz=true`
or `-prec-*=false`: the traverse kernel's contract includes NaN tests,
subnormal inputs and an `abs(fv) <= 1e-35` compare in IEEE f32.  The
accumulations (`accumulate`: the f64 and the f32 sum), the fused
serving kernel (`serve`: its f64 and f32 instances), the fused split
scan (`fused_split`, K2, K3 and K5) and the objectives' links (`links`) add
`-fmad=false` so that no add is ever contracted; the histogram
kernels only add (K1) or add integers and scale with `__fmul_rn` (K4),
so contraction cannot touch them; the threefry draws (`threefry`)
are integer arithmetic and one exact f32 subtract.  The stacked-plane
traversal (`stacked`) and the bounded sum (`bounded`, whose f32 combine
is explicit `__fmul_rn` / `__fmaf_rn`) add `-fmad=false` too.  A source may
include the shared headers `csrc/*.cuh` (the histograms' first stages:
K1's, which K2 shares, and K4's, which K5 shares; the serving kernels'
walk and ordered sum, `forest_common.cuh`); they are part of every
library's hash.

Nothing here runs when the package is imported.  `build_all` is the one
build path: it starts one `nvcc` per missing library, all together,
waits for them, and loads every library once.  A wrapper's `load(name)`
calls it on first use, and launches through `on_stream`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

from ..utils.log import LightGBMError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_EXTRA_FLAGS = {"traverse": [], "accumulate": ["-fmad=false"],
                "serve": ["-fmad=false"], "histogram": [], "histogram_q": [],
                "fused_split": ["-fmad=false"], "links": ["-fmad=false"],
                "threefry": [], "stacked": ["-fmad=false"],
                "bounded": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of each library's entry points: [(symbol, argtypes)]
_SIGNATURES = {
    "traverse": [("lgbt_traverse",
                  [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P, _P])],
    "accumulate": [(sym, [_P, _I, _I, _P, _P, _I, _I, _P, _I, _I, _I, _I,
                          _I, _P, _P])
                   for sym in ("lgbt_accumulate", "lgbt_accumulate_f32")],
    "serve": [(sym, [_P, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _I, _P, _P])
              for sym in ("lgbt_serve", "lgbt_serve_f32")],
    "histogram": [("lgbt_histogram",
                   [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P, _P]),
                  ("lgbt_histogram_carry",
                   [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P, _P, _P, _P, _P, _P, _P])],
    "histogram_q": [("lgbt_histogram_q",
                     [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P, _P, _P]),
                    ("lgbt_histogram_carry_q",
                     [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P, _P]),
                    ("lgbt_histogram_carry_q_finalize",
                     [_P, ctypes.c_longlong, _P, _P, _P])],
    "fused_split": [("lgbt_fused_hist_split",
                     [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P, _P, _P, _F, _F, _F, _F, _F, _P, _P, _P]),
                    ("lgbt_fused_hist_split_q",
                     [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _P, _P,
                      _P]),
                    ("lgbt_split_scan",
                     [_P, _I, _I, _I, _P, _P, _P, _F, _F, _F, _F, _F, _P,
                      _P])],
    "links": [("lgbt_xla_link", [_P, ctypes.c_longlong, _I, _P, _P])],
    "threefry": [("lgbt_threefry",
                  [_P, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
                   ctypes.c_longlong, _I, _P, _P])],
    "stacked": [("lgbt_stacked_slots",
                 [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P])],
    "bounded": [("lgbt_accumulate_bounded",
                 [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                  _I, _I, _I, _I, _I, _I, _P, _P])],
}


class Built(NamedTuple):
    """One loaded kernel library."""
    lib: ctypes.CDLL
    compiled: bool        # False: the library was already in BUILD_DIR
    ptxas: List[str]      # the register / shared-memory / spill lines


_LOCK = threading.Lock()
_BUILT: Dict[str, Built] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise LightGBMError("nvcc not found: the CUDA kernels build on "
                            "first use and need the CUDA toolkit")
    return found


def _flags(name: str) -> List[str]:
    return _BASE_FLAGS + _EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    """Where `name`'s library lives for the current source, the headers
    beside it (`csrc/*.cuh`) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start `nvcc` for `name` unless its library exists; returns
    (process, temporary output, final path) or None."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc()] + _flags(name) + ["-o", str(tmp),
                                      str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _load(name: str, compiled: bool) -> Built:
    so = library_path(name)
    lib = ctypes.CDLL(str(so))
    for sym, argtypes in _SIGNATURES[name]:
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = so.with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    ptxas = [ln.strip() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    return Built(lib, compiled, ptxas)


def build_all() -> Dict[str, Built]:
    """Build every kernel library that is missing, one `nvcc` per source,
    all started together; then load every library once.  Returns each
    kernel's `Built` (the library, whether this call compiled it, and
    its `-Xptxas=-v` report).  Raises with the compiler's output when a
    build fails."""
    with _LOCK:
        if len(_BUILT) == len(_SIGNATURES):
            return dict(_BUILT)
        jobs = {n: _start_build(n) for n in _SIGNATURES if n not in _BUILT}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            proc, tmp, so = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed to build {n}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)    # atomic: a reader never sees half a file
        if errors:
            raise LightGBMError("\n".join(errors))
        for n, job in jobs.items():
            _BUILT[n] = _load(n, compiled=job is not None)
        return dict(_BUILT)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    built = _BUILT.get(name)
    if built is None:
        built = build_all()[name]
    return built.lib


def on_stream(device, launch):
    """`launch(stream)` with `device` current, on its current CUDA stream
    (the raw handle, read without building a Stream object)."""
    if device.index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return launch(torch._C._cuda_getCurrentRawStream(device.index))
