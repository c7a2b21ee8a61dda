"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library
with a plain C interface, loaded through `ctypes` — no PyTorch headers,
so a build takes seconds.  The library lands in `csrc/build/`, named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already there.

Flags: `-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC` (plus `-Xptxas=-v`, whose register and spill report
`build_all` returns), and never `--use_fast_math`, `-ftz=true` or
`-prec-*=false`: the traverse kernel's contract includes NaN tests,
subnormal inputs and an `abs(fv) <= 1e-35` compare in IEEE f32.  The
accumulation adds `-fmad=false` so that no add is ever contracted.

Nothing here runs when the package is imported; the first wrapper
call on a CUDA tensor builds every missing kernel at once through
`build_all`, one `nvcc` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

from ..utils.log import LightGBMError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_EXTRA_FLAGS = {"traverse": [], "accumulate": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each library's entry point: (symbol, argtypes)
_SIGNATURES = {
    "traverse": ("lgbt_traverse",
                 [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  _P, _P]),
    "accumulate": ("lgbt_accumulate",
                   [_P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _P]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


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
    """Where `name`'s library lives for the current source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
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


def build_all() -> Dict[str, str]:
    """Build every kernel library that is missing, one `nvcc` per
    source, all started together.  The only builder: `load` calls it
    on first use.  Returns each built kernel's compiler output (the
    `-Xptxas=-v` resource report); empty when nothing was missing."""
    with _LOCK:
        jobs = {n: _start_build(n) for n in _SIGNATURES}
        logs, errors = {}, []
        for n, job in jobs.items():
            if job is None:
                continue
            proc, tmp, so = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed to build {n}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, so)    # atomic: a reader never sees half a file
            logs[n] = log
        if errors:
            raise LightGBMError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib
