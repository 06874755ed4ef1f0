"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds) under ``build/kernels/`` at the root of the checkout, the first time
a wrapper needs it.  ``build_all`` starts one ``nvcc`` per source at once.  A
source may hold several C entry points, each registered as a kernel of its
own (the four roles of ``ba_global_pcg.cu``).  Libraries are loaded with
ctypes; the wrappers in ``ops/hamming_kernel.py``, ``ops/orb_kernel.py``,
``ops/ba_kernel.py`` and ``ops/ba_global_kernel.py`` pass ``data_ptr()``
pointers and PyTorch's current stream, and raise when a C entry point
returns a CUDA error.

``LAUNCHES`` counts launches per kernel: a wrapper adds one where it
launches, and nowhere else, so a run can show that it went through the
kernels.  A wrapper called while its stream is captured into a CUDA graph
launches nothing then; the graph's replays launch its kernels, and the code
that replays it adds the captured launches at each replay
(``ops/ba_global_kernel``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: kernel name -> (source file, C entry point, argtypes)
KERNELS = {
    "hamming_knn2": ("hamming_knn2.cu", "hamming_knn2",
                     [_P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P]),
    "orb_gather40": ("orb_gather.cu", "orb_gather40",
                     [_P, _I, _I, _P, _P, _I, _P, _P]),
    "ba_window_lm": ("ba_window_lm.cu", "ba_window_lm",
                     [_P] * 8 + [_I] * 5 + [_F] * 8 + [_P] * 6),
    "ba_global_setup": ("ba_global_pcg.cu", "ba_global_setup",
                        [_P] * 14 + [_I] * 5 + [_P] * 5),
    "ba_global_matvec": ("ba_global_pcg.cu", "ba_global_matvec",
                         [_P] * 12 + [_I] * 5 + [_P] * 3),
    "ba_global_backsub": ("ba_global_pcg.cu", "ba_global_backsub",
                          [_P] * 6 + [_I] * 4 + [_P] * 2),
    "ba_global_cost": ("ba_global_pcg.cu", "ba_global_cost",
                       [_P] * 6 + [_I] * 4 + [_P] * 4),
}

LAUNCHES = {name: 0 for name in KERNELS}

_loaded: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    """The library of kernel ``name``: one per source file."""
    return BUILD_DIR / f"lib{Path(KERNELS[name][0]).stem}.so"


def _stale(name: str) -> bool:
    src = SOURCE_DIR / KERNELS[name][0]
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names=None, verbose: bool = False) -> dict:
    """Compile the given kernels (default: all stale ones), one ``nvcc``
    process per source, all started together.  Returns {name: seconds}.
    Raises with the compiler's output when a build fails."""
    names = [n for n in (names or KERNELS) if _stale(n)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    # kernels that share a source share its library: build it once, under
    # the first of their names
    first_of = {}
    for name in names:
        first_of.setdefault(KERNELS[name][0], name)
    for source, name in first_of.items():
        src = SOURCE_DIR / source
        tmp = BUILD_DIR / f"{_lib_path(name).stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    seconds, errors = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
            continue
        if verbose and out:
            print(out)
        os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: seconds[first_of[KERNELS[name][0]]] for name in names}


def library_fn(name: str):
    """The ctypes entry point of kernel ``name``, building it if needed."""
    fn = _loaded.get(name)
    if fn is None:
        if _stale(name):
            build_all([name])
        _, entry, argtypes = KERNELS[name]
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def library_const(name: str, symbol: str) -> int:
    """An int that kernel ``name``'s library exports through a C function of
    no arguments (a compile-time constant of its source)."""
    library_fn(name)
    fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
    fn.restype = ctypes.c_int
    return int(fn())


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
