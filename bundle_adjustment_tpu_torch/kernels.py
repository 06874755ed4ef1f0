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
launches (``count_launch``), and nowhere else, so a run can show that it went
through the kernels.  A wrapper called while its stream is captured into a
CUDA graph launches nothing then: ``count_launch`` tallies the launch in
``CAPTURED`` instead, ``capture`` hands each graph the tally of what one of
its replays launches, and ``replay`` adds that tally to ``LAUNCHES`` at each
replay.  The graphs of the port (the global solve's LM iteration,
``ops/ba_global_kernel``; the tracked-frame step, ``models/frontend``) are
captured on one side stream per device (``side_stream``) after an eager
warm-up call on it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

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

#: a second build of a kernel's source under a macro, beside the shipped one:
#: variant name -> (the kernel of ``KERNELS`` it builds, the macro).  Its
#: launches count as that kernel's.
VARIANTS = {"ba_window_lm_clocks": ("ba_window_lm", "BA_WINDOW_PHASE_CLOCKS")}

LAUNCHES = {name: 0 for name in KERNELS}
#: launches recorded while a CUDA graph is being captured, per kernel
CAPTURED = collections.Counter()

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


def _spec(name: str) -> tuple:
    """(source, C entry point, argtypes, macros) of a kernel or a variant."""
    base, macro = VARIANTS.get(name, (name, None))
    return KERNELS[base] + ((macro,) if macro else (),)


def _lib_path(name: str) -> Path:
    """The library of kernel ``name``: one per source file, and one per
    variant."""
    source, _, _, macros = _spec(name)
    return BUILD_DIR / f"lib{Path(source).stem}{''.join('.' + m for m in macros)}.so"


def _stale(name: str) -> bool:
    src = SOURCE_DIR / _spec(name)[0]
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names=None, verbose: bool = False) -> dict:
    """Compile the given kernels or ``VARIANTS`` (default: all stale
    kernels), one ``nvcc`` process per library, all started together.
    Returns {name: seconds}.  Raises with the compiler's output when a
    build fails."""
    names = [n for n in (names or KERNELS) if _stale(n)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    # kernels that share a library build it once, under the first of their
    # names
    first_of = {}
    for name in names:
        first_of.setdefault(_lib_path(name), name)
    for lib, name in first_of.items():
        source, _, _, macros = _spec(name)
        src = SOURCE_DIR / source
        tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", *(f"-D{m}" for m in macros),
               "-o", str(tmp), str(src)]
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
    return {name: seconds[first_of[_lib_path(name)]] for name in names}


def library_fn(name: str):
    """The ctypes entry point of kernel (or variant) ``name``, building it if
    needed."""
    fn = _loaded.get(name)
    if fn is None:
        if _stale(name):
            build_all([name])
        _, entry, argtypes, _ = _spec(name)
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


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name``: in ``LAUNCHES``, or in
    ``CAPTURED`` while the current stream is being captured into a CUDA
    graph (nothing runs then; each replay adds the count)."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def side_stream(device) -> "torch.cuda.Stream":
    """The one stream per device on which the port warms up and captures its
    CUDA graphs (a new stream per capture would give cuBLAS a new workspace
    each time)."""
    return torch.cuda.Stream(device)


def on_side_stream(device, fn):
    """``fn()`` on ``side_stream(device)``, ordered after the work already on
    the current stream and before the work issued on it afterwards."""
    main = torch.cuda.current_stream(device)
    side = side_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


def capture(device, fn):
    """``fn()`` captured as a CUDA graph on the side stream (nothing runs).
    Returns (graph, what ``fn`` returned: tensors the replays write, the
    launches of each kernel that one replay makes).  ``capture_begin`` and
    ``capture_end`` directly: ``torch.cuda.graph`` would also collect
    Python's garbage and empty the allocator's cache at every capture.  A
    capture that fails raises; nothing stands in for it."""
    graph = torch.cuda.CUDAGraph()
    CAPTURED.clear()

    def record():
        graph.capture_begin()
        try:
            return fn()
        finally:
            graph.capture_end()

    out = on_side_stream(device, record)
    per_replay = dict(CAPTURED)
    CAPTURED.clear()
    return graph, out, per_replay


def replay(graph, per_replay: dict) -> None:
    """Replay ``graph`` on the current stream and count its kernels'
    launches."""
    graph.replay()
    for name, k in per_replay.items():
        LAUNCHES[name] += k
