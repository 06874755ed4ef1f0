"""ctypes bindings for the port's host runtime (``csrc/ba_host.cpp``):
counterpart of ``bundle_adjustment_tpu.native``.

The source is compiled with ``g++ -O3 -std=c++17 -fPIC -shared`` the first
time it is needed, into ``build/native/`` at the root of the checkout (a
temporary file per process, then ``os.replace``, so that several test
workers may build it at once), and loaded with ctypes.  A failed build
raises with the compiler's output: there is no numpy stand-in here.  The
numpy paths are chosen explicitly (``Map(use_native=False)``,
``utils.io.voxel_downsample``).

- ``NativeObsTable``: the observation table with a per-keyframe row index,
  so a window gather reads the window's rows only;
- ``voxel_downsample_native``: the voxel-grid average of a point cloud by a
  hash grid (voxels in order of first appearance).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "ba_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
LIB_PATH = BUILD_DIR / "libba_host.so"

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_vp = ctypes.c_void_p
#: C entry point -> (restype, argtypes)
_SIGNATURES = {
    "obs_create": (_vp, []),
    "obs_destroy": (None, [_vp]),
    "obs_size": (ctypes.c_int64, [_vp]),
    "obs_append": (ctypes.c_int64, [_vp, ctypes.c_int64, _i64p, _i64p, _i64p, _f64p]),
    "obs_kill_rows": (None, [_vp, ctypes.c_int64, _i64p]),
    "obs_kill_mps": (None, [_vp, ctypes.c_int64, _i64p]),
    "obs_gather_window": (ctypes.c_int64, [_vp, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64]),
    "obs_fetch_rows": (None, [_vp, ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _f64p]),
    "obs_counts_per_point": (None, [_vp, ctypes.c_int64, _i64p]),
    "obs_live_count": (ctypes.c_int64, [_vp]),
    "voxel_downsample": (ctypes.c_int64,
                         [_f64p, _f64p, ctypes.c_int64, ctypes.c_double, _f64p, _f64p]),
}


def build() -> Path:
    """Compile ``csrc/ba_host.cpp`` into ``LIB_PATH`` when it is missing or
    older than the source; raises with g++'s output when the build fails."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB_PATH
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host runtime csrc/ba_host.cpp is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libba_host.{os.getpid()}.tmp.so"
    out = subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-o",
                          str(tmp), str(SOURCE)], capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE} (rc {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host runtime, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


class NativeObsTable:
    """C++ observation table (kf_id, mp_id, kp_idx, u, v, alive) with a
    per-keyframe row index; rows are numbered in append order."""

    def __init__(self):
        self._lib = library()
        self._h = self._lib.obs_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.obs_destroy(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.obs_size(self._h))

    def append(self, kf, mp, kp, uv) -> int:
        """Append rows (all alive); returns the first new row id."""
        kf, mp, kp = _i64(kf), _i64(mp), _i64(kp)
        uv = np.ascontiguousarray(uv, np.float64).reshape(-1, 2)
        n = len(kf)
        if not (len(mp) == len(kp) == len(uv) == n):
            raise ValueError(f"row counts differ: {n}, {len(mp)}, {len(kp)}, {len(uv)}")
        return int(self._lib.obs_append(self._h, n, _ptr(kf, _i64p), _ptr(mp, _i64p),
                                        _ptr(kp, _i64p), _ptr(uv, _f64p)))

    def _rows(self, rows) -> np.ndarray:
        rows = _i64(rows)
        if len(rows) and (rows.min() < 0 or rows.max() >= len(self)):
            raise IndexError(f"row ids outside [0, {len(self)})")
        return rows

    def kill_rows(self, rows):
        rows = self._rows(rows)
        self._lib.obs_kill_rows(self._h, len(rows), _ptr(rows, _i64p))

    def kill_mps(self, mps):
        """Kill every live row of the given map-point ids."""
        mps = _i64(mps)
        self._lib.obs_kill_mps(self._h, len(mps), _ptr(mps, _i64p))

    def gather_window(self, window_kf_ids) -> np.ndarray:
        """Live rows of the given keyframes, keyframe by keyframe, each in
        append order (callers sort)."""
        w = _i64(window_kf_ids)
        cap = len(self)
        out = np.empty(max(cap, 1), np.int64)
        n = int(self._lib.obs_gather_window(self._h, len(w), _ptr(w, _i64p),
                                            _ptr(out, _i64p), cap))
        return out[:n]

    def fetch(self, rows):
        """(kf, mp, kp, uv) of the given rows."""
        rows = self._rows(rows)
        n = len(rows)
        kf, mp, kp = (np.empty(n, np.int64) for _ in range(3))
        uv = np.empty((n, 2), np.float64)
        self._lib.obs_fetch_rows(self._h, n, _ptr(rows, _i64p), _ptr(kf, _i64p),
                                 _ptr(mp, _i64p), _ptr(kp, _i64p), _ptr(uv, _f64p))
        return kf, mp, kp, uv

    def counts_per_point(self, n_points: int) -> np.ndarray:
        counts = np.zeros(max(n_points, 1), np.int64)
        self._lib.obs_counts_per_point(self._h, n_points, _ptr(counts, _i64p))
        return counts[:n_points]

    def live_count(self) -> int:
        return int(self._lib.obs_live_count(self._h))


def voxel_downsample_native(points, colors, voxel: float):
    """Voxel-grid average of ``points`` (and ``colors``) in C++: the same
    voxels and means as ``utils.io.voxel_downsample``, in order of first
    appearance instead of sorted by voxel."""
    pts = np.ascontiguousarray(points, np.float64).reshape(-1, 3)
    n = len(pts)
    if n == 0:
        return points, colors
    out_p = np.empty((n, 3), np.float64)
    cols = out_c = None
    if colors is not None:
        cols = np.ascontiguousarray(colors, np.float64).reshape(-1, 3)
        if len(cols) != n:
            raise ValueError(f"{len(cols)} colors for {n} points")
        out_c = np.empty((n, 3), np.float64)
    n_vox = int(library().voxel_downsample(
        _ptr(pts, _f64p), None if cols is None else _ptr(cols, _f64p), n, float(voxel),
        _ptr(out_p, _f64p), None if out_c is None else _ptr(out_c, _f64p)))
    return out_p[:n_vox].copy(), (None if out_c is None else out_c[:n_vox].copy())
