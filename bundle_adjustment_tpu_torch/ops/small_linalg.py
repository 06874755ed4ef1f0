"""``torch.linalg.eigh`` and ``torch.linalg.svd`` for the batches of small
matrices of the tracked-frame step, in a form that a CUDA graph can capture.

``models/frontend.track_step`` solves three batches of them: the null vector
of each 6-point DLT hypothesis' 12x12 system A and of each two-view
triangulation's 4x4 one (``null_vector``: on the card the SVD of A, on the
CPU the eigh of A^T A), and the SVD of each hypothesis' 3x3 ``M``
(``ops/ransac._pose_from_projection``).  On the card PyTorch (2.11,
CUDA 12.8) runs cuSOLVER for them, ``cusolverDnXsyevBatched`` and
``cusolverDnSgesvdjBatched``, and then reads the solver's ``info`` on the
host, which stops a capture.  ``eigh`` and ``svd`` make the same cuSOLVER
calls (the same column-major copy of the input, lower triangle, sorted
values, gesvdj's tolerance of one float32 epsilon) on the current stream,
and read nothing on the host: they return PyTorch's bits on the card
(``tests/test_torch_kernels.py``).  On the CPU they are ``torch.linalg.eigh``
and ``torch.linalg.svd`` (LAPACK, as the JAX package's CPU reference;
``tests/test_torch_geometry.py`` and ``tests/test_torch_frontend.py`` hold
them there).  ``info`` stays on the card: where PyTorch would have raised
for a matrix the solver could not finish, the result holds what the solver
left.

The step's null vectors (the PnP DLT's and the triangulation's) come from
``null_vector``.  The JAX package takes them from a float32 eigh of A^T A,
whose accuracy is its backend's: LAPACK's ``syevd`` on the CPU, XLA's
Jacobi solver on the TPU.  The port reproduces the CPU's on the CPU
(``torch.linalg.eigh``, LAPACK, bit for bit).  On the card it takes the
right singular vector of A's smallest singular value from gesvdj (``svd``),
as accurate as the TPU's Jacobi vector: cuSOLVER's batched eigh of A^T A
left residuals |N p| / |N| 6.73, 6.96 and 6.05 times LAPACK's at the 50th,
90th and 99th percentiles on the committed DLT samples, and the long drive
then took 18.8 Rotation keyframes per seed against the JAX CPU cells' 4.0
and its TPU cell's 0; the SVD of A leaves 0.23, 0.17 and 0.26 times
LAPACK's, and 0 Rotation keyframes (PERF.md section 5).

cuSOLVER is the library that PyTorch itself calls on the card; it is loaded
from the process (PyTorch's CUDA build has it loaded) or from the CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SZ = ctypes.c_size_t
#: cusolverEigMode_t CUSOLVER_EIG_MODE_VECTOR, cublasFillMode_t
#: CUBLAS_FILL_MODE_LOWER, cudaDataType CUDA_R_32F
_EIG_MODE_VECTOR = 1
_FILL_LOWER = 0
_R_32F = 0
#: the largest order of a matrix that PyTorch hands to these batched solvers
MAX_ORDER = 32

_SIGNATURES = {
    "cusolverDnCreate": [ctypes.POINTER(_P)],
    "cusolverDnSetStream": [_P, _P],
    "cusolverDnCreateParams": [ctypes.POINTER(_P)],
    "cusolverDnCreateGesvdjInfo": [ctypes.POINTER(_P)],
    "cusolverDnXgesvdjSetSortEig": [_P, _I],
    "cusolverDnXgesvdjSetTolerance": [_P, ctypes.c_double],
    "cusolverDnXsyevBatched_bufferSize": [_P, _P, _I, _I, _I64, _I, _P, _I64, _I, _P, _I,
                                          ctypes.POINTER(_SZ), ctypes.POINTER(_SZ), _I64],
    "cusolverDnXsyevBatched": [_P, _P, _I, _I, _I64, _I, _P, _I64, _I, _P, _I, _P, _SZ, _P,
                               _SZ, _P, _I64],
    "cusolverDnSgesvdjBatched_bufferSize": [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I,
                                            ctypes.POINTER(_I), _P, _I],
    "cusolverDnSgesvdjBatched": [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P,
                                 _I],
}


@functools.lru_cache(maxsize=None)
def _lib():
    """The cuSOLVER library: the process's own copy where PyTorch loaded it,
    else the CUDA toolkit's."""
    names = ["libcusolver.so.11", "libcusolver.so"]
    names += [str(p) for p in sorted(Path("/usr/local/cuda/lib64").glob("libcusolver.so*"))]
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        return lib
    raise RuntimeError("cuSOLVER not found: neither loaded by PyTorch nor under "
                       "/usr/local/cuda/lib64")


def _check(fn: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{fn} failed: cusolverStatus {status}")


@functools.lru_cache(maxsize=None)
def _solver(device_index: int):
    """One cuSOLVER handle per device, the generic API's parameters (for
    syev) and gesvdj's (sorted values, a tolerance of one float32 epsilon,
    as PyTorch sets them), made outside any capture."""
    lib = _lib()
    with torch.cuda.device(device_index):
        handle, syev, gesvdj = _P(), _P(), _P()
        _check("cusolverDnCreate", lib.cusolverDnCreate(ctypes.byref(handle)))
        _check("cusolverDnCreateParams", lib.cusolverDnCreateParams(ctypes.byref(syev)))
        _check("cusolverDnCreateGesvdjInfo",
               lib.cusolverDnCreateGesvdjInfo(ctypes.byref(gesvdj)))
        _check("cusolverDnXgesvdjSetSortEig", lib.cusolverDnXgesvdjSetSortEig(gesvdj, 1))
        _check("cusolverDnXgesvdjSetTolerance", lib.cusolverDnXgesvdjSetTolerance(
            gesvdj, float(torch.finfo(torch.float32).eps)))
    return handle, syev, gesvdj


def _prepare(A: torch.Tensor, what: str):
    """(library, handle on the current stream, syev and gesvdj parameters,
    batch size, the column-major copy of A as a (batch, n, n) tensor)."""
    n = A.shape[-1]
    batch = math.prod(A.shape[:-2])
    if A.dtype != torch.float32 or batch < 2 or n > MAX_ORDER or A.shape[-2] != n:
        raise ValueError(f"small_linalg.{what} on the card takes a batch of float32 square "
                         f"matrices of order <= {MAX_ORDER}; got {tuple(A.shape)} {A.dtype}")
    lib = _lib()
    handle, syev, gesvdj = _solver(A.device.index if A.device.index is not None
                                   else torch.cuda.current_device())
    _check("cusolverDnSetStream", lib.cusolverDnSetStream(
        handle, _P(torch.cuda.current_stream(A.device).cuda_stream)))
    return lib, handle, syev, gesvdj, batch, A.reshape(batch, n, n).transpose(-1, -2).contiguous()


def eigh(A: torch.Tensor):
    """Eigenvalues (ascending) and eigenvectors (columns) of the symmetric
    matrices A (..., n, n), as ``torch.linalg.eigh(A)`` returns them; on the
    card without a host read."""
    if A.device.type != "cuda":
        return torch.linalg.eigh(A)
    lib, handle, params, _, batch, V = _prepare(A, "eigh")
    n = A.shape[-1]
    w = torch.empty((batch, n), dtype=A.dtype, device=A.device)
    info = torch.empty((batch,), dtype=torch.int32, device=A.device)
    dev_bytes, host_bytes = _SZ(), _SZ()
    args = (handle, params, _EIG_MODE_VECTOR, _FILL_LOWER, n, _R_32F, _P(V.data_ptr()), n,
            _R_32F, _P(w.data_ptr()), _R_32F)
    _check("cusolverDnXsyevBatched_bufferSize", lib.cusolverDnXsyevBatched_bufferSize(
        *args, ctypes.byref(dev_bytes), ctypes.byref(host_bytes), batch))
    if host_bytes.value:
        raise RuntimeError(f"cusolverDnXsyevBatched asks for {host_bytes.value} bytes of host "
                           "workspace: work on the host cannot be captured into a CUDA graph")
    work = torch.empty((max(dev_bytes.value, 1),), dtype=torch.uint8, device=A.device)
    # V (column-major) is overwritten with the eigenvectors
    _check("cusolverDnXsyevBatched", lib.cusolverDnXsyevBatched(
        *args, _P(work.data_ptr()), dev_bytes.value, None, 0, _P(info.data_ptr()), batch))
    return w.reshape(A.shape[:-1]), V.transpose(-1, -2).reshape(A.shape)


#: the least gap, over the largest eigenvalue, across which
#: ``refine_null_vector`` corrects the vector: below it the coupling is
#: rounding, not signal
NULL_GAP = 1e-6


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """The unit vector p (..., n) that minimises |A p| for each square A
    (..., n, n): the one place the step's null vectors are taken, so that a
    study can route them (``tools/stress.ROUTES``).

    On the CPU the eigenvector of the smallest eigenvalue of A^T A,
    ``torch.linalg.eigh(A^T A)[1][..., :, 0]``: LAPACK's float32 ``syevd``,
    as the JAX package computes it on the CPU.  On the card the right
    singular vector of A's smallest singular value, ``svd(A)[2][..., -1,
    :]``: cuSOLVER's gesvdj at a tolerance of one float32 epsilon, no host
    read, capturable in the step's CUDA graph.  A^T A squares A's condition
    number (the DLT's smallest eigenvalue about 1e-10 of its largest, the
    next few 1e-9): no float32 eigh of it resolves the vector inside that
    cluster (LAPACK's is 0.21 off the float64 vector in the median,
    cuSOLVER's 0.29), the SVD of A does (2.7e-6), as the TPU's Jacobi
    solver does for the JAX package (its TPU cell takes no Rotation
    keyframe).  cuSOLVER's eigh of A^T A, which the card took before, left
    residuals 6.73, 6.96 and 6.05 times LAPACK's at the 50th, 90th and 99th
    percentiles; the SVD of A leaves 0.23, 0.17 and 0.26 times (PERF.md
    section 5; the "cuSOLVER eigh" routing keeps the former)."""
    if A.device.type != "cuda":
        N = torch.matmul(A.transpose(-1, -2), A)
        return eigh(N)[1][..., :, 0]
    return _svd_card(A)[2][..., -1, :]


def refine_null_vector(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """A first-order correction of the first column of the eigenvectors V
    (..., n, n) of the symmetric A toward A's null vector, on any device:
    a study route (the "corrected eigh" routing of ``tools/stress``), not
    the shipped path, which takes the SVD of A on the card
    (``null_vector``).  cuSOLVER's float32 vectors carry a few
    1e-7 of the eigenvectors of large eigenvalues; with V the solver's
    eigenvectors, v0 -= sum_i (v_i' A v0) / (v_i' A v_i - v0' A v0) v_i over
    every i whose gap exceeds ``NULL_GAP`` of the largest eigenvalue, then
    v0 is normalised: the residual lands at or below LAPACK's
    (``tests/test_torch_dlt.py``, ``tests/test_torch_kernels.py``).  Inside
    the cluster of small eigenvalues (a few 1e-9 of the largest, below
    float32's resolution of A) the gaps are rounding and the vector is kept
    there: LAPACK's eigh is 0.2 and more off the float64 vector inside it
    too, and only the SVD of A resolves it."""
    AV = torch.matmul(A, V)
    coupling = torch.matmul(V[..., :, 1:].transpose(-1, -2), AV[..., :, :1])[..., 0]
    rayleigh = torch.sum(V * AV, dim=-2)
    gap = rayleigh[..., 1:] - rayleigh[..., :1]
    wide = gap > NULL_GAP * rayleigh[..., -1:]
    theta = torch.where(wide, coupling / torch.where(wide, gap, torch.ones_like(gap)),
                        torch.zeros_like(gap))
    v = V[..., :, 0] - torch.matmul(V[..., :, 1:], theta[..., None])[..., 0]
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def svd(A: torch.Tensor):
    """U, S (descending), Vh of the square matrices A (..., n, n), as
    ``torch.linalg.svd(A)`` returns them; on the card without a host read."""
    if A.device.type != "cuda":
        return torch.linalg.svd(A)
    return _svd_card(A)


def _svd_card(A: torch.Tensor):
    """``svd`` on the card: cuSOLVER's gesvdj, batched, on the current
    stream.  ``null_vector`` calls it by this name, so that a routing of
    ``svd`` (the pose's nearest rotation) leaves the null vectors alone."""
    lib, handle, _, params, batch, Acm = _prepare(A, "svd")
    n = A.shape[-1]
    s = torch.empty((batch, n), dtype=A.dtype, device=A.device)
    U = torch.empty((batch, n, n), dtype=A.dtype, device=A.device)
    V = torch.empty((batch, n, n), dtype=A.dtype, device=A.device)
    info = torch.empty((batch,), dtype=torch.int32, device=A.device)
    lwork = _I()
    args = (_P(Acm.data_ptr()), n, _P(s.data_ptr()), _P(U.data_ptr()), n, _P(V.data_ptr()), n)
    _check("cusolverDnSgesvdjBatched_bufferSize", lib.cusolverDnSgesvdjBatched_bufferSize(
        handle, _EIG_MODE_VECTOR, n, n, *args, ctypes.byref(lwork), params, batch))
    work = torch.empty((max(lwork.value, 1),), dtype=A.dtype, device=A.device)
    # U and V come back column-major: U is the transpose of the buffer, and
    # the buffer of V is Vh
    _check("cusolverDnSgesvdjBatched", lib.cusolverDnSgesvdjBatched(
        handle, _EIG_MODE_VECTOR, n, n, *args, _P(work.data_ptr()), lwork.value,
        _P(info.data_ptr()), params, batch))
    return (U.transpose(-1, -2).reshape(A.shape), s.reshape(A.shape[:-1]),
            V.reshape(A.shape))
