"""The tracked-frame step's small eigenproblems and SVDs
(``ops/small_linalg``), on the CPU.

On the CPU ``small_linalg.eigh`` and ``small_linalg.svd`` are
``torch.linalg.eigh`` and ``torch.linalg.svd`` (LAPACK), bit for bit, which
the parity tests against the JAX package rely on
(``tests/test_torch_geometry.py``, ``tests/test_torch_frontend.py``); on the
card they make PyTorch's cuSOLVER calls without the host read (held bit for
bit to PyTorch's by the card tests in ``tests/test_torch_kernels.py``).
Here:

- the three shapes of the step (the DLT's 12x12 and the triangulation's 4x4
  ``eigh``, the pose's 3x3 ``svd``) are LAPACK's bits, exactly
  rank-deficient matrices included;
- the eigenvectors of a rank-deficient matrix are finite and orthonormal,
  and a triangulation whose 4x4 normal matrices have a null space of two
  dimensions gives finite points;
- the pose of a rank-deficient or zero M is finite.
"""

import pytest
import torch

from bundle_adjustment_tpu_torch.ops import ransac, small_linalg, triangulation

torch.set_num_threads(1)


def _dlt_normal(seed, B=128):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(B, 6, 3, generator=g) * torch.tensor([6.0, 4.0, 8.0]) + torch.tensor(
        [-3.0, -2.0, 4.0])
    x = X[..., :2] / X[..., 2:] + 1e-3 * torch.randn(B, 6, 2, generator=g)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -x[..., 0:1] * Xh], -1),
                   torch.cat([z, Xh, -x[..., 1:2] * Xh], -1)], -2)
    return A.transpose(-1, -2) @ A


def _sym(seed, B, n):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(B, n, n, generator=g)
    return M.transpose(-1, -2) @ M


def _deficient(A):
    """A with its first matrices made exactly rank-deficient: zero, rank 1,
    and (order > 2) rank n - 1 with an exact zero row and column."""
    A = A.clone()
    n = A.shape[-1]
    A[0] = 0.0
    v = torch.arange(1.0, n + 1.0)
    A[1] = torch.outer(v, v)
    A[2, 0, :] = 0.0
    A[2, :, 0] = 0.0
    return A


@pytest.mark.parametrize("shape", ["dlt", "triangulation"])
def test_cpu_eigh_is_lapack_bit_for_bit(shape):
    A = _dlt_normal(0) if shape == "dlt" else _sym(1, 4000, 4)
    A = _deficient(A)
    w, V = small_linalg.eigh(A)
    wl, Vl = torch.linalg.eigh(A)
    assert torch.equal(w, wl) and torch.equal(V, Vl)


@pytest.mark.parametrize("n", [3, 4, 12])
def test_rank_deficient_matrices_give_finite_orthonormal_vectors(n):
    A = _deficient(_sym(n, 8, n))
    w, V = small_linalg.eigh(A)
    assert torch.isfinite(w).all() and torch.isfinite(V).all()
    eye = torch.eye(n).expand(8, n, n)
    assert torch.allclose(V.transpose(-1, -2) @ V, eye, atol=1e-5)
    assert torch.all(w[..., 1:] >= w[..., :-1])
    # the null vector of the exact zero row/column is e_0 up to sign
    assert torch.allclose(V[2, :, 0].abs(), torch.eye(n)[0], atol=1e-6)


def test_triangulation_of_an_exactly_degenerate_pair_is_finite():
    """Identical cameras and pixels: every 4x4 normal matrix has a null
    space of two dimensions; the points are finite."""
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    uv = torch.tensor([[320.0, 240.0], [100.0, 50.0], [600.0, 400.0]])
    X, _ = triangulation.triangulate_pair(K, torch.eye(3), torch.zeros(3), uv, uv)
    assert torch.isfinite(X).all()


@pytest.mark.parametrize("seed", [4, 5])
def test_cpu_svd_is_lapack_bit_for_bit(seed):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(128, 3, 3, generator=g)
    M[0] = torch.outer(torch.tensor([1.0, 2.0, -1.0]), torch.tensor([0.5, 0.1, 0.3]))
    M[1] = 0.0
    for a, b in zip(small_linalg.svd(M), torch.linalg.svd(M)):
        assert torch.equal(a, b)


def test_pose_of_a_rank_deficient_projection_is_finite():
    g = torch.Generator().manual_seed(6)
    P = torch.randn(8, 3, 4, generator=g)
    P[0, :, :3] = torch.outer(torch.tensor([1.0, 2.0, -1.0]), torch.tensor([0.5, 0.1, 0.3]))
    P[1, :, :3] = 0.0
    R, t = ransac._pose_from_projection(P)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    eye = torch.eye(3).expand(6, 3, 3)
    assert torch.allclose(R[2:].transpose(-1, -2) @ R[2:], eye, atol=1e-5)
