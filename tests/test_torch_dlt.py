"""The PnP DLT's null vectors held to LAPACK's on samples of a long drive.

``tests/data/torch_dlt_samples.npz`` holds 1024 six-point samples (``X``:
(1024, 6, 3) map points, ``x``: (1024, 6, 2) normalised image points) that
the fused step's PnP RANSAC drew in the port's drive of the JAX stress cell
of seed 3 (its own video, 640 x 480, 1500 features, the consistent
convention, on the CPU), from frame 20 on: the systems whose null vectors
cuSOLVER's batched float32 eigh of A^T A left 6 to 7 times less accurate
than LAPACK's on the card (ROADMAP Queue 3 item 19).  Written by this
file's script mode (needs cv2 for the video):

    JAX_PLATFORMS=cpu python tests/test_torch_dlt.py --record

On the CPU the port's null vectors are LAPACK's eigh of A^T A, as the JAX
package's are; ``small_linalg.refine_null_vector`` (the "corrected eigh" routing)
brings a basis perturbed as cuSOLVER's eigh leaves it back to LAPACK's
residual.  The SVD of A (the card's shipped null vectors) is held to
LAPACK's eigh and to float64, here through LAPACK's SVD.  The card's own
vectors are held in ``tests/test_torch_kernels.py``.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bundle_adjustment_tpu_torch.ops import ransac, small_linalg  # noqa: E402

SAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_dlt_samples.npz")
QUANTILES = (0.5, 0.9, 0.99)


def samples():
    d = np.load(SAMPLES)
    return torch.tensor(d["X"]), torch.tensor(d["x"])


def quantiles(r: torch.Tensor) -> list:
    return [float(torch.quantile(r.double(), q)) for q in QUANTILES]


def test_the_cpu_null_vectors_are_lapacks_as_the_jax_packages():
    """On the CPU ``null_vector`` is ``torch.linalg.eigh``'s first column of
    A^T A bit for bit, and the port's DLT leaves the JAX package's residuals
    (both LAPACK's float32 solver; their builds differ) within a factor of
    two at the 50th, 90th and 99th percentiles."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.ops import ransac as jax_ransac

    X, x = samples()
    N = ransac._dlt_normal(X, x)
    assert torch.equal(small_linalg.null_vector(ransac._dlt_rows(X, x)),
                       torch.linalg.eigh(N)[1][..., :, 0])
    port = quantiles(ransac.dlt_residual(X, x, ransac._dlt_projection(X, x)))
    P = jax.vmap(jax_ransac._dlt_projection)(jnp.asarray(X.numpy()), jnp.asarray(x.numpy()))
    ref = quantiles(ransac.dlt_residual(X, x, torch.tensor(np.asarray(P))))
    for a, b in zip(port, ref):
        assert a <= 2 * b and b <= 2 * a, (port, ref)


@pytest.mark.parametrize("scale", [1e-7, 1e-6])
def test_the_correction_brings_a_perturbed_basis_to_lapacks_residual(scale):
    """LAPACK's eigenvectors turned by a random rotation of ``scale`` (the
    card's solver leaves residuals about 1e-7: ``chip_smoke.py`` phase 14)
    miss LAPACK's residual by more than twice; ``refine_null_vector`` on
    them lands at or below it at the 50th, 90th and 99th percentiles, and
    leaves each vector's sign."""
    X, x = samples()
    N = ransac._dlt_normal(X, x)
    V = torch.linalg.eigh(N)[1]
    g = torch.Generator().manual_seed(0)
    S = scale * torch.randn(N.shape, generator=g, dtype=torch.float64)
    turned = (V.double() @ torch.linalg.matrix_exp(S - S.transpose(-1, -2))).float()
    lapack = quantiles(ransac.dlt_residual(X, x, V[..., :, 0]))
    before = quantiles(ransac.dlt_residual(X, x, turned[..., :, 0]))
    v = small_linalg.refine_null_vector(N, turned)
    after = quantiles(ransac.dlt_residual(X, x, v))
    assert all(b > 2 * a for a, b in zip(lapack, before)), (lapack, before)
    assert all(a <= b for a, b in zip(after, lapack)), (after, lapack)
    assert bool(torch.all(torch.sum(v * turned[..., :, 0], dim=-1) > 0.99))


def sines(P: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The sine of the angle between each hypothesis P and the float64 null
    vector of its float32 system A."""
    exact = torch.linalg.svd(A.double())[2][..., -1, :]
    p = P.double().reshape(exact.shape)
    cos = torch.abs(torch.sum(p * exact, -1)) / torch.linalg.norm(p, dim=-1)
    return torch.sqrt(torch.clamp(1 - cos * cos, min=0))


@pytest.mark.parametrize("what", ["dlt", "triangulation"])
def test_the_svd_of_a_is_as_accurate_as_lapacks_eigh_and_nearer_float64(what):
    """The null vector from the SVD of A (the card's shipped one), here
    through LAPACK's float32 SVD: on the DLT's samples (and on the triangulation's
    4x4 systems of the same points seen from two cameras) its residuals at
    the 50th, 90th and 99th percentiles at most LAPACK's eigh of A^T A's,
    and its angle to the float64 null vector a hundredth of that eigh's
    or less in the median: A^T A squares A's condition number (its
    smallest eigenvalues 1e-10 and a few 1e-9 of its largest here), and
    inside that cluster the eigh's vector is 0.2 and more off in the median
    in both packages alike."""
    from bundle_adjustment_tpu_torch.ops import triangulation

    X, x = samples()
    if what == "dlt":
        A = ransac._dlt_rows(X, x)
        eigh = ransac._dlt_projection(X, x).reshape(-1, 12)
        r_eigh = quantiles(ransac.dlt_residual(X, x, eigh))
        svd = torch.linalg.svd(A)[2][..., -1, :]
        r_svd = quantiles(ransac.dlt_residual(X, x, svd))
        assert all(a <= b for a, b in zip(r_svd, r_eigh)), (r_svd, r_eigh)
    else:
        K = torch.tensor([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]])
        P1 = triangulation.camera_matrix(K, torch.eye(3), torch.zeros(3))
        R2 = torch.tensor([[0.995, 0, 0.0998], [0, 1, 0], [-0.0998, 0, 0.995]])
        P2 = triangulation.camera_matrix(K, R2, torch.tensor([-0.3, 0.0, 0.0]))
        pts = X.reshape(-1, 3)[:2048] + torch.tensor([0.0, 0.0, 4.0])

        def project(P):
            h = torch.cat([pts, torch.ones_like(pts[:, :1])], 1) @ P.T
            return h[:, :2] / h[:, 2:]

        uv1, uv2 = project(P1), project(P2)
        u1, v1, u2, v2 = uv1[:, 0], uv1[:, 1], uv2[:, 0], uv2[:, 1]
        A = torch.stack([u1[:, None] * P1[2] - P1[0], v1[:, None] * P1[2] - P1[1],
                         u2[:, None] * P2[2] - P2[0], v2[:, None] * P2[2] - P2[1]], dim=-2)
        eigh = small_linalg.null_vector(A)
        svd = torch.linalg.svd(A)[2][..., -1, :]
    s_eigh, s_svd = quantiles(sines(eigh, A)), quantiles(sines(svd, A))
    assert s_svd[0] <= 0.01 * s_eigh[0] or s_svd[0] <= 1e-6, (s_svd, s_eigh)
    assert all(a <= b + 1e-6 for a, b in zip(s_svd, s_eigh)), (s_svd, s_eigh)


def _triangulation_systems():
    """The 4x4 systems of the samples' points seen from two cameras."""
    from bundle_adjustment_tpu_torch.ops import triangulation

    X, _ = samples()
    K = torch.tensor([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]])
    P1 = triangulation.camera_matrix(K, torch.eye(3), torch.zeros(3))
    R2 = torch.tensor([[0.995, 0, 0.0998], [0, 1, 0], [-0.0998, 0, 0.995]])
    P2 = triangulation.camera_matrix(K, R2, torch.tensor([-0.3, 0.0, 0.0]))
    pts = X.reshape(-1, 3)[:2048] + torch.tensor([0.0, 0.0, 4.0])

    def project(P):
        h = torch.cat([pts, torch.ones_like(pts[:, :1])], 1) @ P.T
        return h[:, :2] / h[:, 2:]

    (u1, v1), (u2, v2) = project(P1).T, project(P2).T
    return torch.stack([u1[:, None] * P1[2] - P1[0], v1[:, None] * P1[2] - P1[1],
                        u2[:, None] * P2[2] - P2[0], v2[:, None] * P2[2] - P2[1]], dim=-2)


@pytest.mark.parametrize("what", ["dlt", "triangulation"])
def test_the_cpu_branch_of_null_vector_is_lapacks_eigh_bit_for_bit(what):
    """On the CPU ``null_vector`` (the PnP DLT's and the triangulation's) is
    the first column of ``torch.linalg.eigh`` of A^T A, bit for bit: the
    JAX package's CPU function, whatever the card takes."""
    X, x = samples()
    A = ransac._dlt_rows(X, x) if what == "dlt" else _triangulation_systems()
    N = torch.matmul(A.transpose(-1, -2), A)
    assert torch.equal(small_linalg.null_vector(A), torch.linalg.eigh(N)[1][..., :, 0])


def test_the_card_branchs_function_meets_the_card_tests_rules_on_the_cpu():
    """The card branch's function, ``small_linalg.svd(A)[2][..., -1, :]``,
    here through LAPACK's float32 SVD on the committed samples: residuals
    |N p| / |N| at most twice LAPACK's eigh's at the 50th, 90th and 99th
    percentiles and a median sine to the float64 null vector of at most
    1e-4, the rules ``tests/test_torch_kernels.py``'s
    ``test_dlt_null_vectors_on_the_card_are_as_accurate_as_lapacks`` holds
    the card to."""
    X, x = samples()
    A = ransac._dlt_rows(X, x)
    v = small_linalg.svd(A)[2][..., -1, :]
    got = quantiles(ransac.dlt_residual(X, x, v))
    want = quantiles(ransac.dlt_residual(X, x, ransac._dlt_projection(X, x)))
    assert all(a <= 2 * b for a, b in zip(got, want)), (got, want)
    assert quantiles(sines(v, A))[0] <= 1e-4


def test_a_degenerate_sample_keeps_a_null_vector():
    """One point drawn six times (the PnP before the map has points): a
    ten-dimensional null space, whose gaps are rounding.  The SVD of A,
    LAPACK's eigh of A^T A and the correction of that eigh's vectors each
    give a unit vector of it (residual at rounding), whichever."""
    X, x = samples()
    Xd, xd = X[:64, :1].expand(64, 6, 3), x[:64, :1].expand(64, 6, 2)
    A = ransac._dlt_rows(Xd, xd)
    N = ransac._dlt_normal(Xd, xd)
    for v in (torch.linalg.svd(A)[2][..., -1, :], small_linalg.null_vector(A),
              small_linalg.refine_null_vector(N, torch.linalg.eigh(N)[1])):
        assert torch.allclose(torch.linalg.norm(v, dim=-1), torch.ones(64), atol=1e-5)
        assert float(ransac.dlt_residual(Xd, xd, v).max()) < 1e-6


def record(seed: int = 3, first: int = 20, frames: int = 40, most: int = 1024) -> None:
    """The samples of the fused step's PnP DLT in the port's drive of the
    JAX stress cell of ``seed`` on the CPU, from frame ``first`` on, up to
    ``most``; written to ``SAMPLES``."""
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.tools import stress
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.io import video_frames

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    video = os.path.join(root, ".dedup_study", f"s{seed}_d3_cpu", "sequence.mp4")
    cli = ["--preset", "lehman_indoor", "--video", video, "--out", "unused",
           "--fx", str(stress.FX), "--size", f"{stress.WIDTH}x{stress.HEIGHT}",
           "--consistent-convention", "--features", "1500", "--device", "cpu"]
    pipe = VisualOdometryPipeline(run_mod._config(run_mod.build_parser().parse_args(cli)),
                                  log=EventLog(echo=False), device="cpu")
    kept, live = [], {"on": False}
    rows = ransac._dlt_rows

    def recorded(X, x):
        if live["on"]:
            kept.append((X.reshape(-1, 6, 3).clone(), x.reshape(-1, 6, 2).clone()))
        return rows(X, x)

    ransac._dlt_rows = recorded
    try:
        for i, f in enumerate(video_frames(video, 0, frames)):
            live["on"] = i >= first
            pipe.process_frame(f)
    finally:
        ransac._dlt_rows = rows
    X = torch.cat([k[0] for k in kept])[:most]
    x = torch.cat([k[1] for k in kept])[:most]
    if X.shape[0] < most:
        raise SystemExit(f"only {X.shape[0]} samples in frames {first}-{frames - 1}")
    np.savez_compressed(SAMPLES, X=X.numpy(), x=x.numpy())
    r = ransac.dlt_residual(X, x, ransac._dlt_projection(X, x))
    print(f"wrote {X.shape[0]} samples to {SAMPLES}; LAPACK's residuals at the 50th, 90th, "
          f"99th percentiles {quantiles(r)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", action="store_true", help="write the samples file")
    if ap.parse_args().record:
        torch.set_num_threads(4)
        record()
