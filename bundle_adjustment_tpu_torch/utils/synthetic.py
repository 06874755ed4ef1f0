"""Synthetic rendered sequences with ground-truth camera trajectories,
numpy only.

The same kind of scene as ``bundle_adjustment_tpu.utils.synthetic``: two
textured planes at two depths (one plane would be degenerate for
essential-matrix estimation) seen along a "strafe" or "orbit" trajectory.
That renderer draws with cv2, which the machine with the card does not
have; this one paints the textures with numpy and warps each plane into the
frame by inverse-homography bilinear sampling, at any size, seeded from
numpy.  Frames are not pixel-equal to the JAX package's renders.
"""

from __future__ import annotations

import numpy as np

from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np


def _box_blur3(img):
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge").astype(np.float32)
    h, w = img.shape[:2]
    acc = sum(p[dy: dy + h, dx: dx + w] for dy in range(3) for dx in range(3))
    return acc / 9.0


def _texture(rng, size=512, blobs=400):
    """Feature-rich random texture: filled discs of random colour on grey,
    softened by one 3x3 box blur (FAST-detectable corners on the rims)."""
    img = np.full((size, size, 3), 80.0, np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(blobs):
        cx, cy = rng.integers(0, size, 2)
        col = rng.integers(0, 255, 3).astype(np.float32)
        r = int(rng.integers(3, 14))
        y0, y1 = max(cy - r, 0), min(cy + r + 1, size)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, size)
        disc = ((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2) <= r * r
        img[y0:y1, x0:x1][disc] = col
    return _box_blur3(img)


def _plane_corners_world(center, ex, ey, half):
    c = np.asarray(center, float)
    ex = np.asarray(ex, float)
    ey = np.asarray(ey, float)
    return np.stack([
        c - half * ex - half * ey,
        c + half * ex - half * ey,
        c + half * ex + half * ey,
        c - half * ex + half * ey,
    ])


def _project(K, R, t, X):
    Xc = X @ R.T + t
    return (Xc[:, :2] / Xc[:, 2:]) @ np.diag([K[0, 0], K[1, 1]]) + [K[0, 2], K[1, 2]]


def _homography(src, dst):
    """3x3 H with dst ~ H src from four point pairs (DLT)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A, np.float64))
    return Vt[-1].reshape(3, 3)


def _warp_into(frame, tex, H, width, height):
    """Paint ``tex`` into ``frame`` where the inverse homography maps a
    frame pixel inside the texture, sampling bilinearly."""
    Hinv = np.linalg.inv(H)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    src = Hinv @ pts
    w = src[2]
    ok = np.abs(w) > 1e-12
    sx = np.where(ok, src[0] / np.where(ok, w, 1.0), -1.0)
    sy = np.where(ok, src[1] / np.where(ok, w, 1.0), -1.0)
    th, tw = tex.shape[:2]
    inside = ok & (sx >= 0) & (sx <= tw - 1) & (sy >= 0) & (sy <= th - 1)
    sx, sy = sx[inside], sy[inside]
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, tw - 2)
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, th - 2)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    val = ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x0 + 1])
           + fy * ((1 - fx) * tex[y0 + 1, x0] + fx * tex[y0 + 1, x0 + 1]))
    flat = frame.reshape(-1, 3)
    flat[np.flatnonzero(inside)] = np.clip(np.round(val), 0, 255).astype(np.uint8)


def render_frame(K, R, t, planes, width=640, height=480):
    """planes: list of (texture (h, w, 3) float32, corners_world (4, 3)),
    far to near; a plane reaching behind the camera is skipped."""
    frame = np.full((height, width, 3), 40, np.uint8)
    for tex, corners in planes:
        Xc = corners @ R.T + t
        if (Xc[:, 2] < 0.2).any():
            continue
        uv = _project(K, R, t, corners)
        if not np.isfinite(uv).all():
            continue
        th, tw = tex.shape[:2]
        src = np.array([[0, 0], [tw - 1, 0], [tw - 1, th - 1], [0, th - 1]],
                       np.float64)
        _warp_into(frame, tex, _homography(src, uv), width, height)
    return frame


def synthetic_sequence(
    n_frames: int = 20,
    width: int = 640,
    height: int = 480,
    fx: float = 450.0,
    seed: int = 0,
    motion: str = "strafe",
):
    """Returns (frames list of (H, W, 3) uint8 BGR, K, gt_positions (N, 3),
    gt_rotations (N, 3, 3)); extrinsic poses x_cam = R X + t with camera
    centre C = -R^T t.  ``motion``: "strafe" or "orbit"."""
    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    tex_far = _texture(rng)
    tex_near = _texture(rng)
    planes = [
        (tex_far, _plane_corners_world([0.6, 0.0, 9.0], [1, 0, 0], [0, 1, 0], 6.0)),
        (tex_near, _plane_corners_world([-1.2, -0.4, 4.5], [1, 0, 0.15], [0, 1, 0], 1.8)),
    ]
    frames, centers, rotations = [], [], []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        if motion == "strafe":
            C = np.array([2.2 * s, 0.25 * np.sin(2 * np.pi * s), 0.4 * s])
            w = np.array([0.0, -0.25 * s, 0.0])
        elif motion == "orbit":
            ang = 0.5 * s
            C = np.array([3.0 * np.sin(ang), 0.0, 6.0 - 6.0 * np.cos(ang)])
            w = np.array([0.0, -ang, 0.0])
        else:
            raise ValueError(motion)
        R = so3_exp_np(w)
        t = -R @ C
        frames.append(render_frame(K, R, t, planes, width, height))
        centers.append(C)
        rotations.append(R)
    return frames, K, np.stack(centers), np.stack(rotations)


def synthetic_window(seed: int, C: int = 5, n_pts: int = 96, P: int = 128,
                     D: int | None = None, see: float = 0.8, noise: float = 0.5,
                     fx: float = 300.0, width: int = 320, height: int = 240) -> dict:
    """One BA window in the observation-grid layout (``ops/ba_grid``), as a
    dict of numpy arrays keyed like ``BAProblemGrid``: ``C`` cameras on an
    arc in front of a point cloud, ``n_pts`` live points padded to ``P``
    (padding points are zero and masked out), ``D`` slots per point (default
    C).  Each point is seen by each camera with probability ``see`` and by at
    least two; its observations fill its first slots in camera order, the
    other slots are dead (mask 0).  Pixels carry ``noise`` px of Gaussian
    noise; cameras and points start perturbed from the truth."""
    rng = np.random.default_rng(seed)
    D = D or C
    pts = np.c_[rng.uniform(-2, 2, (n_pts, 2)), rng.uniform(4, 8, n_pts)]
    rv = np.c_[np.zeros(C), np.linspace(0, -0.1, C), np.zeros(C)]
    Rs = np.stack([so3_exp_np(r) for r in rv])
    tv = np.stack([-Rs[i] @ np.array([0.3 * i, 0.05 * i, 0.1 * i]) for i in range(C)])
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]], np.float32)

    seen = rng.random((n_pts, C)) < see
    few = np.flatnonzero(seen.sum(1) < 2)
    seen[few] = False
    first = rng.integers(0, C, len(few))
    seen[few, first] = True
    seen[few, (first + 1 + rng.integers(0, C - 1, len(few))) % C] = True
    # a point's seen cameras, in camera order, fill its first slots
    order = np.argsort(~seen, axis=1, kind="stable")
    live = np.take_along_axis(seen, order, axis=1)
    if D > C:
        order = np.pad(order, ((0, 0), (0, D - C)))
        live = np.pad(live, ((0, 0), (0, D - C)))
    order, live = order[:, :D], live[:, :D]
    Xc = np.einsum("cij,pj->pci", Rs, pts) + tv[None]
    proj = Xc[..., :2] / Xc[..., 2:] * fx + K[:2, 2]
    proj = proj + rng.normal(0, noise, proj.shape)

    cam_slot = np.zeros((P, D), np.int32)
    uv = np.zeros((P, D, 2), np.float32)
    mask = np.zeros((P, D), np.float32)
    cam_slot[:n_pts] = np.where(live, order, 0)
    uv[:n_pts] = np.where(live[..., None],
                          np.take_along_axis(proj, order[..., None], axis=1), 0.0)
    mask[:n_pts] = live
    points = np.zeros((P, 3), np.float32)
    points[:n_pts] = pts + rng.normal(0, 0.05, (n_pts, 3))
    return dict(
        rvecs=(rv + rng.normal(0, 0.01, rv.shape)).astype(np.float32),
        tvecs=(tv + rng.normal(0, 0.02, tv.shape)).astype(np.float32),
        points=points, cam_slot=cam_slot, uv=uv, mask=mask,
        point_mask=np.arange(P) < n_pts, K=K)
