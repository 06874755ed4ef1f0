"""Synthetic rendered sequences with ground-truth camera trajectories.

The same scenes as ``bundle_adjustment_tpu.utils.synthetic``: two textured
planes at two depths (one plane would be degenerate for essential-matrix
estimation) seen along a "strafe" or "orbit" trajectory, and the "room": a
box of 4 textured walls, each split into 6 x 6 sub-planes, with 2 occluder
planes inside, which the camera patrols on an ellipse with a sinusoidal yaw
so that it revisits its start (the long-sequence scene of the JAX package's
``tools/stress.py``).  That renderer draws with cv2, which the machine with
the card does not have; this one paints the textures with numpy and warps
each plane into the frame with torch, on the CPU or on a card, by
inverse-homography bilinear sampling over the plane's projected bounding
box (the room's 146 planes at 1280 x 720 render on the card).  The same
numpy random draws in the same order give the JAX package's ground-truth poses
bit for bit; frames are not pixel-equal to its renders.
"""

from __future__ import annotations

import numpy as np

from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np, so3_log_np


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


def _subdivide(tex, corners, n):
    """An n x n grid of sub-quads of a textured quad, each with its crop of
    the texture: a plane reaching behind the camera is skipped, so a wall
    split this way loses only its sliver nearest the camera."""
    out = []
    c0, c1, c2, c3 = [np.asarray(c, float) for c in corners]
    h, w = tex.shape[:2]
    for i in range(n):        # texture y, the ey direction
        for j in range(n):    # texture x, the ex direction
            u0, u1 = j / n, (j + 1) / n
            v0, v1 = i / n, (i + 1) / n

            def P(u, v):
                top = c0 * (1 - u) + c1 * u
                bot = c3 * (1 - u) + c2 * u
                return top * (1 - v) + bot * v

            sub = tex[int(v0 * h):max(int(v1 * h), int(v0 * h) + 2),
                      int(u0 * w):max(int(u1 * w), int(u0 * w) + 2)]
            out.append((sub, np.stack([P(u0, v0), P(u1, v0), P(u1, v1), P(u0, v1)])))
    return out


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


def _warp_into(frame, tex, H, uv):
    """Paint ``tex`` (float64 tensor) into ``frame`` (uint8 tensor on the
    same device) where the inverse homography maps a frame pixel inside the
    texture, sampling bilinearly.  Only the bounding box of the plane's
    projected corners ``uv``, clipped to the frame, is mapped: every pixel
    the plane covers lies inside it."""
    import torch

    height, width = frame.shape[:2]
    x0, y0 = np.maximum(np.floor(uv.min(0)), 0).astype(int)
    x1 = int(min(np.ceil(uv[:, 0].max()), width - 1))
    y1 = int(min(np.ceil(uv[:, 1].max()), height - 1))
    if x0 > x1 or y0 > y1:
        return
    dev = frame.device
    f64 = torch.float64
    Hinv = torch.as_tensor(np.linalg.inv(H), dtype=f64, device=dev)
    ys = torch.arange(y0, y1 + 1, dtype=f64, device=dev)[:, None]
    xs = torch.arange(x0, x1 + 1, dtype=f64, device=dev)[None, :]
    w = Hinv[2, 0] * xs + Hinv[2, 1] * ys + Hinv[2, 2]
    ok = w.abs() > 1e-12
    w = torch.where(ok, w, 1.0)
    sx = torch.where(ok, (Hinv[0, 0] * xs + Hinv[0, 1] * ys + Hinv[0, 2]) / w, -1.0)
    sy = torch.where(ok, (Hinv[1, 0] * xs + Hinv[1, 1] * ys + Hinv[1, 2]) / w, -1.0)
    th, tw = tex.shape[:2]
    inside = ok & (sx >= 0) & (sx <= tw - 1) & (sy >= 0) & (sy <= th - 1)
    # every pixel of the box is sampled (clamped) and the outside ones kept
    # as they were: no mask indexing, so no read of its count by the host
    sx = torch.where(inside, sx, 0.0)
    sy = torch.where(inside, sy, 0.0)
    xi = torch.clamp(torch.floor(sx).long(), 0, tw - 2)
    yi = torch.clamp(torch.floor(sy).long(), 0, th - 2)
    fx = (sx - xi)[..., None]
    fy = (sy - yi)[..., None]
    val = ((1 - fy) * ((1 - fx) * tex[yi, xi] + fx * tex[yi, xi + 1])
           + fy * ((1 - fx) * tex[yi + 1, xi] + fx * tex[yi + 1, xi + 1]))
    box = frame[y0:y1 + 1, x0:x1 + 1]
    box.copy_(torch.where(inside[..., None],
                          torch.clamp(torch.round(val), 0, 255).to(torch.uint8), box))


def render_frame(K, R, t, planes, width=640, height=480, depth_sort=False, device=None):
    """planes: list of (texture (h, w, 3) float32, corners_world (4, 3)),
    far to near; a plane reaching behind the camera is skipped.
    ``depth_sort`` orders them far to near for this camera (the painter's
    order of a closed scene depends on the viewpoint).  The frame is drawn
    with torch on ``device`` (the CPU by default); textures are float64
    tensors there or numpy arrays.  Returns a numpy array."""
    import torch

    if depth_sort:
        def depth(p):
            return float((R @ p[1].mean(axis=0) + t)[2])

        planes = sorted(planes, key=depth, reverse=True)
    device = torch.device(device or "cpu")
    frame = torch.full((height, width, 3), 40, dtype=torch.uint8, device=device)
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
        _warp_into(frame, torch.as_tensor(tex, dtype=torch.float64, device=device),
                   _homography(src, uv), uv)
    return frame.cpu().numpy()


def _room_planes(rng):
    """The room: 4 walls of a box of half-size 8, each a 768-pixel texture
    split 6 x 6, and 2 free-standing occluders (the JAX package's draws)."""
    half = 8.0
    planes = []
    for center, ex, ey in [
        ([0, 0, half], [1, 0, 0], [0, 1, 0]),      # front wall
        ([0, 0, -half], [-1, 0, 0], [0, 1, 0]),    # back wall
        ([half, 0, 0], [0, 0, -1], [0, 1, 0]),     # right wall
        ([-half, 0, 0], [0, 0, 1], [0, 1, 0]),     # left wall
    ]:
        planes.extend(_subdivide(_texture(rng, size=768, blobs=900),
                                 _plane_corners_world(center, ex, ey, half), n=6))
    planes.append((_texture(rng, size=256, blobs=160),
                   _plane_corners_world([1.5, 0.3, 4.0], [1, 0, 0.2], [0, 1, 0], 1.0)))
    planes.append((_texture(rng, size=256, blobs=160),
                   _plane_corners_world([-2.5, -0.5, -3.0], [1, 0, -0.3], [0, 1, 0], 1.2)))
    return planes


def room_pose(i: int, n_frames: int):
    """The room camera's extrinsic (R, t) and centre C at frame ``i`` of
    ``n_frames``: one full loop of an ellipse, yaw sweeping around it."""
    s = i / max(n_frames - 1, 1)
    ang = 2.0 * np.pi * s                       # a full loop: the end revisits the start
    C = np.array([2.5 * np.sin(ang), 0.3 * np.sin(2 * ang), 2.0 - 2.0 * np.cos(ang)])
    yaw = -ang + 0.35 * np.sin(3 * ang)         # look-around sweeps
    R = so3_exp_np(np.array([0.0, yaw, 0.0]))
    return R, -R @ C, C


def camera_path(n_frames: int, motion: str = "strafe"):
    """The ground truth of ``synthetic_sequence``: per frame the extrinsic
    (R, t) and the centre C, as a list; no frame is drawn (what a run on a
    sequence written earlier is scored against)."""
    if motion == "room":
        return [room_pose(i, n_frames) for i in range(n_frames)]
    path = []
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
        path.append((R, -R @ C, C))
    return path


def synthetic_sequence(
    n_frames: int = 20,
    width: int = 640,
    height: int = 480,
    fx: float = 450.0,
    seed: int = 0,
    motion: str = "strafe",
    device=None,
):
    """Returns (frames list of (H, W, 3) uint8 BGR, K, gt_positions (N, 3),
    gt_rotations (N, 3, 3)); extrinsic poses x_cam = R X + t with camera
    centre C = -R^T t (``camera_path``).  ``motion``: "strafe", "orbit" or
    "room".  The frames are drawn with torch on ``device``, the CPU by
    default (``render_frame``)."""
    import torch

    def on_device(planes):
        return [(torch.as_tensor(tex, dtype=torch.float64, device=device or "cpu"), c)
                for tex, c in planes]

    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    path = camera_path(n_frames, motion)
    if motion == "room":
        planes = on_device(_room_planes(rng))
    else:
        tex_far = _texture(rng)
        tex_near = _texture(rng)
        planes = on_device([
            (tex_far, _plane_corners_world([0.6, 0.0, 9.0], [1, 0, 0], [0, 1, 0], 6.0)),
            (tex_near, _plane_corners_world([-1.2, -0.4, 4.5], [1, 0, 0.15], [0, 1, 0], 1.8)),
        ])
    frames = [render_frame(K, R, t, planes, width, height, depth_sort=motion == "room",
                           device=device) for R, t, _ in path]
    return (frames, K, np.stack([C for _, _, C in path]), np.stack([R for R, _, _ in path]))


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


#: the intrinsics of the global-scale scenes (a 1280 x 720 video camera)
GLOBAL_K = np.array([[912.78, 0, 650.29], [0, 913.03, 362.72], [0, 0, 1.0]])


def repeat_slots(window: dict, k: int, seed: int, jitter: float = 0.5) -> dict:
    """A ``synthetic_window`` with every point's slots repeated ``k`` times
    (D becomes k * D), each copy's pixel moved by Gaussian ``jitter`` px: a
    keyframe that sees one point through several keypoints, which puts more
    slots on a point than the window has cameras."""
    rng = np.random.default_rng(seed)
    w = dict(window)
    w["cam_slot"] = np.tile(window["cam_slot"], (1, k))
    w["mask"] = np.tile(window["mask"], (1, k))
    uv = np.tile(window["uv"], (1, k, 1))
    uv[:, window["uv"].shape[1]:] += rng.normal(0, jitter, uv[:, window["uv"].shape[1]:].shape)
    w["uv"] = (uv * w["mask"][..., None]).astype(np.float32)
    return w


def synthetic_global_problem(seed: int, C: int = 200, P: int = 30000,
                             obs_per_pt: int = 4, K=GLOBAL_K, noise: float = 0.5,
                             rot_sigma: float = 0.005, centre_sigma: float = 0.02,
                             point_sigma: float = 0.02, drop: float = 0.0,
                             pad_to: int | None = None) -> dict:
    """A global-BA problem in the flat layout (``ops/ba.BAProblem``), as a
    dict of numpy arrays keyed like it: a long chain of ``C`` cameras on a
    smooth forward path with band-diagonal visibility (each of the ``P``
    points is seen by ``obs_per_pt`` consecutive cameras), the structure the
    matrix-free PCG camera solve exists for.  Every point sits in front of
    its first camera at depth 4 to 16; pixels carry ``noise`` px of Gaussian
    noise; an observation behind its camera (z <= 0.5) is masked out, and so
    is a random share ``drop`` of all, which leaves points with fewer
    observations than slots.  All cameras but the first start perturbed
    (rotation and centre, the extrinsic translation rebuilt as t = -R c), and
    all points.  With ``pad_to`` the points are padded to that count with
    zeros that ``point_mask`` leaves out.  ``seed`` may be a numpy
    ``Generator``, which is drawn from as it is: with the defaults that
    gives the arrays of ``bench.make_global_problem`` for the same
    generator (the problem of the JAX package's ``global_scale_sweep``)."""
    rng = np.random.default_rng(seed)     # a Generator passes through
    K = np.asarray(K, np.float64)
    c_ids = np.arange(C)
    rvecs = np.stack([0.10 * np.sin(c_ids / 10), 0.10 * np.cos(c_ids / 13),
                      0.05 * np.sin(c_ids / 7)], axis=1)
    Rs = np.stack([so3_exp_np(r) for r in rvecs])
    centers = np.stack([0.3 * c_ids, 0.05 * np.sin(c_ids / 5), 0.02 * c_ids], axis=1)
    tvecs = -np.einsum("cij,cj->ci", Rs, centers)

    base = (np.arange(P) * max(C - obs_per_pt, 1) // P).astype(np.int32)
    offs = rng.uniform([-4, -4, 4], [4, 4, 16], size=(P, 3))
    X = centers[base] + np.einsum("pji,pj->pi", Rs[base], offs)

    cam_idx = (base[:, None] + np.arange(obs_per_pt)[None, :]).reshape(-1)
    cam_idx = np.minimum(cam_idx, C - 1).astype(np.int32)
    pnt_idx = np.repeat(np.arange(P, dtype=np.int32), obs_per_pt)
    Xc = np.einsum("oij,oj->oi", Rs[cam_idx], X[pnt_idx]) + tvecs[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = uv + rng.normal(size=uv.shape) * noise
    valid = Xc[:, 2] > 0.5

    free = np.arange(C)[:, None] > 0
    rv_p = rvecs + rng.normal(size=rvecs.shape) * rot_sigma * free
    c_p = centers + rng.normal(size=centers.shape) * centre_sigma * free
    R_p = np.stack([so3_exp_np(r) for r in rv_p])
    tv_p = -np.einsum("cij,cj->ci", R_p, c_p)
    points = (X + rng.normal(size=X.shape) * point_sigma).astype(np.float32)
    if drop:
        valid = valid & (rng.random(len(valid)) >= drop)
    n_pad = max((pad_to or P) - P, 0)
    return dict(
        rvecs=rv_p.astype(np.float32), tvecs=tv_p.astype(np.float32),
        points=np.concatenate([points, np.zeros((n_pad, 3), np.float32)]),
        cam_idx=cam_idx, pnt_idx=pnt_idx, uv=uv.astype(np.float32),
        obs_mask=valid.astype(np.float32), point_mask=np.arange(P + n_pad) < P,
        K=K.astype(np.float32))


def synthetic_ring_problem(seed: int, C: int = 92, P: int = 1000, D: int = 91,
                           K=GLOBAL_K, noise: float = 0.5, rot_sigma: float = 0.005,
                           centre_sigma: float = 0.02, point_sigma: float = 0.02,
                           drift: float = 0.0) -> dict:
    """A global-BA problem whose points are each seen by ``D`` keyframes:
    the long drive's shapes (a room loop's final map, D = 14 to 91).  ``C``
    cameras on a ring of radius 10 look at its centre; the ``P`` points lie
    in a cylinder of radius 3 about it, point p seen by the ``D`` cameras
    from p * C // P on round the ring (``D <= C``), so every point is 7 to
    13 in front of each of its cameras.  Pixels carry ``noise`` px of
    Gaussian noise.  All cameras but the first start perturbed (rotation and
    centre, t = -R c rebuilt) and all points; ``drift`` adds a bend that
    grows along the ring, each camera's centre and yaw moved by ``drift``
    times its share of the ring (a drifted start that the first LM steps
    mostly remove).  The flat layout of ``synthetic_global_problem``."""
    if not 1 <= D <= C:
        raise ValueError(f"D={D} slots need 1 <= D <= C={C}")
    rng = np.random.default_rng(seed)
    K = np.asarray(K, np.float64)
    ang = 2 * np.pi * np.arange(C) / C
    centers = np.stack([10 * np.sin(ang), np.zeros(C), -10 * np.cos(ang)], axis=1)
    Rs = []
    for c in centers:
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z]))
    Rs = np.stack(Rs)
    rvecs = np.stack([so3_log_np(R) for R in Rs])
    tvecs = -np.einsum("cij,cj->ci", Rs, centers)

    r = 3 * np.sqrt(rng.random(P))
    phi = 2 * np.pi * rng.random(P)
    X = np.stack([r * np.cos(phi), rng.uniform(-1.5, 1.5, P), r * np.sin(phi)], axis=1)
    base = (np.arange(P) * C // P).astype(np.int64)
    cam_idx = ((base[:, None] + np.arange(D)[None, :]) % C).reshape(-1).astype(np.int32)
    pnt_idx = np.repeat(np.arange(P, dtype=np.int32), D)
    Xc = np.einsum("oij,oj->oi", Rs[cam_idx], X[pnt_idx]) + tvecs[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = uv + rng.normal(size=uv.shape) * noise

    free = np.arange(C)[:, None] > 0
    share = (np.arange(C) / C)[:, None]
    rv_p = rvecs + rng.normal(size=rvecs.shape) * rot_sigma * free \
        + drift * share * np.array([0.0, 0.1, 0.0])
    c_p = centers + rng.normal(size=centers.shape) * centre_sigma * free \
        + drift * share * np.array([1.0, 0.3, -0.5])
    R_p = np.stack([so3_exp_np(v) for v in rv_p])
    tv_p = -np.einsum("cij,cj->ci", R_p, c_p)
    points = (X + rng.normal(size=X.shape) * point_sigma).astype(np.float32)
    return dict(
        rvecs=rv_p.astype(np.float32), tvecs=tv_p.astype(np.float32), points=points,
        cam_idx=cam_idx, pnt_idx=pnt_idx, uv=uv.astype(np.float32),
        obs_mask=np.ones(P * D, np.float32), point_mask=np.ones(P, bool),
        K=K.astype(np.float32))


def synthetic_global_map(seed: int, C: int = 200, P: int = 30000, obs_per_pt: int = 4,
                         device="cuda", **scene):
    """The scene of ``synthetic_global_problem`` as a ``Map``: ``C`` keyframes
    (ids and frame indices 0..C-1, perturbed poses), ``P`` map points, the
    live observations; each keyframe's keypoints are its observations, with
    empty descriptors.  Returns (map, K): what ``VisualOdometryPipeline``'s
    ``run_local_ba``, ``run_global_ba``, ``run_full_ba`` and ``finalize`` need
    to be driven at a real size without rendering C frames."""
    import torch

    from bundle_adjustment_tpu_torch.models.map_store import Keyframe, Map

    pr = synthetic_global_problem(seed, C, P, obs_per_pt, **scene)
    m = Map(device=device)
    mp_ids = m.add_map_points(pr["points"].astype(np.float64))
    live = pr["obs_mask"] > 0
    for c in range(C):
        rows = np.flatnonzero(live & (pr["cam_idx"] == c))
        xy = pr["uv"][rows].astype(np.float64)
        m.add_keyframe(Keyframe(
            kf_id=c, R=so3_exp_np(pr["rvecs"][c].astype(np.float64)),
            t=pr["tvecs"][c].astype(np.float64), xy=xy,
            desc=torch.zeros((len(rows), 8), dtype=torch.int32, device=m.device),
            kp_valid=np.ones(len(rows), bool), frame_idx=c))
        m.add_observations(c, mp_ids[pr["pnt_idx"][rows]], np.arange(len(rows)), xy)
    return m, pr["K"].astype(np.float64)


def write_video(frames, path: str, fps: int = 15):
    """Write frames to an mp4 through cv2's ``VideoWriter`` (mp4v), as the
    JAX package's ``write_video`` does; raises naming cv2 where it is not
    installed."""
    from bundle_adjustment_tpu_torch.utils.io import _cv2

    cv2 = _cv2(f"write_video ({path})")
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        out.write(f)
    out.release()
