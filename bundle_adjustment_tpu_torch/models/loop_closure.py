"""Loop closure: bank detection, sim(3) drift correction and point fusion
(port of ``bundle_adjustment_tpu.models.loop_closure``).

Per new keyframe, after its windowed BA:

1. detect: the new keyframe's descriptors against a bank of one descriptor
   per old map point (its first observation, in keyframes at least
   ``loop_min_gap`` older), built on the device by one ``index_select`` per
   keyframe; the exact Hamming 2-NN (K1 on the card) up to
   ``reloc_ann_threshold`` descriptors, the coarse-to-fine search above;
   the anchor is the bank keyframe with the most ratio-tested matches;
2. verify and fit: PnP RANSAC of the new camera in the old map's frame on
   (old point, new pixel) pairs; the drift scale is the median depth ratio
   of PnP-verified pairs that also carry a new (duplicate) point, rotation
   and translation follow from the PnP pose and the drifted pose;
3. correct: the sim(3) spread along the keyframes after the anchor (alpha
   from 0 to 1), each point moved by its first observer's correction;
4. fuse: matched duplicate points merged into the old ones
   (``Map.merge_points``), and reprojection-checked observations of old
   points added at free keypoints;
5. polish: optionally a full-map BA (``run_full_ba``; on the card the
   global-BA kernels K4 through ``GlobalLM``).

Each failed attempt emits a ``loop_reject`` event naming the gate and the
counts it saw; a closure emits ``loop_closure``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bundle_adjustment_tpu_torch.ops import ann, hamming, ransac
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np, so3_log_np
from bundle_adjustment_tpu_torch.utils.metrics import umeyama_align


def fit_sim3_ransac(X_src: np.ndarray, X_dst: np.ndarray, tol: float,
                    iters: int = 256, seed: int = 0):
    """RANSAC similarity fit X_dst ~= s * R @ X_src + t from 3-point minimal
    samples.  Returns (s, R, t, inlier_mask) or None."""
    n = len(X_src)
    if n < 4:
        return None
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(iters):
        sel = rng.choice(n, 3, replace=False)
        s, R, t = umeyama_align(X_src[sel], X_dst[sel], with_scale=True)
        if not (np.isfinite(s) and 1e-3 < s < 1e3):
            continue
        r = np.linalg.norm((s * (R @ X_src.T)).T + t - X_dst, axis=1)
        inl = r < tol
        if best is None or inl.sum() > best.sum():
            best = inl
    if best is None or best.sum() < 4:
        return None
    s, R, t = umeyama_align(X_src[best], X_dst[best], with_scale=True)
    r = np.linalg.norm((s * (R @ X_src.T)).T + t - X_dst, axis=1)
    inl = r < tol
    if inl.sum() < 4:
        return None
    s, R, t = umeyama_align(X_src[inl], X_dst[inl], with_scale=True)
    return float(s), R, t, inl


def _interp_sim3(s: float, R: np.ndarray, t: np.ndarray, alpha: float):
    """Interpolated similarity: identity at alpha = 0, (s, R, t) at alpha =
    1; scale and rotation geodesically, translation linearly."""
    w = so3_log_np(R)
    return s ** alpha, so3_exp_np(alpha * w), alpha * np.asarray(t, np.float64)


def _anchor_bank(pipe, bank_kf: np.ndarray, bank_kp: np.ndarray) -> torch.Tensor:
    """(B, 8) descriptors of the bank rows, gathered on the device: one
    ``index_select`` per keyframe, then the rows put back in bank order."""
    dev = pipe.device
    order, parts = [], []
    for k in np.unique(bank_kf):
        rows = np.flatnonzero(bank_kf == k)
        order.append(rows)
        parts.append(pipe.map.keyframes[int(k)].desc.index_select(
            0, torch.as_tensor(bank_kp[rows], device=dev)))
    inv = np.argsort(np.concatenate(order), kind="stable")
    return torch.cat(parts).index_select(0, torch.as_tensor(inv, device=dev))


def try_close_loop(pipe, new_kf) -> Optional[dict]:
    """Attempt loop closure for a freshly inserted keyframe.  Returns an info
    dict on success, None otherwise.  Mutates poses, points and
    observations."""
    cfg = pipe.cfg
    dev = pipe.device

    def reject(stage, **fields):
        pipe.log.emit("loop_reject", None, kf_id=new_kf.kf_id, stage=stage, **fields)
        return None

    all_ids = pipe.map.sorted_kf_ids()
    cutoff = new_kf.kf_id - cfg.loop_min_gap
    if not any(k <= cutoff for k in all_ids):
        return None  # too early in the run for any candidate

    bank_mp, bank_kf, bank_kp = pipe.map.anchor_observations(cutoff)
    if len(bank_mp) < cfg.loop_min_matches:
        return reject("bank_size", bank=len(bank_mp))
    bank_desc = _anchor_bank(pipe, bank_kf, bank_kp)
    bank_valid = torch.ones(len(bank_mp), dtype=torch.bool, device=dev)
    kp_valid = torch.as_tensor(new_kf.kp_valid, device=dev)
    if len(bank_mp) > cfg.reloc_ann_threshold:
        idx, mask, _ = ann.match_bank(new_kf.desc, bank_desc, bank_valid, ratio=cfg.ratio_test)
    else:
        idx, mask, _ = hamming.match(new_kf.desc, bank_desc, kp_valid, bank_valid,
                                     ratio=cfg.ratio_test)
    got = pipe._host(torch.stack([idx.to(torch.int32), (mask & kp_valid).to(torch.int32)]))
    idx, mask = got[0].astype(np.int64), got[1] > 0

    cur_slots = np.flatnonzero(mask)
    if len(cur_slots) < cfg.loop_min_matches:
        return reject("ratio_matches", bank=len(bank_mp), matches=len(cur_slots))
    hit_kf = bank_kf[idx[cur_slots]]
    kf_vals, kf_counts = np.unique(hit_kf, return_counts=True)
    anchor_id = int(kf_vals[np.argmax(kf_counts)])
    if int(kf_counts.max()) < cfg.loop_min_matches:
        return reject("anchor_consensus", matches=len(cur_slots), top_anchor=anchor_id,
                      top_count=int(kf_counts.max()), n_anchors=len(kf_vals))

    # geometric verification: PnP of the new camera against the OLD map
    near = np.abs(hit_kf - anchor_id) <= max(cfg.loop_min_gap // 2, 3)
    cur_kp = cur_slots[near]
    mp_old = bank_mp[idx[cur_kp]]
    _, f = np.unique(mp_old, return_index=True)      # one pair per old point
    f = np.sort(f)
    cur_kp, mp_old = cur_kp[f], mp_old[f]
    n = len(cur_kp)
    if n < max(cfg.loop_min_inliers, 6):
        return reject("pair_count", top_anchor=anchor_id, top_count=int(kf_counts.max()),
                      pairs=n)

    pts = pipe.map.points()
    cap = max(64, 1 << int(np.ceil(np.log2(n))))
    Xp = np.zeros((cap, 3), np.float32)
    uvp = np.zeros((cap, 2), np.float32)
    Xp[:n] = pts[mp_old]
    uvp[:n] = np.asarray(new_kf.xy)[cur_kp]
    u = pipe.draws.next(ransac.pnp_draw_shape(cfg.pnp_iters))
    res = ransac.estimate_pnp_pose(
        u, torch.as_tensor(Xp, device=dev), torch.as_tensor(uvp, device=dev),
        torch.as_tensor(np.arange(cap) < n, device=dev), pipe.K_t,
        reproj_threshold_px=cfg.pnp_reproj_err_px, num_hyp=cfg.pnp_iters)
    ok = pipe._host(torch.stack([res.ok.to(torch.int32), res.num_inliers.to(torch.int32)]))
    n_inl = int(ok[1])
    if not ok[0] or n_inl < cfg.loop_min_inliers:
        return reject("pnp", top_anchor=anchor_id, pairs=n, pnp_inliers=n_inl)
    R_o = pipe._host(res.R).astype(np.float64)       # new camera in the OLD frame
    t_o = pipe._host(res.t).astype(np.float64)
    pnp_inl = pipe._host(res.inliers)[:n]

    # the drift's scale: median depth ratio over PnP-verified pairs that
    # also carry a (duplicate) new-map point
    mp_new = new_kf.kp_to_mp[cur_kp]
    both = pnp_inl & (mp_new >= 0) & (mp_new != mp_old)
    pair_kp, pair_old, pair_new = cur_kp[both], mp_old[both], mp_new[both]
    _, f = np.unique(pair_new, return_index=True)
    f = np.sort(f)
    pair_kp, pair_old, pair_new = pair_kp[f], pair_old[f], pair_new[f]
    if len(pair_old) < 4:
        return reject("scale_pairs", top_anchor=anchor_id, pnp_inliers=n_inl,
                      pairs=len(pair_old))
    R_c = np.asarray(new_kf.R, np.float64)           # the drifted pose
    t_c = np.asarray(new_kf.t, np.float64)
    z_old = (pts[pair_old] @ R_o.T + t_o)[:, 2]
    z_new = (pts[pair_new] @ R_c.T + t_c)[:, 2]
    good = (z_old > 1e-6) & (z_new > 1e-6)
    if int(good.sum()) < 4:
        return reject("scale_pairs", top_anchor=anchor_id, pnp_inliers=n_inl,
                      pairs=int(good.sum()))
    s = float(np.median(z_old[good] / z_new[good]))
    # a wide bound: monocular scale drift over a long loop is large; the
    # geometry is already PnP-verified
    if not 0.02 < s < 50.0:
        return reject("scale_range", top_anchor=anchor_id, scale=round(s, 4))
    # drift sim(3): X_old = R_o^T (s (R_c X + t_c) - t_o) = s Rg X + tg
    Rg = R_o.T @ R_c
    tg = R_o.T @ (s * t_c - t_o)

    # pairs the recovered sim(3) maps onto their old counterparts (a loose
    # tolerance: fusion merges observations, BA refines the positions)
    X_old = pts[pair_old]
    scene = float(np.median(np.linalg.norm(X_old - np.median(X_old, axis=0), axis=1))) or 1.0
    err = np.linalg.norm(s * (pts[pair_new] @ Rg.T) + tg - X_old, axis=1)
    inl = err < max(3.0 * cfg.loop_sim3_tol_rel, 0.1) * scene

    # correct the pose chain after the anchor
    ids_after = [k for k in all_ids if k > anchor_id]
    m = len(ids_after)
    for i, k in enumerate(ids_after):
        sa, Ra, ta = _interp_sim3(s, Rg, tg, (i + 1) / m)
        kf = pipe.map.keyframes[k]
        Rk = kf.R @ Ra.T
        kf.R = Rk
        kf.t = sa * kf.t - Rk @ ta
    # each live point moves with its first observer's correction
    first = pipe.map.first_observer_per_point()
    alive_idx = np.flatnonzero(pipe.map.point_alive())
    fo = first[alive_idx]
    ids_arr = np.asarray(ids_after, np.int64)
    in_after = (fo > anchor_id) & (fo <= ids_arr[-1])
    pos = np.searchsorted(ids_arr, fo[in_after])
    moved = alive_idx[in_after]
    for p in np.unique(pos):
        sa, Ra, ta = _interp_sim3(s, Rg, tg, (p + 1) / m)
        mp_arr = moved[pos == p]
        pipe.map._pts[mp_arr] = (sa * pts[mp_arr]) @ Ra.T + ta

    # fuse the duplicate points (the old point stays)
    fused = 0
    for o, nw in zip(pair_old[inl], pair_new[inl]):
        fused += pipe.map.merge_points(int(o), int(nw))

    # reprojection-checked observations of old points at free keypoints
    free = new_kf.kp_to_mp[cur_slots] < 0
    f_kp = cur_slots[free]
    f_mp = bank_mp[idx[f_kp]]
    _, f = np.unique(f_mp, return_index=True)
    f_kp, f_mp = f_kp[np.sort(f)], f_mp[np.sort(f)]
    added = 0
    if len(f_kp):
        Xc = pipe.map.points()[f_mp] @ new_kf.R.T + new_kf.t
        z = Xc[:, 2]
        K = pipe.K
        with np.errstate(divide="ignore", invalid="ignore"):
            uv_hat = (Xc[:, :2] / z[:, None]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        err = np.linalg.norm(uv_hat - new_kf.xy[f_kp], axis=1)
        ok = (z > 1e-6) & np.isfinite(err) & (err < cfg.covis_reproj_px)
        if ok.any():
            pipe.map.add_observations(new_kf.kf_id, f_mp[ok], f_kp[ok], new_kf.xy[f_kp[ok]])
            added = int(ok.sum())

    pipe._front_dirty = True
    info = {"anchor_kf": anchor_id, "matches": int(kf_counts.max()),
            "pnp_inliers": n_inl, "sim3_inliers": int(inl.sum()), "scale": round(s, 4),
            "fused": int(fused), "added_obs": added, "chain_corrected": m}
    pipe.log.emit(
        "loop_closure",
        f"    -> Loop closure: KF {new_kf.kf_id} -> anchor {anchor_id} "
        f"(PnP inliers {n_inl}, scale {s:.3f}, fused {fused}, +{added} obs, "
        f"{m} poses corrected)",
        kf_id=new_kf.kf_id, **info)

    if cfg.loop_run_global_ba:
        # the polish after the correction, with an LM cap of its own
        info["ba"] = pipe.run_full_ba(
            max_iterations=min(cfg.ba.max_iterations, cfg.loop_ba_iters))
    return info
