"""Relocalization on tracking loss: a descriptor-bank search, then PnP
re-entry (port of ``bundle_adjustment_tpu.models.relocalize``).

The descriptor banks of the last ``reloc_bank_size`` keyframes are stacked
on the device (one ``torch.cat``) and searched at once against the lost
frame's keypoints, map-point-backed slots only: the exact Hamming 2-NN
(``hamming.match``, the K1 kernel on the card) for a bank of at most
``reloc_ann_threshold`` descriptors, the coarse-to-fine search
(``ops/ann.py``) above it.  The keyframe with the most ratio-tested matches
anchors a PnP RANSAC; on success a keyframe is inserted at the PnP pose with
the inliers as observations, and a windowed BA follows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bundle_adjustment_tpu_torch.models.map_store import Keyframe
from bundle_adjustment_tpu_torch.ops import ann, hamming, ransac


def try_relocalize(pipe, frame_bgr, kp) -> Optional[dict]:
    """PnP re-entry of the lost frame with keypoints ``kp`` (device tensors
    ``xy``, ``desc``, ``valid``).  Returns the result dict on success, None
    on failure (the caller goes on discarding frames)."""
    cfg = pipe.cfg
    bank_ids = pipe.map.sorted_kf_ids()[-cfg.reloc_bank_size:]
    if not bank_ids:
        return None

    kfs = [pipe.map.keyframes[k] for k in bank_ids]
    bank_valid = np.concatenate([kf.kp_valid & (kf.kp_to_mp >= 0) for kf in kfs])
    bank_mp = np.concatenate([kf.kp_to_mp for kf in kfs])
    bank_kf = np.concatenate([np.full(kf.desc.shape[0], k, np.int64)
                              for k, kf in zip(bank_ids, kfs)])
    if not bank_valid.any():
        pipe.log.reloc(pipe.frame_idx, False)
        return None

    dev = pipe.device
    bank_desc = torch.cat([kf.desc for kf in kfs])
    valid_t = torch.as_tensor(bank_valid, device=dev)
    kp_valid_t = torch.as_tensor(kp.valid, device=dev)
    if len(bank_valid) > cfg.reloc_ann_threshold:
        idx, mask, _ = ann.match_bank(kp.desc, bank_desc, valid_t, ratio=cfg.ratio_test)
    else:
        idx, mask, _ = hamming.match(kp.desc, bank_desc, kp_valid_t, valid_t,
                                     ratio=cfg.ratio_test)
    got = pipe._host(torch.stack([idx.to(torch.int32), (mask & kp_valid_t).to(torch.int32)]))
    idx, mask = got[0].astype(np.int64), got[1] > 0

    cur_slots = np.flatnonzero(mask)            # current-frame keypoints
    if len(cur_slots) == 0:
        pipe.log.reloc(pipe.frame_idx, False)
        return None
    hit = idx[cur_slots]                        # stacked-bank slots
    hit_kf = bank_kf[hit]

    # anchor = the bank keyframe with the most matches
    kf_vals, kf_counts = np.unique(hit_kf, return_counts=True)
    kf_id = int(kf_vals[np.argmax(kf_counts)])
    sel = hit_kf == kf_id
    cur_kp = cur_slots[sel]
    mps = bank_mp[hit[sel]]
    # one observation per map point and per keypoint (cur_kp is unique by
    # construction; keep the first of each map point)
    _, first = np.unique(mps, return_index=True)
    first = np.sort(first)
    cur_kp = cur_kp[first]
    mps = mps[first]
    n = len(cur_kp)
    if n < 6:
        pipe.log.reloc(pipe.frame_idx, False, kf_id, 0)
        return None

    kp_xy = pipe._host(kp.xy).astype(np.float64)
    cap = max(64, 1 << int(np.ceil(np.log2(n))))
    Xp = np.zeros((cap, 3), np.float32)
    uvp = np.zeros((cap, 2), np.float32)
    Xp[:n] = pipe.map.points()[mps]
    uvp[:n] = kp_xy[cur_kp]
    u = pipe.draws.next(ransac.pnp_draw_shape(cfg.pnp_iters))
    res = ransac.estimate_pnp_pose(
        u, torch.as_tensor(Xp, device=dev), torch.as_tensor(uvp, device=dev),
        torch.as_tensor(np.arange(cap) < n, device=dev), pipe.K_t,
        reproj_threshold_px=cfg.pnp_reproj_err_px, num_hyp=cfg.pnp_iters)
    ok = pipe._host(torch.stack([res.ok.to(torch.int32), res.num_inliers.to(torch.int32)]))
    num_inl = int(ok[1])
    if not ok[0] or num_inl <= cfg.pose_inlier_numbers:
        pipe.log.reloc(pipe.frame_idx, False, kf_id, num_inl)
        return None

    pipe.log.reloc(pipe.frame_idx, True, kf_id, num_inl)

    # a keyframe at the PnP pose (an extrinsic, as BA reads stored poses)
    new_kf = Keyframe(
        kf_id=pipe.map.new_keyframe_id(),
        R=pipe._host(res.R).astype(np.float64), t=pipe._host(res.t).astype(np.float64),
        xy=kp_xy, desc=kp.desc, kp_valid=pipe._host(kp_valid_t),
        frame_idx=pipe.frame_idx)
    pipe.map.add_keyframe(new_kf)
    pipe.log.keyframe_trigger(pipe.frame_idx, new_kf.kf_id, "Relocalization",
                              {"anchor_kf": kf_id, "pnp_inliers": num_inl})

    # the PnP inliers become observations (cur_kp and mps are already one
    # per keypoint and one per map point)
    inl = pipe._host(res.inliers)[:n]
    pipe.map.add_observations(new_kf.kf_id, mps[inl], cur_kp[inl], kp_xy[cur_kp[inl]])

    ba_result = pipe.run_local_ba()
    return {"status": "relocalized", "kf_id": new_kf.kf_id, "anchor_kf": kf_id,
            "inliers": num_inl, "ba": ba_result}
