"""Checkpoint and resume of a ``VisualOdometryPipeline`` (port of
``bundle_adjustment_tpu.utils.checkpoint``, in the port's own format).

One compressed ``.npz``, no pickle, holding the map (keyframe poses,
keypoints, descriptor banks, keypoint -> map-point back-pointers, map points
with colours and liveness, the flat observation table), the pipeline's
cursor (frame index, lost-frame counter, the loop-closure cooldown's last
closure) and the state of its ``Draws`` (seed and generator state, where the
JAX package stores its PRNG key), with a fingerprint of the configuration.

Resume is exact: every array and the draws round-trip bit for bit, so a
resumed run replays an uninterrupted one.  A restored pipeline refills the
tracked-frame step's state from the restored map before its first frame.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

_FORMAT_VERSION = 1

#: settings that do not change what the map means: a checkpoint resumes
#: across other output folders and export or debug settings
_NON_SEMANTIC = {"output_dir", "debug", "export_pcd_series", "export_voxel",
                 "fused_frontend"}


def _config_fingerprint(cfg) -> str:
    d = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in _NON_SEMANTIC}
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_checkpoint(pipe, path: str):
    """Write ``pipe``'s state to ``path`` (.npz).  The descriptor banks come
    back from the device in one read."""
    from bundle_adjustment_tpu_torch.models.pipeline import Draws

    if not isinstance(pipe.draws, Draws):
        raise TypeError(f"a checkpoint stores Draws; this pipeline draws from "
                        f"{type(pipe.draws).__name__}")
    m = pipe.map
    kf_ids = m.sorted_kf_ids()
    arrays = {
        "format_version": np.array(_FORMAT_VERSION),
        "frame_idx": np.array(pipe.frame_idx),
        "lost_frames": np.array(pipe._lost_frames),
        "last_loop_kf": np.array(pipe._last_loop_kf),
        "draws_seed": np.array(pipe.draws.seed),
        "draws_state": pipe.draws._gen.get_state().numpy(),
        "draws_device": np.frombuffer(pipe.draws.device.type.encode(), dtype=np.uint8),
        "config_fp": np.frombuffer(_config_fingerprint(pipe.cfg).encode(), dtype=np.uint8),
        "points": m._pts[: m._n_pts],
        "colors": m._colors[: m._n_pts],
        "pt_alive": m._pt_alive[: m._n_pts],
        "obs_kf": m._obs_kf[: m._n_obs],
        "obs_mp": m._obs_mp[: m._n_obs],
        "obs_kp": m._obs_kp[: m._n_obs],
        "obs_uv": m._obs_uv[: m._n_obs],
        "obs_alive": m._obs_alive[: m._n_obs],
        "kf_ids": np.array(kf_ids, np.int64),
    }
    if kf_ids:
        kfs = [m.keyframes[k] for k in kf_ids]
        arrays.update(
            kf_R=np.stack([kf.R for kf in kfs]),
            kf_t=np.stack([kf.t for kf in kfs]),
            kf_frame_idx=np.array([kf.frame_idx for kf in kfs]),
            kf_xy=np.stack([kf.xy for kf in kfs]),
            kf_valid=np.stack([kf.kp_valid for kf in kfs]),
            kf_kp_to_mp=np.stack([kf.kp_to_mp for kf in kfs]),
            kf_desc=torch.stack([kf.desc for kf in kfs]).cpu().numpy(),
        )
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, config, log=None, device="cuda",
                    strict_config: bool = True):
    """A ``VisualOdometryPipeline`` on ``device`` restored from ``path``.
    Raises ``ValueError`` when the checkpoint's format, its configuration's
    fingerprint (unless ``strict_config`` is off) or the device type of its
    draws differ."""
    from bundle_adjustment_tpu_torch.models.map_store import Keyframe
    from bundle_adjustment_tpu_torch.models.pipeline import Draws, VisualOdometryPipeline

    with np.load(path, allow_pickle=False) as npz:
        z = dict(npz)
    version = int(z["format_version"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {version} != {_FORMAT_VERSION}")
    fp_saved = z["config_fp"].tobytes().decode()
    fp_now = _config_fingerprint(config)
    if strict_config and fp_saved != fp_now:
        raise ValueError(f"config fingerprint mismatch: checkpoint {fp_saved}, current "
                         f"{fp_now} (pass strict_config=False to override)")

    pipe = VisualOdometryPipeline(config, log=log, device=device)
    saved_dev = z["draws_device"].tobytes().decode()
    if saved_dev != pipe.device.type:
        raise ValueError(f"the checkpoint's draws were made on {saved_dev!r}; they cannot "
                         f"continue on {pipe.device.type!r}")
    pipe.frame_idx = int(z["frame_idx"])
    pipe._lost_frames = int(z["lost_frames"])
    pipe._last_loop_kf = int(z["last_loop_kf"])
    pipe.draws = Draws(int(z["draws_seed"]), pipe.device)
    pipe.draws._gen.set_state(torch.from_numpy(z["draws_state"]))
    pipe._front_dirty = True

    m = pipe.map
    n_pts = len(z["points"])
    m._ensure_pts(n_pts)
    m._pts[:n_pts] = z["points"]
    m._colors[:n_pts] = z["colors"]
    m._pt_alive[:n_pts] = z["pt_alive"]
    m._n_pts = n_pts
    m.next_map_point_id = n_pts

    n_obs = len(z["obs_kf"])
    m._ensure_obs(n_obs)
    m._obs_kf[:n_obs] = z["obs_kf"]
    m._obs_mp[:n_obs] = z["obs_mp"]
    m._obs_kp[:n_obs] = z["obs_kp"]
    m._obs_uv[:n_obs] = z["obs_uv"]
    m._obs_alive[:n_obs] = z["obs_alive"]
    m._n_obs = n_obs
    m.refill_native()   # the restore bypasses add_observations

    if len(z["kf_ids"]):
        descs = torch.as_tensor(z["kf_desc"], device=pipe.device)
        for i, k in enumerate(z["kf_ids"]):
            m.add_keyframe(Keyframe(
                kf_id=int(k), R=z["kf_R"][i].copy(), t=z["kf_t"][i].copy(),
                xy=z["kf_xy"][i].copy(), desc=descs[i], kp_valid=z["kf_valid"][i].copy(),
                frame_idx=int(z["kf_frame_idx"][i]), kp_to_mp=z["kf_kp_to_mp"][i].copy()))
    return pipe
