"""Carry the JAX package's state into the port's tensors.

Inputs are numpy arrays (``np.asarray`` of the JAX arrays) or NamedTuples of
them, or the JAX package's host ``Map`` (numpy arrays throughout), so this
module needs nothing of JAX.  Outputs live on ``device``
(default ``"cuda"``, which raises when there is no card).

Descriptor words are uint32 in the JAX package and int32 here: the same
bits, reinterpreted with a numpy ``.view``.
"""

from __future__ import annotations

import numpy as np
import torch

from bundle_adjustment_tpu_torch import device as device_mod
from bundle_adjustment_tpu_torch.models.frontend import FrontendState
from bundle_adjustment_tpu_torch.models.map_store import Keyframe, Map
from bundle_adjustment_tpu_torch.ops.ba import BAProblem
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid


def descriptors(desc_u32, device="cuda") -> torch.Tensor:
    """(N, 8) uint32 descriptor words -> (N, 8) int32 tensor, same bits."""
    a = np.ascontiguousarray(np.asarray(desc_u32))
    if a.dtype not in (np.uint32, np.int32) or a.shape[-1] != 8:
        raise ValueError(f"expected (..., 8) uint32 words, got {a.shape} {a.dtype}")
    return torch.as_tensor(a.view(np.int32).copy(), device=device_mod.resolve(device))


def descriptors_to_u32(desc: torch.Tensor) -> np.ndarray:
    """The inverse of ``descriptors``: int32 tensor -> uint32 numpy words."""
    return desc.detach().cpu().numpy().view(np.uint32)


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    t = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return t if dtype is None else t.to(dtype)


def frontend_state(state, device="cuda") -> FrontendState:
    """``models.frontend.FrontendState`` of the JAX package -> the port's."""
    dev = device_mod.resolve(device)
    return FrontendState(
        desc=descriptors(state.desc, dev),
        xy=_tensor(state.xy, dev, torch.float32),
        kp_valid=_tensor(state.kp_valid, dev, torch.bool),
        pts3d=_tensor(state.pts3d, dev, torch.float32),
        tracked=_tensor(state.tracked, dev, torch.bool),
        rvec=_tensor(state.rvec, dev, torch.float32),
        tvec=_tensor(state.tvec, dev, torch.float32),
    )


def ba_problem(problem, device="cuda") -> BAProblem:
    """``ops.ba.BAProblem`` of the JAX package -> the port's."""
    dev = device_mod.resolve(device)
    return BAProblem(
        rvecs=_tensor(problem.rvecs, dev), tvecs=_tensor(problem.tvecs, dev),
        points=_tensor(problem.points, dev),
        cam_idx=_tensor(problem.cam_idx, dev, torch.int32),
        pnt_idx=_tensor(problem.pnt_idx, dev, torch.int32),
        uv=_tensor(problem.uv, dev), obs_mask=_tensor(problem.obs_mask, dev),
        point_mask=_tensor(problem.point_mask, dev, torch.bool),
        K=_tensor(problem.K, dev),
    )


_MAP_ARRAYS = ("_pts", "_colors", "_pt_alive", "_obs_kf", "_obs_mp", "_obs_kp",
               "_obs_uv", "_obs_alive")


def map_store(jmap, device="cuda") -> Map:
    """``models.map_store.Map`` of the JAX package (its host arrays and
    keyframes) -> a port ``Map`` holding copies, descriptors on ``device``."""
    m = Map(device=device)
    for k in sorted(jmap.keyframes):
        kf = jmap.keyframes[k]
        m.add_keyframe(Keyframe(
            kf_id=kf.kf_id, R=np.array(kf.R, np.float64), t=np.array(kf.t, np.float64),
            xy=np.array(kf.xy, np.float64), desc=descriptors(kf.desc, m.device),
            kp_valid=np.array(kf.kp_valid, bool), frame_idx=int(kf.frame_idx),
            kp_to_mp=np.array(kf.kp_to_mp, np.int64)))
    for name in _MAP_ARRAYS:
        setattr(m, name, np.array(getattr(jmap, name)))
    m._n_pts, m._n_obs = int(jmap._n_pts), int(jmap._n_obs)
    m.refill_native()
    m.next_keyframe_id = int(jmap.next_keyframe_id)
    m.next_map_point_id = int(jmap.next_map_point_id)
    return m


def ba_problem_grid(grid, device="cuda") -> BAProblemGrid:
    """``ops.ba_grid.BAProblemGrid`` of the JAX package -> the port's."""
    dev = device_mod.resolve(device)
    return BAProblemGrid(
        rvecs=_tensor(grid.rvecs, dev), tvecs=_tensor(grid.tvecs, dev),
        points=_tensor(grid.points, dev),
        cam_slot=_tensor(grid.cam_slot, dev, torch.int32),
        uv=_tensor(grid.uv, dev), mask=_tensor(grid.mask, dev, torch.float32),
        point_mask=_tensor(grid.point_mask, dev, torch.bool),
        K=_tensor(grid.K, dev),
    )
