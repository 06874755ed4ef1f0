"""Global-scale bundle adjustment by matrix-free PCG: the CUDA kernels'
wrappers, their plain versions and the LM solve around them.

Counterpart of ``bundle_adjustment_tpu.ops.ba_global_pallas`` (K4).  One LM
iteration is four per-observation passes, each a hand-written CUDA entry
point of ``csrc/ba_global_pcg.cu``:

``setup``    residuals, analytic Jacobians, Huber weights, the damped V^-1
             (6 packed values), the coupling blocks Y (D*18 rows), z_p, and
             the per-camera (C', 54) reduction: U upper triangle (21), g_c
             (6), W V^-1 g_p (6), the block-Jacobi W V^-1 W^T (21);
``matvec``   per CG iteration, W V^-1 W^T x, reduced per camera to (C', 6);
``backsub``  dp = -(z_p + V^-1 W^T x);
``cost``     the Huber cost (times 0.5) and the raw squared cost of a trial
             state.

Around them, in plain PyTorch as in the JAX package: Rodrigues and its
derivative per camera, the (C', 6)-sized camera algebra (damping, the 6x6
block inverses, the CG recurrences of ``ba._pcg_blocked``), and the LM
accept/reject step with Eisenstat-Walker forcing.  Same LM semantics as
``ba_grid.ba_solve_grid_impl`` with ``cg_iters > 0`` (``ba.lm_loop``).

The loops on the device.  As the reference runs LM and CG as
``while_loop``s in one dispatch, ``GlobalLM.body`` is one whole LM iteration
on tensors that it updates in place (CG to its cap with its updates masked
after the stop, ``ba._pcg_blocked``), with no host read and, on the card, no
allocation by the kernels.  On the card ``solve`` runs the first iteration
eagerly (it loads every kernel), captures the body once as a CUDA graph and
replays it; the host reads the stop flag once per LM iteration.  Elsewhere,
and with the plain roles, the same body runs eagerly.  On the card a solve
reads the host ``iterations + 1`` times (``HOST_READS_OUTSIDE_LOOP``: the
pair counts of ``camera_index``); each solve leaves a record in ``SOLVES``.

Every wrapper launches its kernel for CUDA tensors and runs its plain
version (``setup_plain``, ``matvec_plain``, ``backsub_plain``,
``cost_plain``: the kernel's arithmetic on tensors) for CPU tensors; nothing
gives way from the card to a plain version.  ``solve`` drives the wrappers,
``solve_plain`` the plain versions.

Layouts are the kernels': the point index is the last, fastest axis (points
(3, P), cam_slot (D, P), mask (D, P), uv (2D, P) with rows 2d, 2d+1), cameras
are one row each (``camera_rows``).  A slot is dead when its mask is 0 or
its camera index is outside [0, C): it adds exact zeros and its cam_slot is
never used as an index.  Points keep their input order: the JAX package's
sort of points by owning camera serves its chunk skipping and has no use
here.

Per-camera sums.  The TPU kernels scatter with one-hot matmuls into an
output that the sequential grid accumulates.  Here ``camera_index`` builds,
once per solve, the camera-major list of live (slot, point) pairs of
adjustable cameras (a stable sort, so the order is fixed) and a tile plan over
it (``_packed_plan``): segments of one camera each, in tiles of at most
``PAIR_TILE`` pairs; a camera of more pairs spans several tiles.  The
kernels' per-tile pass forms each pair's lanes in registers and sums each
segment in a fixed order; a camera that spans several segments has their
sums added in segment order (``tiled_camera_sum`` is that order on tensors,
for the tests).  No float atomics: two solves of one problem give the same
bits.  The kernels' outputs and scratch (the segments' sums, a counter per
camera, setup's Y, V^-1, z_p and reduction, the matvec's z and output,
backsub's dp, the cost's per-CTA partials, counter and output) are
allocated with it, so no role allocates on the card: each returns the
index's buffers, which its next call overwrites.

The shape gate.  ``D >= 1`` slots per point, ``0 <= n_fixed < C``,
``P >= 1``; the memory that lives between the passes of one LM iteration
(``scratch_bytes``: per slot of a point 18 floats of Y and its entry in the
pair list; per point V^-1, z_p, the matvec's z and dp, 15 floats; 54 floats
per segment of the tile plan, at most one per tile and one per camera; 2
floats per CTA of the cost) within ``SCRATCH_LIMIT_BYTES`` = 4 GiB; and a
pair index d*P + p inside an int32 (``D * P < 2**31``, the kernels'
``bad_shape``), which the scratch limit already implies (76 bytes per slot
of a point).  No bound on D: the per-point passes loop over a point's slots
at run time and the per-tile passes see pairs, not slots, so a point of 91
live slots is one thread's loop of 91.  The TPU gate's ``D <= 12`` and
``C <= 8192`` and its tile planner (``_plan``, ``_vmem_bytes``, the
live-chunk tables) answer VMEM limits and are not kept.
"""

from __future__ import annotations

import collections
import functools
import time
from typing import NamedTuple, Optional

import torch

from bundle_adjustment_tpu_torch import kernels
from bundle_adjustment_tpu_torch.ops import ba as ba_flat
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid, _inv6, _jtj, _mm, _mv
from bundle_adjustment_tpu_torch.ops.ba_kernel import _inv3_damped
from bundle_adjustment_tpu_torch.ops.lie import so3_exp, so3_exp_and_jac

SETUP = "ba_global_setup"
MATVEC = "ba_global_matvec"
BACKSUB = "ba_global_backsub"
COST = "ba_global_cost"

SCRATCH_LIMIT_BYTES = 4 << 30
#: pairs per tile of the per-camera sums (``camera_index``)
PAIR_TILE = 768
#: threads of the kernels' per-tile CTA (``kTileThreads``): the order of the
#: per-camera sums depends on it
TILE_THREADS = 256
#: (slot, point) pairs of one CTA of the cost kernel: one partial pair each
COST_PAIRS_PER_BLOCK = 512
#: host reads of a solve besides one per LM iteration: ``camera_index``'s
HOST_READS_OUTSIDE_LOOP = 1
_F32, _I32 = torch.float32, torch.int32

# lanes of the setup reduction, (C', 54): symmetric 6x6 blocks are packed as
# the 21 entries of their upper triangle
_TRI6 = [(i, j) for i in range(6) for j in range(i, 6)]
_TRI6_IDX = {ij: k for k, ij in enumerate(_TRI6)}
_RED_U = slice(0, 21)       # U upper triangle
_RED_GC = slice(21, 27)     # camera gradient
_RED_WZ = slice(27, 33)     # right-hand-side coupling W V^-1 g_p
_RED_DO = slice(33, 54)     # block-Jacobi W V^-1 W^T upper triangle
_RED_COLS = 54
_CAM_ROWS = 39              # R 9, dR 27, t 3
_CAMC_ROWS = 12             # R 9, t 3


def red_lane_groups() -> dict:
    """name -> lanes of the (C', 54) setup reduction that share one scale.  A
    camera's rotation lanes are larger than its translation lanes by about
    the scene's depth (its square in the rotation-rotation entries of a 6x6
    block), so a comparison of the reduction with another takes each group
    against its own largest value: ``U.rr``, ``U.rt``, ``U.tt`` (and the same
    of ``DO``), ``gc.r``, ``gc.t``, ``Wz.r``, ``Wz.t``."""
    groups = {}
    for name, sl in (("U", _RED_U), ("DO", _RED_DO)):
        for k, (i, j) in enumerate(_TRI6):
            part = "rr" if j < 3 else "tt" if i >= 3 else "rt"
            groups.setdefault(f"{name}.{part}", []).append(sl.start + k)
    for name, sl in (("gc", _RED_GC), ("Wz", _RED_WZ)):
        groups[f"{name}.r"] = list(range(sl.start, sl.start + 3))
        groups[f"{name}.t"] = list(range(sl.start + 3, sl.stop))
    return groups


@functools.lru_cache(maxsize=None)
def _sym6_index(device):
    """The gather index of ``_unpack_sym6`` on ``device``, made once: a CUDA
    graph's capture cannot copy it from the host."""
    return torch.tensor([[_TRI6_IDX[(min(i, j), max(i, j))] for j in range(6)]
                         for i in range(6)], device=device)


def _unpack_sym6(tri):
    """(..., 21) packed upper triangle -> (..., 6, 6) symmetric blocks."""
    return tri[..., _sym6_index(tri.device)]


def _cost_blocks(P: int, D: int) -> int:
    return -(-D * P // COST_PAIRS_PER_BLOCK)


def scratch_bytes(P: int, D: int, C: int = 1) -> int:
    """Bytes of Y, the pair list, V^-1, z_p, the matvec's z, dp, the tile
    carries and the cost's partials for (P, D) and C cameras (module
    docstring)."""
    n_seg = -(-D * P // PAIR_TILE) + C
    return 4 * (P * (D * (18 + 1) + 15) + _RED_COLS * n_seg + 2 * _cost_blocks(P, D))


def eligible_shape_global(C: int, P: int, D: int, n_fixed: int = 1) -> bool:
    """Whether the kernels take a problem of this shape (module docstring)."""
    if not (D >= 1 and 0 <= n_fixed < C and P >= 1 and D * P < 2 ** 31):
        return False
    return scratch_bytes(P, D, C) <= SCRATCH_LIMIT_BYTES


def kernel_eligible_global(grid: BAProblemGrid, n_fixed: int = 1) -> bool:
    P, D = grid.cam_slot.shape
    return eligible_shape_global(grid.rvecs.shape[0], P, D, n_fixed)


def role_work(g: BAProblemGrid, n_fixed: int) -> dict:
    """role -> (bytes, operations) of one launch on the grid ``g``, counted
    from its shapes and masks.  Bytes: every input read once, every output
    written once (scratch rows are neither).  Operations (a multiply and an
    add count one each):

    * setup, per live slot: residual 29, Huber weights 6, projection Jacobian
      8, point Jacobian 30, dXc/dr 45, camera Jacobian 30, V 36, g_p 18
      (202); per live slot of an adjustable camera: Y 108, U's upper triangle
      126, g_c 36, Y z_p 30, Y V^-1 90, the preconditioner's upper triangle
      105, the 54 adds of the camera sum; per point: damping and the 3x3
      inverse 50, z_p 15;
    * matvec, per live slot of an adjustable camera: Y^T x 36, Y z 30, the 6
      adds of the camera sum; per point V^-1 q 15;
    * backsub, per live slot of an adjustable camera 36; per point 21;
    * cost, per live slot: residual and rho 35."""
    C = g.rvecs.shape[0]
    P, D = g.cam_slot.shape
    c_adj = C - n_fixed
    live = (g.mask > 0) & (g.cam_slot >= 0) & (g.cam_slot < C)
    L = float(live.sum())
    La = float((live & (g.cam_slot >= n_fixed)).sum())
    grid_b = P * D * (4 + 4)                  # cam_slot, mask
    index_b = P * D * 4 + (c_adj + 1) * 4     # pairs, offsets
    y_b = 18 * D * P * 4
    return {
        SETUP: (
            C * 39 * 4 + P * 12 + grid_b + P * D * 8 + P * 4 + 32 + index_b
            + y_b + 9 * P * 4 + c_adj * 54 * 4,
            L * 202 + La * (108 + 126 + 36 + 30 + 90 + 105 + 54) + P * 65),
        MATVEC: (
            y_b + 6 * P * 4 + grid_b + index_b + 2 * c_adj * 24,
            La * (36 + 30 + 6) + P * 15),
        BACKSUB: (
            y_b + 9 * P * 4 + grid_b + c_adj * 24 + 3 * P * 4,
            La * 36 + P * 21),
        COST: (
            C * 12 * 4 + P * 12 + grid_b + P * D * 8 + 32 + 8,
            L * 35),
    }


class CameraIndex(NamedTuple):
    """The live (slot, point) pairs of adjustable cameras, camera-major, the
    tile plan over them, and the kernels' outputs and scratch for one solve."""
    pairs: torch.Tensor     # (D*P,) int32, entry d*P + p; the tail is unused
    offsets: torch.Tensor   # (C' + 1,) int32, camera a owns pairs[off[a]:off[a+1]]
    seg_start: torch.Tensor  # (n_seg + 1,) int32, segment k is pairs[start[k]:start[k+1]]
    seg_cam: torch.Tensor   # (n_seg,) int32, the camera of segment k
    tile_seg: torch.Tensor  # (n_tiles + 1,) int32, tile t holds segments [ts[t], ts[t+1])
    cam_seg: torch.Tensor   # (C' + 1,) int32, camera a owns segments [cs[a], cs[a+1])
    carry: torch.Tensor     # (n_seg, 54) scratch: segments' sums of cameras that span several
    ticket: torch.Tensor    # (C',) int32 counters, 0 between launches
    z: torch.Tensor         # (3, P) scratch of ``matvec``
    out: torch.Tensor       # (C', 6) ``matvec``'s output, overwritten by its next call
    Y: torch.Tensor         # (D*18, P) ``setup``'s outputs, Y ...
    Vinv: torch.Tensor      # (6, P) ... V^-1 ...
    zp: torch.Tensor        # (3, P) ... z_p ...
    red: torch.Tensor       # (C', 54) ... and the camera reduction
    dp: torch.Tensor        # (3, P) ``backsub``'s output
    cost_partial: torch.Tensor  # (n_cost_blocks, 2) scratch of ``cost``
    cost_ticket: torch.Tensor   # (1,) int32 counter, 0 between launches
    cost_out: torch.Tensor  # (2,) ``cost``'s output


def _packed_plan(counts, tile: int):
    """Segments and tiles for the per-camera pair counts ``counts``: a camera
    of more than ``tile`` pairs is cut into as few near-equal segments as
    keep each within ``tile``, each its own tile; the others are whole
    segments, packed in camera order into tiles of at most ``tile`` pairs.
    Returns (segment lengths, segment cameras, tile of each segment)."""
    seg_len, seg_cam, seg_tile = [], [], []
    t, fill = -1, tile
    for a, n in enumerate(counts):
        if n == 0:
            continue
        if n > tile:
            m = -(-n // tile)
            for i in range(m):
                t += 1
                seg_len.append(n // m + (i < n % m))
                seg_cam.append(a)
                seg_tile.append(t)
            fill = tile
            continue
        if fill + n > tile:
            t, fill = t + 1, 0
        seg_len.append(n)
        seg_cam.append(a)
        seg_tile.append(t)
        fill += n
    return seg_len, seg_cam, seg_tile


def camera_index(slotT, maskT, C: int, n_fixed: int, tile: int = PAIR_TILE) -> CameraIndex:
    """Built once per solve: cam_slot and mask do not change during one.
    Tiles of at most ``tile`` pairs (``_packed_plan``); one host read (the
    cameras' pair counts, counted in ``COUNTERS``)."""
    D, P = slotT.shape
    c_adj = C - n_fixed
    dev = slotT.device
    a = slotT.reshape(-1).long() - n_fixed
    ok = (maskT.reshape(-1) != 0) & (a >= 0) & (a < c_adj)
    key = torch.where(ok, a, torch.full_like(a, c_adj))
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=c_adj + 1)[:c_adj]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    seg_len, seg_cam, seg_tile = _packed_plan(_host_list(counts), tile)
    n_tiles = seg_tile[-1] + 1 if seg_tile else 0
    seg_cam = torch.tensor(seg_cam, dtype=torch.long)
    plan = dict(seg_start=torch.cumsum(torch.tensor([0] + seg_len), 0), seg_cam=seg_cam,
                tile_seg=torch.searchsorted(torch.tensor(seg_tile, dtype=torch.long),
                                            torch.arange(n_tiles + 1)),
                cam_seg=torch.searchsorted(seg_cam, torch.arange(c_adj + 1)))
    return CameraIndex(
        pairs=order.to(_I32).contiguous(), offsets=offsets.to(_I32).contiguous(),
        **{k: v.to(device=dev, dtype=_I32).contiguous() for k, v in plan.items()},
        carry=torch.empty((len(seg_len), _RED_COLS), dtype=_F32, device=dev),
        ticket=torch.zeros(c_adj, dtype=_I32, device=dev),
        z=torch.empty((3, P), dtype=_F32, device=dev),
        out=torch.empty((c_adj, 6), dtype=_F32, device=dev),
        Y=torch.empty((D * 18, P), dtype=_F32, device=dev),
        Vinv=torch.empty((6, P), dtype=_F32, device=dev),
        zp=torch.empty((3, P), dtype=_F32, device=dev),
        red=torch.empty((c_adj, _RED_COLS), dtype=_F32, device=dev),
        dp=torch.empty((3, P), dtype=_F32, device=dev),
        cost_partial=torch.empty((_cost_blocks(P, D), 2), dtype=_F32, device=dev),
        cost_ticket=torch.zeros(1, dtype=_I32, device=dev),
        cost_out=torch.empty(2, dtype=_F32, device=dev))


class Layout(NamedTuple):
    """The parts of a problem that one solve does not change, in the kernels'
    layouts, float32 and int32."""
    slotT: torch.Tensor     # (D, P) int32
    maskT: torch.Tensor     # (D, P)
    uvT: torch.Tensor       # (2D, P), rows 2d and 2d+1 are slot d's u and v
    pmask: torch.Tensor     # (P,) 1.0 for a point that may move
    scal: torch.Tensor      # (8,) fx, fy, cx, cy, lambda (0 here), Huber delta, 0, 0


def layout(grid: BAProblemGrid, huber_delta: float = 1.0) -> Layout:
    P, D = grid.cam_slot.shape
    K = grid.K.to(_F32)
    zero = K.new_zeros(())
    return Layout(
        slotT=grid.cam_slot.to(_I32).T.contiguous(),
        maskT=grid.mask.to(_F32).T.contiguous(),
        uvT=grid.uv.to(_F32).permute(1, 2, 0).reshape(2 * D, P).contiguous(),
        pmask=grid.point_mask.to(_F32).contiguous(),
        scal=torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2], zero,
                          K.new_tensor(float(huber_delta)), zero, zero]))


def with_lambda(scal, lam):
    """``scal`` with its lambda lane set from a float or a 0-d tensor."""
    lam = torch.as_tensor(lam, dtype=scal.dtype, device=scal.device)
    return torch.cat([scal[:4], lam.reshape(1), scal[5:]])


def camera_rows(rv, tv, with_jac: bool):
    """One row per camera: (C, 39) = R (9, row-major), dR (27, entry
    k*9 + i*3 + j = dR_ij/dr_k), t (3) with ``with_jac``; else (C, 12) = R, t."""
    C = rv.shape[0]
    if not with_jac:
        return torch.cat([so3_exp(rv).reshape(C, 9), tv], dim=1).contiguous()
    R, dR = so3_exp_and_jac(rv)                       # dR[c, i, j, k]
    return torch.cat([R.reshape(C, 9), dR.permute(0, 3, 1, 2).reshape(C, 27), tv],
                     dim=1).contiguous()


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _gather(table, slotT, maskT):
    """Per-slot camera rows (D, P, k), zeroed for dead slots, and the (D, P)
    float mask of live slots."""
    C = table.shape[0]
    live = (maskT != 0) & (slotT >= 0) & (slotT < C)
    cs = torch.where(live, slotT, torch.zeros_like(slotT)).long()
    live = live.to(table.dtype)
    return table[cs] * live[..., None], live


def _frame(Rg, tg, ptT, maskT, live, uvT, scal):
    """Camera-frame points (D, P, 3), the safe 1/z and masked residuals
    (D, P, 2) of every slot."""
    D, P = maskT.shape
    Xc = torch.sum(Rg * ptT.T[None, :, None, :], dim=-1) + tg
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / z_safe
    u = scal[0] * Xc[..., 0] * inv_z + scal[2]
    v = scal[1] * Xc[..., 1] * inv_z + scal[3]
    m = maskT * live
    r = (torch.stack([u, v], dim=-1) - uvT.reshape(D, 2, P).permute(0, 2, 1)) * m[..., None]
    return Xc, inv_z, m, r


def _camera_sum(rows, slotT, live, n_fixed: int, c_adj: int):
    """(D, P, k) rows -> (C', k): each live slot's row added to its camera,
    slots of gauge-fixed cameras dropped, in a fixed order."""
    a = slotT.long() - n_fixed
    idx = torch.where((live > 0) & (a >= 0), a, torch.full_like(a, c_adj))
    return ba_flat._segment_sum(rows.reshape(-1, rows.shape[-1]), idx.reshape(-1),
                                c_adj + 1)[:c_adj]


def tiled_camera_sum(rows, index: CameraIndex):
    """(D, P, k) rows -> (C', k) summed over the tile plan of ``index`` in the
    kernels' order (for the tests: the kernels form the rows in registers).
    In a segment, thread i of the tile's CTA adds the rows of the tile's
    pairs i, i + TILE_THREADS, ... that lie in the segment, the threads of a
    warp are summed pairwise across bit 4 of the lane index, then 3, 2, 1, 0,
    then the warps in order; a camera adds its segments' sums in order."""
    k = rows.shape[-1]
    flat = rows.reshape(-1, k)
    start, tile_seg = index.seg_start.tolist(), index.tile_seg.tolist()
    cam_seg = index.cam_seg.tolist()
    warps = TILE_THREADS // 32
    seg_sums = []
    for t in range(len(tile_seg) - 1):
        lo = start[tile_seg[t]]
        for s in range(tile_seg[t], tile_seg[t + 1]):
            a, b = start[s], start[s + 1]
            n_rounds = -(-(b - lo) // TILE_THREADS)
            grid = flat.new_zeros((n_rounds * TILE_THREADS, k))
            grid[a - lo:b - lo] = flat[index.pairs[a:b].long()]
            acc = flat.new_zeros((TILE_THREADS, k))
            for r in grid.reshape(n_rounds, TILE_THREADS, k):
                acc = acc + r
            w = acc.reshape(warps, 32, k)
            for half in (16, 8, 4, 2, 1):
                w = w[:, :half] + w[:, half:2 * half]
            total = flat.new_zeros(k)
            for j in range(warps):
                total = total + w[j, 0]
            seg_sums.append(total)
    out = flat.new_zeros((len(cam_seg) - 1, k))
    for c in range(len(cam_seg) - 1):
        for s in range(cam_seg[c], cam_seg[c + 1]):
            out[c] = out[c] + seg_sums[s]
    return out


def _vinv_matrix(VinvT):
    """(6, P) packed 00 01 02 11 12 22 -> (P, 3, 3)."""
    v = VinvT
    return torch.stack([v[0], v[1], v[2], v[1], v[3], v[4], v[2], v[4], v[5]],
                       dim=-1).reshape(-1, 3, 3)


def _y_blocks(YT, D: int):
    """(D*18, P) rows d*18 + i*3 + l -> (D, P, 6, 3)."""
    P = YT.shape[1]
    return YT.reshape(D, 18, P).permute(0, 2, 1).reshape(D, P, 6, 3)


def _x_slots(x, slotT, maskT, n_fixed: int):
    """Each slot's camera vector (D, P, 6); zeros for gauge-fixed cameras and
    dead slots."""
    table = torch.cat([x.new_zeros((n_fixed, 6)), x], dim=0)
    return _gather(table, slotT, maskT)


def _setup_rows(cam, ptT, slotT, maskT, uvT, pmask, scal, n_fixed: int):
    """The setup pass on tensors up to the camera sum: (Y (D*18, P), V^-1
    (6, P), z_p (3, P), the per-slot rows of the reduction (D, P, 54), the
    (D, P) live mask)."""
    D, P = slotT.shape
    g, live = _gather(cam, slotT, maskT)
    Rg = g[..., :9].reshape(D, P, 3, 3)
    dRg = g[..., 9:36].reshape(D, P, 3, 3, 3)                  # [k, i, j]
    Xc, inv_z, m, r = _frame(Rg, g[..., 36:], ptT, maskT, live, uvT, scal)
    lam, delta = scal[4], scal[5]
    a = torch.abs(r)
    w = torch.where(a <= delta, torch.ones_like(a), delta / torch.clamp(a, min=1e-12)) \
        * m[..., None]

    fx, fy = scal[0], scal[1]
    zeros = torch.zeros_like(inv_z)
    duv = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * Xc[..., 0] * inv_z * inv_z], dim=-1),
        torch.stack([zeros, fy * inv_z, -fy * Xc[..., 1] * inv_z * inv_z], dim=-1),
    ], dim=-2)                                                  # (D, P, 2, 3)
    Jp = torch.sum(duv[..., :, :, None] * Rg[..., None, :, :], dim=-2)
    dXdr = torch.sum(dRg * ptT.T[None, :, None, None, :], dim=-1)   # (D, P, k, i)
    Jr = torch.sum(duv[..., :, None, :] * dXdr[..., None, :, :], dim=-1)
    # gauge-fixed cameras: zero camera Jacobians before Y and U
    cam_ok = (slotT >= n_fixed).to(r.dtype)[..., None, None]
    Jc = torch.cat([Jr, duv], dim=-1) * cam_ok                  # (D, P, 2, 6)

    V = torch.sum(_jtj(Jp, Jp, w), dim=0)                       # (P, 3, 3)
    wr = w * r
    g_p = torch.sum(Jp * wr[..., None], dim=(0, 2))             # (P, 3)
    Vinv = _inv3_damped(V, lam, pmask)
    z_p = _mv(Vinv, g_p)
    Y = _jtj(Jc, Jp, w)                                         # (D, P, 6, 3)
    YV = _mm(Y, Vinv[None])
    iu = torch.tensor([i for i, _ in _TRI6], device=Y.device)
    ju = torch.tensor([j for _, j in _TRI6], device=Y.device)
    rows = torch.cat([
        _jtj(Jc, Jc, w)[..., iu, ju],
        torch.sum(Jc * wr[..., None], dim=-2),
        torch.sum(Y * z_p[None, :, None, :], dim=-1),
        torch.sum(YV[..., :, None, :] * Y[..., None, :, :], dim=-1)[..., iu, ju],
    ], dim=-1)                                                  # (D, P, 54)
    YT = Y.reshape(D, P, 18).permute(0, 2, 1).reshape(D * 18, P)
    VinvT = torch.stack([Vinv[:, 0, 0], Vinv[:, 0, 1], Vinv[:, 0, 2],
                         Vinv[:, 1, 1], Vinv[:, 1, 2], Vinv[:, 2, 2]])
    return YT.contiguous(), VinvT, z_p.T.contiguous(), rows, live


def setup_plain(cam, ptT, slotT, maskT, uvT, pmask, scal, n_fixed: int, index=None):
    """The setup pass on tensors (``index`` is the kernels' and is not
    read).  Returns (Y (D*18, P), V^-1 (6, P), z_p (3, P), red (C', 54))."""
    YT, VinvT, zpT, rows, live = _setup_rows(cam, ptT, slotT, maskT, uvT, pmask, scal, n_fixed)
    return YT, VinvT, zpT, _camera_sum(rows, slotT, live, n_fixed, cam.shape[0] - n_fixed)


def _coupling_z(YT, VinvT, slotT, maskT, x, n_fixed: int):
    """Y (D, P, 6, 3), the live mask and z = V^-1 sum_d Y_d^T x_cam(d), (P, 3)."""
    Y = _y_blocks(YT, slotT.shape[0])
    xs, live = _x_slots(x, slotT, maskT, n_fixed)
    q = torch.sum(Y * xs[..., None], dim=(0, 2))
    return Y, live, _mv(_vinv_matrix(VinvT), q)


def _matvec_rows(YT, VinvT, slotT, maskT, x, n_fixed: int):
    """The per-slot rows Y_d z (D, P, 6) of the coupling term and the live mask."""
    Y, live, z = _coupling_z(YT, VinvT, slotT, maskT, x, n_fixed)
    return torch.sum(Y * z[None, :, None, :], dim=-1), live


def matvec_plain(YT, VinvT, slotT, maskT, x, n_fixed: int, index=None):
    """The coupling term W V^-1 W^T x of S x, (C', 6); ``index`` is not read."""
    w2, live = _matvec_rows(YT, VinvT, slotT, maskT, x, n_fixed)
    return _camera_sum(w2, slotT, live, n_fixed, x.shape[0])


def backsub_plain(YT, VinvT, zpT, slotT, maskT, x, n_fixed: int, index=None):
    """dp (3, P) = -(z_p + V^-1 W^T x); ``index`` is not read."""
    _, _, z = _coupling_z(YT, VinvT, slotT, maskT, x, n_fixed)
    return -(zpT + z.T)


def cost_plain(camc, ptT, slotT, maskT, uvT, scal, index=None):
    """(2,): 0.5 * sum rho(r) with Huber rho, and sum r^2; ``index`` is not
    read."""
    D, P = slotT.shape
    g, live = _gather(camc, slotT, maskT)
    _, _, _, r = _frame(g[..., :9].reshape(D, P, 3, 3), g[..., 9:], ptT, maskT, live,
                        uvT, scal)
    return torch.stack([ba_flat.robust_cost(r, scal[5]), torch.sum(r * r)])


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _kind(*tensors) -> str:
    """"cpu" or "cuda": the one device type of all tensors, or ValueError."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tensors[0].device}")
    return kind


def _check(**named):
    """Each ``name=(tensor, shape, dtype)``: shape, dtype and contiguity."""
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _check_shape(C: int, P: int, D: int, n_fixed: int):
    if not eligible_shape_global(C, P, D, n_fixed):
        raise ValueError(f"problem of C={C}, P={P}, D={D}, n_fixed={n_fixed} is outside "
                         "the kernels' gate (eligible_shape_global)")


def _check_index(index: Optional[CameraIndex], D: int, P: int, c_adj: int, dev):
    """That ``index`` is a ``camera_index`` of this problem's shape on ``dev``
    (``camera_index`` builds all its parts together, contiguous int32 and
    float32; this runs once per CG iteration, so it checks only what ties
    the index to the problem)."""
    if index is None:
        raise ValueError("index: CUDA tensors need the camera_index of this problem")
    if (index.pairs.device != dev or index.pairs.shape != (D * P,)
            or index.cam_seg.shape != (c_adj + 1,) or index.z.shape != (3, P)
            or index.out.shape != (c_adj, 6)):
        raise ValueError(f"index: a camera_index of D={D}, P={P}, C'={c_adj} on {dev} expected, "
                         f"got pairs {tuple(index.pairs.shape)} on {index.pairs.device}, "
                         f"C'={index.cam_seg.shape[0] - 1}")


def _plan_args(index: CameraIndex):
    return (index.pairs, index.seg_start, index.seg_cam, index.tile_seg, index.cam_seg,
            index.carry, index.ticket)


#: host reads made by this module (``camera_index`` and the LM loop's stop
#: flag); ``SOLVES`` takes each solve's share
COUNTERS = {"host_reads": 0}
#: one record per solve, newest last: LM iterations, host reads, graph
#: replays, the live CG iterations and the stop code (``ba.STOP_TESTS``) as
#: device tensors (reading them is the caller's host read), and host
#: seconds of the first iteration, the capture and the replays, each up to
#: its read of the stop flag
SOLVES = collections.deque(maxlen=64)


def _host_list(t):
    COUNTERS["host_reads"] += 1
    return t.tolist()


def _host_bool(t) -> bool:
    COUNTERS["host_reads"] += 1
    return bool(t)


def _launch(name: str, dev, *args):
    """Launch kernel ``name`` on the current stream and count it
    (``kernels.count_launch``)."""
    fn = kernels.library_fn(name)
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(name, err)
    kernels.count_launch(name)


def setup(cam, ptT, slotT, maskT, uvT, pmask, scal, n_fixed: int,
          index: Optional[CameraIndex] = None):
    """The setup pass of one LM iteration.  Returns (Y (D*18, P), V^-1 (6, P),
    z_p (3, P), red (C', 54)); for CUDA tensors the index's buffers, which
    the next call overwrites."""
    if _kind(cam, ptT, slotT, maskT, uvT, pmask, scal) == "cpu":
        return setup_plain(cam, ptT, slotT, maskT, uvT, pmask, scal, n_fixed)
    C = cam.shape[0]
    D, P = slotT.shape
    _check_shape(C, P, D, n_fixed)
    _check(cam=(cam, (C, _CAM_ROWS), _F32), ptT=(ptT, (3, P), _F32),
           slotT=(slotT, (D, P), _I32), maskT=(maskT, (D, P), _F32),
           uvT=(uvT, (2 * D, P), _F32), pmask=(pmask, (P,), _F32), scal=(scal, (8,), _F32))
    dev = cam.device
    _check_index(index, D, P, C - n_fixed, dev)
    _launch(SETUP, dev, cam, ptT, slotT, maskT, uvT, pmask, scal, *_plan_args(index),
            C, P, D, n_fixed, index.tile_seg.shape[0] - 1, index.Y, index.Vinv, index.zp,
            index.red)
    return index.Y, index.Vinv, index.zp, index.red


def matvec(YT, VinvT, slotT, maskT, x, n_fixed: int, index: Optional[CameraIndex] = None):
    """The coupling term W V^-1 W^T x of one CG iteration, (C', 6).  For CUDA
    tensors the result is ``index.out``, which the next call overwrites; the
    call allocates nothing."""
    if _kind(YT, VinvT, slotT, maskT, x) == "cpu":
        return matvec_plain(YT, VinvT, slotT, maskT, x, n_fixed)
    c_adj = x.shape[0]
    D, P = slotT.shape
    _check_shape(c_adj + n_fixed, P, D, n_fixed)
    _check(YT=(YT, (D * 18, P), _F32), VinvT=(VinvT, (6, P), _F32),
           slotT=(slotT, (D, P), _I32), maskT=(maskT, (D, P), _F32), x=(x, (c_adj, 6), _F32))
    dev = x.device
    _check_index(index, D, P, c_adj, dev)
    _launch(MATVEC, dev, YT, VinvT, slotT, maskT, x, *_plan_args(index), c_adj + n_fixed, P, D,
            n_fixed, index.tile_seg.shape[0] - 1, index.z, index.out)
    return index.out


def backsub(YT, VinvT, zpT, slotT, maskT, x, n_fixed: int,
            index: Optional[CameraIndex] = None):
    """Point back-substitution dp (3, P) = -(z_p + V^-1 W^T x); for CUDA
    tensors ``index.dp``, which the next call overwrites."""
    if _kind(YT, VinvT, zpT, slotT, maskT, x) == "cpu":
        return backsub_plain(YT, VinvT, zpT, slotT, maskT, x, n_fixed)
    c_adj = x.shape[0]
    D, P = slotT.shape
    _check_shape(c_adj + n_fixed, P, D, n_fixed)
    _check(YT=(YT, (D * 18, P), _F32), VinvT=(VinvT, (6, P), _F32), zpT=(zpT, (3, P), _F32),
           slotT=(slotT, (D, P), _I32), maskT=(maskT, (D, P), _F32), x=(x, (c_adj, 6), _F32))
    dev = x.device
    _check_index(index, D, P, c_adj, dev)
    _launch(BACKSUB, dev, YT, VinvT, zpT, slotT, maskT, x, c_adj + n_fixed, P, D, n_fixed,
            index.dp)
    return index.dp


def cost(camc, ptT, slotT, maskT, uvT, scal, index: Optional[CameraIndex] = None):
    """(2,): the Huber cost (times 0.5) and the raw squared cost; for CUDA
    tensors ``index.cost_out``, which the next call overwrites."""
    if _kind(camc, ptT, slotT, maskT, uvT, scal) == "cpu":
        return cost_plain(camc, ptT, slotT, maskT, uvT, scal)
    C = camc.shape[0]
    D, P = slotT.shape
    _check_shape(C, P, D, 0)
    _check(camc=(camc, (C, _CAMC_ROWS), _F32), ptT=(ptT, (3, P), _F32),
           slotT=(slotT, (D, P), _I32), maskT=(maskT, (D, P), _F32),
           uvT=(uvT, (2 * D, P), _F32), scal=(scal, (8,), _F32))
    dev = camc.device
    if index is None or index.cost_partial.device != dev \
            or index.cost_partial.shape != (_cost_blocks(P, D), 2):
        raise ValueError(f"index: CUDA tensors need the camera_index of a problem of D={D}, "
                         f"P={P} on {dev}")
    _launch(COST, dev, camc, ptT, slotT, maskT, uvT, scal, C, P, D,
            index.cost_partial.shape[0], index.cost_partial, index.cost_ticket, index.cost_out)
    return index.cost_out


# ---------------------------------------------------------------------------
# the LM solve
# ---------------------------------------------------------------------------


class _Roles(NamedTuple):
    setup: object
    matvec: object
    backsub: object
    cost: object


_KERNELS = _Roles(setup, matvec, backsub, cost)
_PLAIN = _Roles(setup_plain, matvec_plain, backsub_plain, cost_plain)


class GlobalLM:
    """One global solve: its layout, ``camera_index`` (on the card), the LM
    state as tensors (``state``: rv, tv, ptT, lambda, cost, b0, blast, the
    ``ba.stop_code`` of the test that ended the loop, the live CG
    iterations) and ``body``, one LM iteration that updates the
    state in place and reads nothing on the host.  ``run`` loops; ``solve``
    is ``GlobalLM(...).run()``."""

    def __init__(self, grid: BAProblemGrid, n_fixed: int = 1, max_iterations: int = 50,
                 huber_delta: float = 1.0, lambda_init: float = 1e-3, lambda_up: float = 4.0,
                 lambda_down: float = 0.5, lambda_min: float = 1e-10, lambda_max: float = 1e8,
                 ftol: float = 1e-5, xtol: float = 1e-5, cg_iters: int = 8,
                 cg_tol: float = 1e-6, cg_forcing: bool = True, roles: _Roles = _KERNELS):
        _kind(*grid)
        C = grid.rvecs.shape[0]
        P, D = grid.cam_slot.shape
        if not eligible_shape_global(C, P, D, n_fixed) or cg_iters < 1:
            raise ValueError(f"problem of C={C}, P={P}, D={D}, n_fixed={n_fixed}, "
                             f"cg_iters={cg_iters} is outside the kernels' gate "
                             "(eligible_shape_global)")
        self.opts = dict(max_iterations=max_iterations, lambda_up=lambda_up,
                         lambda_down=lambda_down, lambda_min=lambda_min,
                         lambda_max=lambda_max, ftol=ftol, xtol=xtol, cg_iters=cg_iters,
                         cg_tol=cg_tol, cg_forcing=cg_forcing)
        self.n_fixed, self.roles = n_fixed, roles
        self.dev = dev = grid.rvecs.device
        reads = COUNTERS["host_reads"]
        self.lay = layout(grid, huber_delta)
        self.index = camera_index(self.lay.slotT, self.lay.maskT, C, n_fixed) \
            if dev.type == "cuda" else None
        self.eye6 = torch.eye(6, dtype=_F32, device=dev)
        # the state is updated in place: copies, never views of the caller's
        rv = grid.rvecs.to(_F32).clone()
        tv = grid.tvecs.to(_F32).clone()
        ptT = grid.points.to(_F32).T.clone(memory_format=torch.contiguous_format)
        init = self._cost(rv, tv, ptT)
        self.initial = (init[0].clone(), init[1].clone())
        self.state = dict(
            rv=rv, tv=tv, ptT=ptT, lam=torch.full((), lambda_init, dtype=_F32, device=dev),
            cost=init[0].clone(), b0=torch.full((), -1.0, dtype=_F32, device=dev),
            blast=torch.full((), -1.0, dtype=_F32, device=dev),
            stop=torch.zeros((), dtype=_I32, device=dev),
            cg_live=torch.zeros((), dtype=_I32, device=dev))
        self.reads_before = reads

    def _cost(self, rv, tv, ptT):
        lay = self.lay
        return self.roles.cost(camera_rows(rv, tv, False), ptT, lay.slotT, lay.maskT, lay.uvT,
                               lay.scal, self.index)

    def body(self):
        """One LM iteration, ``ba.lm_loop``'s, on the state in place: the
        forcing tolerance, setup, the camera algebra, masked CG, backsub,
        the trial cost, accept/reject, lambda, b0/blast and the stop code."""
        s, o, lay, roles, n_fixed, index = (self.state, self.opts, self.lay, self.roles,
                                            self.n_fixed, self.index)
        rv, tv, ptT, lam, cost_, b0, blast = (s[k] for k in ("rv", "tv", "ptT", "lam", "cost",
                                                               "b0", "blast"))
        if o["cg_forcing"]:
            tol = torch.where(
                b0 > 0.0,
                torch.clamp(torch.sqrt(blast / torch.clamp(b0, min=1e-30)),
                            min=o["cg_tol"], max=0.1),
                torch.full_like(b0, 0.1))
        else:
            tol = torch.full_like(b0, o["cg_tol"])
        YT, VinvT, zpT, red = roles.setup(camera_rows(rv, tv, True), ptT, lay.slotT, lay.maskT,
                                          lay.uvT, lay.pmask, with_lambda(lay.scal, lam),
                                          n_fixed, index)
        U = ba_flat._damp(_unpack_sym6(red[:, _RED_U]), lam)
        b = -red[:, _RED_GC] + red[:, _RED_WZ]
        Minv = _inv6(U - _unpack_sym6(red[:, _RED_DO]) + 1e-8 * self.eye6)

        def camera_matvec(x):
            return _mv(U, x) - roles.matvec(YT, VinvT, lay.slotT, lay.maskT, x.contiguous(),
                                            n_fixed, index)

        dc = ba_flat._pcg_blocked(camera_matvec, b, Minv, o["cg_iters"], tol, live=s["cg_live"])
        dpT = roles.backsub(YT, VinvT, zpT, lay.slotT, lay.maskT, dc.contiguous(), n_fixed,
                            index)
        d_r = torch.zeros_like(rv)
        d_t = torch.zeros_like(tv)
        d_r[n_fixed:] = dc[:, :3]
        d_t[n_fixed:] = dc[:, 3:]
        bnorm = torch.sqrt(torch.sum(b * b))
        b0.copy_(torch.where(b0 > 0.0, b0, bnorm))
        blast.copy_(bnorm)
        rv2, tv2, pt2 = rv + d_r, tv + d_t, ptT + dpT
        new_cost = self._cost(rv2, tv2, pt2)[0]
        accept = new_cost < cost_
        step_norm = torch.sqrt(torch.sum(d_r * d_r) + torch.sum(d_t * d_t)
                               + torch.sum(dpT * dpT))
        param_norm = torch.sqrt(torch.sum(rv * rv) + torch.sum(tv * tv)
                                + torch.sum(ptT * ptT))
        ftol_met = (cost_ - new_cost) <= o["ftol"] * torch.clamp(cost_, min=1e-12)
        xtol_met = step_norm <= o["xtol"] * (param_norm + o["xtol"])
        rv.copy_(torch.where(accept, rv2, rv))
        tv.copy_(torch.where(accept, tv2, tv))
        ptT.copy_(torch.where(accept, pt2, ptT))
        cost_.copy_(torch.where(accept, new_cost, cost_))
        lam.copy_(torch.where(accept, torch.clamp(lam * o["lambda_down"], min=o["lambda_min"]),
                              torch.clamp(lam * o["lambda_up"], max=o["lambda_max"])))
        stuck = (~accept) & (lam >= o["lambda_max"])
        s["stop"].copy_(ba_flat.stop_code(accept, ftol_met, xtol_met, stuck))

    def warm_up(self):
        """The body once, eagerly, on the stream that captures it, as a
        capture wants the first call of each operation on its stream to have
        been made (it loads every kernel and gives cuBLAS its workspace)."""
        kernels.on_side_stream(self.dev, self.body)

    def capture(self):
        """The body captured as a CUDA graph (nothing runs) and the launches
        of each kernel that one replay makes."""
        graph, _, per_replay = kernels.capture(self.dev, self.body)
        return graph, per_replay

    def run(self):
        """LM iterations until the stop flag or ``max_iterations``; one host
        read per iteration.  Kernel roles on the card: the first iteration
        eagerly on a side stream, then replays of the captured body.
        Returns (rvecs, tvecs, points, BAStats)."""
        graphed = self.dev.type == "cuda" and self.roles is _KERNELS
        graph, per_replay, replays, n = None, {}, 0, 0
        seconds = dict(first_s=0.0, capture_s=0.0, replay_s=0.0)
        t0 = time.perf_counter()
        while n < self.opts["max_iterations"]:
            if graph is not None:
                kernels.replay(graph, per_replay)
                replays += 1
            elif graphed:
                self.warm_up()
            else:
                self.body()
            n += 1
            stop = _host_bool(self.state["stop"])
            t1 = time.perf_counter()
            seconds["replay_s" if graph is not None else "first_s"] += t1 - t0
            t0 = t1
            if stop:
                break
            if graphed and graph is None and n < self.opts["max_iterations"]:
                graph, per_replay = self.capture()
                t0 = time.perf_counter()
                seconds["capture_s"] = t0 - t1
        s = self.state
        final_sq = self._cost(s["rv"], s["tv"], s["ptT"])[1].clone()
        SOLVES.append(dict(lm_iterations=n, graph_replays=replays,
                           host_reads=COUNTERS["host_reads"] - self.reads_before,
                           cg_iterations=s["cg_live"], stop=s["stop"], **seconds))
        stats = ba_flat.BAStats(
            initial_cost=self.initial[0], final_cost=s["cost"], initial_sq=self.initial[1],
            final_sq=final_sq, iterations=torch.tensor(n, dtype=torch.int32),
            accepted=s["cost"] < self.initial[0], stop=s["stop"])
        return s["rv"], s["tv"], s["ptT"].T.contiguous(), stats


def solve(grid: BAProblemGrid, n_fixed: int = 1, **opts):
    """Global BA of ``grid`` through the four kernels: CUDA tensors launch
    them (one CUDA graph per LM iteration), CPU tensors take their plain
    versions, any other device raises.  ``opts`` are ``GlobalLM``'s (the LM
    and CG settings, ``roles``).  Returns (rvecs, tvecs, points, BAStats),
    as ``ba_grid.ba_solve_grid_impl`` with ``cg_iters > 0``."""
    return GlobalLM(grid, n_fixed, **opts).run()


#: ``solve`` with every role's plain version, on whatever device the tensors
#: lie, eagerly: what the kernels are held against.
solve_plain = functools.partial(solve, roles=_PLAIN)
