"""ORB-style feature detection + description (port of
``bundle_adjustment_tpu.ops.orb``).

Same pipeline, same static shapes: bilinear pyramid (JAX's antialiased
triangle weights), FAST-9 via 16 shifted compares and a bit-packed run test,
3x3 NMS, Harris re-ranking, fixed per-level budgets, intensity-centroid
orientation from dense moment maps, and steered rBRIEF as one matmul of
extracted patches against a +-1 pattern matrix with 2-bin soft steering.

Where the JAX package's float results depend on XLA's evaluation order, the
port reproduces that order, so the CPU paths agree bit for bit:

- ``_cumsum_xla``: XLA's CPU cumsum is a blocked prefix sum (16-element
  blocks, sequential inside a block, recursive over block totals); a plain
  sequential cumsum of the large Harris prefix sums rounds differently.
- ``lax.approx_max_k`` / ``lax.top_k`` break ties by lower index; the port
  uses a stable descending sort and slices it (``torch.topk`` promises no
  tie order).
- ``jnp.argsort`` is stable: ``stable=True``.

The patch gather goes through the K2 wrapper (``ops/orb_kernel.py``).  The
descriptor matmul after it stays a plain product, as the JAX package leaves
it to XLA; its operands are rounded to bf16 first (``_DESC_DTYPE``), which
is exact here because every pattern column holds one +1 and one -1.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bundle_adjustment_tpu_torch.ops import orb_kernel
from bundle_adjustment_tpu_torch.ops.brief_pattern import PATTERN as _BRIEF_PATTERN
from bundle_adjustment_tpu_torch.utils.stages import stage

_FAST_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

_PATCH_R = 15          # orientation disc radius
_SAMPLE_R = 18         # max |rotated BRIEF offset|
_PATCH = 2 * _SAMPLE_R + 1   # meaningful descriptor patch side (37)
_GRID = 40             # physical patch side (rows/cols 37..39 unused)
_BORDER = 19           # detection border (sampling radius + 1)
_NUM_PAIRS = 256
_NBINS = 30            # rBRIEF steering quantization: 12 degrees
_DESC_DTYPE = torch.bfloat16   # descriptor-matmul operand dtype
_DEDUP_CELL_PX = 3.0   # cross-level dedup cell (px at level 0)
_SCAN_BLOCK = 16       # XLA CPU cumsum block length


class Keypoints(NamedTuple):
    """SoA keypoint batch, fixed capacity N (padded, masked)."""

    xy: torch.Tensor        # (N, 2) f32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) f32 Harris response
    angle: torch.Tensor     # (N,) f32 radians
    size: torch.Tensor      # (N,) f32
    level: torch.Tensor     # (N,) i32 pyramid level
    desc: torch.Tensor      # (N, 8) i32 packed 256-bit descriptors
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def _edge_pad(img, top, bottom, left, right):
    return F.pad(img[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def _top_desc(x: torch.Tensor, k: int):
    """Largest k values, ties broken by lower index (lax.top_k's order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """cumsum with XLA CPU's rounding: sequential within blocks of 16,
    recursive prefix over the block totals, then one add per element."""
    x = torch.movedim(x, dim, -1)
    out = _blocked_cumsum_last(x)
    return torch.movedim(out, -1, dim)


def _seq_cumsum_last(x):
    parts = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        parts.append(parts[-1] + x[..., k])
    return torch.stack(parts, dim=-1)


def _blocked_cumsum_last(x):
    n = x.shape[-1]
    B = _SCAN_BLOCK
    if n <= B:
        return _seq_cumsum_last(x)
    nb = -(-n // B)
    xp = F.pad(x, (0, nb * B - n))
    inner = _seq_cumsum_last(xp.reshape(x.shape[:-1] + (nb, B)))
    carry = _blocked_cumsum_last(inner[..., -1])
    carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]], dim=-1)
    return (inner + carry[..., None]).reshape(x.shape[:-1] + (nb * B,))[..., :n]


@functools.lru_cache(maxsize=None)
def _gaussian_taps(sigma: float, ksize: int, device) -> torch.Tensor:
    """The normalised float32 Gaussian taps, once per device (a copy from
    host memory cannot be captured into a CUDA graph)."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return torch.as_tensor(k, device=device)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, ksize: int = 7) -> torch.Tensor:
    """Separable Gaussian blur, edge padding.  img: (H, W) f32."""
    r = ksize // 2
    kt = _gaussian_taps(sigma, ksize, img.device)
    H, W = img.shape
    p = _edge_pad(img, 0, 0, r, r)
    img_h = sum(p[:, i: i + W] * kt[i] for i in range(ksize))
    p = _edge_pad(img_h, r, r, 0, 0)
    return sum(p[i: i + H, :] * kt[i] for i in range(ksize))


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 corner score map: 0 where not a corner, else the arc-contrast
    magnitude used for NMS.  img: (H, W) f32 in [0, 255]."""
    H, W = img.shape
    p = _edge_pad(img, 3, 3, 3, 3)
    shifted = torch.stack(
        [p[3 + int(dy): 3 + int(dy) + H, 3 + int(dx): 3 + int(dx) + W]
         for dx, dy in _FAST_CIRCLE])
    bright = shifted > img[None] + threshold
    dark = shifted < img[None] - threshold

    def has_run9(masks):
        bits = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
        for i in range(16):
            bits = bits | (masks[i].to(torch.int32) << i)
        y = bits | (bits << 16)
        z = y & (y >> 1)
        z = z & (z >> 2)
        z = z & (z >> 4)
        z = z & (z >> 1)
        return z != 0

    corner = has_run9(bright) | has_run9(dark)
    diff = shifted - img[None]
    bright_mag = torch.sum(torch.clamp(diff - threshold, min=0.0), dim=0)
    dark_mag = torch.sum(torch.clamp(-diff - threshold, min=0.0), dim=0)
    return torch.where(corner, torch.maximum(bright_mag, dark_mag), 0.0)


def harris_response(img: torch.Tensor, k: float = 0.04, block: int = 7) -> torch.Tensor:
    """Dense Harris corner response (Sobel gradients, box-summed products)."""
    p = _edge_pad(img, 1, 1, 1, 1)
    gx = (
        (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    ) * 0.125
    gy = (
        (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    ) * 0.125

    def box(a):
        r = block // 2
        pa = _edge_pad(a, r, r, r, r)
        c = _cumsum_xla(_cumsum_xla(pa, 0), 1)
        c = F.pad(c, (1, 0, 1, 0))
        H, W = a.shape
        return (c[block: block + H, block: block + W] - c[:H, block: block + W]
                - c[block: block + H, :W] + c[:H, :W])

    sxx, syy, sxy = box(gx * gx), box(gy * gy), box(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """Keep strict local maxima over a 3x3 neighborhood."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score == m) & (score > 0), score, 0.0)


def _moment_maps(img: torch.Tensor):
    """Dense intensity-centroid moments (m10, m01) over the radius-15 disc at
    every pixel, by incremental-width ramp/box x-filters (see the JAX
    docstring); same order of additions."""
    H, W = img.shape
    r = _PATCH_R
    p = _edge_pad(img, r, r, r, r)
    widths = [int(np.floor(np.sqrt(r * r - dy * dy))) for dy in range(r + 1)]

    def xs(j):
        return p[:, r + j: r + j + W]

    ramp = [torch.zeros((H + 2 * r, W), dtype=img.dtype, device=img.device)]
    box = [xs(0)]
    for j in range(1, r + 1):
        ramp.append(ramp[-1] + float(j) * (xs(j) - xs(-j)))
        box.append(box[-1] + xs(j) + xs(-j))

    m10 = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    m01 = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    for dy in range(-r, r + 1):
        w = widths[abs(dy)]
        if w > 0:
            m10 = m10 + ramp[w][r + dy: r + dy + H, :]
        if dy != 0:
            m01 = m01 + float(dy) * box[w][r + dy: r + dy + H, :]
    return m10, m01


def _detect_level(img_f32, threshold, budget, border=_BORDER):
    """One pyramid level: FAST -> NMS -> Harris re-rank -> top-`budget`.
    Returns (xy (B, 2) [x, y], harris (B,), angle (B,), valid (B,),
    desc (B, 8))."""
    H, W = img_f32.shape
    dev = img_f32.device
    with stage("blur"):
        blurred = gaussian_blur(img_f32)
    with stage("fast"):
        fast = fast_score_map(img_f32, threshold)
    with stage("nms"):
        score = _nms3(fast)
    with stage("harris"):
        ys = torch.arange(H, device=dev)[:, None]
        xs = torch.arange(W, device=dev)[None, :]
        in_border = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
        harris = harris_response(img_f32)
        rank = torch.where((score > 0) & in_border, harris, -torch.inf)

    with stage("topk"):
        # lax.approx_max_k is exact off the TPU; ties go to the lower index
        top_vals, top_idx = _top_desc(rank.reshape(-1), budget)
        valid = torch.isfinite(top_vals)
        yx = torch.stack([top_idx // W, top_idx % W], dim=1)

    def score_at(dy, dx):
        return score[torch.clamp(yx[:, 0] + dy, 0, H - 1),
                     torch.clamp(yx[:, 1] + dx, 0, W - 1)]

    def subpixel_offset(s_minus, s_plus):
        denom = s_minus - 2.0 * s0 + s_plus
        denom = torch.where(torch.abs(denom) < 1e-6, 1e-6, denom)
        return torch.clamp(0.5 * (s_minus - s_plus) / denom, -0.5, 0.5)

    with stage("subpixel"):
        s0 = score_at(0, 0)
        off_x = subpixel_offset(score_at(0, -1), score_at(0, 1))
        off_y = subpixel_offset(score_at(-1, 0), score_at(1, 0))

    with stage("moments"):
        m10, m01 = _moment_maps(img_f32)
        flat = yx[:, 0] * W + yx[:, 1]
        angle = torch.arctan2(m01.reshape(-1)[flat], m10.reshape(-1)[flat])

    with stage("describe"):
        desc = _describe(blurred, yx, angle)
        xy = torch.stack([yx[:, 1] + off_x, yx[:, 0] + off_y], dim=1).to(torch.float32)
    return xy, top_vals, angle, valid, desc


@functools.lru_cache(maxsize=1)
def _pattern_matrix() -> np.ndarray:
    """(GRID*GRID, NBINS*256) +-1 descriptor-sampling matrix: column (q, j)
    is onehot(rotated point b) - onehot(rotated point a) for steering bin q
    (see the JAX docstring)."""
    D = np.zeros((_GRID * _GRID, _NBINS * _NUM_PAIRS), np.float32)
    pat = _BRIEF_PATTERN.astype(np.float64)
    px, py = pat[..., 0], pat[..., 1]
    for q in range(_NBINS):
        th = 2.0 * np.pi * q / _NBINS
        c, s = np.cos(th), np.sin(th)
        ox = np.round(px * c - py * s).astype(np.int64)
        oy = np.round(px * s + py * c).astype(np.int64)
        cell = (oy + _SAMPLE_R) * _GRID + (ox + _SAMPLE_R)
        cols = q * _NUM_PAIRS + np.arange(_NUM_PAIRS)
        np.add.at(D, (cell[:, 1], cols), 1.0)
        np.add.at(D, (cell[:, 0], cols), -1.0)
    return D


_pattern_on_device: dict = {}


def _pattern_tensor(device) -> torch.Tensor:
    key = str(device)
    if key not in _pattern_on_device:
        _pattern_on_device[key] = torch.as_tensor(_pattern_matrix(), device=device)
    return _pattern_on_device[key]


def _extract_patches(blurred, start_y, start_x):
    """(B, 40, 40) f32 patches centered at 128, through the K2 wrapper."""
    return orb_kernel.gather_patches40(blurred, start_y, start_x)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, 256) bool -> (B, 8) int32 words, bit l of word w = bits[32 w + l]."""
    lane = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(-1, 8, 32).to(torch.int64) << lane).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _describe(blurred, yx, angle):
    """Steered BRIEF: one patch per keypoint, all 256 pair tests for every
    12-degree bin as one matmul against the pattern matrix, 2-bin soft
    steering, packed to (B, 8) int32 words."""
    H, W = blurred.shape
    start_y = torch.clamp(yx[:, 0] - _SAMPLE_R, 0, H - _PATCH).to(torch.int32)
    start_x = torch.clamp(yx[:, 1] - _SAMPLE_R, 0, W - _PATCH).to(torch.int32)

    with stage("K2 gather"):
        patches = _extract_patches(blurred, start_y, start_x)      # (B, 40, 40)
    pm = patches.reshape(-1, _GRID * _GRID).to(_DESC_DTYPE).to(torch.float32)
    vals = torch.matmul(pm, _pattern_tensor(blurred.device)).reshape(
        -1, _NBINS, _NUM_PAIRS)

    a = angle * (_NBINS / (2.0 * np.pi))
    q0 = torch.floor(a).to(torch.int64)
    t = (a - q0.to(a.dtype))[:, None]
    w = (F.one_hot(torch.remainder(q0, _NBINS), _NBINS).to(vals.dtype) * (1 - t)
         + F.one_hot(torch.remainder(q0 + 1, _NBINS), _NBINS).to(vals.dtype) * t)
    sel = torch.einsum("bq,bqj->bj", w, vals)
    return _pack_bits(sel > 0)


def level_budgets(num_features: int, levels: int, scale: float) -> list[int]:
    """Per-level keypoint budgets, geometric in 1/scale^2 (OpenCV's split)."""
    f = 1.0 / (scale * scale)
    raw = np.array([f ** i for i in range(levels)])
    raw = raw / raw.sum() * num_features
    b = np.maximum(np.round(raw).astype(int), 1)
    b[0] += num_features - b.sum()
    return [int(x) for x in b]


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of jax.image.resize's
    antialiased bilinear (triangle) kernel (compute_weight_mat), with the
    column sums taken in increasing row order; built once per (in, out,
    device) and shared (callers do not write to it)."""
    f32 = torch.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
                * inv_scale - 0.0 * inv_scale - 0.5)
    rows = torch.arange(in_size, dtype=f32, device=device)
    x = torch.abs(sample_f[None, :] - rows[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    # column sums in row order over the few nonzero rows of each column
    nz = weights > 0
    first = torch.where(nz.any(dim=0), nz.to(torch.int8).argmax(dim=0),
                        torch.zeros(out_size, dtype=torch.int64, device=device))
    span = int(math.ceil(2.0 * kernel_scale)) + 2
    total = torch.zeros(out_size, dtype=f32, device=device)
    cols = torch.arange(out_size, device=device)
    for k in range(span):
        r = first + k
        ok = r < in_size
        total = total + torch.where(ok, weights[r.clamp(max=in_size - 1), cols], 0.0)
    total = total[None, :]
    eps32 = float(np.finfo(np.float32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps32,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """jax.image.resize(img, out_hw, "bilinear") for a 2-D float32 image:
    separable antialiased triangle weights, contracted as two matmuls."""
    H, W = img.shape
    h, w = out_hw
    wy = _resize_weights(H, h, img.device)          # (H, h)
    wx = _resize_weights(W, w, img.device)          # (W, w)
    return torch.matmul(torch.matmul(wy.T, img), wx)


def extract(
    image_u8: torch.Tensor,
    *,
    num_features: int = 4000,
    levels: int = 8,
    scale: float = 1.2,
    threshold: float = 20.0,
    height: int = 720,
    width: int = 1280,
    overdetect: float = 1.6,
) -> Keypoints:
    """Detect + describe up to ``num_features`` keypoints.  image_u8: (H, W)
    uint8 grayscale on the device to run on.  Returns a fixed-capacity
    Keypoints SoA (invalid slots masked)."""
    with stage("pyramid"):
        img0 = image_u8.to(torch.float32)
    dev = img0.device
    budgets = level_budgets(int(num_features * overdetect), levels, scale)

    parts = []
    img = img0
    for lvl in range(levels):
        sf = scale ** lvl
        h, w = max(int(round(height / sf)), 64), max(int(round(width / sf)), 64)
        if lvl > 0:
            with stage("pyramid"):
                img = resize_bilinear(img0, (h, w))
        xy, resp, ang, valid, desc = _detect_level(img, threshold, budgets[lvl])
        with stage("dedup + select"):
            parts.append((xy * sf, resp, ang, torch.full_like(resp, 31.0 * sf),
                          torch.full(resp.shape, lvl, dtype=torch.int32, device=dev),
                          desc, valid))
    with stage("dedup + select"):
        return _dedup_select(parts, num_features, height, width)


def _dedup_select(parts, num_features: int, height: int, width: int) -> Keypoints:
    """The levels' keypoints concatenated, deduplicated across levels and
    the best ``num_features`` kept."""
    xy, resp, ang, size, lvl, desc, valid = (
        torch.cat([p[i] for p in parts]) for i in range(7))
    dev = xy.device

    # cross-level dedup: keep the highest-response keypoint per 3 px cell
    if _DEDUP_CELL_PX > 0:
        cp = _DEDUP_CELL_PX
        cell_w = int((width + 2) // cp) + 1
        cell_h = int((height + 2) // cp) + 1
        cell = (torch.clamp((xy[:, 1] / cp).to(torch.int32), 0, cell_h - 1) * cell_w
                + torch.clamp((xy[:, 0] / cp).to(torch.int32), 0, cell_w - 1)).long()
        n = resp.shape[0]
        order = torch.argsort(torch.where(valid, -resp, torch.inf), stable=True)
        rank = torch.zeros(n, dtype=torch.int64, device=dev)
        rank[order] = torch.arange(n, device=dev)
        score = -rank
        cell_best = torch.full((cell_h * cell_w,), -(2 ** 62), dtype=torch.int64,
                               device=dev)
        cell_best = cell_best.scatter_reduce(0, cell, score, reduce="amax")
        valid = valid & (score == cell_best[cell])

    sel_score = torch.where(valid, resp, -torch.inf)
    _, sel = _top_desc(sel_score, num_features)
    return Keypoints(
        xy=xy[sel], response=resp[sel], angle=ang[sel], size=size[sel],
        level=lvl[sel], desc=desc[sel],
        valid=valid[sel] & torch.isfinite(sel_score[sel]),
    )
