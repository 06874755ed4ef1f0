"""Debug and run plots drawn with PyTorch on a device (port of
``bundle_adjustment_tpu.utils.viz``): trajectory plots, the BA sparsity spy,
match and keypoint overlays, depth-coloured keypoints.

The JAX package draws these with matplotlib and cv2, which the machine with
the card does not have.  Here an image is an (H, W, 3) uint8 BGR tensor on
the caller's device (a frame is one upload), every primitive of one call is
drawn in one vectorized pass (``Canvas.render``), and the PNG is written
with the standard library (``utils/io.write_png``).

Primitives: the anti-aliased 1-px stroke of ``cv2.line(..., 1, LINE_AA)``
and of ``cv2.circle(..., 1, LINE_AA)``, the 8-connected ring of
``cv2.circle(..., 1)``, filled discs (``thickness=-1``), squares,
triangles, rectangles and single pixels.  A pixel's coverage comes from the
distance of its centre to the stroke or to the shape's edge, not from cv2's
rasterizer bit for bit.  A pixel takes the colour of the last primitive
drawn over it (cv2's painter's order), blended over the image below by that
primitive's coverage: each pixel is first resolved to its highest primitive
index (``scatter_reduce`` with ``amax``), then that primitive's colour is
gathered, so two draws give equal bits on the card.  Random selections and
colours (``draw_matches``) and depth percentiles are drawn with numpy as
the JAX package draws them.

The plots are raster plots of the same data and marks as the JAX package's
matplotlib figures, at the same pixel size (figsize x dpi): the look differs,
the data is the same.  There is no font rasterizer: the title, axis labels
and legend that matplotlib would print go into the PNG's text chunks
(``utils/io.read_png_text``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from bundle_adjustment_tpu_torch import device as device_mod
from bundle_adjustment_tpu_torch.utils.io import write_png

#: cv2.COLORMAP_JET as a (256, 3) uint8 BGR table: each channel a trapezoid
#: in steps of 4 (``tests/test_torch_viz.py`` holds it to ``applyColorMap``)
JET = np.stack([
    np.r_[128 + 4 * np.arange(32), [255] * 64, 254 - 4 * np.arange(63), 1, [0] * 96],
    np.r_[[0] * 33, 4 * np.arange(1, 64), [255] * 64, 252 - 4 * np.arange(64), [0] * 32],
    np.r_[[0] * 96, 2 + 4 * np.arange(64), [255] * 64, 252 - 4 * np.arange(32)],
], axis=1).astype(np.uint8)

#: matplotlib's single-letter colours as BGR
BLUE, GREEN, RED, BLACK, WHITE = (255, 0, 0), (0, 128, 0), (0, 0, 255), (0, 0, 0), (255, 255, 255)
GRID = (176, 176, 176)
#: matplotlib's default subplot box, as fractions of the figure
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88)
#: matplotlib's default 3-D view, degrees
VIEW_ELEV, VIEW_AZIM = 30.0, -60.0

#: a 1-px anti-aliased line covers pixels whose centres lie within this many
#: pixels of it, linearly less with the distance (cv2's LINE_AA reaches
#: about 1.5 px); a ring, 1.25 px
_STROKE, _RING_STROKE = 1.5, 1.25
#: candidate pixels of a segment on each side of its ideal minor coordinate
_SEG_SPREAD = 2


class Canvas:
    """An (H, W, 3) uint8 BGR image on a device and the primitives queued
    on it.  Each ``add_*`` queues a batch; ``order`` (one int per primitive)
    sets the painter's order across batches, by default after everything
    queued so far.  ``render`` draws them all in one pass and returns the
    image on the host."""

    def __init__(self, image, device="cuda"):
        self.device = device_mod.resolve(device)
        # a copy: the caller's frame stays as it is (on the CPU as_tensor would share it)
        self.image = (image if isinstance(image, torch.Tensor)
                      else torch.tensor(np.asarray(image), device=self.device))
        if self.image.dtype != torch.uint8 or self.image.ndim != 3 or self.image.shape[2] != 3:
            raise ValueError(f"a canvas is (H, W, 3) uint8, got {tuple(self.image.shape)} "
                             f"{self.image.dtype}")
        self._batches = []
        self._next = 0

    @classmethod
    def blank(cls, height: int, width: int, device="cuda", color=WHITE) -> "Canvas":
        dev = device_mod.resolve(device)
        img = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
        img[:] = torch.tensor(color, dtype=torch.uint8)
        return cls(img, dev)

    # -- queueing ----------------------------------------------------------

    def _add(self, kind, n, colors, order, opacity, box=(0.0, 0.0), **params):
        if order is None:
            order = np.arange(self._next, self._next + n)
        order = np.asarray(order, np.int64).reshape(-1)
        if len(order) != n:
            raise ValueError(f"{kind}: {n} primitives but {len(order)} orders")
        if n:
            self._next = max(self._next, int(order.max()) + 1)
            colors = np.array(np.broadcast_to(np.asarray(colors, np.float32).reshape(-1, 3),
                                              (n, 3)))
            dev = self.device
            self._batches.append(dict(
                kind=kind, n=n, box=box, opacity=float(opacity),
                order=torch.as_tensor(order, device=dev),
                colors=torch.as_tensor(colors, device=dev),
                **{k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                   for k, v in params.items()}))
        return self

    def add_segments(self, p1, p2, colors, order=None, opacity=1.0):
        """Anti-aliased 1-px segments from ``p1`` to ``p2`` (n, 2) pixel
        coordinates (x, y), host arrays."""
        p1 = np.asarray(p1, np.float64).reshape(-1, 2)
        p2 = np.asarray(p2, np.float64).reshape(-1, 2)
        span = np.abs(p2 - p1).max(1) if len(p1) else np.zeros(0)
        return self._add("segment", len(p1), colors, order, opacity,
                         box=(float(np.ceil(span.max())) + 4 if len(p1) else 0.0, 0.0),
                         p1=p1, p2=p2)

    def add_rings(self, centers, radius: float, colors, order=None, aa=True):
        """Rings of ``radius`` around ``centers``: the anti-aliased stroke
        (``cv2.circle(..., 1, LINE_AA)``) or, with ``aa=False``, the
        8-connected ring of ``cv2.circle(..., 1)``: the pixels whose centres
        lie from radius - 0.8 to radius from the centre (cv2's pixel set
        at radius 3)."""
        c = np.asarray(centers, np.float64).reshape(-1, 2)
        ext = radius + _RING_STROKE + 1
        return self._add("ring" if aa else "ring8", len(c), colors, order, 1.0,
                         box=(ext, ext), c=c, r=np.full(len(c), radius))

    def add_discs(self, centers, radius: float, colors, order=None):
        """Filled anti-aliased discs (``cv2.circle(..., -1, LINE_AA)``, which
        fills out to radius + 0.5)."""
        c = np.asarray(centers, np.float64).reshape(-1, 2)
        ext = radius + 2
        return self._add("disc", len(c), colors, order, 1.0, box=(ext, ext), c=c,
                         r=np.full(len(c), radius))

    def add_squares(self, centers, half: float, colors, order=None):
        """Filled squares of side 2 * ``half`` (matplotlib's "s" marker)."""
        c = np.asarray(centers, np.float64).reshape(-1, 2)
        ext = half + 2
        return self._add("square", len(c), colors, order, 1.0, box=(ext, ext), c=c,
                         r=np.full(len(c), half))

    def add_triangles(self, centers, radius: float, colors, order=None):
        """Filled triangles pointing up, circumradius ``radius`` (the "^"
        marker)."""
        c = np.asarray(centers, np.float64).reshape(-1, 2)
        ext = radius + 2
        return self._add("triangle", len(c), colors, order, 1.0, box=(ext, ext), c=c,
                         r=np.full(len(c), radius))

    def add_rects(self, x0, y0, x1, y1, colors, order=None, opacity=1.0):
        """Filled axis-aligned rectangles over the pixel centres in
        [x0, x1] x [y0, y1]."""
        lo = np.stack([np.minimum(x0, x1), np.minimum(y0, y1)], 1).astype(np.float64)
        hi = np.stack([np.maximum(x0, x1), np.maximum(y0, y1)], 1).astype(np.float64)
        half = (hi - lo) / 2
        box = (float(half[:, 0].max()) + 2, float(half[:, 1].max()) + 2) if len(lo) else (0, 0)
        return self._add("rect", len(lo), colors, order, opacity, box=box,
                         c=(lo + hi) / 2, h=half)

    def add_pixels(self, xy, color, order=None):
        """Single pixels at the nearest integer positions of ``xy`` (n, 2),
        a host array or a tensor on the canvas's device."""
        n = int(xy.shape[0])
        return self._add("pixel", n, color, order, 1.0, c=xy)

    # -- drawing -----------------------------------------------------------

    def _candidates(self, b):
        """(pixel x, pixel y, primitive index, coverage) of batch ``b``."""
        kind, n, dev = b["kind"], b["n"], self.device
        if kind == "pixel":
            c = torch.round(b["c"])
            return c[:, 0], c[:, 1], torch.arange(n, device=dev), torch.ones(n, device=dev)
        if kind == "segment":
            return _segment_candidates(b["p1"], b["p2"], int(b["box"][0]))
        bx, by = int(math.ceil(b["box"][0])), int(math.ceil(b["box"][1]))
        c = b["c"]
        ox = torch.arange(-bx, bx + 1, device=dev, dtype=torch.float32)
        oy = torch.arange(-by, by + 1, device=dev, dtype=torch.float32)
        px = torch.round(c[:, 0])[:, None, None] + ox[None, None, :]
        py = torch.round(c[:, 1])[:, None, None] + oy[None, :, None]
        dx = px - c[:, 0, None, None]
        dy = py - c[:, 1, None, None]
        if kind == "rect":
            h = b["h"]
            sdf = torch.maximum(dx.abs() - h[:, 0, None, None], dy.abs() - h[:, 1, None, None])
            a = (sdf <= 0).float()
        else:
            r = b["r"][:, None, None]
            d = torch.hypot(dx, dy)
            if kind == "ring":
                a = (1 - (d - r).abs() / _RING_STROKE).clamp(0, 1)
            elif kind == "ring8":
                a = ((d >= r - 0.8) & (d <= r)).float()
            elif kind == "disc":
                a = (r + 1 - d).clamp(0, 1)
            elif kind == "square":
                a = (0.5 - (torch.maximum(dx.abs(), dy.abs()) - r)).clamp(0, 1)
            else:   # triangle, apex up (y grows downward): three edges
                s3 = math.sqrt(3) / 2
                sdf = torch.maximum(torch.maximum(dy - r / 2, s3 * dx - dy / 2 - r / 2),
                                    -s3 * dx - dy / 2 - r / 2)
                a = (0.5 - sdf).clamp(0, 1)
        idx = torch.arange(n, device=dev)[:, None, None].expand_as(a)
        return px.expand_as(a).reshape(-1), py.expand_as(a).reshape(-1), idx.reshape(-1), \
            a.reshape(-1)

    def render(self) -> np.ndarray:
        """Draw every queued primitive in one pass: each pixel takes the
        colour of its highest-ordered primitive, blended over the image by
        that primitive's coverage.  Returns the image on the host."""
        H, W = self.image.shape[:2]
        if self._batches:
            pix, order, alpha, colors = [], [], [], []
            for b in self._batches:
                x, y, i, a = self._candidates(b)
                a = a * b["opacity"]
                keep = (a > 0) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
                pix.append((y[keep] * W + x[keep]).long())
                order.append(b["order"][i[keep]])
                alpha.append(a[keep])
                colors.append((b["order"], b["colors"]))
            pix, order, alpha = torch.cat(pix), torch.cat(order), torch.cat(alpha)
            palette = torch.zeros((self._next, 3), device=self.device)
            for o, c in colors:
                palette[o] = c
            top = torch.full((H * W,), -1, dtype=torch.int64, device=self.device)
            top.scatter_reduce_(0, pix, order, reduce="amax")
            win = top[pix] == order
            pix, order, alpha = pix[win], order[win], alpha[win, None]
            flat = self.image.view(-1, 3)
            bg = flat[pix].float()
            flat[pix] = torch.floor(bg + (palette[order] - bg) * alpha + 0.5).clamp(0, 255) \
                .to(torch.uint8)
            self._batches = []
        return self.image.cpu().numpy()


def _segment_candidates(p1, p2, length: int):
    """Candidate pixels of anti-aliased segments: along each segment's major
    axis one step per pixel (one past each end), ``_SEG_SPREAD`` pixels on
    each side of the ideal minor coordinate; coverage from the distance of
    the pixel centre to the segment."""
    dev = p1.device
    n = p1.shape[0]
    d = p2 - p1
    steep = d[:, 1].abs() > d[:, 0].abs()
    a1 = torch.where(steep, p1[:, 1], p1[:, 0])
    a2 = torch.where(steep, p2[:, 1], p2[:, 0])
    b1 = torch.where(steep, p1[:, 0], p1[:, 1])
    b2 = torch.where(steep, p2[:, 0], p2[:, 1])
    slope = torch.where(a2 != a1, (b2 - b1) / torch.where(a2 != a1, a2 - a1, 1.0), 0.0)
    lo, hi = torch.minimum(a1, a2), torch.maximum(a1, a2)
    s = torch.arange(length + 1, device=dev, dtype=torch.float32)
    u = torch.floor(lo)[:, None] - 1 + s[None, :]                        # (n, L)
    on = u <= torch.ceil(hi)[:, None] + 1
    v_ideal = b1[:, None] + (torch.minimum(torch.maximum(u, lo[:, None]), hi[:, None])
                             - a1[:, None]) * slope[:, None]
    off = torch.arange(-_SEG_SPREAD, _SEG_SPREAD + 1, device=dev, dtype=torch.float32)
    v = torch.round(v_ideal)[:, :, None] + off                           # (n, L, k)
    u = u[:, :, None].expand_as(v)
    x = torch.where(steep[:, None, None], v, u)
    y = torch.where(steep[:, None, None], u, v)
    ex, ey = d[:, 0, None, None], d[:, 1, None, None]
    qx, qy = x - p1[:, 0, None, None], y - p1[:, 1, None, None]
    t = ((qx * ex + qy * ey) / (ex * ex + ey * ey).clamp_min(1e-12)).clamp(0, 1)
    dist = torch.hypot(qx - t * ex, qy - t * ey)
    a = (1 - dist / _STROKE).clamp(0, 1) * on[:, :, None]
    idx = torch.arange(n, device=dev)[:, None, None].expand_as(a)
    return x.reshape(-1), y.reshape(-1), idx.reshape(-1), a.reshape(-1)


# -- axes --------------------------------------------------------------------


def nice_ticks(lo: float, hi: float, target: int = 6) -> np.ndarray:
    """Round tick values (1, 2 or 5 times a power of ten apart) in [lo, hi]."""
    span = hi - lo
    if not span > 0:
        return np.asarray([lo])
    raw = span / target
    mag = 10 ** math.floor(math.log10(raw))
    step = mag * min((m for m in (1, 2, 5, 10) if m * mag >= raw), default=10)
    first = math.ceil(lo / step)
    return np.arange(first, math.floor(hi / step) + 1) * step


class LinearAxes:
    """A rectangle of a canvas of ``size`` (W, H) pixels, at matplotlib's
    default subplot position unless ``box`` (left, top, right, bottom in
    pixels) is given, showing x in ``xlim`` left to right and y in ``ylim``
    bottom to top (top to bottom with ``invert_y``)."""

    def __init__(self, size, xlim, ylim, box=None, invert_y=False):
        W, H = size
        self.box = box or (SUBPLOT["left"] * W, (1 - SUBPLOT["top"]) * H,
                           SUBPLOT["right"] * W, (1 - SUBPLOT["bottom"]) * H)
        self.xlim, self.ylim, self.invert_y = tuple(xlim), tuple(ylim), invert_y

    def to_px(self, x, y) -> np.ndarray:
        l, t, r, b = self.box
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        fx = (np.asarray(x, np.float64) - x0) / ((x1 - x0) or 1.0)
        fy = (np.asarray(y, np.float64) - y0) / ((y1 - y0) or 1.0)
        py = t + fy * (b - t) if self.invert_y else b - fy * (b - t)
        return np.stack([l + fx * (r - l), py], -1)

    def frame(self, canvas: Canvas):
        l, t, r, b = self.box
        corners = np.asarray([[l, t], [r, t], [r, b], [l, b]])
        canvas.add_segments(corners, np.roll(corners, -1, 0), BLACK)

    def grid(self, canvas: Canvas):
        """Grid lines at round ticks of both axes."""
        l, t, r, b = self.box
        xt, yt = nice_ticks(*sorted(self.xlim)), nice_ticks(*sorted(self.ylim))
        xs = self.to_px(xt, np.full(len(xt), self.ylim[0]))[:, 0]
        ys = self.to_px(np.full(len(yt), self.xlim[0]), yt)[:, 1]
        canvas.add_segments(np.stack([xs, np.full(len(xs), t)], 1),
                            np.stack([xs, np.full(len(xs), b)], 1), GRID)
        canvas.add_segments(np.stack([np.full(len(ys), l), ys], 1),
                            np.stack([np.full(len(ys), r), ys], 1), GRID)


def _equal_limits(x, y, box, margin: float = 0.05):
    """x and y limits around the data with equal units per pixel in the box
    (matplotlib's ``axis("equal")``), ``margin`` of the span on each side."""
    l, t, r, b = box
    xc, yc = (x.min() + x.max()) / 2, (y.min() + y.max()) / 2
    per_px = max((x.max() - x.min()) / (r - l), (y.max() - y.min()) / (b - t), 1e-9)
    per_px *= 1 + 2 * margin
    if per_px <= 1e-9 * (1 + 2 * margin):     # a single point
        per_px = 1.0 / min(r - l, b - t)
    hw, hh = per_px * (r - l) / 2, per_px * (b - t) / 2
    return (xc - hw, xc + hw), (yc - hh, yc + hh)


# -- plots -------------------------------------------------------------------


def plot_and_save_sparsity(cam_idx, pnt_idx, n_cams, n_pts, out_dir, tag, device="cuda"):
    """Spy plot of the BA Jacobian block structure from the observation
    table: 6 camera columns and 3 point columns per observation (``cam_idx``
    and ``pnt_idx`` host arrays or tensors, drawn where they are), one pixel
    per entry on a 600 x 600 canvas, residual rows downward."""
    dev = device_mod.resolve(device)
    cam = torch.as_tensor(cam_idx, device=dev).long()
    pnt = torch.as_tensor(pnt_idx, device=dev).long()
    n_obs = int(cam.shape[0])
    n_cols = max(n_cams * 6 + n_pts * 3, 1)
    W = H = 600
    ax = LinearAxes((W, H), (0, n_cols), (0, max(2 * n_obs, 1)), invert_y=True)
    cols = torch.cat([cam[:, None] * 6 + torch.arange(6, device=dev),
                      n_cams * 6 + pnt[:, None] * 3 + torch.arange(3, device=dev)], 1)
    rows = (torch.arange(n_obs, device=dev) * 2)[:, None].expand_as(cols)
    l, t, r, b = ax.box
    xy = torch.stack([l + (cols.reshape(-1).float() + 0.5) / n_cols * (r - l),
                      t + (rows.reshape(-1).float() + 0.5) / max(2 * n_obs, 1) * (b - t)], 1)
    canvas = Canvas.blank(H, W, dev)
    ax.frame(canvas)
    canvas.add_pixels(xy, BLACK)
    write_png(os.path.join(out_dir, f"sparsity_{tag}.png"), canvas.render(), text={
        "Title": f"BA sparsity {tag}: {n_obs} obs, {n_cams} cams, {n_pts} pts",
        "xlabel": "parameter columns", "ylabel": "residual rows",
        "xlim": f"0 {n_cols}", "ylim": f"{2 * n_obs} 0"})


def trajectory_2d_axes(trajectory, size=(800, 800)) -> LinearAxes:
    """The axes of ``plot_and_save_trajectory_2d``: X to the right, Z up,
    equal units per pixel."""
    t = np.asarray(trajectory, np.float64).reshape(-1, 3)
    ax = LinearAxes(size, (0, 1), (0, 1))
    if len(t):
        ax.xlim, ax.ylim = _equal_limits(t[:, 0], t[:, 2], ax.box)
    return ax


def plot_and_save_trajectory_2d(trajectory, out_dir, tag, device="cuda"):
    """Top-down X-Z path on an 800 x 800 canvas: a blue line with circle
    markers, a green square at the start, a red triangle at the latest
    position, a grid, equal aspect."""
    t = np.asarray(trajectory, np.float64).reshape(-1, 3)
    n = len(t)
    t = t[np.isfinite(t).all(1)]          # matplotlib leaves non-finite points out
    W = H = 800
    ax = trajectory_2d_axes(t, (W, H))
    canvas = Canvas.blank(H, W, device)
    ax.grid(canvas)
    ax.frame(canvas)
    text = {"Title": f"Trajectory (top-down) — {n} keyframes", "xlabel": "X",
            "ylabel": "Z", "xlim": " ".join(f"{v:.6g}" for v in ax.xlim),
            "ylim": " ".join(f"{v:.6g}" for v in ax.ylim)}
    if len(t):
        p = ax.to_px(t[:, 0], t[:, 2])
        canvas.add_segments(p[:-1], p[1:], BLUE)
        canvas.add_discs(p, 1.5, BLUE)
        canvas.add_squares(p[:1], 5.5, GREEN)
        canvas.add_triangles(p[-1:], 6.5, RED)
        text["legend"] = "start (green square), latest (red triangle)"
    write_png(os.path.join(out_dir, f"trajectory_2d_{tag}.png"), canvas.render(), text=text)


def trajectory_3d_projection(trajectory, size=(900, 900)) -> tuple:
    """``plot_and_save_trajectory_3d``'s map from data to pixels, a function
    of (m, 3) points, with the centre and half side of its cube: the
    orthographic view from matplotlib's default elevation and azimuth (Z
    up) of the equal-aspect bounding cube (centre of the path's box, half
    side the largest half extent, at least 0.5), scaled so that the cube
    fits the subplot box."""
    t = np.asarray(trajectory, np.float64).reshape(-1, 3)
    l, tp, r, b = LinearAxes(size, (0, 1), (0, 1)).box
    if len(t):
        mins, maxs = t.min(0), t.max(0)
        center, half = (mins + maxs) / 2, max((maxs - mins).max() / 2, 0.5)
    else:
        center, half = np.zeros(3), 0.5
    e, a = math.radians(VIEW_ELEV), math.radians(VIEW_AZIM)
    right = np.asarray([-math.sin(a), math.cos(a), 0.0])
    up = np.asarray([-math.sin(e) * math.cos(a), -math.sin(e) * math.sin(a), math.cos(e)])
    scale = min((r - l) / (2 * np.abs(right).sum()), (b - tp) / (2 * np.abs(up).sum()))
    cx, cy = (l + r) / 2, (tp + b) / 2

    def project(points):
        q = (np.asarray(points, np.float64).reshape(-1, 3) - center) / half
        return np.stack([cx + scale * (q @ right), cy - scale * (q @ up)], -1)

    return project, center, half


def plot_and_save_trajectory_3d(trajectory, rotations, out_dir, tag, device="cuda"):
    """3-D path on a 900 x 900 canvas, orthographic from matplotlib's
    default view, inside the equal-aspect bounding cube (its edges drawn):
    a blue line with circle markers and one red arrow of length 0.3 along
    each keyframe's camera Z axis (the third row of R)."""
    t = np.asarray(trajectory, np.float64).reshape(-1, 3)
    z = np.asarray([np.asarray(R, np.float64)[2, :] for R in rotations]).reshape(-1, 3)
    n = len(t)
    finite = np.isfinite(t).all(1) & np.isfinite(z).all(1)
    t, z = t[finite], z[finite]           # matplotlib leaves non-finite points out
    W = H = 900
    project, c, h = trajectory_3d_projection(t, (W, H))
    canvas = Canvas.blank(H, W, device)
    text = {"Title": f"Trajectory 3D — {n} keyframes", "xlabel": "X", "ylabel": "Y",
            "zlabel": "Z", "view": f"elev={VIEW_ELEV:g} azim={VIEW_AZIM:g}"}
    if len(t):
        corners = c + h * np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                                      for z in (-1, 1)], np.float64)
        edges = [(i, j) for i in range(8) for j in range(i + 1, 8)
                 if bin(i ^ j).count("1") == 1]
        pc = project(corners)
        canvas.add_segments(pc[[i for i, _ in edges]], pc[[j for _, j in edges]], GRID)
        p = project(t)
        canvas.add_segments(p[:-1], p[1:], BLUE)
        canvas.add_discs(p, 1.5, BLUE)
        tip = project(t + 0.3 * z)
        # the arrow head: two strokes back from the tip, 0.3 of the shaft, 30 degrees off
        back = p - tip
        heads = []
        for ang in (math.radians(30), -math.radians(30)):
            rot = np.asarray([[math.cos(ang), -math.sin(ang)], [math.sin(ang), math.cos(ang)]])
            heads.append(tip + 0.3 * back @ rot.T)
        canvas.add_segments(np.concatenate([p, tip, tip]),
                            np.concatenate([tip, heads[0], heads[1]]), RED)
        text.update(xlim=f"{c[0] - h:.6g} {c[0] + h:.6g}", ylim=f"{c[1] - h:.6g} {c[1] + h:.6g}",
                    zlim=f"{c[2] - h:.6g} {c[2] + h:.6g}")
    write_png(os.path.join(out_dir, f"trajectory_3d_{tag}.png"), canvas.render(), text=text)


# -- overlays ----------------------------------------------------------------


def match_selection(n: int, max_draw: int = 200):
    """``draw_matches``'s selection and colours, drawn from
    ``np.random.default_rng(0)`` in the JAX package's order: the permutation
    first, then one ``integers(64, 255, 3)`` per drawn match."""
    rng = np.random.default_rng(0)
    sel = rng.permutation(n)[:max_draw]
    colors = np.asarray([rng.integers(64, 255, 3) for _ in sel], np.int64).reshape(-1, 3)
    return sel, colors


def draw_matches(frame1, xy1, frame2, xy2, out_path, max_draw=200, device="cuda"):
    """Side-by-side match overlay: for each of at most ``max_draw`` matches,
    in a random order, an anti-aliased line and an 8-connected ring of radius
    3 at each end, in one random colour."""
    h = max(frame1.shape[0], frame2.shape[0])
    w = frame1.shape[1] + frame2.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: frame1.shape[0], : frame1.shape[1]] = frame1
    canvas[: frame2.shape[0], frame1.shape[1]:] = frame2
    off = frame1.shape[1]
    sel, colors = match_selection(len(xy1), max_draw)
    p1 = np.round(np.asarray(xy1, np.float64)[sel]).astype(np.int64)
    p2 = np.round(np.asarray(xy2, np.float64)[sel]).astype(np.int64) + [off, 0]
    k = 3 * np.arange(len(sel))
    c = Canvas(canvas, device)
    c.add_segments(p1, p2, colors, order=k)
    c.add_rings(p1, 3, colors, order=k + 1, aa=False)
    c.add_rings(p2, 3, colors, order=k + 2, aa=False)
    write_png(out_path, c.render())


def draw_keypoints(frame, xy, out_path, color=(0, 255, 0), device="cuda"):
    """Keypoint overlay: an anti-aliased ring of radius 3 at each keypoint."""
    p = np.round(np.asarray(xy, np.float64)).astype(np.int64).reshape(-1, 2)
    write_png(out_path, Canvas(frame, device).add_rings(p, 3, color).render())


def depth_colors(depths, pmin=5, pmax=95) -> np.ndarray:
    """The JET colour (BGR) of each depth, normalised between the ``pmin``
    and ``pmax`` percentiles."""
    depths = np.asarray(depths)
    lo, hi = np.percentile(depths, [pmin, pmax])
    norm = np.clip((depths - lo) / max(hi - lo, 1e-9), 0, 1)
    return JET[(norm * 255).astype(np.uint8)]


def draw_depth_overlay(frame, xy, depths, out_path, pmin=5, pmax=95, device="cuda"):
    """Percentile-normalised depth-coloured filled discs of radius 4."""
    canvas = Canvas(frame, device)
    if len(depths):
        p = np.round(np.asarray(xy, np.float64)).astype(np.int64).reshape(-1, 2)
        canvas.add_discs(p, 4, depth_colors(depths, pmin, pmax))
    write_png(out_path, canvas.render())


def two_panel_axes(size, x1, y1, x2, y2) -> tuple:
    """Two stacked linear axes over a canvas of ``size`` (W, H), as
    ``plt.subplots(2, 1)`` with ``tight_layout`` places them."""
    W, H = size
    l, r = 0.07 * W, 0.98 * W
    return (LinearAxes(size, x1, y1, box=(l, 0.05 * H, r, 0.46 * H)),
            LinearAxes(size, x2, y2, box=(l, 0.55 * H, r, 0.93 * H)))


def padded(lo: float, hi: float, margin: float = 0.05) -> tuple:
    """[lo, hi] widened by ``margin`` of its span on each side (1 when the
    span is 0), as matplotlib's autoscale pads its data."""
    span = hi - lo
    pad = margin * span if span > 0 else 1.0
    return lo - pad, hi + pad
