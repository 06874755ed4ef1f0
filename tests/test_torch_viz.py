"""The port's drawing (``bundle_adjustment_tpu_torch.utils.viz``) and PNG
writer against the JAX package's matplotlib and cv2 outputs, on the CPU.

- ``write_png`` decodes to its input through the port's ``read_png`` and
  through ``cv2.imread``, and its text chunks read back;
- the port's JET table equals ``cv2.applyColorMap(arange(256), COLORMAP_JET)``;
- ``draw_keypoints``, ``draw_matches`` and ``draw_depth_overlay`` on a
  1280x720 frame of the JAX package's synthetic render, at the ORB keypoints
  that cv2 finds on it (as the pipeline draws its keypoints), against the
  JAX functions' cv2 output: the masks of changed pixels are within a
  symmetric Hausdorff distance of 1 px; the centre pixel of every disc that
  no later disc overlaps has the JAX colour exactly; the match selection and
  colours equal the JAX function's (the ring pixel right of each match's
  first end, where no later match reaches, has the same colour in both
  images).  cv2's anti-aliasing is its own rasterizer and is not copied, so
  the blended values are not compared.  OpenCV 5 reads the 1-D array that
  the JAX ``draw_depth_overlay`` hands to ``applyColorMap`` as one row, so
  there only its first disc is coloured (the port colours each, ROADMAP
  Queue 3): the JAX function runs here with that array given as a column;
- the 2-D and 3-D plots of a map carried from a JAX run by
  ``convert.map_store``: the same trajectory and rotations as the JAX map's,
  each keyframe's marker at its predicted pixel (X right, Z up at one scale;
  the 3-D plot an orthographic view from elevation 30 and azimuth -60);
- two draws give equal bits;
- the titles in the text chunks carry the numbers of the JAX package's
  matplotlib titles.
"""

import math

import cv2
import matplotlib.axes
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

import bundle_adjustment_tpu.config as jcfg
from bundle_adjustment_tpu.models.pipeline import VisualOdometryPipeline as JaxPipeline
from bundle_adjustment_tpu.utils import viz as jviz
from bundle_adjustment_tpu.utils.event_log import EventLog as JaxEventLog
from bundle_adjustment_tpu.utils.synthetic import synthetic_sequence
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.utils import io, viz

torch.set_num_threads(1)


def test_write_png_decodes_to_its_input(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    img[5:20, 10:40] = 200
    path = str(tmp_path / "sub" / "a.png")
    text = {"Title": "Trajectory (top-down) — 5 keyframes", "xlabel": "X"}
    io.write_png(path, img, text=text)
    np.testing.assert_array_equal(io.read_png(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)
    assert io.read_png_text(path) == text
    with pytest.raises(ValueError, match="uint8"):
        io.write_png(path, img.astype(np.float32))


def test_jet_table_equals_cv2():
    ref = cv2.applyColorMap(np.arange(256, dtype=np.uint8).reshape(-1, 1), cv2.COLORMAP_JET)
    np.testing.assert_array_equal(viz.JET, ref[:, 0])


@pytest.fixture(scope="module")
def scene():
    frames, _, _, _ = synthetic_sequence(n_frames=2, width=1280, height=720, seed=0)
    orb = cv2.ORB_create(4000)
    kps = [np.asarray([k.pt for k in orb.detect(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY), None)])
           for f in frames]
    return frames, kps


def _changed(img, base):
    return (img != base).any(2)


def _hausdorff(a, b) -> float:
    da, db = distance_transform_edt(~a), distance_transform_edt(~b)
    return max(db[a].max(initial=0), da[b].max(initial=0))


def _later_within(p, r):
    """For each of the points ``p`` (in drawing order), whether a later one
    lies within ``r`` px (Chebyshev)."""
    d = np.abs(p[:, None, :] - p[None, :, :]).max(-1)
    return np.triu(d <= r, k=1).any(1)


def _jax_depth_overlay(frame, xy, depths, path, monkeypatch):
    apply = cv2.applyColorMap
    monkeypatch.setattr(cv2, "applyColorMap", lambda a, m: apply(a.reshape(-1, 1), m))
    jviz.draw_depth_overlay(frame, xy, depths, path)
    monkeypatch.setattr(cv2, "applyColorMap", apply)


@pytest.mark.parametrize("what", ["keypoints", "matches", "depth"])
def test_overlays_match_jax(scene, tmp_path, monkeypatch, what):
    (f1, f2), (k1, k2) = scene
    j, t = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    if what == "keypoints":
        jviz.draw_keypoints(f1, k1, j)
        viz.draw_keypoints(f1, k1, t, device="cpu")
        base = f1
    elif what == "matches":
        n = min(len(k1), len(k2))
        jviz.draw_matches(f1, k1[:n], f2, k2[:n], j)
        viz.draw_matches(f1, k1[:n], f2, k2[:n], t, device="cpu")
        base = np.concatenate([f1, f2], 1)
    else:
        depths = np.random.default_rng(1).uniform(1.0, 12.0, len(k1))
        _jax_depth_overlay(f1, k1, depths, j, monkeypatch)
        viz.draw_depth_overlay(f1, k1, depths, t, device="cpu")
        base = f1
    ja, ta = cv2.imread(j), io.read_png(t)
    assert ta.shape == ja.shape == base.shape
    mj, mt = _changed(ja, base), _changed(ta, base)
    assert mj.sum() > 1000 and mt.sum() > 1000
    assert _hausdorff(mj, mt) <= 1.0
    if what == "depth":
        p = np.round(k1).astype(int)
        alone = ~_later_within(p, 10)
        colors = viz.depth_colors(depths)
        x, y = p[alone, 0], p[alone, 1]
        np.testing.assert_array_equal(ta[y, x], ja[y, x])
        np.testing.assert_array_equal(ta[y, x], colors[alone])
    if what == "matches":
        sel, colors = viz.match_selection(n)
        p1 = np.round(k1[:n][sel]).astype(int)
        p2 = np.round(k2[:n][sel]).astype(int) + [f1.shape[1], 0]
        ring = p1 + [3, 0]
        # no later line's box, nor later ring, reaches the pixel
        lo, hi = np.minimum(p1, p2) - 3, np.maximum(p1, p2) + 3
        covered = np.asarray([((ring[i] >= lo[i + 1:]) & (ring[i] <= hi[i + 1:])).all(1).any()
                              for i in range(len(sel))])
        free = ~covered
        assert free.sum() >= 5
        x, y = ring[free, 0], ring[free, 1]
        np.testing.assert_array_equal(ja[y, x], colors[free])
        np.testing.assert_array_equal(ta[y, x], colors[free])


def test_two_draws_are_bit_equal(scene, tmp_path):
    (f1, f2), (k1, k2) = scene
    n = min(len(k1), len(k2))
    outs = []
    for i in range(2):
        path = str(tmp_path / f"m{i}.png")
        viz.draw_matches(f1, k1[:n], f2, k2[:n], path, device="cpu")
        with open(path, "rb") as fh:
            outs.append(fh.read())
    assert outs[0] == outs[1]
    traj = np.random.default_rng(0).normal(size=(7, 3))
    rots = [np.eye(3)] * 7
    for i in range(2):
        viz.plot_and_save_trajectory_3d(traj, rots, str(tmp_path / f"t{i}"), "x", device="cpu")
    assert io.read_png(str(tmp_path / "t0" / "trajectory_3d_x.png")).tobytes() \
        == io.read_png(str(tmp_path / "t1" / "trajectory_3d_x.png")).tobytes()


@pytest.fixture(scope="module")
def jax_run():
    """A JAX pipeline over 8 frames of its synthetic render at 320x240 and
    its map carried into the port."""
    frames, K, _, _ = synthetic_sequence(n_frames=20, width=320, height=240, seed=0)
    cfg = jcfg.PipelineConfig(
        camera=jcfg.CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                                width=320, height=240),
        num_features=300, pyramid_levels=3,
        ba=jcfg.BAConfig(use_pallas_ba=False, window_size=4))
    jp = JaxPipeline(cfg, log=JaxEventLog(echo=False), use_pallas_matcher=False)
    for f in frames[:8]:
        jp.process_frame(f)
    return jp, convert.map_store(jp.map, device="cpu")


def _titles(monkeypatch):
    seen = []
    orig = matplotlib.axes.Axes.set_title
    monkeypatch.setattr(matplotlib.axes.Axes, "set_title",
                        lambda self, label, *a, **k: seen.append(label) or orig(self, label, *a,
                                                                                **k))
    return seen


def test_trajectory_plots_of_a_jax_map(jax_run, tmp_path, monkeypatch):
    jp, port_map = jax_run
    ids = port_map.sorted_kf_ids()
    assert ids == jp.map.sorted_kf_ids() and len(ids) >= 3
    traj = port_map.trajectory(False)
    rots = [port_map.keyframes[k].R for k in ids]
    np.testing.assert_array_equal(traj, jp.map.trajectory(False))
    for k, R in zip(ids, rots):
        np.testing.assert_array_equal(R, jp.map.keyframes[k].R)
    viz.plot_and_save_trajectory_2d(traj, str(tmp_path), "t", device="cpu")
    viz.plot_and_save_trajectory_3d(traj, rots, str(tmp_path), "t", device="cpu")
    img2 = io.read_png(str(tmp_path / "trajectory_2d_t.png"))
    img3 = io.read_png(str(tmp_path / "trajectory_3d_t.png"))
    assert img2.shape == (800, 800, 3) and img3.shape == (900, 900, 3)

    # 2-D: X to the right and Z up at one scale, each marker at its pixel
    p = viz.trajectory_2d_axes(traj).to_px(traj[:, 0], traj[:, 2])
    dx, dz = np.diff(p[:, 0]), -np.diff(p[:, 1])
    data = np.hypot(np.diff(traj[:, 0]), np.diff(traj[:, 2]))
    moved = data > 1e-6
    scale = np.hypot(dx, dz)[moved] / data[moved]
    np.testing.assert_allclose(scale, scale[0], rtol=1e-9)
    np.testing.assert_allclose(dx[moved] / scale[0], np.diff(traj[:, 0])[moved], atol=1e-9)
    np.testing.assert_allclose(dz[moved] / scale[0], np.diff(traj[:, 2])[moved], atol=1e-9)
    c = np.round(p).astype(int)
    np.testing.assert_array_equal(img2[c[0, 1], c[0, 0]], viz.GREEN)
    np.testing.assert_array_equal(img2[c[-1, 1], c[-1, 0]], viz.RED)
    far = [i for i in range(1, len(c) - 1)
           if np.abs(c[i] - c[0]).max() > 8 and np.abs(c[i] - c[-1]).max() > 8]
    for i in far:
        np.testing.assert_array_equal(img2[c[i, 1], c[i, 0]], viz.BLUE)

    # 3-D: an orthographic view from elevation 30, azimuth -60 of the cube
    project, _, _ = viz.trajectory_3d_projection(traj)
    q = project(traj)
    e, a = math.radians(30), math.radians(-60)
    eye = np.asarray([math.cos(e) * math.cos(a), math.cos(e) * math.sin(a), math.sin(e)])
    right = np.cross(eye, [0.0, 0.0, 1.0])
    right = -right / np.linalg.norm(right)
    up = np.cross(eye, right)
    mins, maxs = traj.min(0), traj.max(0)
    half = max((maxs - mins).max() / 2, 0.5)
    rel = (traj - (mins + maxs) / 2) / half
    want = np.stack([rel @ right, -(rel @ up)], 1)
    s = np.linalg.lstsq(want - want.mean(0), q - q.mean(0), rcond=None)[0]
    np.testing.assert_allclose(s, s[0, 0] * np.eye(2), atol=1e-9 * s[0, 0])
    c3 = np.round(q).astype(int)
    for i in range(len(c3)):
        assert (img3[c3[i, 1], c3[i, 0]] != 255).any(), i

    seen = _titles(monkeypatch)
    jviz.plot_and_save_trajectory_2d(traj, str(tmp_path / "jax"), "t")
    jviz.plot_and_save_trajectory_3d(traj, rots, str(tmp_path / "jax"), "t")
    assert seen == [io.read_png_text(str(tmp_path / "trajectory_2d_t.png"))["Title"],
                    io.read_png_text(str(tmp_path / "trajectory_3d_t.png"))["Title"]]


def test_sparsity_title_and_marks(jax_run, tmp_path, monkeypatch):
    """The spy of a window gathered from the carried map: the title of the
    JAX plot, one mark per Jacobian entry (9 per observation) inside the
    axes, the first row's camera block at the top left."""
    jp, port_map = jax_run
    ids = port_map.sorted_kf_ids()[:4]
    problem, mp_ids, _ = port_map.gather_window(ids, jp.K, 4096, 16384)
    seen = _titles(monkeypatch)
    jviz.plot_and_save_sparsity(problem.cam_idx.numpy(), problem.pnt_idx.numpy(), len(ids),
                                len(mp_ids), str(tmp_path / "jax"), "w")
    viz.plot_and_save_sparsity(problem.cam_idx, problem.pnt_idx, len(ids), len(mp_ids),
                               str(tmp_path), "w", device="cpu")
    text = io.read_png_text(str(tmp_path / "sparsity_w.png"))
    assert seen == [text["Title"]]
    img = io.read_png(str(tmp_path / "sparsity_w.png"))
    assert img.shape == (600, 600, 3)
    ax = viz.LinearAxes((600, 600), (0, 1), (0, 1))
    l, t, r, b = (int(round(v)) for v in ax.box)
    inside = (img[t + 2: b - 1, l + 2: r - 1] == 0).all(2)
    assert inside.sum() > 50
    assert (img[:t - 1] == 255).all() and (img[b + 2:] == 255).all()
