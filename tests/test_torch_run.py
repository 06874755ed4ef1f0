"""The port's entry points around the main path, on the CPU:

- ``process_stream`` gives what the sequential ``process_frame`` loop gives,
  bit for bit (statuses, keyframes, points, observations, poses), as the JAX
  package's ``tests/test_process_stream.py`` holds its own;
- the CLI (``run.main``) on a folder of PNG frames, pipelined and
  ``--no-pipelined``: equal results, ``summary.json`` written;
- the PNG reader is byte-equal to ``cv2.imread(path, IMREAD_COLOR)`` on gray,
  RGB and RGBA files written by cv2 and by this file's encoder with each of
  the five row filters, and reads a PNG folder with cv2 hidden; video and
  other images raise naming cv2 where it is hidden;
- ``--debug`` and ``--features-from-cv2`` map to the configuration as the
  JAX CLI maps them; a ``--debug`` run writes the JAX package's debug
  artifact names and the plain run's ``trajectory.txt`` bit for bit, and
  with cv2 hidden announces the videos it could not write; ``--mesh 2``
  and ``--multihost`` run in two gloo ranks on the CPU (``--mesh 2`` in one
  process raises: the world has one rank);
- ``--checkpoint`` writes a checkpoint after the frame loop and resumes from
  it, skipping the frames consumed, to the straight run's trajectory;
- ``read_pcd`` reads back what ``write_pcd`` writes, as the JAX package's
  reader does;
- ``TrackStep`` refuses uniforms that are not its static buffer.
"""

import json
import os
import re
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.utils import io as jio
from bundle_adjustment_tpu_torch import run
from bundle_adjustment_tpu_torch.config import (BAConfig, CameraModel, KeyframeCriteria,
                                                PipelineConfig)
from bundle_adjustment_tpu_torch.models import frontend
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.utils import io
from bundle_adjustment_tpu_torch.utils.event_log import EventLog, read_events
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other.
torch.set_num_threads(1)

W, H = 320, 240


def _png_bytes(img: np.ndarray, colour: int, filt: int) -> bytes:
    """A PNG of ``img`` (H, W[, C]) uint8 with every row under filter
    ``filt`` (0-4), or filter ``y % 5`` on row y when ``filt`` is -1."""
    bpp = {0: 1, 2: 3, 6: 4}[colour]
    h, w = img.shape[:2]
    raw = img.reshape(h, w * bpp).astype(np.int16)
    prev = np.zeros(w * bpp, np.int16)
    rows = []
    for y in range(h):
        cur = raw[y]
        left = np.r_[np.zeros(bpp, np.int16), cur[:-bpp]]
        ul = np.r_[np.zeros(bpp, np.int16), prev[:-bpp]]
        f = y % 5 if filt < 0 else filt
        if f == 0:
            r = cur
        elif f == 1:
            r = cur - left
        elif f == 2:
            r = cur - prev
        elif f == 3:
            r = cur - ((left + prev) >> 1)
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            r = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        rows.append(bytes([f]) + (r & 255).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _image(colour: int) -> np.ndarray:
    rng = np.random.default_rng(colour)
    shape = (29, 41) if colour == 0 else (29, 41, {2: 3, 6: 4}[colour])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[4:15, 6:30] = 200                    # flat and ramped regions beside noise
    img[16:, :20] = np.arange(20, dtype=np.uint8).reshape((1, 20) + (1,) * (img.ndim - 2)) * 12
    return img


@pytest.mark.parametrize("colour", [0, 2, 6], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("writer", ["cv2", "none", "sub", "up", "average", "paeth", "mixed"])
def test_png_reader_equals_cv2_imread(tmp_path, colour, writer):
    img = _image(colour)
    path = str(tmp_path / "f.png")
    if writer == "cv2":
        assert cv2.imwrite(path, img)
    else:
        filt = ["none", "sub", "up", "average", "paeth"].index(writer) if writer != "mixed" else -1
        with open(path, "wb") as fh:
            fh.write(_png_bytes(img, colour, filt))
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    out = io.read_png(path)
    assert out.dtype == ref.dtype == np.uint8 and out.shape == ref.shape == (29, 41, 3)
    np.testing.assert_array_equal(out, ref)


def test_png_folder_reads_without_cv2_and_the_rest_names_it(tmp_path, monkeypatch):
    frames = [_image(2), _image(6)]
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"{i:03d}.png"), f)
    refs = [cv2.imread(str(tmp_path / f"{i:03d}.png")) for i in range(2)]
    monkeypatch.setitem(sys.modules, "cv2", None)           # import cv2 now fails
    got = list(io.image_folder_frames(str(tmp_path)))
    assert len(got) == 2
    for a, b in zip(got, refs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ImportError, match="cv2"):
        next(io.video_frames(str(tmp_path / "clip.mp4")))
    (tmp_path / "003.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="cv2"):
        list(io.image_folder_frames(str(tmp_path)))
    # a 16-bit PNG is a kind read_png leaves to cv2
    with open(tmp_path / "004.png", "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
                 + struct.pack(">IIBBBBB", 2, 2, 16, 0, 0, 0, 0) + b"\0" * 4)
    with pytest.raises(ImportError, match="cv2"):
        io.read_image(str(tmp_path / "004.png"))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("with_colors", [False, True])
def test_read_pcd_round_trips_write_pcd(tmp_path, binary, with_colors):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(57, 3)) * 3
    cols = rng.integers(0, 256, (57, 3)) / 255.0 if with_colors else None
    path = str(tmp_path / "m.pcd")
    io.write_pcd(path, pts, cols, binary=binary)
    p, c = io.read_pcd(path)
    pj, cj = jio.read_pcd(path)
    np.testing.assert_array_equal(p, pj)
    # float32 on disk, and six decimals in the ASCII form
    np.testing.assert_allclose(p, pts, rtol=0, atol=1e-5)
    if with_colors:
        np.testing.assert_array_equal(c, cj)
        np.testing.assert_array_equal(np.round(c * 255), np.round(cols * 255))
    else:
        assert c is None and cj is None


def test_debug_and_cv2_flags_map_to_the_config(tmp_path):
    """``--debug`` and ``--features-from-cv2`` set ``debug`` and
    ``features_source="cv2"``, as the JAX CLI maps them."""
    args = run.build_parser().parse_args(["--images", str(tmp_path), "--debug",
                                          "--features-from-cv2"])
    cfg = run._config(args)
    assert cfg.debug and cfg.features_source == "cv2"
    cfg = run._config(run.build_parser().parse_args(["--images", str(tmp_path)]))
    assert not cfg.debug and cfg.features_source == "orb_tpu"


#: what the JAX package's ``debug=True`` run writes beside the plain outputs
#: (``bundle_adjustment_tpu/models/pipeline.py``: ``_add_new_keyframe``,
#: ``_solve_window``, ``_write_debug_videos``, ``finalize``), each folder
#: with its file-name pattern
DEBUG_ARTIFACTS = {
    "debug_keyframes": r"keyframe_\d{4}\.png", "debug_matches": r"matches_\d{4}\.png",
    "debug_depth": r"depth_\d{4}\.png", "debug_sparsity": r"sparsity_kf\d{4}_\d{4}\.png",
    "trajectory_2d": r"trajectory_2d_(kf\d{4}|final)\.png",
    "trajectory_3d": r"trajectory_3d_(kf\d{4}|final)\.png",
    "lba_steps": r"map_after_lba_kf_\d{4}\.pcd",
}
DEBUG_VIDEOS = ["depth_video.mp4", "keypoint_video.mp4", "match_video.mp4"]


@pytest.mark.parametrize("cv2_installed", [True, False], ids=["cv2", "no-cv2"])
def test_debug_run_writes_the_jax_artifacts(png_folder, tmp_path, monkeypatch, cv2_installed):
    """The CLI with ``--debug`` on the CPU writes every artifact name the
    JAX package's debug run writes, each PNG readable at its size, one
    keyframe overlay per keyframe after the first, and ``trajectory.txt``
    bit-equal to the run without ``--debug``.  With cv2 hidden the videos
    are not written: a ``debug_videos_skipped`` event names cv2 and the
    files, and so does ``summary.json``."""
    folder, K = png_folder
    args = ["--device", "cpu", "--images", folder, "--features", "500", "--size", f"{W}x{H}",
            "--fx", str(K[0, 0]), "--cx", str(K[0, 2]), "--cy", str(K[1, 2])]
    plain, debug = str(tmp_path / "plain"), str(tmp_path / "debug")
    a = run.main(args + ["--out", plain])
    if not cv2_installed:
        monkeypatch.setitem(sys.modules, "cv2", None)
    b = run.main(args + ["--out", debug, "--debug"])
    with open(os.path.join(plain, "trajectory.txt")) as fa, \
            open(os.path.join(debug, "trajectory.txt")) as fb:
        assert fa.read() == fb.read()
    for key in ("num_keyframes", "num_points", "num_observations"):
        assert a[key] == b[key], key
    names = set(os.listdir(debug))
    assert set(DEBUG_ARTIFACTS) <= names
    for sub, pattern in DEBUG_ARTIFACTS.items():
        files = sorted(os.listdir(os.path.join(debug, sub)))
        assert files and all(re.fullmatch(pattern, f) for f in files), (sub, files)
        for f in files:
            if f.endswith(".png"):
                img = io.read_png(os.path.join(debug, sub, f))
                assert img.shape[0] in (H, 600, 800, 900), (sub, f, img.shape)
    n_kf = b["num_keyframes"]
    assert len(os.listdir(os.path.join(debug, "debug_keyframes"))) == n_kf - 1
    assert len(os.listdir(os.path.join(debug, "debug_matches"))) == n_kf - 1
    assert io.read_png(os.path.join(debug, "debug_matches", "matches_0001.png")).shape \
        == (H, 2 * W, 3)
    # the plain run writes the final plots too, as the JAX finalize does
    assert sorted(os.listdir(os.path.join(plain, "trajectory_2d"))) == ["trajectory_2d_final.png"]
    assert sorted(os.listdir(os.path.join(plain, "trajectory_3d"))) == ["trajectory_3d_final.png"]
    skipped = [e for e in read_events(os.path.join(debug, "events.jsonl"))
               if e["event"] == "debug_videos_skipped"]
    if cv2_installed:
        assert DEBUG_VIDEOS == sorted(n for n in names if n.endswith(".mp4"))
        assert not skipped and "debug_videos_skipped" not in b
    else:
        assert not [n for n in names if n.endswith(".mp4")]
        assert len(skipped) == 1 and skipped[0]["needs"] == "cv2"
        assert sorted(skipped[0]["files"]) == DEBUG_VIDEOS
        with open(os.path.join(debug, "summary.json")) as fh:
            assert sorted(json.load(fh)["debug_videos_skipped"]) == DEBUG_VIDEOS


def test_mesh_flag_without_the_ranks_raises(png_folder, tmp_path):
    """``--mesh 2`` in one process: the world has one rank, and the port
    raises where the JAX package would quietly solve on one device."""
    folder, K = png_folder
    with pytest.raises(ValueError, match="2 ranks; the world has 1"):
        run.main(["--device", "cpu", "--images", folder, "--out", str(tmp_path / "o"),
                  "--mesh", "2"])


@pytest.mark.parametrize("flags", [["--multihost"], ["--multihost", "--mesh", "2"]],
                         ids=["multihost", "multihost-mesh2"])
def test_multihost_flags_run_in_two_ranks(png_folder, tmp_path, flags):
    """The CLI in two gloo ranks on the CPU, each started with torchrun's
    environment (``parallel.launch.run_ranks(join=False)``): both ranks run
    the frames and end bit-equal; rank 0 alone writes the outputs, and its
    ``summary.json`` records the backend, the world size and the ranks per
    card.  With ``--mesh 2`` every BA is point-sharded over the two ranks;
    without it the run equals a single-process run bit for bit."""
    import torch_ranks
    from bundle_adjustment_tpu_torch.parallel.launch import run_ranks

    folder, K = png_folder
    args = ["--device", "cpu", "--images", folder, "--features", "500", "--size", f"{W}x{H}",
            "--fx", str(K[0, 0]), "--cx", str(K[0, 2]), "--cy", str(K[1, 2])]
    out = str(tmp_path / "out")
    res = run_ranks(torch_ranks.cli, 2, args + ["--out", out] + flags, device_type="cpu",
                    timeout=120.0, join=False)
    assert res[0]["state"][0] == res[1]["state"][0]
    np.testing.assert_array_equal(res[0]["state"][1], res[1]["state"][1])
    np.testing.assert_array_equal(res[0]["state"][2], res[1]["state"][2])
    for rank, r in enumerate(res):
        assert r["summary"]["distributed"] == {"backend": "gloo", "world_size": 2,
                                               "rank": rank, "ranks_per_card": 0}
        assert r["summary"]["frames"] == 9 and r["summary"]["num_keyframes"] >= 3
    with open(os.path.join(out, "summary.json")) as fh:
        assert json.load(fh)["distributed"]["rank"] == 0
    assert sorted(os.listdir(out)) == ["events.jsonl", "final_map_global_ba.pcd",
                                       "summary.json", "trajectory.txt", "trajectory_2d",
                                       "trajectory_3d"]
    if "--mesh" not in flags:
        single = run.main(args + ["--out", str(tmp_path / "single")])
        assert single["num_keyframes"] == res[0]["summary"]["num_keyframes"]
        with open(os.path.join(out, "trajectory.txt")) as fa, \
                open(tmp_path / "single" / "trajectory.txt") as fb:
            assert fa.read() == fb.read()


def test_track_step_takes_its_own_uniforms():
    step = frontend.TrackStep("cpu")
    u = torch.zeros((128, 6))
    with pytest.raises(RuntimeError, match="load_state"):
        step.run(np.zeros((8, 8), np.uint8), torch.eye(3), step.u_buffer((128, 6)))
    step.load_state(frontend.FrontendState(
        desc=torch.zeros((4, 8), dtype=torch.int32), xy=torch.zeros((4, 2)),
        kp_valid=torch.zeros(4, dtype=torch.bool), pts3d=torch.zeros((4, 3)),
        tracked=torch.zeros(4, dtype=torch.bool), rvec=torch.zeros(3), tvec=torch.zeros(3)))
    with pytest.raises(ValueError, match="u_buffer"):
        step.run(np.zeros((8, 8), np.uint8), torch.eye(3), u)


def _stream_cfg(K):
    """The JAX package's ``tests/test_process_stream.py`` configuration at
    the port's test size, with a displacement trigger of 30 px so that the
    frames after the keyframes of the start are tracked."""
    return PipelineConfig(
        camera=CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H),
        num_features=500, pyramid_levels=3, ratio_test=0.75, min_tracked_features=15,
        pose_inlier_ratio=0.4, pose_inlier_numbers=15, consistent_convention=True,
        keyframe=KeyframeCriteria(min_median_displacement_px=30.0),
        ba=BAConfig(window_size=4, max_points=4096, max_obs=16384))


def test_stream_matches_sequential():
    frames, K, _, _ = synthetic_sequence(n_frames=12, width=W, height=H, fx=300.0, seed=3)
    frames = frames[:10]
    pipe_a = VisualOdometryPipeline(_stream_cfg(K), log=EventLog(echo=False), device="cpu")
    seq = [pipe_a.process_frame(f) for f in frames]
    pipe_b = VisualOdometryPipeline(_stream_cfg(K), log=EventLog(echo=False), device="cpu")
    stream = list(pipe_b.process_stream(frames))

    statuses = [r["status"] for r in seq]
    assert [r["status"] for r in stream] == statuses
    # the run tracks, inserts keyframes and solves windows, so a speculative
    # step is both used and dropped
    assert "tracked" in statuses and statuses.count("keyframe") >= 3
    assert pipe_b.map.num_keyframes == pipe_a.map.num_keyframes
    assert pipe_b.map.num_points == pipe_a.map.num_points
    assert pipe_b.map.num_observations == pipe_a.map.num_observations
    for k in pipe_a.map.sorted_kf_ids():
        np.testing.assert_array_equal(pipe_b.map.keyframes[k].R, pipe_a.map.keyframes[k].R)
        np.testing.assert_array_equal(pipe_b.map.keyframes[k].t, pipe_a.map.keyframes[k].t)
    np.testing.assert_array_equal(pipe_b.map.points(), pipe_a.map.points())
    # one host read (the packed scalars) per frame tracked by the fused
    # step's PnP; the essential-RANSAC fallback reads more
    timing = [e for e in pipe_b.log.events if e["event"] == "frame_timing"]
    by_pnp = [e["host_reads"] for e in timing
              if e["status"] == "tracked" and e["pose"] == "pnp"]
    assert by_pnp and by_pnp == [1] * len(by_pnp)


@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    frames, K, _, _ = synthetic_sequence(n_frames=12, width=W, height=H, fx=300.0, seed=3)
    folder = tmp_path_factory.mktemp("frames")
    for i, f in enumerate(frames[:9]):
        cv2.imwrite(str(folder / f"{i:04d}.png"), f)
    return str(folder), K


def test_cli_pipelined_equals_sequential(png_folder, tmp_path):
    folder, K = png_folder
    args = ["--device", "cpu", "--images", folder, "--features", "500", "--size", f"{W}x{H}",
            "--fx", str(K[0, 0]), "--cx", str(K[0, 2]), "--cy", str(K[1, 2])]
    outs = [str(tmp_path / "pipelined"), str(tmp_path / "sequential")]
    a = run.main(args + ["--out", outs[0]])
    b = run.main(args + ["--out", outs[1], "--no-pipelined"])
    for summary, out in zip((a, b), outs):
        with open(os.path.join(out, "summary.json")) as fh:
            on_disk = json.load(fh)
        assert on_disk == json.loads(json.dumps(summary))
        assert summary["frames"] == 9 and summary["elapsed_s"] > 0
        assert summary["frames_per_s"] == pytest.approx(9 / summary["elapsed_s"], rel=1e-2)
        assert summary["track_step"] == {"captures": 0, "replays": 0, "capture_s": []}
    for key in ("num_keyframes", "num_points", "num_observations"):
        assert a[key] == b[key], key
    timed = ("elapsed_s",)
    assert ({k: v for k, v in a["global_ba"].items() if k not in timed}
            == {k: v for k, v in b["global_ba"].items() if k not in timed})
    assert a["num_keyframes"] >= 3
    for name in ("trajectory.txt", "final_map_global_ba.pcd"):
        with open(os.path.join(outs[0], name)) as fa, open(os.path.join(outs[1], name)) as fb:
            assert fa.read() == fb.read(), name
    status = [[e["status"] for e in read_events(os.path.join(out, "events.jsonl"))
               if e["event"] == "frame_timing"] for out in outs]
    assert status[0] == status[1] and len(status[0]) == 9


def test_checkpoint_flag_writes_and_resumes(png_folder, tmp_path):
    """The CLI over the first 5 frames with ``--checkpoint`` writes it; over
    all 9 it resumes, skips the 5 and ends where a straight run ends."""
    folder, K = png_folder
    head = tmp_path / "head"
    head.mkdir()
    for name in sorted(os.listdir(folder))[:5]:
        os.symlink(os.path.join(folder, name), head / name)
    args = ["--device", "cpu", "--features", "500", "--size", f"{W}x{H}", "--fx", str(K[0, 0]),
            "--cx", str(K[0, 2]), "--cy", str(K[1, 2])]
    ck = str(tmp_path / "state.npz")
    first = run.main(args + ["--images", str(head), "--out", str(tmp_path / "a"),
                             "--checkpoint", ck])
    assert os.path.exists(ck) and first["frames"] == 5 and first["resumed_frames"] == 0
    resumed = run.main(args + ["--images", folder, "--out", str(tmp_path / "b"),
                               "--checkpoint", ck])
    assert resumed["frames"] == 4 and resumed["resumed_frames"] == 5
    straight = run.main(args + ["--images", folder, "--out", str(tmp_path / "c")])
    for key in ("num_keyframes", "num_points", "num_observations"):
        assert resumed[key] == straight[key], key
    with open(tmp_path / "b" / "trajectory.txt") as fb, \
            open(tmp_path / "c" / "trajectory.txt") as fc:
        assert fb.read() == fc.read()
