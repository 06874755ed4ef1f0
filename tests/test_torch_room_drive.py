"""The lehman_indoor drive on the room (``utils.synthetic``'s ``motion="room"``),
the port against the JAX package on the CPU, one frame at a time from the
same state.

Free runs of the two packages part after a few keyframes: float32
evaluation order moves a keyframe's pose by about 1e-5, and a later PnP
RANSAC on points that disagree by that much can keep one inlier more or
less, which changes a keyframe decision.  So each frame is held from a
shared state.  The JAX pipeline runs free; before each frame the port
pipeline takes a copy of its state (the map through
``convert.map_store``, the frame counter, the lost-frame counter, the
loop-closure cooldown and the sequential RANSAC key, which ``JaxDraws``
replays) and processes the same frame.  Its result must be the JAX
pipeline's: the same status and keyframe trigger and the same events in
the same order, with every integer and string in them equal and every
float within 1e-3 + 1e-2 of the JAX value relatively (a rotation angle of
a few milliradians from an arccos carries float32 rounding of a few
percent; a BA cost carries the order of float32 sums).

The test runs frames 0-12 of a 600-frame loop at 320x240 with 500
features, ``preset_lehman_indoor`` otherwise as it ships: the reference
pose convention, relocalization, culling and loop closure on.  Run as a
script, the same comparison covers a longer drive under either pose
convention, and the two packages' free runs over it are tallied side by
side (keyframes, triggers, statuses, relocalizations, ``loop_reject``
stages, closures):

    JAX_PLATFORMS=cpu python tests/test_torch_room_drive.py --frames 150 \\
        --convention reference

The same comparison runs on a JAX stress cell's own video (``--cell SEED``:
``.dedup_study/s{SEED}_d3_cpu/sequence.mp4``, read through cv2 as it is, at
640x480 with 1500 features and the consistent convention, as
``tools/stress`` drives it); the test covers seed 3's frames 0-13, through
the JAX run's Rotation trigger at frame 12, and skips only where cv2 is not
installed.  ``--first F`` starts the script's comparison at frame F (the
JAX pipeline runs the frames before it alone):

    JAX_PLATFORMS=cpu python tests/test_torch_room_drive.py --cell 3 --frames 200

``--dlt svd`` runs the script with the DLT null vectors (the PnP's and the
two-view triangulation's) taken from the SVD of A in both packages, inside
the script's own process and for the duration of the run
(``dlt_substituted``): the JAX package's ``ops.ransac._dlt_projection`` and
``ops.triangulation.triangulate_dlt`` replaced by functions that return
``jnp.linalg.svd(A)[2][-1]`` of the same system (the JAX package's files
are not changed; its jit caches are cleared on the way in and out), and
the port's ``small_linalg.null_vector`` routed to ``torch.linalg.svd``,
what the port takes on the card.  The free runs' tallies then say what
each package decides under an accurate DLT:

    JAX_PLATFORMS=cpu python tests/test_torch_room_drive.py --frames 150 \
        --convention reference --dlt svd
"""

import argparse
import contextlib
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bundle_adjustment_tpu.config as jcfg  # noqa: E402
from bundle_adjustment_tpu.models.pipeline import VisualOdometryPipeline as JaxPipeline  # noqa: E402
from bundle_adjustment_tpu.utils.event_log import EventLog as JaxEventLog  # noqa: E402
import bundle_adjustment_tpu_torch.config as tcfg  # noqa: E402
from bundle_adjustment_tpu_torch import convert  # noqa: E402
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline  # noqa: E402
from bundle_adjustment_tpu_torch.utils import synthetic  # noqa: E402
from bundle_adjustment_tpu_torch.utils.event_log import EventLog  # noqa: E402

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other.
torch.set_num_threads(1)

W, H, LOOP = 320, 240, 600
FX = 912.7816 * W / 1280          # CAMERA_LEHMAN's focal length at this width
TIME_KEYS = {"t", "total_ms", "elapsed_s", "wall_ms", "ms"}
#: the room at 320x240 with 500 features, as the tests run it; a JAX stress
#: cell's camera as ``tools/stress`` drives it (its render's defaults)
ROOM = dict(width=W, height=H, fx=FX, features=500)
CELL = dict(width=640, height=480, fx=450.0, features=1500)
STUDY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".dedup_study")
#: frame -> the JAX map's points before it, of the last ``step_drive``
MAP_POINTS: dict = {}


class JaxDraws:
    """The JAX pipeline's key schedule from ``key`` on, as the port's
    ``draws``: split once per sequential RANSAC call, fold_in(PRNGKey(1),
    frame) for the fused step."""

    def __init__(self, key):
        self._key = key

    def next(self, shape):
        self._key, k = jax.random.split(self._key)
        return torch.as_tensor(np.array(jax.random.uniform(k, shape)))

    def for_frame(self, frame_idx, shape, out=None):
        k = jax.random.fold_in(jax.random.PRNGKey(1), frame_idx)
        u = torch.as_tensor(np.array(jax.random.uniform(k, shape)))
        return u if out is None else out.copy_(u)


def room_frames(n: int):
    """Frames 0..n-1 of a ``LOOP``-frame loop of the room at W x H."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    planes = synthetic._room_planes(np.random.default_rng(2))
    return [synthetic.render_frame(K, *synthetic.room_pose(i, LOOP)[:2], planes, W, H,
                                   depth_sort=True) for i in range(n)]


def cell_frames(seed: int, n: int):
    """Frames 0..n-1 of the JAX stress cell ``s{seed}_d3_cpu``'s committed
    video, as the port reads it (``utils/io.video_frames``: cv2)."""
    from bundle_adjustment_tpu_torch.utils.io import video_frames

    return list(video_frames(os.path.join(STUDY, f"s{seed}_d3_cpu", "sequence.mp4"), 0, n))


def config(mod, consistent: bool, cam: dict = ROOM):
    w, h, fx = cam["width"], cam["height"], cam["fx"]
    return dataclasses.replace(
        mod.preset_lehman_indoor(),
        camera=mod.CameraModel(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h),
        num_features=cam["features"], consistent_convention=consistent)


def port_from(jp, consistent: bool, cam: dict = ROOM):
    """A port pipeline holding a copy of the JAX pipeline ``jp``'s state."""
    tp = VisualOdometryPipeline(config(tcfg, consistent, cam), log=EventLog(echo=False),
                                device="cpu", draws=JaxDraws(jp._key))
    tp.map = convert.map_store(jp.map, device="cpu")
    tp.map.log = tp.log
    tp.frame_idx, tp._lost_frames = jp.frame_idx, jp._lost_frames
    tp._last_loop_kf = jp._last_loop_kf
    tp._front_dirty = True
    return tp


def _close(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool) or not isinstance(a, (int, float)) \
            or not isinstance(b, (int, float)):
        return a == b
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    return abs(a - b) <= 1e-3 + 1e-2 * abs(b)


def differences(jres, jevents, tres, tevents) -> list:
    """How the port's result and events on one frame differ from the JAX
    pipeline's (empty when they agree); keys only one of them logs, and
    clock times, are not compared."""
    out = []
    for key in ("status", "reason"):
        if jres.get(key) != tres.get(key):
            out.append(f"{key}: {jres.get(key)} != {tres.get(key)}")
    if [e["event"] for e in jevents] != [e["event"] for e in tevents]:
        out.append(f"events: {[e['event'] for e in jevents]} != {[e['event'] for e in tevents]}")
        return out
    for je, te in zip(jevents, tevents):
        for k in sorted((je.keys() & te.keys()) - TIME_KEYS):
            if not _close(je[k], te[k]):
                out.append(f"{je['event']}.{k}: {je[k]} != {te[k]}")
    return out


def step_drive(frames, consistent: bool, cam: dict = ROOM, first: int = 0):
    """The JAX pipeline over ``frames``; before each from ``first`` on, the
    port from its state.  Returns (JAX pipeline, [(frame, differences)]);
    ``MAP_POINTS`` gets the JAX map's points before each compared frame."""
    jp = JaxPipeline(config(jcfg, consistent, cam), log=JaxEventLog(echo=False),
                     use_pallas_matcher=False)
    steps = []
    for i, f in enumerate(frames):
        if i < first:
            jp.process_frame(f)
            continue
        tp = port_from(jp, consistent, cam)
        MAP_POINTS[i] = jp.map.num_points
        n0 = len(jp.log.events)
        jres = jp.process_frame(f)
        tres = tp.process_frame(f)
        steps.append((i, differences(jres, jp.log.events[n0:], tres, tp.log.events)))
    return jp, steps


def test_each_frame_from_the_jax_state_reference_convention():
    frames = room_frames(13)
    jp, steps = step_drive(frames, consistent=False)
    assert [d for _, d in steps] == [[]] * len(frames), [s for s in steps if s[1]]
    triggers = [e["reason"] for e in jp.log.events if e["event"] == "keyframe_trigger"]
    assert triggers[:3] == ["Initialization", "Rotation", "Parallax"]


#: what the failed PnP's rotation decides on a frame without a map point
DEGENERATE = ("status: tracked != keyframe", "status: keyframe != tracked",
              "reason: None != Rotation", "reason: Rotation != None",
              "keyframe_trigger.rotation_rad", "events: ")


def test_each_frame_from_the_jax_state_on_a_stress_cell():
    """Seed 3's JAX stress cell, frames 0-13 of its own video at 640x480 with
    1500 features and the consistent convention, each from the JAX state.

    Until frame 12's keyframe triangulates the first points the JAX map
    holds none, and the fused step's PnP has no tracked correspondence:
    every 6-point sample is one keypoint six times, whose DLT normal matrix
    has a ten-dimensional null space, and which vector of it LAPACK returns
    differs between the two packages' builds (and with their threading: the
    identity rotation from the JAX package's on frame 1, a half turn from
    the port's).  On the essential fallback the keyframe cascade reads that
    failed PnP's rotation (``rotation_rad=sc.rot_mag``, the JAX package's
    ``models/pipeline.py:580``, the port's alike), so on those frames the
    two may part on a Rotation keyframe or its angle (the JAX run takes one
    at frame 12, at pi; the port has taken one at frame 1).  Held: every
    frame with a map point decides as JAX in every number, and a frame
    without one parts only in what that rotation decides.

    This runs on the CPU, where the port's DLT solver is LAPACK's: it
    cannot see the card's (the SVD of A, ROADMAP Queue 3 item 19), which
    ``tests/test_torch_kernels.py``'s
    ``test_dlt_null_vectors_on_the_card_are_as_accurate_as_lapacks`` and
    ``chip_smoke.py`` phase 14 hold.  The script mode covers the later
    frames that have map points (``--first``; PERF.md section 5)."""
    pytest.importorskip("cv2")
    frames = cell_frames(3, 14)
    jp, steps = step_drive(frames, consistent=True, cam=CELL)
    assert [i for i, _ in steps if MAP_POINTS[i] > 0] == [13]
    for i, d in steps:
        if MAP_POINTS[i] > 0:
            assert d == [], (i, d)
        else:
            assert all(x.startswith(DEGENERATE) for x in d), (i, d)
    rot = [(e["frame_idx"], round(e["rotation_rad"], 3), e["tracked"])
           for e in jp.log.events
           if e["event"] == "keyframe_trigger" and e["reason"] == "Rotation"]
    assert rot == [(12, 3.142, 0)]


def _jax_dlt_svd(X, x, w=None):
    """The JAX package's ``ransac._dlt_projection`` with the null vector
    from the SVD of A: the same rows, ``jnp.linalg.svd(A)[2][-1]``."""
    import jax.numpy as jnp

    Xh = jnp.concatenate([X, jnp.ones((X.shape[0], 1), X.dtype)], axis=1)
    zeros = jnp.zeros_like(Xh)
    A = jnp.concatenate([jnp.concatenate([Xh, zeros, -x[:, 0:1] * Xh], axis=1),
                         jnp.concatenate([zeros, Xh, -x[:, 1:2] * Xh], axis=1)], axis=0)
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    return jnp.linalg.svd(A)[2][-1].reshape(3, 4)


def _jax_triangulate_svd(P1, P2, uv1, uv2):
    """The JAX package's ``triangulation.triangulate_dlt`` with the null
    vector of each 4x4 system from the SVD of A."""
    import jax.numpy as jnp

    u1, v1 = uv1[..., 0], uv1[..., 1]
    u2, v2 = uv2[..., 0], uv2[..., 1]
    A = jnp.stack([u1[:, None] * P1[2] - P1[0], v1[:, None] * P1[2] - P1[1],
                   u2[:, None] * P2[2] - P2[0], v2[:, None] * P2[2] - P2[1]], axis=-2)
    Xh = jnp.linalg.svd(A)[2][..., -1, :]
    w = Xh[..., 3]
    return Xh[..., :3] / (w + jnp.where(w >= 0, 1e-6, -1e-6))[..., None]


@contextlib.contextmanager
def dlt_substituted(dlt: str):
    """Both packages' DLT null vectors as ``dlt`` names them for the block:
    "eigh", each package's own (an eigh of A^T A), or "svd", the SVD of A
    in both (the JAX functions replaced, the port's ``null_vector``
    routed), then put back; JAX's jit caches are cleared on the way in and
    out, so that no trace of the other kind is reused."""
    if dlt == "eigh":
        yield
        return
    from bundle_adjustment_tpu.ops import ransac as jax_ransac
    from bundle_adjustment_tpu.ops import triangulation as jax_triangulation
    from bundle_adjustment_tpu_torch.ops import small_linalg

    saved = (jax_ransac._dlt_projection, jax_triangulation.triangulate_dlt,
             small_linalg.null_vector)
    jax_ransac._dlt_projection = _jax_dlt_svd
    jax_triangulation.triangulate_dlt = _jax_triangulate_svd
    small_linalg.null_vector = lambda A: torch.linalg.svd(A)[2][..., -1, :]
    jax.clear_caches()
    try:
        yield
    finally:
        (jax_ransac._dlt_projection, jax_triangulation.triangulate_dlt,
         small_linalg.null_vector) = saved
        jax.clear_caches()


def test_the_svd_substitution_takes_both_packages_and_puts_them_back():
    """``dlt_substituted("svd")`` (the script's ``--dlt svd``): inside the
    block a jitted call of the JAX package's ``_dlt_projection`` traced
    before it gives the SVD of A's null vector, and so do its triangulation
    and the port's ``null_vector``; after it every function is the
    package's own again and the same jitted call gives its earlier bits."""
    import jax.numpy as jnp

    from bundle_adjustment_tpu.ops import ransac as jax_ransac
    from bundle_adjustment_tpu.ops import triangulation as jax_triangulation
    from bundle_adjustment_tpu_torch.ops import ransac, small_linalg

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                             "torch_dlt_samples.npz"))
    X, x = d["X"][:64], d["x"][:64]
    A = ransac._dlt_rows(torch.tensor(X), torch.tensor(x))
    want = torch.linalg.svd(A.double())[2][..., -1, :]
    dlt = jax.jit(jax.vmap(lambda X, x: jax_ransac._dlt_projection(X, x)))
    K = jnp.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]])
    P1 = jax_triangulation.camera_matrix(K, jnp.eye(3), jnp.zeros(3))
    P2 = jax_triangulation.camera_matrix(K, jnp.eye(3), jnp.array([-0.3, 0.0, 0.0]))
    uv = jnp.asarray(x[:, 0] * 450.0 + np.array([320.0, 240.0]), jnp.float32)
    tri = jax.jit(lambda a, b: jax_triangulation.triangulate_dlt(P1, P2, a, b))
    saved = (jax_ransac._dlt_projection, jax_triangulation.triangulate_dlt,
             small_linalg.null_vector)
    before, tri_before = np.asarray(dlt(X, x)), np.asarray(tri(uv, uv + 5.0))

    def sine(P):
        p = torch.tensor(np.asarray(P), dtype=torch.float64).reshape(want.shape)
        cos = torch.abs(torch.sum(p * want, -1)) / torch.linalg.norm(p, dim=-1)
        return torch.sqrt(torch.clamp(1 - cos * cos, min=0))

    with dlt_substituted("svd"):
        inside = np.asarray(dlt(X, x))
        assert float(sine(inside).median()) < 1e-4 < float(sine(before).median())
        assert jax_triangulation.triangulate_dlt is _jax_triangulate_svd
        assert not np.array_equal(np.asarray(tri(uv, uv + 5.0)), tri_before)
        v = small_linalg.null_vector(A)
        assert torch.equal(v, torch.linalg.svd(A)[2][..., -1, :])
    assert (jax_ransac._dlt_projection, jax_triangulation.triangulate_dlt,
            small_linalg.null_vector) == saved
    assert np.array_equal(np.asarray(dlt(X, x)), before)
    assert np.array_equal(np.asarray(tri(uv, uv + 5.0)), tri_before)
    with dlt_substituted("eigh"):
        assert small_linalg.null_vector is saved[2]


def tally(pipe) -> dict:
    ev = pipe.log.events

    def count(event, key):
        out = {}
        for e in ev:
            if e["event"] == event:
                out[e[key]] = out.get(e[key], 0) + 1
        return out

    relocs = [e for e in ev if e["event"] == "relocalization"]
    return dict(keyframes=pipe.map.num_keyframes, statuses=count("frame_timing", "status"),
                triggers=count("keyframe_trigger", "reason"),
                relocalizations=f"{sum(e['success'] for e in relocs)}/{len(relocs)}",
                loop_reject=count("loop_reject", "stage"),
                closures=sum(e["event"] == "loop_closure" for e in ev))


def main(argv=None):
    ap = argparse.ArgumentParser(description="the room drive, JAX against the port, "
                                             "frame by frame from the same state")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--convention", choices=("reference", "consistent"), default="reference")
    ap.add_argument("--cell", type=int, default=None, metavar="SEED",
                    help="the JAX stress cell of this seed's video (640x480, 1500 features, "
                         "the consistent convention) in place of the room")
    ap.add_argument("--first", type=int, default=0,
                    help="compare from this frame on (the JAX pipeline runs those before)")
    ap.add_argument("--dlt", choices=("eigh", "svd"), default="eigh",
                    help="the DLT null vectors of both packages: each one's own eigh of "
                         "A^T A, or the SVD of A (dlt_substituted)")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    with dlt_substituted(args.dlt):
        drive_and_tally(args)


def drive_and_tally(args):
    """The script's comparison from the JAX state and its free runs'
    tallies (``main``)."""
    if args.cell is not None:
        cam, consistent = CELL, True
        frames = cell_frames(args.cell, args.frames)
        what = f"frames of the JAX stress cell s{args.cell}_d3_cpu at 640x480"
    else:
        cam, consistent = ROOM, args.convention == "consistent"
        frames = room_frames(args.frames)
        what = f"room frames at {W}x{H}, {args.convention} convention"
    jp, steps = step_drive(frames, consistent, cam, args.first)
    agree = [i for i, d in steps if not d]
    decided = [i for i, d in steps if not any(x.split(":")[0] in ("status", "reason", "events")
                                               for x in d)]
    what += f", DLT null vectors: {args.dlt}"
    print(f"{args.frames} {what}: the port from the JAX state decides as it (status, "
          f"trigger, events) on {len(decided)} of {len(steps)} frames, and agrees in every "
          f"number too on {len(agree)}")
    for i, d in steps:
        if d:
            print(f"  frame {i} (JAX map points before it: {MAP_POINTS[i]}): " + "; ".join(d))
    tp = VisualOdometryPipeline(config(tcfg, consistent, cam), log=EventLog(echo=False),
                                device="cpu", draws=JaxDraws(jax.random.PRNGKey(0)))
    for f in frames:
        tp.process_frame(f)
    print(f"free runs: JAX {tally(jp)}")
    print(f"           port {tally(tp)}")


if __name__ == "__main__":
    main()
