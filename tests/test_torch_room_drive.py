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

The first test runs frames 0-12 of a 600-frame loop at 320x240 with 500
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

``--camera lehman`` takes run (a)'s own camera in place of the 320x240
room: ``chip_smoke.py`` phase 11's 1280x720 frames of seed 2's room (the
first 150 of its 600-frame loop) with CAMERA_LEHMAN's fx (fy = fx, the
principal point at the image centre, as ``synthetic_sequence`` builds K)
and 4000 features.  ``--run jax`` or ``--run port`` runs one package's
free run alone (several can run at once on a CPU of several cores),
``--run compare`` the comparison alone (its JAX pipeline is that
package's free run); each tally gives keyframes, triggers, discarded
frames by ``why``, relocalizations and the first discarded frame
(``tools/stress.tally``).  ``--seed S`` gives both packages draw seed S
(``jax_pipeline``), ``--pyramid jax`` the port's ORB pyramid levels from the
JAX package's resize (``jax_pyramid``: at this size the one ORB layer where
the two part; ``test_at_run_a_size_the_two_orbs_part_only_by_the_pyramid``
holds that on frame 1), and ``--pnp-at F ...`` holds each relocalization
PnP of those compared frames to the JAX package's (``held_pnp_lines``):

    JAX_PLATFORMS=cpu python tests/test_torch_room_drive.py --camera lehman \
        --frames 150 --dlt svd --run compare --threads 2
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
#: the room at 320x240 with 500 features, as the tests run it; the room at
#: the preset's own 1280x720 with CAMERA_LEHMAN's fx (fy = fx, the centre
#: at the image's, as ``synthetic_sequence`` builds K) and 4000 features,
#: as ``chip_smoke.py`` phase 11 drives run (a); a JAX stress cell's camera
#: as ``tools/stress`` drives it (its render's defaults)
ROOM = dict(width=W, height=H, fx=FX, features=500)
LEHMAN = dict(width=1280, height=720, fx=912.7816, features=4000)
CELL = dict(width=640, height=480, fx=450.0, features=1500)
CAMERAS = dict(room=ROOM, lehman=LEHMAN)
STUDY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".dedup_study")
#: frame -> the JAX map's points before it, of the last ``step_drive``
MAP_POINTS: dict = {}
#: frame -> (the port's PnP records, the JAX package's) at the frames of
#: ``step_drive``'s ``pnp_at``
PNP_HELD: dict = {}


class JaxDraws:
    """The JAX pipeline's key schedule from ``key`` on, as the port's
    ``draws``: split once per sequential RANSAC call, fold_in(``dispatch``,
    frame) for the fused step (the JAX pipeline's ``_key`` and
    ``_dispatch_key``, PRNGKey(0) and PRNGKey(1) as it starts)."""

    def __init__(self, key, dispatch=None):
        self._key = key
        self._dispatch = jax.random.PRNGKey(1) if dispatch is None else dispatch

    def next(self, shape):
        self._key, k = jax.random.split(self._key)
        return torch.as_tensor(np.array(jax.random.uniform(k, shape)))

    def for_frame(self, frame_idx, shape, out=None):
        k = jax.random.fold_in(self._dispatch, frame_idx)
        u = torch.as_tensor(np.array(jax.random.uniform(k, shape)))
        return u if out is None else out.copy_(u)


def room_frames(n: int, cam: dict = ROOM):
    """Frames 0..n-1 of a ``LOOP``-frame loop of seed 2's room at ``cam``'s
    size and focal length."""
    w, h, fx = cam["width"], cam["height"], cam["fx"]
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    planes = synthetic._room_planes(np.random.default_rng(2))
    return [synthetic.render_frame(K, *synthetic.room_pose(i, LOOP)[:2], planes, w, h,
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
                                device="cpu", draws=JaxDraws(jp._key, jp._dispatch_key))
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


def jax_pipeline(consistent: bool, cam: dict = ROOM, seed: int = 0):
    """The JAX pipeline of the comparison, its Hamming matcher the Pallas
    kernel's XLA twin (``use_pallas_matcher=False``), which needs no
    interpret mode on the CPU.  Draw seed ``seed`` starts its keys at
    PRNGKey(2 seed) (sequential RANSAC) and PRNGKey(2 seed + 1) (the fused
    step): seed 0 is the package's own schedule."""
    jp = JaxPipeline(config(jcfg, consistent, cam), log=JaxEventLog(echo=False),
                     use_pallas_matcher=False)
    jp._key, jp._dispatch_key = jax.random.PRNGKey(2 * seed), jax.random.PRNGKey(2 * seed + 1)
    return jp


def jax_pnp_counts(idx, X, uv, valid, K, thr_px):
    """Per hypothesis of the (H, 6) sample indices ``idx`` the JAX
    package's inlier count, as its ``estimate_pnp_pose`` scores them before
    the polish (its ``_dlt_projection``, ``_pose_from_projection`` and
    ``_reproj_err_norm``)."""
    import jax.numpy as jnp

    from bundle_adjustment_tpu.ops import ransac as jax_ransac
    from bundle_adjustment_tpu.ops.projection import pixel_to_normalized

    x = pixel_to_normalized(K, uv)
    thr = (thr_px / ((K[0, 0] + K[1, 1]) * 0.5)) ** 2
    Rs, ts = jax.vmap(lambda i: jax_ransac._pose_from_projection(
        jax_ransac._dlt_projection(X[i], x[i])))(idx)
    return jax.vmap(lambda R, t: jnp.sum((jax_ransac._reproj_err_norm(R, t, X, x) < thr)
                                         & valid))(Rs, ts)


@contextlib.contextmanager
def jax_pnp_recorded(records: list):
    """The JAX package's ``ransac.estimate_pnp_pose`` wrapped in this
    process for the block: each call made outside a trace (relocalization's
    and loop closure's; the fused step's runs inside its jitted step and
    is not seen) appended to ``records`` with its valid rows, K, the sample
    indices its key draws, its per-hypothesis counts (``jax_pnp_counts``)
    and its ``ok`` and inlier count; then put back."""
    from bundle_adjustment_tpu.ops import ransac as jax_ransac

    orig = jax_ransac.estimate_pnp_pose

    def call(key, X, uv, valid, K, reproj_threshold_px=8.0, num_hyp=128, polish_iters=5):
        res = orig(key, X, uv, valid, K, reproj_threshold_px=reproj_threshold_px,
                   num_hyp=num_hyp, polish_iters=polish_iters)
        if not isinstance(X, jax.core.Tracer):
            idx = jax_ransac._sample_indices(key, valid, num_hyp, 6)
            n = int(np.sum(valid))
            records.append(dict(
                X=np.asarray(X)[:n], uv=np.asarray(uv)[:n], n=n, K=np.asarray(K),
                idx=np.asarray(idx), ok=bool(res.ok), num_inliers=int(res.num_inliers),
                counts=np.asarray(jax.jit(jax_pnp_counts, static_argnames=("thr_px",))(
                    idx, X, uv, valid, K, thr_px=float(reproj_threshold_px)))))
        return res

    jax_ransac.estimate_pnp_pose = call
    try:
        yield records
    finally:
        jax_ransac.estimate_pnp_pose = orig


def step_drive(frames, consistent: bool, cam: dict = ROOM, first: int = 0, pnp_at=(),
               seed: int = 0):
    """The JAX pipeline over ``frames``; before each from ``first`` on, the
    port from its state.  Returns (JAX pipeline, [(frame, differences)]);
    ``MAP_POINTS`` gets the JAX map's points before each compared frame, and
    ``PNP_HELD`` both packages' relocalization and loop-closure PnPs on each
    frame of ``pnp_at`` (``pnp_study.recording``, ``jax_pnp_recorded``)."""
    from bundle_adjustment_tpu_torch.tools import pnp_study

    jp = jax_pipeline(consistent, cam, seed)
    steps = []
    for i, f in enumerate(frames):
        if i < first:
            jp.process_frame(f)
            continue
        tp = port_from(jp, consistent, cam)
        MAP_POINTS[i] = jp.map.num_points
        n0 = len(jp.log.events)
        held = ([], []) if i in pnp_at else None
        with (jax_pnp_recorded(held[1]) if held else contextlib.nullcontext()):
            jres = jp.process_frame(f)
        with (pnp_study.recording(held[0]) if held else contextlib.nullcontext()):
            tres = tp.process_frame(f)
        if held:
            PNP_HELD[i] = ([r for r in held[0] if r["kind"] != "step"], held[1])
        steps.append((i, differences(jres, jp.log.events[n0:], tres, tp.log.events)))
    return jp, steps


def held_pnp_lines(frame: int) -> list:
    """One line per PnP of ``PNP_HELD[frame]``: the port's and the JAX
    package's valid rows (equal, or their largest difference), the samples
    (equal?), the samples that repeat a point or whose A has a null space of
    two or more dimensions (``pnp_study``), the sound samples whose counts
    differ, each package's winner and whether it is degenerate, the
    polished inlier counts, and per sound sample scored apart both counts,
    the float64 hypothesis' (``pnp_study.float64_counts``) and A's
    sigma_11 / sigma_12 and sigma_1 / sigma_12."""
    from bundle_adjustment_tpu_torch.tools import pnp_study

    port, jx = PNP_HELD[frame]
    out = [] if len(port) == len(jx) else [
        f"frame {frame}: the port made {len(port)} PnPs outside its step, JAX {len(jx)}"]
    for t, j in zip(port, jx):
        same_rows = t["n"] == j["n"]
        diff = (max(float(np.abs(t["X"][:t["n"]] - j["X"]).max(initial=0)),
                    float(np.abs(t["uv"][:t["n"]] - j["uv"]).max(initial=0)))
                if same_rows else None)
        rep, ratio = pnp_study.sample_facts(t["X"], t["uv"], t["K"], t["idx"])
        deg = pnp_study.degenerate(rep, ratio)
        wt, wj = int(np.argmax(t["counts"])), int(np.argmax(j["counts"]))
        apart = np.flatnonzero((t["counts"] != j["counts"]) & ~deg)
        s = torch.linalg.svdvals(pnp_study.dlt_systems(t["X"], t["uv"], t["K"], t["idx"][apart]))
        c64 = pnp_study.float64_counts(t["X"], t["uv"], t["K"], t["idx"][apart], t["n"])
        detail = [f"sample {h}: port {int(t['counts'][h])}, JAX {int(j['counts'][h])}, "
                  f"float64 {int(c)}, sigma_11/sigma_12 {float(ratio[h]):.4g}, sigma_1/sigma_12 "
                  f"{float(sv[0] / sv[-1]):.4g}" for h, c, sv in zip(apart, c64, s)]
        out.append(
            f"frame {frame} {t['kind']}: valid rows port {t['n']}, JAX {j['n']} (largest "
            f"difference {diff}); samples equal {np.array_equal(t['idx'], j['idx'])}; "
            f"degenerate {int(deg.sum())} of {len(deg)} (repeating a point {int(rep.sum())}); "
            f"sound samples scored apart {int((t['counts'] != j['counts'])[~deg].sum())}; "
            f"winner port {wt} ({'degenerate' if deg[wt] else 'sound'}, "
            f"{int(t['counts'][wt])}), JAX {wj} ({'degenerate' if deg[wj] else 'sound'}, "
            f"{int(j['counts'][wj])}); inliers port {t['num_inliers']}, JAX {j['num_inliers']}"
            + "".join(f"; {d}" for d in detail))
    return out


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


def keypoint_sets(jkp, tkp):
    """The two packages' valid keypoints (x, y to 1e-3 px, pyramid level)
    of one frame: (the common ones as (JAX slot, port slot) pairs, the
    count only in JAX's set, the count only in the port's)."""
    def keyed(xy, level, valid):
        return {(round(float(x), 3), round(float(y), 3), int(lv)): i
                for i, ((x, y), lv, v) in enumerate(zip(xy, level, valid)) if v}

    j = keyed(np.asarray(jkp.xy), np.asarray(jkp.level), np.asarray(jkp.valid))
    t = keyed(tkp.xy.numpy(), tkp.level.numpy(), tkp.valid.numpy())
    return [(j[k], t[k]) for k in j.keys() & t.keys()], len(j.keys() - t.keys()), \
        len(t.keys() - j.keys())


#: the port's pyramid levels against the float64 resize (the same weights,
#: float64 sums) on a 0-255 image: float32 rounding of a few-term sum
PYRAMID_TOL = 1e-4
#: the share of descriptor bits of common keypoints that may differ: the
#: blur's float32 rounding puts a BRIEF pair's two samples at equality on
#: either side (8 to 25 bits of some 900,000 on frames 0, 1, 50, 56)
DESC_BITS_TOL = 1e-4


def test_at_run_a_size_the_two_orbs_part_only_by_the_pyramid():
    """Frame 1 of run (a)'s drive at 1280x720 with 4000 features
    (``LEHMAN``): the port's pyramid levels (``orb.resize_bilinear``) are
    the float64 resize within ``PYRAMID_TOL``; given the JAX package's
    level images (``jax_pyramid``) the port's ORB gives the JAX package's
    keypoint set, and their descriptors differ in at most ``DESC_BITS_TOL``
    of the bits.  With each package's own pyramid the sets part by a few
    dozen keypoints (printed; the JAX package's ``jax.image.resize`` is up
    to about 1.3e-3 off the float64 resize on the CPU, the port's 4e-5):
    where the room drives at this size part from the JAX state, this is
    their first layer (PERF.md section 5)."""
    import jax.numpy as jnp

    from bundle_adjustment_tpu.ops import orb as jorb
    from bundle_adjustment_tpu_torch.models.pipeline import bgr_to_gray
    from bundle_adjustment_tpu_torch.ops import orb

    gray = bgr_to_gray(room_frames(2, LEHMAN)[1])
    c = tcfg.preset_lehman_indoor()
    kw = dict(num_features=LEHMAN["features"], levels=c.pyramid_levels,
              scale=c.pyramid_scale, threshold=float(c.fast_threshold), height=720, width=1280)
    img = torch.as_tensor(gray).to(torch.float32)
    for lvl in range(1, c.pyramid_levels):
        sf = c.pyramid_scale ** lvl
        hw = (max(int(round(720 / sf)), 64), max(int(round(1280 / sf)), 64))
        ref = (orb._resize_weights(720, hw[0], img.device).double().T @ img.double()
               @ orb._resize_weights(1280, hw[1], img.device).double())
        assert float((orb.resize_bilinear(img, hw).double() - ref).abs().max()) <= PYRAMID_TOL
    jkp = jorb.extract(jnp.asarray(gray), **kw)
    own = keypoint_sets(jkp, orb.extract(torch.as_tensor(gray), **kw))
    with jax_pyramid(True):
        tkp = orb.extract(torch.as_tensor(gray), **kw)
    common, only_j, only_t = keypoint_sets(jkp, tkp)
    print(f"frame 1 at 1280x720: keypoints in one set only, each package's own pyramid: JAX "
          f"{own[1]}, port {own[2]} (common {len(own[0])}); on JAX's level images: JAX "
          f"{only_j}, port {only_t} (common {len(common)})")
    assert (only_j, only_t) == (0, 0) and len(common) > 3000
    jd, td = np.asarray(jkp.desc).view(np.uint32), tkp.desc.numpy().view(np.uint32)
    bits = sum(int(np.unpackbits((jd[a] ^ td[b]).view(np.uint8)).sum()) for a, b in common)
    assert bits <= DESC_BITS_TOL * 256 * len(common), bits


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


@contextlib.contextmanager
def jax_pyramid(on: bool):
    """For the block, when ``on``, the port's ORB pyramid levels
    (``ops/orb.resize_bilinear``) taken from the JAX package's
    ``jax.image.resize``, then put back.  At 1280x720 the two resizes part
    by float32 rounding (up to about 2e-3 on a 0-255 image, on a third of
    each level's pixels), which moves FAST corners and subpixel offsets:
    13 to 48 of some 3,550 keypoints per frame are in one package's set
    only.  On the same level images the two ORBs give the same keypoint
    sets (PERF.md section 5), so this isolates every layer after the
    pyramid."""
    if not on:
        yield
        return
    import jax.numpy as jnp

    from bundle_adjustment_tpu_torch.ops import orb

    saved = orb.resize_bilinear
    orb.resize_bilinear = lambda img, hw: torch.as_tensor(np.array(jax.image.resize(
        jnp.asarray(img.cpu().numpy()), tuple(hw), method="bilinear")), device=img.device)
    try:
        yield
    finally:
        orb.resize_bilinear = saved


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
    """A free run's decisions (``tools/stress.tally``, as ``chip_smoke.py
    --pnp-study`` tallies the card's drives)."""
    from bundle_adjustment_tpu_torch.tools import stress

    return stress.tally(pipe.log.events, pipe.map.num_keyframes)


def jax_free_run(frames, consistent: bool, cam: dict, seed: int = 0):
    """The JAX pipeline alone over ``frames``, as ``step_drive`` runs it."""
    jp = jax_pipeline(consistent, cam, seed)
    for f in frames:
        jp.process_frame(f)
    return jp


def port_free_run(frames, consistent: bool, cam: dict, seed: int = 0):
    """The port alone over ``frames`` on the CPU, with the JAX pipeline's
    key schedule of draw seed ``seed`` (``jax_pipeline``, ``JaxDraws``)."""
    tp = VisualOdometryPipeline(config(tcfg, consistent, cam), log=EventLog(echo=False),
                                device="cpu", draws=JaxDraws(jax.random.PRNGKey(2 * seed),
                                                             jax.random.PRNGKey(2 * seed + 1)))
    for f in frames:
        tp.process_frame(f)
    return tp


def main(argv=None):
    ap = argparse.ArgumentParser(description="the room drive, JAX against the port, "
                                             "frame by frame from the same state")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--convention", choices=("reference", "consistent"), default="reference")
    ap.add_argument("--camera", choices=sorted(CAMERAS), default="room",
                    help="the room at 320x240 with 500 features (room), or at run (a)'s "
                         "1280x720 with CAMERA_LEHMAN's fx and 4000 features (lehman)")
    ap.add_argument("--cell", type=int, default=None, metavar="SEED",
                    help="the JAX stress cell of this seed's video (640x480, 1500 features, "
                         "the consistent convention) in place of the room")
    ap.add_argument("--first", type=int, default=0,
                    help="compare from this frame on (the JAX pipeline runs those before)")
    ap.add_argument("--dlt", choices=("eigh", "svd"), default="eigh",
                    help="the DLT null vectors of both packages: each one's own eigh of "
                         "A^T A, or the SVD of A (dlt_substituted)")
    ap.add_argument("--run", choices=("all", "compare", "jax", "port"), default="all",
                    help="the comparison from the JAX state, whose JAX pipeline runs free, "
                         "then the port's free run (all); the comparison alone (compare); "
                         "one package's free run alone (jax, port)")
    ap.add_argument("--threads", type=int, default=1, help="torch's CPU threads")
    ap.add_argument("--pyramid", choices=("own", "jax"), default="own",
                    help="the port's ORB pyramid levels from its own resize, or from the JAX "
                         "package's jax.image.resize (jax_pyramid)")
    ap.add_argument("--seed", type=int, default=0,
                    help="draw seed of both packages' RANSAC keys (jax_pipeline); 0 is the "
                         "JAX package's own schedule")
    ap.add_argument("--pnp-at", type=int, nargs="+", default=[], metavar="FRAME",
                    help="on these compared frames, hold each relocalization and loop-closure "
                         "PnP of the port to the JAX package's (held_pnp_lines)")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    with dlt_substituted(args.dlt), jax_pyramid(args.pyramid == "jax"):
        drive_and_tally(args)


def drive_and_tally(args):
    """The script's comparison from the JAX state and its free runs'
    tallies (``main``)."""
    if args.cell is not None:
        cam, consistent = CELL, True
        frames = cell_frames(args.cell, args.frames)
        what = f"frames of the JAX stress cell s{args.cell}_d3_cpu at 640x480"
    else:
        cam, consistent = CAMERAS[args.camera], args.convention == "consistent"
        frames = room_frames(args.frames, cam)
        what = (f"room frames at {cam['width']}x{cam['height']} with {cam['features']} "
                f"features, {args.convention} convention")
    what += (f", DLT null vectors: {args.dlt}, draw seed {args.seed}, the port's pyramid: "
             f"{args.pyramid}")
    if args.run in ("jax", "port"):
        run = jax_free_run if args.run == "jax" else port_free_run
        print(f"{args.frames} {what}: free run: {args.run} "
              f"{tally(run(frames, consistent, cam, args.seed))}", flush=True)
        return
    jp, steps = step_drive(frames, consistent, cam, args.first, set(args.pnp_at), args.seed)
    agree = [i for i, d in steps if not d]

    def alike(keys):
        return [i for i, d in steps if not any(x.split(":")[0] in keys for x in d)]

    print(f"{args.frames} {what}: the port from the JAX state decides as it (status, "
          f"trigger, events) on {len(alike(('status', 'reason', 'events')))} of {len(steps)} "
          f"frames (status and trigger on {len(alike(('status', 'reason')))}), and agrees in "
          f"every number too on {len(agree)}")
    for i, d in steps:
        if d:
            print(f"  frame {i} (JAX map points before it: {MAP_POINTS[i]}): " + "; ".join(d))
    for i in sorted(PNP_HELD):
        for line in held_pnp_lines(i):
            print("  " + line)
    print(f"free runs: JAX {tally(jp)}", flush=True)
    if args.run == "all":
        print(f"           port {tally(port_free_run(frames, consistent, cam, args.seed))}")


if __name__ == "__main__":
    main()
