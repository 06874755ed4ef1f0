"""The PnP RANSAC problems of a drive, kept to be held to the JAX package.

``recording(records)`` wraps ``ops/ransac.estimate_pnp_pose`` for the
duration of a block.  Every PnP that the pipeline makes is appended to
``records`` with its kind and frame: the fused tracked-frame step's
("step", ``models/frontend.track_step``), relocalization's ("reloc") and
loop closure's ("loop").  A record holds the problem's inputs (the rows of
X and uv up to the last one a sample drew, the count ``n`` of valid rows
before them, K, the draws ``u``), its outputs (``ok``, ``num_inliers``, R,
t) and, per hypothesis, the six sample indices and the inlier count
(``hypotheses``: ``ransac._hypotheses``, the draw and score stage of
``estimate_pnp_pose``, again on the same device and null-vector solver).  ``_sample_indices`` draws
from the valid rows in their order, so the kept rows are those rows first:
the same problem in fewer rows, its indices unchanged.

A CUDA graph capture cannot read its tensors on the host: record with the
fused step run eagerly (``tools/stress.ROUTES``' "eager step" and "CPU
eigh"); the wrapper raises inside a capture.

``sample_facts`` says of each hypothesis' sample whether it repeats a
point, and the ratio of the two smallest singular values of its DLT
system A (12 x 12, in float64): near 1 where A's null space has two or
more dimensions, so that which vector of it a solver returns is arbitrary.
``save`` and ``load`` keep a set of records in one ``.npz`` file
(``tests/data/torch_run_a_pnp.npz``, written by ``chip_smoke.py
--pnp-study`` on the card and held to the JAX package by
``tests/test_torch_run_a_pnp.py``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

#: below this ratio of A's two smallest singular values a sample's null
#: space is taken to have two or more dimensions (``sample_facts``)
DEGENERATE_RATIO = 10.0
KINDS = ("step", "reloc", "loop", "other")


def hypotheses(u, X, uv, valid, K, reproj_threshold_px: float = 8.0, num_hyp: int = 128):
    """The (num_hyp, 6) sample indices and the (num_hyp,) inlier counts of
    ``ransac.estimate_pnp_pose`` on these inputs (``ransac._hypotheses``,
    the stage it runs before the winner's polish)."""
    from bundle_adjustment_tpu_torch.ops import ransac

    _, _, idx, _, _, counts = ransac._hypotheses(u, X, uv, valid, K, reproj_threshold_px,
                                                 num_hyp)
    return idx, counts


def _normalized64(uv, K):
    K = np.asarray(K, np.float64)
    uv = np.asarray(uv, np.float64)
    return np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], -1)


def dlt_systems(X, uv, K, idx):
    """The DLT systems A (H, 12, 12) of the samples ``idx`` (numpy, (H, 6)
    indices into X (N, 3) and uv (N, 2), pixels), in float64."""
    from bundle_adjustment_tpu_torch.ops import ransac

    idx = np.asarray(idx)
    return ransac._dlt_rows(torch.as_tensor(np.asarray(X, np.float64)[idx]),
                            torch.as_tensor(_normalized64(uv, K)[idx]))


def sample_facts(X, uv, K, idx):
    """Per row of ``idx`` (see ``dlt_systems``): whether the sample repeats
    a point, and sigma_11 / sigma_12 of its DLT system A in float64 (the
    largest ratio where the smallest singular value is 0)."""
    s = torch.linalg.svdvals(dlt_systems(X, uv, K, idx)).numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(s[:, -1] > 0, s[:, -2] / s[:, -1], np.inf)
    idx = np.asarray(idx)
    repeats = np.array([len(set(row.tolist())) < idx.shape[1] for row in idx])
    return repeats, ratio


def float64_counts(X, uv, K, idx, n: int, reproj_threshold_px: float = 8.0):
    """Per row of ``idx`` the inlier count among the first ``n`` rows of
    the hypothesis from the float64 null vector of its A (the SVD of A),
    scored in float64: what the float32 solvers approximate."""
    from bundle_adjustment_tpu_torch.ops import ransac

    P = torch.linalg.svd(dlt_systems(X, uv, K, idx))[2][..., -1, :].reshape(-1, 3, 4)
    Rs, ts = ransac._pose_from_projection(P)
    X64 = torch.as_tensor(np.asarray(X, np.float64)[:n])
    x64 = torch.as_tensor(_normalized64(uv, K)[:n])
    K = np.asarray(K, np.float64)
    thr = (reproj_threshold_px / ((K[0, 0] + K[1, 1]) * 0.5)) ** 2
    return torch.sum(ransac._reproj_err_norm(Rs, ts, X64, x64) < thr, dim=-1).numpy()


def degenerate(repeats, ratio):
    """A sample that repeats a point or whose A has a null space of two or
    more dimensions (``DEGENERATE_RATIO``)."""
    return np.asarray(repeats) | (np.asarray(ratio) < DEGENERATE_RATIO)


@contextlib.contextmanager
def recording(records: list):
    """Every ``ransac.estimate_pnp_pose`` call inside the block appended to
    ``records`` (see the module docstring), then the functions put back."""
    from bundle_adjustment_tpu_torch.models import loop_closure, relocalize
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ransac

    tag = {"kind": None, "frame": -1}
    orig = (ransac.estimate_pnp_pose, relocalize.try_relocalize,
            loop_closure.try_close_loop, VisualOdometryPipeline._fused_dispatch)

    def tagged(kind, fn, frame_of):
        def call(*a, **kw):
            saved = dict(tag)
            tag.update(kind=kind, frame=frame_of(*a, **kw))
            try:
                return fn(*a, **kw)
            finally:
                tag.update(saved)
        return call

    def pnp(u, X, uv, valid, K, reproj_threshold_px=8.0, num_hyp=128, polish_iters=5):
        if X.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("pnp_study.recording: a PnP inside a CUDA graph capture "
                               "cannot be recorded; run the fused step eagerly")
        res = orig[0](u, X, uv, valid, K, reproj_threshold_px=reproj_threshold_px,
                      num_hyp=num_hyp, polish_iters=polish_iters)
        idx, counts = hypotheses(u, X, uv, valid, K, reproj_threshold_px, num_hyp)
        records.append(_compact(dict(
            kind=tag["kind"] or "other", frame=tag["frame"], X=X, uv=uv, valid=valid, u=u,
            K=K, idx=idx, counts=counts, ok=res.ok, num_inliers=res.num_inliers, R=res.R,
            t=res.t, reproj_threshold_px=float(reproj_threshold_px))))
        return res

    ransac.estimate_pnp_pose = pnp
    relocalize.try_relocalize = tagged("reloc", orig[1], lambda pipe, *a, **kw: pipe.frame_idx)
    loop_closure.try_close_loop = tagged("loop", orig[2], lambda pipe, *a, **kw: pipe.frame_idx)
    VisualOdometryPipeline._fused_dispatch = tagged(
        "step", orig[3], lambda self, gray, frame_idx=None: (
            self.frame_idx if frame_idx is None else frame_idx))
    try:
        yield records
    finally:
        (ransac.estimate_pnp_pose, relocalize.try_relocalize, loop_closure.try_close_loop,
         VisualOdometryPipeline._fused_dispatch) = orig


def _compact(rec: dict) -> dict:
    """A record on the host with its valid rows first, in their order, and
    no row past the last one a sample drew; ``idx`` renumbered to them
    (unchanged where the problem's valid rows came first already)."""
    # copies: on the CPU ``numpy()`` shares the tensor's memory, and the
    # step's inputs are static buffers that the next frame overwrites
    host = {k: np.array(v.detach().cpu().numpy()) if torch.is_tensor(v) else v
            for k, v in rec.items()}
    valid = host.pop("valid").astype(bool)
    order = np.argsort(~valid, kind="stable")
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    idx = pos[host["idx"]]
    n = int(valid.sum())
    m = max(n, int(idx.max()) + 1)
    rows = order[:m]
    return dict(host, X=host["X"][rows].astype(np.float32),
                uv=host["uv"][rows].astype(np.float32), n=n, idx=idx.astype(np.int16),
                counts=host["counts"].astype(np.int32), ok=bool(host["ok"]),
                num_inliers=int(host["num_inliers"]))


#: the per-record arrays of ``save``, stacked along a first axis of records
_STACKED = ("u", "K", "idx", "counts", "R", "t")


def save(path: str, records: list, **meta) -> None:
    """``records`` (``recording``'s) into one compressed ``.npz``: X and uv
    concatenated with each record's row offset, the rest stacked, the kind
    as its index in ``KINDS``, the routing as given (``routing``, a string
    per record), and ``meta`` as 0-d arrays."""
    offsets = np.cumsum([0] + [len(r["X"]) for r in records])
    np.savez_compressed(
        path, X=np.concatenate([r["X"] for r in records]),
        uv=np.concatenate([r["uv"] for r in records]), offsets=offsets,
        n=np.array([r["n"] for r in records], np.int32),
        kind=np.array([KINDS.index(r["kind"]) for r in records], np.int8),
        frame=np.array([r["frame"] for r in records], np.int32),
        routing=np.array([r["routing"] for r in records]),
        ok=np.array([r["ok"] for r in records]),
        num_inliers=np.array([r["num_inliers"] for r in records], np.int32),
        reproj_threshold_px=np.array([r["reproj_threshold_px"] for r in records], np.float32),
        **{k: np.stack([np.asarray(r[k]) for r in records]) for k in _STACKED},
        **{k: np.asarray(v) for k, v in meta.items()})


def load(path: str):
    """``save``'s file back: (records, meta)."""
    d = np.load(path)
    per = set(_STACKED) | {"X", "uv", "offsets", "n", "kind", "frame", "routing", "ok",
                           "num_inliers", "reproj_threshold_px"}
    off = d["offsets"]
    records = [dict(kind=KINDS[int(d["kind"][i])], frame=int(d["frame"][i]),
                    routing=str(d["routing"][i]), ok=bool(d["ok"][i]),
                    num_inliers=int(d["num_inliers"][i]), n=int(d["n"][i]),
                    reproj_threshold_px=float(d["reproj_threshold_px"][i]),
                    X=d["X"][off[i]:off[i + 1]], uv=d["uv"][off[i]:off[i + 1]],
                    **{k: d[k][i] for k in _STACKED})
               for i in range(len(d["n"]))]
    return records, {k: d[k][()] for k in d.files if k not in per}
