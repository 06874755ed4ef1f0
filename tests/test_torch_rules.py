"""Rules the PyTorch port keeps:

- no module of ``bundle_adjustment_tpu_torch`` (its ``tools/`` harnesses
  among them), and none of the ``chip_*.py`` scripts, imports ``jax``,
  anything of the JAX package, ``bench`` or the repo's ``tools/`` scripts
  (a source scan, and a fresh interpreter that imports every module and
  finds none of them loaded); none imports matplotlib, and cv2 is imported
  only by ``utils/io._cv2`` (a source scan; importing every module loads
  neither);
- every entry point's default device is ``"cuda"`` (the pipeline, the
  tracked-frame step, the CLI's ``run.main``, ``prewarm`` and the drawing
  of ``utils/viz`` among them),
  and without a card it raises instead of running on the CPU;
- a kernel wrapper takes its plain version only for a CPU tensor;
- every configuration of the JAX package builds: ``debug`` and
  ``features_source="cv2"`` on the CPU (and raise on the default device
  without a card), relocalization, culling and loop closure, a BA window
  above ``pcg_min_cameras`` cameras, ``mesh_shape`` (which raises when the
  world has fewer ranks) and ``export_voxel``.
"""

import ast
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bundle_adjustment_tpu_torch
from bundle_adjustment_tpu_torch import convert, run
from bundle_adjustment_tpu_torch.config import BAConfig, CameraModel, PipelineConfig
from bundle_adjustment_tpu_torch.models import frontend, pipeline
from bundle_adjustment_tpu_torch.ops import ba, ba_global_kernel, ba_kernel, hamming_kernel, \
    orb_kernel
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
from bundle_adjustment_tpu_torch.parallel import launch, mesh
from bundle_adjustment_tpu_torch.tools import dedup_study, global_scale_sweep, stress
from bundle_adjustment_tpu_torch.utils import prewarm, viz
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_map, synthetic_window

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "bundle_adjustment_tpu_torch"
CAM = CameraModel(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "bundle_adjustment_tpu", "bench", "tools")


def _sources():
    return sorted(PKG.rglob("*.py")) + sorted(REPO.glob("chip_*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_matplotlib_and_cv2_only_through_io(path):
    """The card machine has neither: no module imports matplotlib, and cv2
    is imported only inside ``utils/io._cv2``, which raises naming it."""
    tree = ast.parse(path.read_text())
    funcs = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for inner in ast.walk(node):
                funcs.setdefault(id(inner), node.name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        top = {n.split(".")[0] for n in names}
        assert "matplotlib" not in top, f"{path.name}:{node.lineno} imports matplotlib"
        if "cv2" in top:
            assert path == PKG / "utils" / "io.py" and funcs.get(id(node)) == "_cv2", \
                f"{path.name}:{node.lineno} imports cv2 outside utils/io._cv2"


def test_importing_every_module_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages([str(PKG)], "bundle_adjustment_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'bench', 'tools',\n"
            "       'bundle_adjustment_tpu', 'cv2', 'matplotlib')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20
    assert {"bundle_adjustment_tpu_torch.tools.stress",
            "bundle_adjustment_tpu_torch.tools.dedup_study",
            "bundle_adjustment_tpu_torch.tools.global_scale_sweep"} <= set(mods)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.VisualOdometryPipeline(PipelineConfig(camera=CAM))
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.Draws()
    with pytest.raises(RuntimeError, match="cuda"):
        convert.descriptors(np.zeros((2, 8), np.uint32))

    class KF:
        desc = torch.zeros((4, 8), dtype=torch.int32)
        xy, kp_valid = np.zeros((4, 2)), np.ones(4, bool)
        kp_to_mp, R, t = -np.ones(4, int), np.eye(3), np.zeros(3)

    with pytest.raises(RuntimeError, match="cuda"):
        frontend.make_state(KF, np.zeros((0, 3)), 4)
    with pytest.raises(RuntimeError, match="cuda"):
        frontend.TrackStep()
    with pytest.raises(RuntimeError, match="cuda"):
        prewarm.prewarm(PipelineConfig(camera=CAM))
    with pytest.raises(RuntimeError, match="cuda"):
        run.main(["--images", str(REPO / "no_such_folder"), "--out", str(REPO / "no_such_out")])
    assert not (REPO / "no_such_out").exists()
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.default_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        launch.run_ranks(print, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        viz.draw_keypoints(np.zeros((4, 4, 3), np.uint8), np.zeros((0, 2)),
                           str(REPO / "no_such_out" / "k.png"))
    with pytest.raises(RuntimeError, match="cuda"):
        viz.plot_and_save_trajectory_2d(np.zeros((2, 3)), str(REPO / "no_such_out"), "t")
    assert not (REPO / "no_such_out").exists()
    for tool, argv in ((stress, ["--video", "no.mp4", "--out", str(REPO / "no_such_out")]),
                       (dedup_study, ["--out", str(REPO / "no_such_out")]),
                       (global_scale_sweep, ["--cams", "16"])):
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main(argv)
    assert not (REPO / "no_such_out").exists()
    # the CPU is used when asked for
    assert pipeline.VisualOdometryPipeline(PipelineConfig(camera=CAM), device="cpu")
    assert frontend.TrackStep("cpu")


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    d = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        hamming_kernel.knn2_fused(d, d, torch.ones(4, dtype=torch.bool, device="meta"))
    img = torch.zeros((64, 64), device="meta")
    s = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        orb_kernel.gather_patches40(img, s, s)
    w = synthetic_window(0, C=3, n_pts=30, P=32)
    g = BAProblemGrid(**{k: torch.as_tensor(v, device="meta") for k, v in w.items()})
    with pytest.raises(ValueError, match="device"):
        ba_kernel.lm_solve(g, n_fixed=1)
    with pytest.raises(ValueError, match="device"):
        ba_global_kernel.solve(g, n_fixed=1)


@pytest.mark.parametrize("change", [
    dict(reloc_enabled=True), dict(cull_enabled=True), dict(loop_closure=True),
    dict(reloc_enabled=True, cull_enabled=True, loop_closure=True),
], ids=["reloc_enabled", "cull_enabled", "loop_closure", "all-three"])
def test_lehman_indoor_switches_build(change):
    """Relocalization, culling and loop closure are ported: each switch,
    and the three together, build a pipeline on the CPU, and the card is
    the default."""
    cfg = dataclasses.replace(PipelineConfig(camera=CAM), **change)
    pipe = pipeline.VisualOdometryPipeline(cfg, device="cpu")
    assert pipe._last_loop_kf < 0 and pipe.device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.VisualOdometryPipeline(cfg)


@pytest.mark.parametrize("change", [dict(debug=True), dict(features_source="cv2")],
                         ids=["debug", "features_source-cv2"])
def test_debug_and_cv2_features_build(change, monkeypatch):
    """``debug`` and the cv2 features are ported: each builds a pipeline on
    the CPU, and on the default device without a card it raises."""
    cfg = dataclasses.replace(PipelineConfig(camera=CAM), **change)
    pipe = pipeline.VisualOdometryPipeline(cfg, device="cpu")
    assert pipe.device.type == "cpu" and pipe.cfg == cfg
    assert pipe._fusable() is False       # no keyframe yet; never in cv2 mode
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.VisualOdometryPipeline(cfg)


@pytest.mark.parametrize("change,ranks,built", [
    (dict(mesh_shape=(2, 1)), 2, True),
    (dict(export_voxel=0.05), 1, True),
    (dict(mesh_shape=(2, 1)), 1, False),
], ids=["mesh_shape", "export_voxel", "mesh_shape-larger-than-the-world"])
def test_ported_configurations_build(change, ranks, built):
    """``mesh_shape`` and ``export_voxel`` are ported: neither is refused on
    the card or the CPU; a pipeline with ``mesh_shape=(2, 1)`` builds in two
    gloo ranks, and in a world of one rank it raises (the JAX package
    would solve on one device instead)."""
    import torch_ranks
    from bundle_adjustment_tpu_torch.parallel.launch import run_ranks

    cfg = dataclasses.replace(PipelineConfig(camera=CAM), **change)
    if ranks > 1:
        assert run_ranks(torch_ranks.build_pipeline, ranks, cfg, device_type="cpu",
                         timeout=120.0) == ["built"] * 2
    elif built:
        assert pipeline.VisualOdometryPipeline(cfg, device="cpu").cfg.export_voxel == 0.05
    else:
        with pytest.raises(ValueError, match="the world has 1"):
            pipeline.VisualOdometryPipeline(cfg, device="cpu")


def test_pallas_ba_and_big_windows_raise():
    """The default configuration (use_pallas_ba=True, the window LM kernel
    K3) is ported: nothing refuses it on the card or on the CPU, and the
    kernel's wrapper refuses a tensor that is on neither.  A window wider
    than pcg_min_cameras is ported too: 25 cameras solve on the CPU through
    the PCG camera solve, whatever use_pallas_ba says.  The sharded solver's
    ``axis_name`` is a process group now: with none the solve is the
    single-rank one, bit for bit."""
    cfg = PipelineConfig(camera=CAM)
    assert cfg.ba.use_pallas_ba
    w = synthetic_window(0, C=3, n_pts=30, P=32)
    g = BAProblemGrid(**{k: torch.as_tensor(v, device="meta") for k, v in w.items()})
    with pytest.raises(ValueError, match="device"):
        ba_kernel.lm_solve(g, n_fixed=1)
    for use in (True, False):
        pipe = pipeline.VisualOdometryPipeline(
            dataclasses.replace(cfg, ba=BAConfig(use_pallas_ba=use, max_iterations=6)),
            device="cpu")
        n = pipe.cfg.ba.pcg_min_cameras + 1
        pipe.map, pipe.K = synthetic_global_map(0, C=n + 1, P=500, device="cpu")
        out = pipe._solve_window(list(range(n)), list(range(n + 1)), global_ba=True)
        assert out["n_cams"] == n == 25 and not out["diverged"]
        assert np.isfinite(out["final"]) and out["final"] < 0.5 * out["initial"]
        # the event that names a card window the kernels did not take is the card's
        assert not [e for e in pipe.log.events if e["event"] == "pcg_plain_solver"]
    problem = pipe.map.gather_window(list(range(n)), pipe.K, 8192, 32768)[0]
    one = ba.ba_solve(problem, n_fixed=1, max_iterations=4)
    grouped = ba.ba_solve(problem, n_fixed=1, max_iterations=4, group=None)
    for a, b in zip(one[:3], grouped[:3]):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="axis_name"):
        ba.ba_solve(problem, n_fixed=1, axis_name="pt")


def test_package_version_and_entry_point():
    assert bundle_adjustment_tpu_torch.__version__
    assert bundle_adjustment_tpu_torch.PipelineConfig is PipelineConfig
