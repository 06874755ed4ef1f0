"""Rules the PyTorch port keeps:

- no module of ``bundle_adjustment_tpu_torch``, and neither ``chip_smoke.py``
  nor ``chip_determinism.py``, imports ``jax`` or anything of the JAX package
  (a source scan, and a fresh interpreter that imports every module and
  finds no ``jax`` loaded);
- every entry point's default device is ``"cuda"``, and without a card it
  raises instead of running on the CPU;
- a kernel wrapper takes its plain version only for a CPU tensor;
- every configuration not ported yet raises ``NotImplementedError`` naming
  the missing kernel or module; the default configuration is not one.
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
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.config import BAConfig, CameraModel, PipelineConfig
from bundle_adjustment_tpu_torch.models import frontend, pipeline
from bundle_adjustment_tpu_torch.ops import ba_kernel, hamming_kernel, orb_kernel
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_window

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "bundle_adjustment_tpu_torch"
CAM = CameraModel(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.") or module == "jaxlib"
            or module == "bundle_adjustment_tpu"
            or module.startswith("bundle_adjustment_tpu."))


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_determinism.py"]


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


def test_importing_every_module_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages([str(PKG)], "bundle_adjustment_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m.startswith('bundle_adjustment_tpu.')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20


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
    # the CPU is used when asked for
    assert pipeline.VisualOdometryPipeline(PipelineConfig(camera=CAM), device="cpu")


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


@pytest.mark.parametrize("change,needs", [
    (dict(reloc_enabled=True), "relocalize"),
    (dict(cull_enabled=True), "cull"),
    (dict(loop_closure=True), "loop_closure"),
    (dict(mesh_shape=(2, 1)), "parallel"),
    (dict(features_source="cv2"), "cv2"),
    (dict(debug=True), "viz"),
    (dict(export_voxel=0.05), "voxel"),
])
def test_unported_configurations_raise(change, needs):
    cfg = dataclasses.replace(PipelineConfig(camera=CAM), **change)
    with pytest.raises(NotImplementedError, match=needs):
        pipeline.VisualOdometryPipeline(cfg, device="cpu")


def test_pallas_ba_and_big_windows_raise():
    """The default configuration (use_pallas_ba=True, the window LM kernel
    K3) is ported: nothing refuses it on the card or on the CPU, and the
    kernel's wrapper refuses a tensor that is on neither.  A window wider
    than pcg_min_cameras still needs K4 and the PCG solve."""
    cfg = PipelineConfig(camera=CAM)
    assert cfg.ba.use_pallas_ba
    assert pipeline._unported(cfg, torch.device("cuda")) is None
    assert pipeline._unported(cfg, torch.device("cpu")) is None
    w = synthetic_window(0, C=3, n_pts=30, P=32)
    g = BAProblemGrid(**{k: torch.as_tensor(v, device="meta") for k, v in w.items()})
    with pytest.raises(ValueError, match="device"):
        ba_kernel.lm_solve(g, n_fixed=1)
    for use in (True, False):
        pipe = pipeline.VisualOdometryPipeline(
            dataclasses.replace(cfg, ba=BAConfig(use_pallas_ba=use)), device="cpu")
        n = pipe.cfg.ba.pcg_min_cameras + 1
        with pytest.raises(NotImplementedError, match="K4"):
            pipe._solve_window(list(range(n)), list(range(n)), global_ba=True)


def test_package_version_and_entry_point():
    assert bundle_adjustment_tpu_torch.__version__
    assert bundle_adjustment_tpu_torch.PipelineConfig is PipelineConfig
