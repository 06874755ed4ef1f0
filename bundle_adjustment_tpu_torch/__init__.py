"""bundle_adjustment_tpu_torch — the PyTorch/CUDA port of the monocular
SfM / visual-odometry engine in ``bundle_adjustment_tpu``.

Same layout and names as the JAX package, so every function has a
counterpart that a reader can find:

- ``ops``     — Lie algebra, projection, triangulation, Hamming matching,
                ORB extraction, RANSAC pose, bundle-adjustment solvers.
                The hand-written Hopper kernels live beside their callers:
                ``ops/hamming_kernel.py`` (Hamming 2-NN),
                ``ops/orb_kernel.py`` (ORB patch gather) and
                ``ops/ba_kernel.py`` (the one-launch window LM solve),
                sources in ``csrc/``, built at first use by ``kernels.py``.
- ``models``  — the map store, keyframe policy, fused tracked-frame step and
                the frame-pipeline orchestrator.
- ``utils``   — event log and its analytics, PNG and PCD files, the debug
                plots and overlays drawn with torch (``viz``), trajectory
                metrics, the synthetic renderer.
- ``parallel`` — torch.distributed: the device mesh, the point-sharded
                Schur BA, window consensus, sharded and ring matching.
- ``native``  — the C++ host runtime (``csrc/ba_host.cpp``, built with g++
                at first use): the observation table's mirror, voxel export.
- ``convert`` — carries JAX-side state (as numpy) into the port's tensors.

The package imports torch and numpy only.  Every entry point takes an
explicit ``device`` (default ``"cuda"``) and raises when that device is
absent instead of running on the CPU by itself.
"""

__version__ = "0.1.0"

from bundle_adjustment_tpu_torch.config import CameraModel, PipelineConfig  # noqa: F401
