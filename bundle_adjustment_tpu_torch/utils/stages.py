"""Named stages of the tracked-frame step, for a profile by stage
(``tools/profile_orb``).

``frontend.track_step`` and ``ops/orb.extract`` run each of their stages
inside ``stage(name)``, which does nothing until ``marking(fn)`` makes it
``fn(name)`` (the profile's ``torch.profiler.record_function``), so the
device time of every kernel of the step falls in one named range.  A CUDA
graph captured inside ``marking`` records no range: the profile runs the
step eagerly.
"""

from __future__ import annotations

import contextlib

#: every stage of the tracked-frame step, in the order it runs them: the
#: ORB stages from "pyramid" to "describe" once per pyramid level ("K2
#: gather" inside "describe"), then once per step
STAGES = ("pyramid", "blur", "fast", "nms", "harris", "topk", "subpixel", "moments",
          "describe", "K2 gather", "dedup + select", "K1 match", "pnp ransac",
          "relative model", "sampson", "keyframe metrics", "speculative DLT", "pack")

_mark = None


def stage(name: str):
    """The context stage ``name`` of the step runs in."""
    return contextlib.nullcontext() if _mark is None else _mark(name)


@contextlib.contextmanager
def marking(fn):
    """``stage(name)`` is ``fn(name)`` inside the block."""
    global _mark
    old, _mark = _mark, fn
    try:
        yield
    finally:
        _mark = old
