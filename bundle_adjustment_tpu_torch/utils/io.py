"""Point-cloud output: the PCD writer of ``bundle_adjustment_tpu.utils.io``
(own copy).  Frame sources (video and image decoding) are not ported yet."""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np


def write_pcd(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              binary: bool = False):
    """Write a PCD v0.7 file (x y z [rgb]).  Colors are floats in [0, 1]
    packed into the PCL float-rgb convention."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    fields = "x y z rgb" if has_color else "x y z"
    sizes = "4 4 4 4" if has_color else "4 4 4"
    types = "F F F F" if has_color else "F F F"
    counts = "1 1 1 1" if has_color else "1 1 1"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )

    if has_color:
        c = np.clip(np.asarray(colors).reshape(-1, 3), 0, 1)
        rgb_u32 = (
            (np.round(c[:, 0] * 255).astype(np.uint32) << 16)
            | (np.round(c[:, 1] * 255).astype(np.uint32) << 8)
            | np.round(c[:, 2] * 255).astype(np.uint32)
        )
        data = np.column_stack([points, rgb_u32.view(np.float32)])
    else:
        data = points

    if binary:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for row in data:
                if has_color:
                    f.write(f"{row[0]:.6f} {row[1]:.6f} {row[2]:.6f} "
                            f"{struct.unpack('<f', struct.pack('<f', row[3]))[0]:.9e}\n")
                else:
                    f.write(f"{row[0]:.6f} {row[1]:.6f} {row[2]:.6f}\n")
