"""Host I/O: frame sources, PNG and PCD files and the voxel-grid
downsample (own copy of ``bundle_adjustment_tpu.utils.io``'s frame sources,
PCD reader/writer and ``voxel_downsample``).

The machine with the card has no cv2, so PNG files are read and written
here with the standard library: ``read_png`` takes 8-bit gray, RGB and RGBA
PNGs without interlace (``zlib`` and the five PNG row filters) and returns
the BGR array that ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns, byte for
byte (gray replicated to three channels, alpha dropped); ``write_png``
writes 8-bit BGR as ``cv2.imwrite`` does (RGB, zlib level 1), with text
chunks, which ``read_png_text`` reads back.  Any other image, a PNG of
another kind included, and any video go through cv2 where it is installed
and raise ``ImportError`` naming it where it is not.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels, for the kinds ``read_png`` decodes itself
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}
_IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


#: what a reader's ``_cv2`` error adds
_PNG_HINT = "; folders of 8-bit gray, RGB or RGBA PNG files are read without it"


def _cv2(what: str, hint: str = ""):
    """The cv2 module; raises ``ImportError`` naming cv2 and ``what`` needs
    it where it is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (OpenCV), which is not installed{hint}") from e
    return cv2


class _PngKindUnsupported(ValueError):
    """A valid PNG of a kind that ``read_png`` does not decode itself."""


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        yield kind, data[pos + 8: pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG file (no IEND chunk)")


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays: a left, b above, c above-left."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``rows`` (H, stride) uint8 with
    ``filters`` (H,) and ``bpp`` bytes per pixel."""
    H, stride = rows.shape
    W = stride // bpp
    if np.all(filters <= 2):
        # None, Sub and Up: one row at a time, each vectorised
        out = np.empty_like(rows)
        prev = np.zeros(stride, np.uint8)
        for y in range(H):
            f = filters[y]
            if f == 0:
                cur = rows[y]
            elif f == 1:
                cur = np.cumsum(rows[y].reshape(W, bpp), axis=0, dtype=np.uint8).reshape(-1)
            else:
                cur = rows[y] + prev
            out[y] = prev = cur
        return out
    # Average and Paeth depend on the left, upper and upper-left pixels:
    # one anti-diagonal of pixels at a time, vectorised over the rows
    raw = rows.reshape(H, W, bpp).astype(np.int16)
    out = np.zeros((H + 1, W + 1, bpp), np.int16)     # a zero row and column in front
    f = filters.astype(np.int16)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        fy = f[y][:, None]
        pred = np.where(fy == 1, a, np.where(fy == 2, b, np.where(
            fy == 3, (a + b) >> 1, np.where(fy == 4, _paeth(a, b, c), 0))))
        out[y + 1, x + 1] = (raw[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(H, stride)


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of an 8-bit gray, RGB or RGBA PNG without
    interlace, equal to ``cv2.imread(path, cv2.IMREAD_COLOR)``.  Raises
    ``ValueError`` on a file that is not such a PNG."""
    with open(path, "rb") as fh:
        data = fh.read()
    chunks = _png_chunks(data)
    kind, body = next(chunks)
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR first")
    width, height, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        raise _PngKindUnsupported(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}; decoded here: bit depth 8, colour type 0, 2 or 6, no interlace")
    idat = [body for kind, body in chunks if kind == b"IDAT"]
    bpp = _PNG_CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data of {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    raw = raw.reshape(height, stride + 1)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(raw[:, 0].max())}")
    pix = _unfilter(raw[:, 1:], raw[:, 0], bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(pix, 3, axis=2)
    return np.ascontiguousarray(pix[:, :, 2::-1])


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, bgr: np.ndarray, text: Optional[dict] = None) -> None:
    """``bgr`` (H, W, 3) uint8 as an 8-bit RGB PNG, every row under the Up
    filter, zlib level 1 (``cv2.imwrite``'s default compression), creating
    the folder.  ``text``: keyword -> value pairs written as ``tEXt`` chunks
    (``iTXt``, UTF-8, for a value outside Latin-1)."""
    bgr = np.asarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {bgr.shape} {bgr.dtype}")
    h, w = bgr.shape[:2]
    rgb = bgr[:, :, ::-1].reshape(h, -1)
    up = np.diff(rgb, axis=0, prepend=np.zeros_like(rgb[:1]))      # uint8, wraps
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    chunks = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    for key, value in (text or {}).items():
        try:
            chunks.append(_png_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                                     + str(value).encode("latin-1")))
        except UnicodeEncodeError:
            chunks.append(_png_chunk(b"iTXt", key.encode("latin-1") + b"\0\0\0\0\0"
                                     + str(value).encode("utf-8")))
    chunks += [_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)), _png_chunk(b"IEND", b"")]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIGNATURE + b"".join(chunks))


def read_png_text(path: str) -> dict:
    """The ``tEXt`` and uncompressed ``iTXt`` chunks of a PNG file as a
    keyword -> value dict."""
    with open(path, "rb") as fh:
        data = fh.read()
    out = {}
    for kind, body in _png_chunks(data):
        if kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            out[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"iTXt":
            key, _, rest = body.partition(b"\0")
            if rest[:1] == b"\0":      # not compressed: skip method, language, translated key
                value = rest[2:].split(b"\0", 2)[2]
                out[key.decode("latin-1")] = value.decode("utf-8")
    return out


def read_image(path: str) -> Optional[np.ndarray]:
    """BGR uint8 of an image file, as ``cv2.imread(path, cv2.IMREAD_COLOR)``:
    PNGs that ``read_png`` takes are decoded here, anything else by cv2
    (``None`` where cv2 cannot read it), which raises ``ImportError`` where
    it is not installed."""
    if path.lower().endswith(".png"):
        try:
            return read_png(path)
        except _PngKindUnsupported as e:
            what = f"reading {e}"
    else:
        what = f"reading {path} (not a PNG file)"
    cv2 = _cv2(what, _PNG_HINT)
    return cv2.imread(path, cv2.IMREAD_COLOR)


def video_frames(path: str, start: int = 0, end: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield BGR frames of a video from frame ``start`` up to ``end``
    (exclusive), decoded by cv2."""
    cv2 = _cv2(f"video_frames ({path})", _PNG_HINT)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (end is not None and i >= end):
                return
            if i >= start:
                yield frame
            i += 1
    finally:
        cap.release()


def image_folder_frames(folder: str, pattern: str = "*") -> Iterator[np.ndarray]:
    """Yield BGR frames of the images in ``folder`` (sorted by name)."""
    paths = sorted(p for p in glob.glob(os.path.join(folder, pattern))
                   if p.lower().endswith(_IMAGE_EXTENSIONS))
    if not paths:
        raise FileNotFoundError(f"no images found in {folder}")
    for p in paths:
        img = read_image(p)
        if img is not None:
            yield img


def prefetch(iterator: Iterator, depth: int = 3) -> Iterator:
    """Run an iterator (frame decoding) in a background thread with a
    bounded queue, overlapping host I/O with device work; its exceptions
    reach the consumer.  zlib and cv2 release the interpreter lock while
    they decode."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


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


def read_pcd(path: str):
    """Read the PCD subset written by ``write_pcd``.  Returns (points, colors
    or None), float64."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode().strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        n = int(header["POINTS"])
        fields = header["FIELDS"].split()
        ncols = len(fields)
        if header["DATA"] == "binary":
            data = np.frombuffer(f.read(n * ncols * 4), np.float32).reshape(n, ncols)
        else:
            data = np.loadtxt(f, dtype=np.float32).reshape(n, ncols)
    points = data[:, :3].astype(np.float64)
    colors = None
    if "rgb" in fields:
        rgb_u32 = np.ascontiguousarray(data[:, fields.index("rgb")]).view(np.uint32)
        colors = np.stack(
            [(rgb_u32 >> 16) & 0xFF, (rgb_u32 >> 8) & 0xFF, rgb_u32 & 0xFF], axis=1
        ).astype(np.float64) / 255.0
    return points, colors


def voxel_downsample(points: np.ndarray, colors: Optional[np.ndarray], voxel: float):
    """Average points (and colors) per voxel of edge ``voxel``, voxels sorted
    by their integer coordinates: the numpy version of
    ``native.voxel_downsample_native``."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    n_vox = counts.shape[0]
    acc = np.zeros((n_vox, 3))
    np.add.at(acc, inv, points)
    out_pts = acc / counts[:, None]
    out_colors = None
    if colors is not None:
        cacc = np.zeros((n_vox, 3))
        np.add.at(cacc, inv, colors)
        out_colors = cacc / counts[:, None]
    return out_pts, out_colors
