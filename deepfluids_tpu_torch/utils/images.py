"""Field visualization: vorticity / magnitude PNGs and GIFs, numpy only.

Counterpart of :mod:`deepfluids_tpu.utils.images`, with the same renders:
the same colormaps (blue-white-red for signed scalars, black-body for
magnitudes), the same modes and 3D projections (the mid-depth slice, or
the maximum-intensity projection along depth), and the same orientation
(origin flipped so +y is up); an image is byte-equal to the JAX module's.
The JAX module writes through PIL and imageio; here the PNG (zlib + CRC
chunks) and the GIF (a fixed 252-colour palette, uncompressed LZW) are
written with numpy and the standard library alone, so serving needs
neither package.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np


def _colorize_diverging(x: np.ndarray,
                        vmax: float | None = None) -> np.ndarray:
    """Signed scalar [H, W] -> uint8 RGB, blue-white-red diverging map."""
    vmax = vmax or (np.abs(x).max() + 1e-8)
    t = np.clip(x / vmax, -1.0, 1.0)
    r = np.where(t >= 0, 1.0, 1.0 + t)
    g = 1.0 - np.abs(t)
    b = np.where(t <= 0, 1.0, 1.0 - t)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _colorize_magnitude(x: np.ndarray,
                        vmax: float | None = None) -> np.ndarray:
    """Nonnegative scalar [H, W] -> uint8 RGB, black-body-style ramp."""
    vmax = vmax or (x.max() + 1e-8)
    t = np.clip(x / vmax, 0.0, 1.0)
    r = np.clip(3.0 * t, 0, 1)
    g = np.clip(3.0 * t - 1.0, 0, 1)
    b = np.clip(3.0 * t - 2.0, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _np_fdiff(x: np.ndarray, axis: int) -> np.ndarray:
    """numpy twin of ops.fd._fdiff (forward diff, last-derivative edge
    replication)."""
    d = np.diff(x, axis=axis)
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(-1, None)
    return np.concatenate([d, d[tuple(idx)]], axis=axis)


def _np_vorticity2d(field: np.ndarray) -> np.ndarray:
    """dvdx - dudy of [H, W, 2] (matches ops.fd.vorticity2d)."""
    return (_np_fdiff(field[..., 1], axis=-1)
            - _np_fdiff(field[..., 0], axis=-2))


def _np_vorticity3d(field: np.ndarray) -> np.ndarray:
    """The vorticity vector ``(dwdy - dvdz, dudz - dwdx, dvdx - dudy)`` of
    [D, H, W, 3] (matches ops.fd.vorticity3d)."""
    u, v, w = field[..., 0], field[..., 1], field[..., 2]
    return np.stack([_np_fdiff(w, -2) - _np_fdiff(v, -3),
                     _np_fdiff(u, -3) - _np_fdiff(w, -1),
                     _np_fdiff(v, -1) - _np_fdiff(u, -2)], axis=-1)


def _render_scalar(field: np.ndarray, mode: str,
                   projection: str = "slice") -> tuple[np.ndarray, bool]:
    """The scalar [H, W] a field renders as, and whether it is signed (the
    diverging map, scaled by |max|) or a magnitude (black-body, by max).

    A 3D field is reduced to a plane first: its mid-depth slice
    (``projection="slice"``), or (``"max"``) the in-plane vorticity at the
    depth of the largest |vorticity| (mode "vorticity" on 3 channels) or
    the largest magnitude along depth (any other mode)."""
    field = np.asarray(field, np.float32)
    if field.ndim == 4:      # [D, H, W, C] -> a plane
        if projection == "max":
            if mode == "vorticity" and field.shape[-1] == 3:
                vort = _np_vorticity3d(field)
                d_idx = np.linalg.norm(vort, axis=-1).argmax(axis=0)
                hh, ww = np.indices(d_idx.shape)
                return vort[..., 2][d_idx, hh, ww], True
            return np.linalg.norm(field, axis=-1).max(axis=0), False
        field = field[field.shape[0] // 2]
    if field.ndim != 3:
        raise ValueError(f"cannot render a field of shape {field.shape}: "
                         "want [H, W, C] or [D, H, W, C]")
    if mode == "vorticity" and field.shape[-1] >= 2:
        return _np_vorticity2d(field[..., :2]), True
    if mode == "magnitude":
        return np.linalg.norm(field, axis=-1), False
    return field[..., 0], True


def field_to_image(field: np.ndarray, mode: str = "vorticity",
                   vmax: float | None = None,
                   projection: str = "slice") -> np.ndarray:
    """Render one [H, W, C] or [D, H, W, C] field to an RGB uint8 image, +y
    up, scaled by ``vmax`` (default: the rendered scalar's own max).

    mode: "vorticity" | "magnitude" | "levelset" | "scalar"; projection (3D
    only): "slice" (the mid-depth plane) or "max" (the maximum-intensity
    projection along depth)."""
    scalar, diverging = _render_scalar(field, mode, projection)
    img = (_colorize_diverging(scalar, vmax) if diverging
           else _colorize_magnitude(scalar, vmax))
    return img[::-1]


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an RGB uint8 [H, W, 3] image as PNG (8-bit truecolour)."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),       # filter: none
                          np.ascontiguousarray(img).reshape(h, w * 3)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


# GIF palette: the 6 x 7 x 6 RGB cube (252 colours, padded to 256).
_LEVELS = (6, 7, 6)


def gif_palette() -> np.ndarray:
    """The [256, 3] uint8 palette every GIF frame is quantized to."""
    axes = [np.round(np.linspace(0, 255, n)) for n in _LEVELS]
    cube = np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")],
                    axis=1)
    return np.concatenate([cube, np.zeros((256 - len(cube), 3))]).astype(
        np.uint8)


def quantize(img: np.ndarray) -> np.ndarray:
    """RGB uint8 [H, W, 3] -> palette indices [H, W] (nearest cube level
    per channel)."""
    q = [np.rint(img[..., c] / 255.0 * (n - 1)).astype(np.int32)
         for c, n in enumerate(_LEVELS)]
    return ((q[0] * _LEVELS[1] + q[1]) * _LEVELS[2] + q[2]).astype(np.uint8)


def _lzw_uncompressed(indices: np.ndarray) -> bytes:
    """GIF image data for 8-bit indices, as 9-bit literal codes.

    A Clear code (256) before every 254 literals keeps the decoder's string
    table below 512 entries, so the code width never grows past 9 bits and
    no compression is needed; End (257) closes the stream."""
    px = indices.ravel().astype(np.uint16)
    parts = []
    for i in range(0, len(px), 254):
        parts += [np.array([256], np.uint16), px[i:i + 254]]
    parts.append(np.array([257], np.uint16))
    codes = np.concatenate(parts)
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(
        np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little").tobytes()
    blocks = [data[i:i + 255] for i in range(0, len(data), 255)]
    return b"\x08" + b"".join(bytes([len(b)]) + b for b in blocks) + b"\x00"


def gif_bytes(frames: Sequence[np.ndarray], fps: float = 25) -> bytes:
    """Encode RGB uint8 frames [H, W, 3] as a GIF89a looping forever, each
    frame shown round(100 / ``fps``) hundredths of a second (the format's
    unit)."""
    delay = struct.pack("<H", round(100 / fps))
    h, w, _ = frames[0].shape
    out = [b"GIF89a",
           struct.pack("<HHBBB", w, h, 0xF7, 0, 0),  # global 256-colour table
           gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for f in frames:
        out += [b"\x21\xf9\x04\x00" + delay + b"\x00\x00",  # its delay
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0),
                _lzw_uncompressed(quantize(f))]
    out.append(b"\x3b")
    return b"".join(out)


def _write(path: str, data: bytes) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def save_field_image(path: str, field: np.ndarray, mode: str = "vorticity",
                     vmax: float | None = None,
                     projection: str = "slice") -> str:
    return _write(path, png_bytes(field_to_image(field, mode, vmax,
                                                 projection)))


def save_image_grid(path: str, fields: Sequence[np.ndarray], ncol: int = 0,
                    mode: str = "vorticity", vmax: float | None = None,
                    projection: str = "slice") -> str:
    """Tile several fields into one PNG montage, each on its own colour
    scale unless ``vmax`` is given (the train-time sample dump)."""
    imgs = [field_to_image(f, mode, vmax, projection) for f in fields]
    ncol = ncol or int(np.ceil(np.sqrt(len(imgs))))
    nrow = -(-len(imgs) // ncol)
    h, w, _ = imgs[0].shape
    grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return _write(path, png_bytes(grid))


def save_gif(path: str, fields: Sequence[np.ndarray],
             mode: str = "vorticity", vmax: float | None = None,
             fps: float = 24, projection: str = "slice") -> str:
    """Assemble a field sequence into a GIF at ``fps`` frames a second.
    ``vmax=None`` takes ONE colour scale over the whole sequence (the
    largest |rendered scalar|), so a decaying plume fades instead of being
    renormalized every frame.

    JAX's ``save_gif`` hands imageio ``duration=1 / fps``, seconds, which
    imageio's Pillow plugin reads as milliseconds: its GIFs carry a delay
    of 0.  This one writes the frame rate that was meant."""
    if vmax is None:
        vmax = max((float(np.abs(_render_scalar(f, mode, projection)[0])
                          .max()) for f in fields), default=0.0) or None
    return _write(path, gif_bytes([field_to_image(f, mode, vmax, projection)
                                   for f in fields], fps))
