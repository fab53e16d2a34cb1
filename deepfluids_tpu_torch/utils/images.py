"""Field visualization: vorticity PNGs and GIFs, numpy only.

Counterpart of :mod:`deepfluids_tpu.utils.images` for the renders the
sweep and the trainer write, with the same diverging colormap and the same
orientation (origin flipped so +y is up).  A 3D field renders as its
mid-depth slice, the JAX module's default ``projection="slice"`` (its
``"max"`` projection is not ported).  The JAX module writes through PIL and
imageio; here the PNG (zlib + CRC chunks) and the GIF (a fixed 252-colour
palette, uncompressed LZW) are written with numpy and the standard library
alone, so serving needs neither package.
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


def _render_scalar(field: np.ndarray, mode: str) -> np.ndarray:
    """The signed scalar [H, W] a field renders as: the (mid-depth slice of
    a 3D field's) vorticity of its first two channels, or its first
    channel (levelset / generic scalar)."""
    field = np.asarray(field, np.float32)
    if field.ndim == 4:      # [D, H, W, C] -> the mid-depth plane
        field = field[field.shape[0] // 2]
    if field.ndim != 3:
        raise ValueError(f"cannot render a field of shape {field.shape}: "
                         "want [H, W, C] or [D, H, W, C]")
    if mode == "vorticity" and field.shape[-1] >= 2:
        return _np_vorticity2d(field[..., :2])
    return field[..., 0]


def field_to_image(field: np.ndarray, mode: str = "vorticity",
                   vmax: float | None = None) -> np.ndarray:
    """Render one [H, W, C] field (or the mid-depth slice of a [D, H, W, C]
    one) to an RGB uint8 image, +y up, on the blue-white-red map scaled by
    ``vmax`` (default: the field's own max).

    mode: "vorticity" | "levelset" | "scalar"."""
    return _colorize_diverging(_render_scalar(field, mode), vmax)[::-1]


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


def gif_bytes(frames: Sequence[np.ndarray]) -> bytes:
    """Encode RGB uint8 frames [H, W, 3] as a GIF89a looping at 25 fps."""
    h, w, _ = frames[0].shape
    out = [b"GIF89a",
           struct.pack("<HHBBB", w, h, 0xF7, 0, 0),  # global 256-colour table
           gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for f in frames:
        out += [b"\x21\xf9\x04\x00\x04\x00\x00\x00",  # 4/100 s a frame
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0),
                _lzw_uncompressed(quantize(f))]
    out.append(b"\x3b")
    return b"".join(out)


def _write(path: str, data: bytes) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def save_field_image(path: str, field: np.ndarray,
                     mode: str = "vorticity") -> str:
    return _write(path, png_bytes(field_to_image(field, mode)))


def save_image_grid(path: str, fields: Sequence[np.ndarray], ncol: int = 0,
                    mode: str = "vorticity") -> str:
    """Tile several fields into one PNG montage, each on its own colour
    scale (the train-time sample dump)."""
    imgs = [field_to_image(f, mode) for f in fields]
    ncol = ncol or int(np.ceil(np.sqrt(len(imgs))))
    nrow = -(-len(imgs) // ncol)
    h, w, _ = imgs[0].shape
    grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return _write(path, png_bytes(grid))


def save_gif(path: str, fields: Sequence[np.ndarray],
             mode: str = "vorticity") -> str:
    """Assemble a field sequence into a GIF with ONE colour scale over the
    whole sequence, so a decaying plume fades instead of being renormalized
    every frame."""
    vmax = max((float(np.abs(_render_scalar(f, mode)).max())
                for f in fields), default=0.0) or None
    return _write(path, gif_bytes([field_to_image(f, mode, vmax)
                                   for f in fields]))
