"""The port's image renders and sweep-directory parity against the JAX
package's.

``deepfluids_tpu_torch.utils.images.field_to_image`` must give JAX's
``field_to_image`` bytes for every mode (vorticity, magnitude, levelset,
scalar) and projection (the mid-depth slice, the maximum-intensity
projection) of 2D and 3D fields; a GIF under ``"max"`` takes one colour
scale over the sequence, the JAX rule; ``utils.parity.check_dirs`` returns
JAX's dict for two sweep directories.
"""

import io
import os
import struct

import numpy as np
import pytest

from deepfluids_tpu.utils import images as jimages
from deepfluids_tpu.utils import parity as jparity
from deepfluids_tpu_torch.utils import images, parity

MODES = ["vorticity", "magnitude", "levelset", "scalar"]
SHAPES = {"2d": (16, 12, 2), "3d": (6, 16, 12, 3)}


def _field(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("nd", list(SHAPES))
@pytest.mark.parametrize("projection", ["slice", "max"])
@pytest.mark.parametrize("mode", MODES)
def test_field_to_image_is_jax_bytes(mode, projection, nd):
    field = _field(SHAPES[nd], 0)
    got = images.field_to_image(field, mode, projection=projection)
    want = jimages.field_to_image(field, mode, projection=projection)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and on a given colour scale
    np.testing.assert_array_equal(
        images.field_to_image(field, mode, 0.5, projection),
        jimages.field_to_image(field, mode, 0.5, projection))


def test_gif_shares_one_scale_under_max_projection(tmp_path):
    """Three 3D frames of decaying amplitude: every frame of the GIF is
    rendered on the scale of the largest (the JAX rule), not its own."""
    Image = pytest.importorskip("PIL.Image")
    frames = [_field(SHAPES["3d"], k) * s
              for k, s in enumerate((1.0, 0.5, 0.1))]
    for mode in ("vorticity", "magnitude"):
        path = images.save_gif(str(tmp_path / f"{mode}.gif"), frames, mode,
                               projection="max")
        vmax = max(float(np.abs(jimages._render_scalar(f, mode, "max")[0])
                         .max()) for f in frames)
        gif = Image.open(path)
        assert gif.n_frames == len(frames)
        pal = images.gif_palette()
        for k, f in enumerate(frames):
            gif.seek(k)
            want = jimages.field_to_image(f, mode, vmax, "max")
            np.testing.assert_array_equal(np.asarray(gif.convert("RGB")),
                                          pal[images.quantize(want)])
        # the faded last frame is not renormalized to full saturation
        assert not np.array_equal(
            images.field_to_image(frames[-1], mode, vmax, "max"),
            images.field_to_image(frames[-1], mode, projection="max"))


def _gif_delays(data: bytes) -> list[int]:
    """Each frame's delay, in 1/100 s, from its Graphics Control Extension
    (None for a frame without one): a walk over the GIF's blocks."""
    def skip_sub_blocks(i):
        while data[i]:
            i += data[i] + 1
        return i + 1

    def table(flags):
        return 3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0

    assert data[:6] in (b"GIF87a", b"GIF89a")
    i, delays, pending = 13 + table(data[10]), [], None
    while data[i] != 0x3B:
        if data[i] == 0x21:                       # an extension
            if data[i + 1] == 0xF9:
                pending = struct.unpack("<H", data[i + 4:i + 6])[0]
            i = skip_sub_blocks(i + 2)
        elif data[i] == 0x2C:                     # an image
            delays.append(pending)
            pending = None
            i = skip_sub_blocks(i + 10 + table(data[i + 9]) + 1)
        else:
            raise AssertionError(f"byte {data[i]:#x} at {i}: not a block")
    return delays


@pytest.mark.parametrize("fps,delay", [(24, 4), (10, 10)])
def test_gif_frame_rate(tmp_path, fps, delay):
    """``save_gif``'s ``fps`` is the delay round(100 / fps) of every frame,
    and the frames are the pixels JAX's ``save_gif`` renders."""
    Image = pytest.importorskip("PIL.Image")
    frames = [_field(SHAPES["2d"], k) * s
              for k, s in enumerate((1.0, 0.5, 0.1))]
    path = images.save_gif(str(tmp_path / "port.gif"), frames, "vorticity",
                           None, fps)
    with open(path, "rb") as f:
        assert _gif_delays(f.read()) == [delay] * len(frames)
    vmax = max(float(np.abs(jimages._render_scalar(f, "vorticity",
                                                   "slice")[0]).max())
               for f in frames)
    gif, pal = Image.open(path), images.gif_palette()
    for k, f in enumerate(frames):
        gif.seek(k)
        want = jimages.field_to_image(f, "vorticity", vmax)
        np.testing.assert_array_equal(np.asarray(gif.convert("RGB")),
                                      pal[images.quantize(want)])


def test_gif_default_rate_is_unchanged():
    """25 fps, 4/100 s a frame, as before ``fps`` existed; ``save_gif``'s
    default (JAX's 24 fps) rounds to the same delay."""
    frames = [images.field_to_image(_field(SHAPES["2d"], k), "vorticity")
              for k in range(2)]
    data = images.gif_bytes(frames)
    assert data == images.gif_bytes(frames, 25) == images.gif_bytes(
        frames, 24)
    assert _gif_delays(data) == [4, 4]


@pytest.mark.parametrize("fps", [24, 10])
def test_jax_save_gif_writes_a_delay_of_zero(tmp_path, fps):
    """The reference's fault that the port does not copy (ROADMAP, held
    divergences): JAX's ``save_gif`` passes ``duration=1 / fps`` seconds,
    which imageio's Pillow plugin takes as milliseconds: every frame's
    delay is 0 or absent (a decoder reads an absent one as 0)."""
    pytest.importorskip("imageio")
    frames = [_field(SHAPES["2d"], k) for k in range(3)]
    path = jimages.save_gif(str(tmp_path / "jax.gif"), frames, fps=fps)
    with open(path, "rb") as f:
        delays = _gif_delays(f.read())
    assert len(delays) == 3 and set(delays) <= {None, 0} and 0 in delays


def test_png_writers_take_the_projection(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    field = _field(SHAPES["3d"], 3)
    one = images.save_field_image(str(tmp_path / "one.png"), field,
                                  "magnitude", projection="max")
    grid = images.save_image_grid(str(tmp_path / "grid.png"),
                                  [field, field * 2], ncol=2, mode="magnitude",
                                  vmax=1.0, projection="max")
    with open(one, "rb") as f:
        got = np.asarray(Image.open(io.BytesIO(f.read())).convert("RGB"))
    np.testing.assert_array_equal(
        got, jimages.field_to_image(field, "magnitude", projection="max"))
    got = np.asarray(Image.open(grid).convert("RGB"))
    w = SHAPES["3d"][2]
    for i, f in enumerate((field, field * 2)):
        np.testing.assert_array_equal(
            got[:, i * w:(i + 1) * w],
            jimages.field_to_image(f, "magnitude", 1.0, "max"))


def test_check_dirs_matches_jax(tmp_path):
    """Two sweep directories sharing three of their files, one of them off
    the gate: the same dict as JAX's; none shared raises, as JAX's."""
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    os.makedirs(ours)
    os.makedirs(ref)
    rng = np.random.default_rng(4)
    for name in ("0_0", "0_1", "1_0", "1_1"):
        x = rng.standard_normal((8, 6, 2)).astype(np.float32)
        np.savez(ref / f"{name}.npz", x=x, y=np.zeros(3))
        if name != "1_1":
            off = 1e-2 if name == "0_1" else 1e-5
            np.savez(ours / f"{name}.npz", x=x * (1 + off), y=np.zeros(3))
    got = parity.check_dirs(str(ours), str(ref))
    assert got == jparity.check_dirs(str(ours), str(ref))
    assert got["num_compared"] == 3 and got["num_failed"] == 1
    assert got["missing_in_ours"] == ["1_1.npz"]
    assert parity.check_dirs(str(ours), str(ref), tol=0.1) == (
        jparity.check_dirs(str(ours), str(ref), tol=0.1))
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError):
        parity.check_dirs(str(empty), str(ref))
