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
