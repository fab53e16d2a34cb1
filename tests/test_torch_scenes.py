"""The port's scene writers (``deepfluids_tpu_torch.datagen.scenes``) and
datagen CLI held against the JAX package's on the CPU: each of the four
scenes at a tiny grid writes the same file names, the same ``args.txt``
fields and, to a per-frame normalized L2 under 1e-3 (the repo's parity
gate), the same frames and parameter vectors.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from deepfluids_tpu.data import load_manifest as jload_manifest
from deepfluids_tpu.datagen import scenes as jscenes
from deepfluids_tpu_torch.data import FieldDataset, load_manifest
from deepfluids_tpu_torch.datagen import __main__ as cli
from deepfluids_tpu_torch.datagen import scenes as tscenes
from deepfluids_tpu_torch.utils.parity import normalized_l2

# scene -> (kwargs for both packages, field dirs)
TINY = {
    "smoke_pos21_size5": (dict(num_pos=2, num_size=2, num_frames=4,
                               height=32, width=32), ("v", "d")),
    "smoke_mov": (dict(num_scenes=3, num_frames=5, height=32, width=32,
                       seed=3), ("v", "d")),
    "liquid_pos10_size4": (dict(num_pos=2, num_size=1, num_frames=3,
                                height=32, width=32), ("l", "v")),
    "smoke3_vel5_buo3": (dict(num_vel=2, num_buo=1, num_frames=3, depth=6,
                              height=8, width=8), ("v", "d")),
}


@pytest.fixture(scope="module", params=sorted(TINY))
def pair(request, tmp_path_factory):
    """(scene, JAX's dataset dir, the port's dataset dir, field dirs)."""
    kw, keys = TINY[request.param]
    root = tmp_path_factory.mktemp(request.param)
    theirs = jscenes.SCENES[request.param](str(root / "jax"), name="tiny",
                                           **kw)
    ours = tscenes.SCENES[request.param](str(root / "torch"), name="tiny",
                                         device="cpu", **kw)
    return request.param, theirs, ours, keys


def test_same_file_names(pair):
    _, theirs, ours, keys = pair
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for k in keys:
        names = sorted(os.listdir(os.path.join(ours, k)))
        assert names and names == sorted(os.listdir(os.path.join(theirs, k)))


def test_same_manifest(pair):
    _, theirs, ours, _ = pair
    mo, mt = load_manifest(ours), jload_manifest(theirs)
    do, dt = dataclasses.asdict(mo), dataclasses.asdict(mt)
    vo, vt = do.pop("v_range"), dt.pop("v_range")
    assert do == dt
    np.testing.assert_allclose(vo, vt, rtol=1e-3, atol=1e-5)
    assert vo[0] < vo[1]


def test_same_frames(pair):
    _, theirs, ours, keys = pair
    for k in keys:
        for name in sorted(os.listdir(os.path.join(ours, k))):
            with np.load(os.path.join(ours, k, name)) as a, \
                    np.load(os.path.join(theirs, k, name)) as b:
                assert a["x"].dtype == np.float32 == a["y"].dtype
                assert a["x"].shape == b["x"].shape
                np.testing.assert_array_equal(a["y"], b["y"])
                if np.abs(b["x"]).max() > 0:
                    assert normalized_l2(a["x"], b["x"]) < 1e-3, (k, name)
                else:
                    assert np.abs(a["x"]).max() == 0


def test_the_port_reads_what_it_wrote(pair):
    scene, _, ours, keys = pair
    ds = FieldDataset(ours, field_key=keys[0])
    x, y = ds.get(0)
    m = load_manifest(ours)
    assert x.shape == m.field_shape and y.shape == (m.num_param,)
    xn, yn = ds.get_normalized(0)
    assert np.abs(xn).max() <= 1.0 + 1e-6 and np.abs(yn).max() <= 1.0 + 1e-6


def test_smoke_mov_params_are_numpys_knots(tmp_path):
    out = tscenes.smoke_mov(str(tmp_path), num_scenes=2, num_frames=80,
                            height=16, width=16, seed=5, name="m",
                            device="cpu")
    rng = np.random.default_rng(5)
    for s in range(2):
        knots = rng.uniform(0.2, 0.8, size=2)
        want = np.interp(np.linspace(0, 1, 80), np.arange(2), knots
                         ).astype(np.float32)
        got = np.stack([np.load(os.path.join(out, "v", f"{s}_{f}.npz"))["y"]
                        for f in range(80)])
        np.testing.assert_array_equal(got[:, 0], want)
        np.testing.assert_array_equal(got[:, 1], np.arange(80))


def test_stale_frames_are_cleared(tmp_path):
    kw = dict(num_size=1, height=16, width=16, name="s", device="cpu")
    tscenes.smoke_pos21_size5(str(tmp_path), num_pos=2, num_frames=3, **kw)
    out = tscenes.smoke_pos21_size5(str(tmp_path), num_pos=1, num_frames=2,
                                    **kw)
    assert sorted(os.listdir(os.path.join(out, "v"))) == ["0_0_0.npz",
                                                          "0_0_1.npz"]


def test_scene_batch_does_not_change_the_frames(tmp_path):
    kw = dict(num_pos=3, num_size=1, num_frames=3, height=16, width=16,
              device="cpu")
    a = tscenes.smoke_pos21_size5(str(tmp_path), name="a", scene_batch=1,
                                  **kw)
    b = tscenes.smoke_pos21_size5(str(tmp_path), name="b", scene_batch=2,
                                  **kw)
    for name in sorted(os.listdir(os.path.join(a, "v"))):
        np.testing.assert_allclose(
            np.load(os.path.join(a, "v", name))["x"],
            np.load(os.path.join(b, "v", name))["x"], atol=1e-6)


def test_3d_surplus_frames_of_the_last_segment_are_dropped(tmp_path):
    # 52 frames in segments of 50: the second segment keeps two frames.
    out = tscenes.smoke3_vel5_buo3(str(tmp_path), num_vel=1, num_buo=1,
                                   num_frames=52, depth=6, height=8, width=8,
                                   name="seg", device="cpu")
    names = set(os.listdir(os.path.join(out, "v")))
    assert names == {f"0_0_{f}.npz" for f in range(52)}
    assert load_manifest(out).num_frames == 52
    y = np.load(os.path.join(out, "d", "0_0_51.npz"))["y"]
    np.testing.assert_array_equal(y, np.array([0.5, 0.04, 51.0], np.float32))


def test_auto_scene_batch():
    assert tscenes._auto_scene_batch(15, torch.device("cpu")) == 1
    assert tscenes._auto_scene_batch(15, torch.device("cuda")) == 15
    assert set(tscenes.SCENES) == set(jscenes.SCENES)


@pytest.mark.parametrize("scene", sorted(TINY))
def test_scene_functions_default_to_the_card(tmp_path, scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tscenes.SCENES[scene](str(tmp_path), **TINY[scene][0])
    assert not os.listdir(tmp_path)


# --- the CLI ---------------------------------------------------------------

def test_cli_projection_flag(tmp_path, monkeypatch):
    seen = {}

    def fake_scene(out_root, **kwargs):
        seen.update(kwargs)
        return out_root

    monkeypatch.setitem(cli.SCENES, "smoke_pos21_size5", fake_scene)
    cli.main(["--scene", "smoke_pos21_size5", "--out", str(tmp_path),
              "--num-a", "2", "--num-b", "1", "--num-frames", "3",
              "--projection", "matched", "--device", "cpu"])
    assert seen == {"projection": "matched", "num_pos": 2, "num_size": 1,
                    "num_frames": 3, "device": "cpu"}


def test_cli_projection_guard(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--scene", "liquid_pos10_size4", "--out", str(tmp_path),
                  "--projection", "matched", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--scene", "smoke_pos21_size5", "--out", str(tmp_path),
                  "--projection", "Matched", "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_cli_writes_a_dataset_and_raises_without_a_card(tmp_path, capsys):
    cli.main(["--scene", "smoke_mov", "--out", str(tmp_path), "--num-a", "1",
              "--num-frames", "2", "--name", "m", "--device", "cpu"])
    assert "dataset written to" in capsys.readouterr().out
    assert load_manifest(str(tmp_path / "m")).num_scenes == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--scene", "smoke_mov", "--out", str(tmp_path),
                      "--num-a", "1", "--num-frames", "2", "--name", "n"])
