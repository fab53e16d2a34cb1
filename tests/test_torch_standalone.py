"""The port stands alone: it imports nothing of jax or of the JAX package,
and its own copies of the JAX package's numpy-only modules (``config``,
``data.manifest``, ``data.dataset``, ``data.native_npz``,
``infer.score``) behave as the originals on the same inputs; its
``train.augment`` runs with jax refused and gives the JAX module's signs.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from deepfluids_tpu import config as jconfig
from deepfluids_tpu.data import dataset as jdataset
from deepfluids_tpu.data import manifest as jmanifest
from deepfluids_tpu.data import native_npz as jnative
from deepfluids_tpu.infer import score as jscore
from deepfluids_tpu_torch import config as tconfig
from deepfluids_tpu_torch.data import dataset as tdataset
from deepfluids_tpu_torch.data import manifest as tmanifest
from deepfluids_tpu_torch.data import native_npz as tnative
from deepfluids_tpu_torch.infer import score as tscore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Refuses jax and the JAX package (the exact top-level name, not
# deepfluids_tpu_torch) ...
_REFUSE = """
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "deepfluids_tpu"):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
"""
# ... then imports every module of the port and chip_smoke.py.
_IMPORT_ALL = _REFUSE + """
import deepfluids_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deepfluids_tpu_torch.__path__, "deepfluids_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 30   # every module was imported


# The datagen with jax refused: a tiny matched 2D set and a liquid step
# through the CLI and the scene functions, then a density rendering.
_DATAGEN = _REFUSE + """
import sys, tempfile
import numpy as np
from deepfluids_tpu_torch.data import load_manifest
from deepfluids_tpu_torch.datagen import __main__ as cli, scenes
from deepfluids_tpu_torch.infer import advect_density

root = tempfile.mkdtemp()
cli.main(["--scene", "smoke_pos21_size5", "--out", root, "--num-a", "1",
          "--num-b", "1", "--num-frames", "2", "--name", "s", "--projection",
          "matched", "--device", "cpu"])
out = scenes.liquid_pos10_size4(root, num_pos=1, num_size=1, num_frames=2,
                                height=16, width=16, name="l", device="cpu")
m = load_manifest(root + "/s")
print(m.num_frames, load_manifest(out).data_type,
      sorted(sys.modules).count("jax"))
"""


def test_datagen_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _DATAGEN], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-3:] == ["2", "levelset", "0"]


# Every public name of the JAX datagen modules and of infer.advect has its
# counterpart in the port; what is left out, with its reason, is listed in
# ROADMAP.md ("Not to port").
_NOT_PORTED = {"scenes": {"_fetch_scene", "_FETCH_BYTES"}}


@pytest.mark.parametrize("module", [
    "datagen.grids", "datagen.smoke2d", "datagen.smoke3d",
    "datagen.liquid2d", "datagen.projection", "datagen.scenes",
    "datagen.__main__", "datagen", "infer.advect"])
def test_datagen_names_have_counterparts(module):
    import importlib
    import inspect

    theirs = importlib.import_module("deepfluids_tpu." + module)
    ours = importlib.import_module("deepfluids_tpu_torch." + module)
    names = [n for n, v in vars(theirs).items()
             if (inspect.isfunction(v) or inspect.isclass(v)
                 or n in ("SCENES", "_OPERATORS", "__all__"))
             and getattr(v, "__module__", theirs.__name__) == theirs.__name__]
    assert names
    left_out = _NOT_PORTED.get(module.split(".")[-1], set())
    missing = [n for n in names if not hasattr(ours, n) and n not in left_out]
    assert not missing, missing
    if hasattr(theirs, "__all__"):
        assert set(theirs.__all__) <= set(ours.__all__)


# The augmentation with jax refused: the signs, a mask and a flip.
_AUGMENT = _REFUSE + """
import torch
from deepfluids_tpu_torch.data import Manifest
from deepfluids_tpu_torch.train import augment

m = Manifest(param_names=["drop_x_pos", "drop_radius", "frame"],
             param_ranges=[[0.25, 0.75], [0.06, 0.15], [0.0, 199.0]],
             num_scenes=40, num_frames=200, resolution=[8, 6],
             num_channels=1, v_range=[-1.0, 1.0], data_type="levelset")
chan, psign = augment.flip_signs(m)
mask = augment.flip_mask(0, 3, 16)
x, y = augment.flip_x_batch(torch.ones(16, 8, 6, 1), torch.ones(16, 3),
                            mask, chan, psign)
print(chan.tolist(), psign.tolist(), int(mask.sum()), float(y[:, 0].sum()))
"""


def test_augment_runs_without_jax():
    from deepfluids_tpu.train import augment as jaugment

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _AUGMENT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    words = out.stdout.split()
    flipped, ysum = int(words[-2]), float(words[-1])
    assert 0 < flipped < 16 and ysum == 16 - 2 * flipped
    m = tmanifest.Manifest(
        param_names=["drop_x_pos", "drop_radius", "frame"],
        param_ranges=[[0.25, 0.75], [0.06, 0.15], [0.0, 199.0]],
        num_scenes=40, num_frames=200, resolution=[8, 6], num_channels=1,
        v_range=[-1.0, 1.0], data_type="levelset")
    want = [np.asarray(a).tolist() for a in jaugment.flip_signs(m)]
    assert out.stdout.startswith(f"{want[0]} {want[1]} ")


# --- config ----------------------------------------------------------------

def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_match():
    assert _fields(tconfig.Config) == _fields(jconfig.Config)
    assert tconfig.Config().dataset_dir == jconfig.Config().dataset_dir
    flags = [(a.dest, a.default, a.choices)
             for a in tconfig.get_parser()._actions]
    assert flags == [(a.dest, a.default, a.choices)
                     for a in jconfig.get_parser()._actions]


@pytest.mark.parametrize("argv", [
    [],
    ["--is_train", "False", "--load_path", "logs/run", "--test_counts",
     "21,5", "--test_frames", "20"],
    ["--is_3d", "True", "--res_z", "32", "--res_y", "64", "--res_x", "112",
     "--dataset", "smoke3_vel5_buo3", "--batch_size", "8", "--grad_clip",
     "0.5"],
    ["--arch", "de", "--loss_norm", "l2", "--relative_loss", "t",
     "--compute_dtype", "float32", "--device_data_cache", "true",
     "--cache_dtype", "float16"],
    ["--num_model_shards", "1", "--filters", "64", "--num_conv", "2",
     "--max_step", "300", "--lr_max", "2e-4"],
])
def test_get_config_matches(argv):
    ours, theirs = tconfig.get_config(argv), jconfig.get_config(argv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours._explicit_flags == theirs._explicit_flags
    assert ours.to_json() == theirs.to_json()


@pytest.mark.parametrize("argv", [["--is_train", "Ture"], ["--arch", "DE"],
                                  ["--loss_norm", "L1"]])
def test_get_config_refuses_the_same(argv):
    for get_config in (tconfig.get_config, jconfig.get_config):
        with pytest.raises(SystemExit):
            get_config(argv)


@pytest.mark.parametrize("writer,reader", [
    (tconfig, jconfig), (jconfig, tconfig)])
def test_params_json_is_read_by_both(tmp_path, writer, reader):
    cfg = writer.get_config(["--filters", "32", "--dataset", "tiny",
                             "--is_3d", "True"])
    writer.save_config(cfg, str(tmp_path))
    back = reader.load_config(str(tmp_path))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)


def test_merge_test_config_matches(tmp_path):
    run = str(tmp_path)
    jconfig.save_config(jconfig.get_config(["--filters", "32",
                                            "--num_conv", "2"]), run)
    argv = ["--is_train", "False", "--load_path", run, "--num_conv", "4",
            "--test_batch_size", "16"]
    ours = tconfig.merge_test_config(tconfig.get_config(argv), run)
    theirs = jconfig.merge_test_config(jconfig.get_config(argv), run)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.filters, ours.num_conv, ours.is_train) == (32, 4, False)


# --- data ------------------------------------------------------------------

MANIFESTS = [
    dict(param_names=["src_x_pos", "src_radius", "frame"],
         param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]], num_scenes=9,
         num_frames=4, resolution=[12, 10], num_channels=2,
         v_range=[-3.0, 2.5], data_type="velocity", param_counts=[3, 3]),
    dict(param_names=["inflow_vel", "buoyancy", "frame"],
         param_ranges=[[0.5, 1.5], [0.04, 0.12], [0.0, 249.0]],
         num_scenes=15, num_frames=250, resolution=[4, 6, 8],
         num_channels=3, v_range=[-1.0, 1.0]),
]


@pytest.mark.parametrize("kw", MANIFESTS, ids=["2d", "3d"])
def test_manifest_round_trip(tmp_path, kw):
    m = tmanifest.Manifest(**kw)
    tmanifest.save_manifest(m, str(tmp_path))
    back = tmanifest.load_manifest(str(tmp_path))
    assert back == m
    assert dataclasses.asdict(jmanifest.load_manifest(str(tmp_path))) == (
        dataclasses.asdict(m))
    assert (back.field_shape, back.is_3d, back.v_scale) == (
        tuple(kw["resolution"]) + (kw["num_channels"],),
        len(kw["resolution"]) == 3, max(abs(v) for v in kw["v_range"]))
    p = np.random.default_rng(0).uniform(0, 3, (5, 3)).astype(np.float32)
    jm = jmanifest.Manifest(**kw)
    np.testing.assert_array_equal(back.normalize_params(p),
                                  jm.normalize_params(p))
    np.testing.assert_array_equal(back.denormalize_params(p),
                                  jm.denormalize_params(p))


@pytest.mark.parametrize("seed,n,batch", [(0, 9, 4), (123, 256, 8),
                                          (7, 3750, 8)])
def test_step_batch_indices_match(seed, n, batch):
    for step in range(200):
        ours = tdataset.step_batch_indices(seed, step, n, batch)
        theirs = jdataset.step_batch_indices(seed, step, n, batch)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """A 3 x 3 scene x 4 frame 2D dataset of random fields (deflated .npz,
    as datagen writes them); its directory."""
    ds = str(tmp_path_factory.mktemp("standalone") / "tiny")
    tmanifest.save_manifest(tmanifest.Manifest(**MANIFESTS[0]), ds)
    os.makedirs(os.path.join(ds, "v"))
    rng = np.random.default_rng(1)
    for i in range(3):
        for j in range(3):
            for f in range(4):
                np.savez_compressed(
                    os.path.join(ds, "v", f"{i}_{j}_{f}.npz"),
                    x=rng.standard_normal((12, 10, 2)).astype(np.float32),
                    y=np.array([0.2 + 0.3 * i, 0.04 + 0.04 * j, f],
                               np.float32))
    return ds


@pytest.mark.parametrize("holdout,mode,pair", [
    (0, "edge", False), (2, "edge", False), (1, "interior", False),
    (0, "edge", True)])
def test_batch_manager_matches(tiny_dataset, holdout, mode, pair):
    kw = dict(batch_size=4, seed=5, num_workers=2, holdout_scenes=holdout,
              holdout_mode=mode, pair=pair)
    ours = tdataset.BatchManager(tiny_dataset, **kw)
    theirs = jdataset.BatchManager(tiny_dataset, **kw)
    try:
        for name in ("train_indices", "eval_indices"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name))
        assert ours.ds.files == theirs.ds.files
        assert ours.ds.scene_keys == theirs.ds.scene_keys
        for (xo, yo), (xt, yt) in zip(ours.batches(6, start_step=3),
                                      theirs.batches(6, start_step=3)):
            np.testing.assert_array_equal(xo, xt)
            np.testing.assert_array_equal(yo, yt)
        xo, _ = ours.sample_batch(np.random.default_rng(2))
        xt, _ = theirs.sample_batch(np.random.default_rng(2))
        np.testing.assert_array_equal(xo, xt)
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("key,shape", [("x", (12, 10, 2)), ("y", (3,))])
def test_load_npz_batch_matches(tiny_dataset, key, shape):
    files = tdataset.FieldDataset(tiny_dataset).files
    ours = tnative.load_npz_batch(files, key, shape, num_threads=2)
    theirs = jnative.load_npz_batch(files, key, shape, num_threads=2)
    assert ours.shape == (len(files),) + shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        tnative.load_npz_field(files[5], key), theirs[5])


def test_native_reader_builds_into_the_port():
    # The port builds native/npz_loader.cc into its own _build/ and leaves
    # the JAX package's native/libnpz.so alone.
    if not tnative.native_available():
        pytest.skip("no C++ toolchain: the numpy reader is in use")
    path = tnative._lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(os.path.dirname(path)) == os.path.join(
        REPO, "deepfluids_tpu_torch", "_build")


# --- infer.score -----------------------------------------------------------

@pytest.mark.parametrize("scene,frames", [("0_0", 4), ("2_1", 3),
                                          ("1_2", 6)])
def test_score_matches(tiny_dataset, scene, frames):
    # A rollout of `frames` frames (more than the scene holds in the last
    # case) scored against the scene's simulated frames.
    x = np.random.default_rng(3).standard_normal(
        (frames, 12, 10, 2)).astype(np.float32)
    ours = tscore.score_rollout_vs_sim(x, tiny_dataset, scene)
    assert ours == jscore.score_rollout_vs_sim(x, tiny_dataset, scene)
    assert ours["rollout_steps"] == min(frames, 4)
    np.testing.assert_array_equal(
        tscore.load_scene_fields(tiny_dataset, scene),
        jscore.load_scene_fields(tiny_dataset, scene))
    for mod in (tscore, jscore):
        with pytest.raises(FileNotFoundError):
            mod.score_rollout_vs_sim(x, tiny_dataset, "9_9")
