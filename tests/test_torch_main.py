"""The port's serving path end to end against the JAX package's.

A JAX ``de`` run is trained 3 steps on a tiny smoke dataset (as
tests/test_main.py does), its params are exported to ``weights.npz``, and
the JAX sweep and the port's ``main`` sweep the same grid from the same
weights.  Fields must agree at normalized L2 < 1e-3, the repo's parity gate.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.config import Config, load_config  # noqa: E402
from deepfluids_tpu.datagen import scenes  # noqa: E402
from deepfluids_tpu_torch.main import main as torch_main  # noqa: E402
from deepfluids_tpu_torch.ops import cuda_fd  # noqa: E402
from deepfluids_tpu_torch.utils.images import (  # noqa: E402
    field_to_image,
    gif_bytes,
    gif_palette,
    png_bytes,
    quantize,
)
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(env, **kw):
    base = dict(arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=env["data"], dataset="tiny", log_dir=env["logs"],
                max_step=3, lr_max=1e-3, lr_min=1e-4, log_step=1,
                test_step=1000, save_step=1000, compute_dtype="float32",
                num_worker=2, seed=0, test_batch_size=8, tag="de")
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A trained JAX run with its JAX sweep, plus a copy of its params.json
    and exported weights.npz for the port to sweep."""
    from deepfluids_tpu.main import main as jax_main
    from deepfluids_tpu.train.trainer import Trainer as JaxTrainer

    root = tmp_path_factory.mktemp("torch_e2e")
    env = {"data": str(root / "data"), "logs": str(root / "logs")}
    scenes.smoke_pos21_size5(env["data"], num_pos=2, num_size=2,
                             num_frames=4, height=32, width=32, name="tiny")
    jax_main(_cfg(env))
    run = os.path.join(env["logs"], "tiny_de")
    jax_result = jax_main(_cfg(env, is_train=False, load_path=run,
                               test_frames=4))
    # The export EXPORT_COMMAND performs, done in-process.
    t = JaxTrainer(load_config(run), run_dir=run, save_cfg=False)
    t.restore_checkpoint()
    torch_run = str(root / "torch_run")
    os.makedirs(torch_run)
    weights_io.export_npz(t.state.params,
                          os.path.join(torch_run, "weights.npz"))
    shutil.copy(os.path.join(run, "params.json"), torch_run)
    return {"env": env, "jax_run": run, "jax_result": jax_result,
            "torch_run": torch_run}


def test_sweep_matches_jax(runs):
    env, torch_run = runs["env"], runs["torch_run"]
    before = cuda_fd.launch_counts["curl2d_fused"]
    result = torch_main(_cfg(env, is_train=False, load_path=torch_run,
                             test_frames=4), device="cpu")
    assert cuda_fd.launch_counts["curl2d_fused"] == before
    jax_test = os.path.join(runs["jax_run"], "test")
    ours = os.path.join(torch_run, "test")
    names = sorted(f for f in os.listdir(jax_test) if f.endswith(".npz"))
    assert result["num_fields"] == len(names) == 16
    assert sorted(f for f in os.listdir(ours) if f.endswith(".npz")) == names
    for name in names:
        with np.load(os.path.join(jax_test, name)) as a, \
                np.load(os.path.join(ours, name)) as b:
            assert b["x"].shape == (32, 32, 2) and b["x"].dtype == np.float32
            assert normalized_l2(b["x"], a["x"]) < 1e-3, name
            np.testing.assert_array_equal(b["y"], a["y"])
    assert os.path.exists(os.path.join(ours, "scene0.gif"))
    assert os.path.exists(os.path.join(ours, "0_0.png"))
    want = runs["jax_result"]["eval"]
    for key in ("l2_mean", "l2_median", "l2_max", "rmse"):
        assert abs(result["eval"][key] - want[key]) < 1e-3, key
    assert result["eval"]["num_samples"] == want["num_samples"]


def test_missing_weights_names_the_export(runs, tmp_path):
    run = str(tmp_path / "no_weights")
    os.makedirs(run)
    shutil.copy(os.path.join(runs["torch_run"], "params.json"), run)
    with pytest.raises(FileNotFoundError, match="weights_io.export_npz"):
        torch_main(_cfg(runs["env"], is_train=False, load_path=run),
                   device="cpu")


@pytest.mark.parametrize("kw,match", [
    ({"is_train": True, "augment_flip_x": True}, "Queue A item 9"),
    ({"is_train": False, "arch": "ae"}, "Queue A item 7"),
    ({"is_train": False, "arch": "nn"}, "Queue A item 8"),
    ({"is_train": False, "decoder": "grid"}, "Queue A item 10"),
    ({"is_train": False, "embed_bands": 2}, "Queue A item 10"),
    ({"is_train": False, "spectral_modes": 4}, "Queue A item 10"),
    ({"is_train": False, "spatial_shard": True}, "Queue A item 11")])
def test_unported_paths_raise(runs, kw, match):
    cfg = _cfg(runs["env"], load_path=runs["torch_run"], **kw)
    with pytest.raises(NotImplementedError, match=match):
        torch_main(cfg, device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, pkgutil, importlib, deepfluids_tpu_torch, "
            "deepfluids_tpu_torch.main\n"
            "for m in pkgutil.walk_packages(deepfluids_tpu_torch.__path__, "
            "'deepfluids_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_png_decodes_exactly():
    Image = pytest.importorskip("PIL.Image")
    import io

    field = np.random.default_rng(1).standard_normal((20, 12, 2))
    img = field_to_image(field)
    back = np.asarray(Image.open(io.BytesIO(png_bytes(img))).convert("RGB"))
    np.testing.assert_array_equal(back, img)


def test_gif_decodes_to_quantized_frames():
    Image = pytest.importorskip("PIL.Image")
    import io

    rng = np.random.default_rng(2)
    # 40x30 = 1200 pixels: several Clear-code runs of 254 literals
    frames = [field_to_image(rng.standard_normal((40, 30, 2)))
              for _ in range(3)]
    gif = Image.open(io.BytesIO(gif_bytes(frames)))
    pal = gif_palette()
    assert gif.n_frames == 3
    for k, f in enumerate(frames):
        gif.seek(k)
        got = np.asarray(gif.convert("RGB"))
        np.testing.assert_array_equal(got, pal[quantize(f)])

