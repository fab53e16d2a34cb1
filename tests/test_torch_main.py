"""The port's CLI end to end against the JAX package's.

A JAX ``de`` run is trained 3 steps on a tiny smoke dataset (as
tests/test_main.py does), its params are exported to ``weights.npz``, and
the JAX sweep and the port's ``main`` sweep the same grid from the same
weights.  The port's config #4 pipeline (``ae`` train, encode, ``nn``
train, rollout) runs on the same dataset, and JAX's ``rollout_trajectory``
rolls out the port's weights.  Fields must agree at normalized L2 < 1e-3,
the repo's parity gate.
"""

import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.config import Config, load_config  # noqa: E402
from deepfluids_tpu.datagen import scenes  # noqa: E402
from deepfluids_tpu_torch.config import Config as PortConfig  # noqa: E402
from deepfluids_tpu_torch.infer.sweep import (  # noqa: E402
    run_test_sweep,
    sweep_generator,
    sweep_on_device,
)
from deepfluids_tpu_torch.main import main as torch_main  # noqa: E402
from deepfluids_tpu_torch.ops import cuda_fd  # noqa: E402
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402
from deepfluids_tpu_torch.utils.images import (  # noqa: E402
    field_to_image,
    gif_bytes,
    gif_palette,
    png_bytes,
    quantize,
)
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kw(env, **kw):
    base = dict(arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=env["data"], dataset="tiny", log_dir=env["logs"],
                max_step=3, lr_max=1e-3, lr_min=1e-4, log_step=1,
                test_step=1000, save_step=1000, compute_dtype="float32",
                num_worker=2, seed=0, test_batch_size=8, tag="de")
    base.update(kw)
    return base


def _cfg(env, **kw):
    """The JAX package's config."""
    return Config(**_kw(env, **kw))


def _port_cfg(env, **kw):
    """The port's config, from the same keywords."""
    return PortConfig(**_kw(env, **kw))


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
    result = torch_main(_port_cfg(env, is_train=False, load_path=torch_run,
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


def test_ae_nn_pipeline_matches_jax_rollout(runs):
    """``ae`` train (with sample dumps) -> encode pass -> ``nn`` train ->
    ``nn`` rollout through ``main``; JAX's ``rollout_trajectory`` on the
    port's two ``weights.npz`` gives the fields of ``rollout.npz``."""
    import jax
    import jax.numpy as jnp

    from deepfluids_tpu.data.manifest import load_manifest
    from deepfluids_tpu.infer import rollout_trajectory
    from deepfluids_tpu.models import Autoencoder, LatentIntegrator
    from deepfluids_tpu.train.losses import apply_curl

    env = runs["env"]
    before = dict(cuda_fd.launch_counts)
    torch_main(_port_cfg(env, arch="ae", tag="ae", test_step=2),
               device="cpu")
    ae_run = os.path.join(env["logs"], "tiny_ae")
    assert os.listdir(os.path.join(ae_run, "sample")) == ["0000002.png"]
    r = torch_main(_port_cfg(env, arch="ae", is_train=False,
                             load_path=ae_run), device="cpu")
    code_dir = os.path.join(env["data"], "tiny", "code8")
    assert r == {"code_dir": code_dir}
    assert len(os.listdir(code_dir)) == 4          # one file a scene
    torch_main(_port_cfg(env, arch="nn", tag="nn", w_num=3), device="cpu")
    nn_run = os.path.join(env["logs"], "tiny_nn")
    with pytest.raises(SystemExit, match="ae_load_path"):
        torch_main(_port_cfg(env, arch="nn", is_train=False,
                             load_path=nn_run), device="cpu")
    r = torch_main(_port_cfg(env, arch="nn", is_train=False,
                             load_path=nn_run, ae_load_path=ae_run,
                             test_frames=4), device="cpu")
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"
    out = os.path.join(nn_run, "test")
    assert r["rollout_steps"] == 4 and r["out_dir"] == out
    assert r["rollout_field_l2"]["rollout_steps"] == 4
    assert os.path.exists(os.path.join(out, "rollout.gif"))
    with np.load(os.path.join(out, "rollout.npz")) as d:
        got_x, got_z = d["x"], d["z"]
    assert got_x.shape == (4, 32, 32, 2) and np.isfinite(got_x).all()
    assert got_z.shape == (4, 1, 8)

    fae = Autoencoder(output_shape=(32, 32, 1), z_num=8, filters=8,
                      num_conv=1, num_param=3)
    ae_params = weights_io.import_npz(
        os.path.join(ae_run, "weights.npz"),
        fae.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2)))["params"])
    fnn = LatentIntegrator(z_num=8, num_param=3)
    nn_params = weights_io.import_npz(
        os.path.join(nn_run, "weights.npz"),
        fnn.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)),
                 jnp.zeros((1, 3)))["params"])
    first = sorted(os.listdir(code_dir))[0]
    with np.load(os.path.join(code_dir, first)) as d:
        z_seq, p_raw = d["z"], d["p"]
    want_z, want_x = rollout_trajectory(
        lambda q, zf, dp: fnn.apply({"params": q}, zf, dp), nn_params,
        lambda z: apply_curl(fae.apply({"params": ae_params}, z,
                                       method=fae.decode)),
        z_seq[:1], p_raw[:4], load_manifest(os.path.join(env["data"],
                                                         "tiny")),
        decode_batch=8)
    np.testing.assert_allclose(got_z, want_z, atol=1e-5)
    assert normalized_l2(got_x, want_x[:, 0]) < 1e-3


def test_missing_weights_names_the_export(runs, tmp_path):
    run = str(tmp_path / "no_weights")
    os.makedirs(run)
    shutil.copy(os.path.join(runs["torch_run"], "params.json"), run)
    with pytest.raises(FileNotFoundError, match="weights_io.export_npz"):
        torch_main(_port_cfg(runs["env"], is_train=False, load_path=run),
                   device="cpu")


@pytest.mark.parametrize("kw,exc,match", [
    # The JAX trainer's refusal, with its message.
    pytest.param({"is_train": False, "arch": "nn", "ae_load_path": "ae",
                  "decoder": "grid"}, ValueError, "applies to arch de",
                 id="kw1-ValueError-applies to arch de")])
def test_unported_paths_raise(runs, kw, exc, match):
    cfg = _port_cfg(runs["env"], load_path=runs["torch_run"], **kw)
    with pytest.raises(exc, match=match):
        torch_main(cfg, device="cpu")


@pytest.mark.parametrize("kw,ranks", [
    ({"arch": "ae", "spatial_shard": True, "num_model_shards": 2}, 4),
    ({"spatial_shard": True, "spectral_modes": 4}, 2)],
    ids=["ae-rows_by_channels", "de-spectral"])
def test_spatial_combinations_train_and_serve_through_main(runs, kw, ranks):
    """--spatial_shard with --num_model_shards 2 (arch ae, 2 rows x 2
    channels over 4 ranks) and with --spectral_modes (2 ranks) train
    through ``python -m deepfluids_tpu_torch.main`` on gloo ranks, then
    serve from the run in one process (the encode pass; the sweep)."""
    from deepfluids_tpu_torch.tools import launch_multihost

    env = runs["env"]
    tag = "sp_" + "_".join(f"{k}{v}" for k, v in kw.items() if k != "arch")
    flags = _kw(env, tag=tag, **kw)
    argv = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
    rcs, outs = launch_multihost.spawn(
        [sys.executable, "-m", "deepfluids_tpu_torch.main", "--device",
         "cpu", *argv], ranks, "gloo", threads=1, capture=True, timeout=300)
    assert rcs == [0] * ranks, outs[0][-3000:]
    run = os.path.join(env["logs"], f"tiny_{tag}")
    assert os.path.exists(os.path.join(run, "weights.npz"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 3
    # the codes go beside, not over, the ae -> nn pipeline's
    r = torch_main(_port_cfg(env, is_train=False, load_path=run,
                             test_frames=2, code_suffix="_sp", **kw),
                   device="cpu")
    if kw.get("arch") == "ae":
        assert r == {"code_dir": os.path.join(env["data"], "tiny",
                                              "code8_sp")}
    else:
        assert r["num_fields"] == 8 and np.isfinite(r["eval"]["l2_mean"])


@pytest.mark.parametrize("is_train", [False, True])
def test_main_without_a_card_raises(runs, is_train, monkeypatch):
    # The entry point runs on the card unless asked for the CPU: with no
    # card and no device it refuses rather than training or serving on
    # the CPU.  (No card here; patched so the test holds on any machine.)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(runs["env"], is_train=is_train,
                    load_path=runs["torch_run"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        torch_main(cfg)


@pytest.mark.parametrize("fn", [Trainer, sweep_generator, run_test_sweep,
                                sweep_on_device])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


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

