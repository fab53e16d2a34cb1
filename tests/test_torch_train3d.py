"""The port's 3D training and serving path (config #5's shape of run)
against the JAX package.

A tiny 3D smoke dataset is made by the JAX datagen
(``scenes.smoke3_vel5_buo3`` at 8x16x16, as tests/test_train.py does);
weights are Flax's init carried over with ``models/weights.py``, so both
frameworks train the same Conv3d network on the same (seed, step) batch
stream.  The JAX trainer runs on conftest's 8-device CPU mesh; its loss
does not depend on the mesh.
"""

import glob
import json
import os
import shutil
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.config import Config, load_config  # noqa: E402
from deepfluids_tpu.datagen import scenes  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu_torch.main import main as torch_main  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    flax_to_state_dict,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.ops import cuda_fd, fd  # noqa: E402
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402

# The curl annihilates a constant potential: conv_out's bias gradient is
# rounding noise (tests/test_torch_train.py); held through the fields.
NULL_PARAM = "conv_out/bias"
GRID = (8, 16, 16)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data3d")
    scenes.smoke3_vel5_buo3(str(root), num_vel=2, num_buo=1, num_frames=4,
                            depth=GRID[0], height=GRID[1], width=GRID[2],
                            name="tiny3d")
    return str(root)


def tiny_config(data_dir, log_dir, **kw) -> Config:
    base = dict(arch="de", filters=8, num_conv=1, batch_size=8,
                data_dir=data_dir, dataset="tiny3d", log_dir=log_dir,
                max_step=50, lr_max=2e-3, lr_min=1e-4, log_step=10,
                test_step=10_000, save_step=10_000, compute_dtype="float32",
                num_worker=2, seed=0, test_batch_size=4)
    base.update(kw)
    return Config(**base)


def _carry(jax_trainer, port_trainer) -> None:
    flat = weights_io.flatten_params(jax.device_get(jax_trainer.state.params))
    port_trainer.model.load_state_dict(
        flax_to_state_dict(flat, port_trainer.model))


def test_one_step_loss_and_grads_match_jax_3d(data_dir, tmp_path):
    c = tiny_config(data_dir, str(tmp_path))
    jt, tt = JaxTrainer(c), Trainer(c, run_dir=str(tmp_path / "port"))
    assert tt.manifest.is_3d and tt._potential_channels() == 3
    _carry(jt, tt)
    x, y = jt.bm.step_batch(1)
    assert x.shape == (8,) + GRID + (3,)
    f = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0]))
    want, want_g = f(jt.state.params)
    out = tt.model(torch.from_numpy(y))
    before = dict(cuda_fd.launch_counts)
    loss, aux = tt._loss_fn(tt.model, torch.from_numpy(x),
                            torch.from_numpy(y))
    loss.backward()
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"
    assert set(aux) == {"loss_field", "loss_jac"}
    # The port's f32 loss against float64 arithmetic on the same network
    # output at 1e-6, and against JAX at 2e-6 (XLA's f32 CPU mean, see
    # tests/test_torch_train.py).
    u = fd.curl3d(out.detach().double())
    x64 = torch.from_numpy(x).double()
    ref = (u - x64).abs().mean() + (
        fd.jacobian3d(u)[0] - fd.jacobian3d(x64)[0]).abs().mean()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-6)
    want_g = weights_io.flatten_params(jax.device_get(want_g))
    got_g = state_dict_to_flax({n: p.grad for n, p in
                                tt.model.named_parameters()})
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kw", [
    {"loss_norm": "l2"}, {"relative_loss": True, "loss_norm": "l2"}])
def test_params_after_5_steps_match_jax_3d(data_dir, tmp_path, kw):
    # Held under the l2 losses, where the params stay within 4e-7 of JAX's
    # for 5 steps (measured).  Gradients agree at 2e-7 relative, but Adam
    # turns that noise into lr-sized steps where an entry's gradient nears
    # zero (ROADMAP Queue C): in this 3D run plain L1 and --grad_clip 0.05
    # (with l1 or l2) jump to 4e-5 .. 1.1e-4 by step 3 or 4 (measured).
    c = tiny_config(data_dir, str(tmp_path), **kw)
    jt, tt = JaxTrainer(c), Trainer(c, run_dir=str(tmp_path / "port"))
    _carry(jt, tt)
    want_aux = jt.train(num_steps=5)
    got_aux = tt.train(num_steps=5)
    assert tt.step == int(jt.state.step) == 5
    want = weights_io.flatten_params(jax.device_get(jt.state.params))
    got = state_dict_to_flax(tt.model.state_dict())
    for k in want:
        if k != NULL_PARAM:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    p = np.random.default_rng(4).uniform(-1, 1, (2, 3)).astype(np.float32)
    np.testing.assert_allclose(tt.generate(p), jt.generate(p), atol=1e-4)
    for k in ("loss", "loss_field", "loss_jac"):
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=1e-3)


@pytest.mark.parametrize("cache", [False, True])
def test_resume_is_bitwise_exact_3d(data_dir, tmp_path, cache):
    # With the cache: the whole set on the device in float16.
    kw = dict(device_data_cache=cache,
              cache_dtype="float16" if cache else "float32")
    ta = Trainer(tiny_config(data_dir, str(tmp_path), tag="full", **kw))
    ta.train(num_steps=6)
    cb = tiny_config(data_dir, str(tmp_path), tag="int", **kw)
    tb = Trainer(cb)
    tb.train(num_steps=3)
    tc = Trainer(cb, run_dir=tb.run_dir, save_cfg=False)
    assert tc.restore_checkpoint() == 3
    tc.train(num_steps=3)
    assert tc.step == ta.step == 6
    for k, v in ta.model.state_dict().items():
        torch.testing.assert_close(tc.model.state_dict()[k], v, atol=0,
                                   rtol=0)
    if cache:
        x, y = tc._load_device_cache()
        assert x.dtype == torch.float16 and x.shape == (8,) + GRID + (3,)
        assert y.dtype == torch.float32 and y.shape == (8, 3)


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])     # width, height


def test_3d_run_writes_sample_pngs(data_dir, tmp_path):
    # A sample dump renders 8 fields' mid-depth slices into a 3x3 montage;
    # a dump that failed would only log a warning, so check the files.
    env = dict(data_dir=data_dir, log_dir=str(tmp_path), tag="samples")
    torch_main(tiny_config(max_step=4, save_step=2, test_step=2, log_step=2,
                           **env), device="cpu")
    run = os.path.join(str(tmp_path), "tiny3d_samples")
    pngs = sorted(os.listdir(os.path.join(run, "sample")))
    assert pngs == ["0000002.png", "0000004.png"]
    for name in pngs:
        assert _png_size(os.path.join(run, "sample", name)) == (
            3 * GRID[2], 3 * GRID[1])
    steps = [json.loads(ln)["step"]
             for ln in open(os.path.join(run, "metrics.jsonl"))]
    assert steps == [2, 4]


def test_serving_3d_matches_jax_sweep(data_dir, tmp_path):
    """A JAX run trained 3 steps, exported to weights.npz; the JAX sweep
    and the port's ``main`` sweep the same grid from the same weights."""
    from deepfluids_tpu.main import main as jax_main

    env = dict(data_dir=data_dir, log_dir=str(tmp_path), tag="serve")
    jax_main(tiny_config(max_step=3, log_step=1, save_step=1000, **env))
    run = os.path.join(str(tmp_path), "tiny3d_serve")
    jax_result = jax_main(tiny_config(is_train=False, load_path=run,
                                      test_frames=2, **env))
    t = JaxTrainer(load_config(run), run_dir=run, save_cfg=False)
    t.restore_checkpoint()
    port_run = str(tmp_path / "port_run")
    os.makedirs(port_run)
    weights_io.export_npz(t.state.params,
                          os.path.join(port_run, "weights.npz"))
    shutil.copy(os.path.join(run, "params.json"), port_run)

    before = dict(cuda_fd.launch_counts)
    result = torch_main(tiny_config(is_train=False, load_path=port_run,
                                    test_frames=2, **env), device="cpu")
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"
    jax_test, ours = os.path.join(run, "test"), os.path.join(port_run, "test")
    names = sorted(f for f in os.listdir(jax_test) if f.endswith(".npz"))
    assert result["num_fields"] == len(names) == 4      # 2 scenes x 2
    assert sorted(glob.glob(os.path.join(ours, "*.npz"))) == [
        os.path.join(ours, n) for n in names]
    for name in names:
        with np.load(os.path.join(jax_test, name)) as a, \
                np.load(os.path.join(ours, name)) as b:
            assert b["x"].shape == GRID + (3,) and b["x"].dtype == np.float32
            assert normalized_l2(b["x"], a["x"]) < 1e-3, name
            np.testing.assert_array_equal(b["y"], a["y"])
            # divergence-free away from the replicated edge, in the
            # normalized units the curl produced
            div = fd.divergence3d(torch.from_numpy(b["x"])[None])
            scale = float(np.abs(b["x"]).max())
            assert float(div[:, :-2, :-2, :-2].abs().max()) <= 1e-5 * scale
    assert os.path.exists(os.path.join(ours, "scene0.gif"))
    assert _png_size(os.path.join(ours, "0_0.png")) == (GRID[2], GRID[1])
    want = jax_result["eval"]
    for key in ("l2_mean", "l2_median", "l2_max", "rmse"):
        assert abs(result["eval"][key] - want[key]) < 1e-3, key
