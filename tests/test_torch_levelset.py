"""Config #3's route (``--data_type levelset``: scalar levelset fields, no
curl, the loss's jacobian term the field's spatial gradient) against the
JAX package.

The fields are a tiny liquid set made by the JAX package's own datagen
(2 drop positions x 1 radius x 4 frames of 32x32, as tests/test_train.py
makes it); weights are Flax's init carried over with ``models/weights.py``.
Tolerances: ``_grad_scalar`` at atol 1e-6; a step's loss at 2e-6 (XLA's
f32 CPU mean, see test_torch_train.py) and every gradient within 1e-5 of
JAX's relative to the parameter's largest entry; 5-step l2 trajectories
at 1e-5; fields at normalized L2 < 1e-3, the repo's parity gate.
"""

import io
import os
import shutil
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
from deepfluids_tpu.train import losses as jlosses  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu.utils import images as jimages  # noqa: E402
from deepfluids_tpu_torch.config import Config as PortConfig  # noqa: E402
from deepfluids_tpu_torch.main import main as torch_main  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    flax_to_state_dict,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.ops import cuda_fd  # noqa: E402
from deepfluids_tpu_torch.train import losses as tlosses  # noqa: E402
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402
from deepfluids_tpu_torch.utils import images as timages  # noqa: E402
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("liquid")
    scenes.liquid_pos10_size4(str(root), num_pos=2, num_size=1,
                              num_frames=4, height=32, width=32,
                              name="tinyliq")
    return str(root)


def _kw(data_dir, log_dir, **kw) -> dict:
    base = dict(arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=data_dir, dataset="tinyliq", data_type="levelset",
                log_dir=log_dir, max_step=50, lr_max=2e-3, lr_min=1e-4,
                log_step=10, test_step=10_000, save_step=10_000,
                compute_dtype="float32", num_worker=2, seed=0,
                test_batch_size=8)
    base.update(kw)
    return base


def _pair(data_dir, tmp_path, **kw):
    """(JAX trainer, port trainer) on the same config, the JAX init carried
    over."""
    jt = JaxTrainer(Config(**_kw(data_dir, str(tmp_path), **kw)))
    tt = Trainer(PortConfig(**_kw(data_dir, str(tmp_path), **kw)),
                 run_dir=str(tmp_path / "port"), device="cpu")
    tt.model.load_state_dict(flax_to_state_dict(weights_io.flatten_params(
        jax.device_get(jt.state.params)), tt.model))
    return jt, tt


def _rel_grad_errors(got: dict, want: dict) -> dict:
    return {k: float(np.abs(got[k] - want[k]).max())
            / float(np.abs(want[k]).max()) for k in want}


@pytest.mark.parametrize("shape", [(3, 16, 12, 1), (2, 5, 6, 7, 1)],
                         ids=["2d", "3d"])
def test_grad_scalar_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jlosses._grad_scalar(jnp.asarray(x)))
    got = tlosses._grad_scalar(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape[:-1] + (len(shape) - 2,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_levelset_route_reads_l_and_skips_the_curl(data_dir, tmp_path):
    jt, tt = _pair(data_dir, tmp_path)
    assert not tt.curl_active and not jt.curl_active
    assert tt.manifest.data_type == "levelset"
    assert all(f.split(os.sep)[-2] == "l" for f in tt.bm.ds.files)
    assert tt.bm.ds.files == jt.bm.ds.files
    # the 1-channel generator, its fields as the network emits them
    assert tt.model.output_shape == (32, 32, 1)
    p = np.random.default_rng(1).uniform(-1, 1, (5, 3)).astype(np.float32)
    got, want = tt.generate(p), jt.generate(p)
    assert got.shape == want.shape == (5, 32, 32, 1)
    assert normalized_l2(got, want) < 1e-3
    # the device cache follows the field key too
    x, y = tt._load_device_cache()
    xs, ys = zip(*[tt.bm.ds.get_normalized(i) for i in range(len(tt.bm.ds))])
    np.testing.assert_array_equal(x.numpy(), np.stack(xs))
    np.testing.assert_array_equal(y.numpy(), np.stack(ys))


@pytest.mark.parametrize("kw", [{}, {"relative_loss": True},
                                {"loss_norm": "l2"}])
def test_one_step_loss_and_grads_match_jax(data_dir, tmp_path, kw):
    jt, tt = _pair(data_dir, tmp_path, **kw)
    x, y = jt.bm.step_batch(1)
    want, want_g = jax.value_and_grad(
        lambda p: jt._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0])(
            jt.state.params)
    before = dict(cuda_fd.launch_counts)
    loss, aux = tt._loss_fn(tt.model, torch.from_numpy(x),
                            torch.from_numpy(y))
    loss.backward()
    assert cuda_fd.launch_counts == before
    assert set(aux) == {"loss_field", "loss_jac"}
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-6)
    want_g = weights_io.flatten_params(jax.device_get(want_g))
    got_g = state_dict_to_flax({n: p.grad for n, p in
                                tt.model.named_parameters()})
    assert set(got_g) == set(want_g)
    err = _rel_grad_errors(got_g, want_g)
    assert max(err.values()) <= 1e-5, err


def test_params_after_5_steps_l2_match_jax(data_dir, tmp_path):
    jt, tt = _pair(data_dir, tmp_path, loss_norm="l2")
    want_aux = jt.train(num_steps=5)
    got_aux = tt.train(num_steps=5)
    assert tt.step == int(jt.state.step) == 5
    want = weights_io.flatten_params(jax.device_get(jt.state.params))
    got = state_dict_to_flax(tt.model.state_dict())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    for k in ("loss", "loss_field", "loss_jac"):
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=1e-4)
    p = np.random.default_rng(2).uniform(-1, 1, (4, 3)).astype(np.float32)
    assert normalized_l2(tt.generate(p), jt.generate(p)) < 1e-3


def test_resume_with_the_cache_is_exact(data_dir, tmp_path):
    kw = dict(device_data_cache=True, steps_per_call=2)
    ta = Trainer(PortConfig(**_kw(data_dir, str(tmp_path), tag="full",
                                  **kw)), device="cpu")
    ta.train(num_steps=8)
    cb = PortConfig(**_kw(data_dir, str(tmp_path), tag="int", **kw))
    tb = Trainer(cb, device="cpu")
    tb.train(num_steps=4)
    tc = Trainer(cb, run_dir=tb.run_dir, device="cpu", save_cfg=False)
    assert tc.restore_checkpoint() == 4
    tc.train(num_steps=4)
    for k, v in ta.model.state_dict().items():
        torch.testing.assert_close(tc.model.state_dict()[k], v, atol=0,
                                   rtol=0)


def test_levelset_sweep_through_main_matches_jax(data_dir, tmp_path):
    """JAX trains 3 steps and sweeps the dataset's own 2 x 1 grid; the port
    sweeps it through ``main`` from the exported weights: the same .npz
    files and fields, levelset PNGs and one GIF."""
    from deepfluids_tpu.main import main as jax_main

    Image = pytest.importorskip("PIL.Image")
    env = dict(log_dir=str(tmp_path / "logs"), tag="liq", test_frames=4)
    jax_main(Config(**_kw(data_dir, max_step=3, **env)))
    run = os.path.join(env["log_dir"], "tinyliq_liq")
    jax_result = jax_main(Config(**_kw(data_dir, is_train=False,
                                       load_path=run, **env)))
    t = JaxTrainer(load_config(run), run_dir=run, save_cfg=False)
    t.restore_checkpoint()
    ours = str(tmp_path / "torch_run")
    os.makedirs(ours)
    weights_io.export_npz(t.state.params, os.path.join(ours, "weights.npz"))
    shutil.copy(os.path.join(run, "params.json"), ours)
    # counts default to the manifest's param_counts (2, 1): no --test_counts
    result = torch_main(PortConfig(**_kw(data_dir, is_train=False,
                                         load_path=ours, **env)),
                        device="cpu")
    jax_test, port_test = os.path.join(run, "test"), os.path.join(ours,
                                                                  "test")
    names = sorted(os.listdir(jax_test))
    assert sorted(os.listdir(port_test)) == names
    npz = [n for n in names if n.endswith(".npz")]
    assert result["num_fields"] == jax_result["num_fields"] == len(npz) == 8
    for name in npz:
        with np.load(os.path.join(jax_test, name)) as a, \
                np.load(os.path.join(port_test, name)) as b:
            assert sorted(b.files) == sorted(a.files) == ["x", "y"]
            assert b["x"].shape == (32, 32, 1)
            assert normalized_l2(b["x"], a["x"]) < 1e-3, name
            np.testing.assert_array_equal(b["y"], a["y"])
    # levelset renders: the PNG is JAX's image of the port's field, and the
    # GIF's frames are the quantized images on one shared scale
    field = np.load(os.path.join(port_test, "0_0.npz"))["x"]
    png = np.asarray(Image.open(os.path.join(port_test, "0_0.png"))
                     .convert("RGB"))
    np.testing.assert_array_equal(png, jimages.field_to_image(field,
                                                              "levelset"))
    fields = [np.load(os.path.join(port_test, f"0_{k}.npz"))["x"]
              for k in range(4)]
    vmax = max(float(np.abs(f[..., 0]).max()) for f in fields)
    with open(os.path.join(port_test, "scene0.gif"), "rb") as f:
        gif = Image.open(io.BytesIO(f.read()))
    assert gif.n_frames == 4
    pal = timages.gif_palette()
    for k, f in enumerate(fields):
        gif.seek(k)
        np.testing.assert_array_equal(
            np.asarray(gif.convert("RGB")), pal[timages.quantize(
                timages.field_to_image(f, "levelset", vmax))])
    for key in ("l2_mean", "l2_median", "l2_max", "rmse"):
        assert abs(result["eval"][key] - jax_result["eval"][key]) < 1e-3


def test_autoencoder_on_levelset_matches_jax(data_dir, tmp_path):
    jt, tt = _pair(data_dir, tmp_path, arch="ae", tag="ae")
    assert not tt.curl_active
    x, y = jt.bm.step_batch(1)
    want, want_g = jax.value_and_grad(
        lambda p: jt._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0])(
            jt.state.params)
    loss, aux = tt._loss_fn(tt.model, torch.from_numpy(x),
                            torch.from_numpy(y))
    loss.backward()
    assert "loss_param" in aux
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-6)
    want_g = weights_io.flatten_params(jax.device_get(want_g))
    got_g = state_dict_to_flax({n: p.grad for n, p in
                                tt.model.named_parameters()})
    err = _rel_grad_errors(got_g, want_g)
    assert max(err.values()) <= 1e-5, err
    z, zj = tt.encode(x), jt.encode(x)
    assert z.shape == (8, 8)
    np.testing.assert_allclose(z, zj, atol=1e-5)
    got, want = tt.decode(z), jt.decode(z)
    assert got.shape == want.shape == (8, 32, 32, 1)
    assert normalized_l2(got, want) < 1e-3
    assert normalized_l2(tt.reconstruct(x), jt.reconstruct(x)) < 1e-3
