"""The port's training of archs "ae" and "nn" (config #4's pipeline)
against the JAX package.

A tiny moving-source set (3 scenes x 8 frames of 32x24 velocity, params
``src_x_pos`` and ``frame``, as ``smoke_mov`` lays it out) is made with
numpy from a seed.  A JAX autoencoder is initialized and checkpointed; its
params are exported to the run's ``weights.npz``, so it is the AE behind
``--ae_load_path`` in both frameworks, and JAX's encode pass writes the
code set both integrators train on.  Weights are Flax's init carried over
with ``models/weights.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.config import Config  # noqa: E402
from deepfluids_tpu.infer import encode_dataset as jax_encode  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu_torch.config import Config as PortConfig  # noqa: E402
from deepfluids_tpu_torch.data import Manifest, save_manifest  # noqa: E402
from deepfluids_tpu_torch.infer import encode_dataset  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    flax_to_state_dict,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402

SCENES, FRAMES, H, W = 3, 8, 32, 24
# The curl annihilates a constant psi: the gradient of the decoder's
# conv_out bias is rounding noise in both frameworks (held against the
# largest gradient of all, and through the fields after training).
NULL_PARAM = "decoder/conv_out/bias"


def _make_dataset(ds: str) -> None:
    """The curl of a Gaussian stream-function blob whose x position walks
    (seeded) and which rises with the frame."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, W / H, W),
                         indexing="ij")
    os.makedirs(os.path.join(ds, "v"))
    vmax = 0.0
    for s in range(SCENES):
        pos = np.clip(0.5 + np.cumsum(rng.uniform(-0.05, 0.05, FRAMES)),
                      0.2, 0.8)
        for f in range(FRAMES):
            psi = np.exp(-((xx - 0.75 * pos[f]) ** 2
                           + (yy - 0.2 - 0.08 * f) ** 2) / 0.02)
            u = np.diff(psi, axis=0, append=psi[-1:]) * H
            v = -np.diff(psi, axis=1, append=psi[:, -1:]) * W
            x = np.stack([u, v], -1).astype(np.float32)
            vmax = max(vmax, float(np.abs(x).max()))
            np.savez(os.path.join(ds, "v", f"{s}_{f}.npz"), x=x,
                     y=np.array([pos[f], f], np.float32))
    save_manifest(Manifest(
        param_names=["src_x_pos", "frame"],
        param_ranges=[[0.2, 0.8], [0.0, FRAMES - 1.0]], num_scenes=SCENES,
        num_frames=FRAMES, resolution=[H, W], num_channels=2,
        v_range=[-vmax, vmax], data_type="velocity"), ds)


def _kw(env, **kw) -> dict:
    # batch 8: the JAX trainer shards it over conftest's 8 CPU devices
    base = dict(arch="ae", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=env["data"], dataset="tiny_mov",
                log_dir=env["logs"], max_step=50, lr_max=2e-3, lr_min=1e-4,
                log_step=10, test_step=10_000, save_step=10_000,
                compute_dtype="float32", num_worker=2, seed=0, w_num=4,
                nn_hidden=32, ae_pred_hidden=16, test_batch_size=4)
    base.update(kw)
    return base


def jax_cfg(env, **kw) -> Config:
    return Config(**_kw(env, **kw))


def port_cfg(env, **kw) -> PortConfig:
    return PortConfig(**_kw(env, **kw))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("ae_nn")
    env = {"data": str(root / "data"), "logs": str(root / "logs")}
    _make_dataset(os.path.join(env["data"], "tiny_mov"))
    jt = JaxTrainer(jax_cfg(env, tag="ae"))
    jt.save_checkpoint(wait=True)
    weights_io.export_npz(jax.device_get(jt.state.params),
                          os.path.join(jt.run_dir, "weights.npz"))
    jax_encode(jt.encode, os.path.join(env["data"], "tiny_mov"), 8,
               batch_size=3)
    env.update(ae=jt, ae_run=jt.run_dir)
    return env


def _carry(params, trainer) -> None:
    flat = weights_io.flatten_params(jax.device_get(params))
    trainer.model.load_state_dict(flax_to_state_dict(flat, trainer.model))


def _random_heads(params, seed=0):
    """Params with every latent integrator head (zero at Flax's init, so
    nothing before it would get a gradient) made small and random."""
    flat = weights_io.flatten_params(jax.device_get(params))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("fc_out/kernel") and not k.startswith("encoder"):
            flat[k] = (0.02 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return jax.tree_util.tree_map(jnp.asarray,
                                  weights_io.unflatten_params(flat))


def _one_step(jt, tt, a, b, params):
    """(JAX loss, JAX grads, port loss, port grads, port aux) of one step
    on the batch (a, b) from ``params``."""
    _carry(params, tt)
    extra = (0,) if tt.c.arch == "nn" else ()
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_fn(p, jnp.asarray(a), jnp.asarray(b),
                              *extra)[0]))(params)
    loss, aux = tt._loss_fn(tt.model, torch.from_numpy(a),
                            torch.from_numpy(b), 0)
    loss.backward()
    got_g = state_dict_to_flax({n: p.grad for n, p in
                                tt.model.named_parameters()})
    return (float(want), weights_io.flatten_params(jax.device_get(want_g)),
            loss.item(), got_g, aux)


def _assert_grads(got, want):
    # 1e-5 relative to each tensor's largest entry (the null-space bias to
    # the largest entry of all).
    assert set(got) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for k, g in want.items():
        ref = scale if k == NULL_PARAM else float(np.abs(g).max())
        err = float(np.abs(got[k] - g).max())
        assert err <= 1e-5 * ref, (k, err, ref)


@pytest.mark.parametrize("kw,keys", [
    ({}, {"loss_field", "loss_jac", "loss_param"}),
    ({"ae_pred_w": 0.5, "loss_norm": "l2"},
     {"loss_field", "loss_jac", "loss_param", "loss_pred"})])
def test_ae_loss_and_grads_match_jax(env, tmp_path, kw, keys):
    jt = JaxTrainer(jax_cfg(env, tag="ae1", **kw))
    tt = Trainer(port_cfg(env, **kw), run_dir=str(tmp_path), device="cpu")
    x, y = jt.bm.step_batch(1)
    assert x.shape[0] == (16 if kw else 8)      # pair mode: [x_t ; x_t+1]
    want, want_g, loss, got_g, aux = _one_step(
        jt, tt, x, y, _random_heads(jt.state.params))
    assert set(aux) == keys
    # 2e-6: XLA's float32 mean on the CPU (ROADMAP Queue C).
    np.testing.assert_allclose(loss, want, rtol=2e-6)
    _assert_grads(got_g, want_g)


@pytest.mark.parametrize("kw,keys", [
    ({}, {"loss_z"}),
    ({"nn_history": 2}, {"loss_z"}),
    ({"nn_field_w": 0.5, "nn_field_frames": 2}, {"loss_z", "loss_nnfield"})])
def test_nn_loss_and_grads_match_jax(env, tmp_path, kw, keys):
    if "nn_field_w" in kw:
        kw = dict(kw, ae_load_path=env["ae_run"])
    jt = JaxTrainer(jax_cfg(env, arch="nn", tag="nn1", **kw))
    tt = Trainer(port_cfg(env, arch="nn", **kw), run_dir=str(tmp_path),
                 device="cpu")
    z, p = jt.codes.window_batch(8, 4, step=1)
    want, want_g, loss, got_g, aux = _one_step(
        jt, tt, z, p, _random_heads(jt.state.params))
    assert set(aux) == keys
    np.testing.assert_allclose(loss, want, rtol=2e-6)
    _assert_grads(got_g, want_g)
    if "nn_field_w" in kw:      # the decoder is frozen, not trained
        ae = tt._ae_trainer()
        assert not any(q.requires_grad for q in ae.model.parameters())


@pytest.mark.parametrize("kw", [{"loss_norm": "l2"},
                                {"loss_norm": "l2", "ae_pred_w": 0.5},
                                {"arch": "nn"}])
def test_params_after_5_steps_match_jax(env, tmp_path, kw):
    # Under l2 and at lr 2e-4: plain L1 + Adam amplifies 1e-7 gradient
    # noise, and so does Adam at lr 2e-3 here (the AE's params jump from
    # 3e-7 to 1.1e-4 apart at step 5, against 1.2e-7 at 2e-4; Queue C).
    kw = dict(kw, lr_max=2e-4, lr_min=1e-5)
    jt = JaxTrainer(jax_cfg(env, tag="traj", **kw))
    tt = Trainer(port_cfg(env, **kw), run_dir=str(tmp_path), device="cpu")
    _carry(jt.state.params, tt)
    want_aux = jt.train(num_steps=5)
    got_aux = tt.train(num_steps=5)
    assert tt.step == int(jt.state.step) == 5
    want = weights_io.flatten_params(jax.device_get(jt.state.params))
    got = state_dict_to_flax(tt.model.state_dict())
    for k in want:
        if k != NULL_PARAM:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=1e-4,
                                   err_msg=k)
    if tt.c.arch == "ae":
        x, _ = jt.bm.step_batch(7)
        np.testing.assert_allclose(tt.reconstruct(x), jt.reconstruct(x),
                                   atol=1e-4)


def test_encode_pass_matches_jax(env):
    # The port's encode pass on the JAX AE's weights.npz writes the code
    # files JAX's wrote (batch 3: each scene's last batch padded).
    ae = Trainer(port_cfg(env, is_train=False), run_dir=env["ae_run"],
                 device="cpu", save_cfg=False)
    ae.restore_weights()
    ds = os.path.join(env["data"], "tiny_mov")
    out = encode_dataset(ae.encode, ds, 8, batch_size=3, suffix="port")
    assert out == os.path.join(ds, "code8port")
    names = sorted(os.listdir(os.path.join(ds, "code8")))
    assert names == sorted(os.listdir(out)) == ["0.npz", "1.npz", "2.npz"]
    for name in names:
        with np.load(os.path.join(ds, "code8", name)) as a, \
                np.load(os.path.join(out, name)) as b:
            assert b["z"].shape == (FRAMES, 8) and b["z"].dtype == np.float32
            np.testing.assert_allclose(b["z"], a["z"], atol=1e-5)
            np.testing.assert_array_equal(b["p"], a["p"])


def test_evaluate_matches_jax(env, tmp_path):
    # ae: reconstruction L2 / rmse and the code's parameter error; nn: the
    # latent rollout of every scene, decoded through --ae_load_path's AE,
    # with its drift profile against the simulated frames.
    ae = Trainer(port_cfg(env, is_train=False), run_dir=env["ae_run"],
                 device="cpu", save_cfg=False)
    ae.restore_weights()
    want, got = env["ae"].evaluate(num_samples=10), ae.evaluate(10)
    assert set(got) == set(want)
    for k in ("l2_mean", "l2_median", "l2_max", "rmse", "param_mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["per_scene_l2_median"] == pytest.approx(
        want["per_scene_l2_median"], abs=2e-4)

    kw = dict(arch="nn", ae_load_path=env["ae_run"])
    jt = JaxTrainer(jax_cfg(env, tag="nneval", **kw))
    tt = Trainer(port_cfg(env, **kw), run_dir=str(tmp_path), device="cpu")
    params = _random_heads(jt.state.params, seed=3)
    jt.state = jt.state.replace(params=params)
    _carry(params, tt)
    want = jt.evaluate(num_samples=3, profile_scenes=2)
    got = tt.evaluate(num_samples=3, profile_scenes=2)
    assert set(got) == set(want)
    for k in ("z_mae", "z_mae_final", "field_rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["rollout_steps"] == want["rollout_steps"] == FRAMES
    for k in ("rollout_field_l2", "ae_floor_field_l2",
              "rollout_field_l2_agg"):
        assert got[k] == pytest.approx(want[k], abs=2e-4), k


@pytest.mark.parametrize("kw", [
    {},
    {"ae_pred_w": 0.5, "device_data_cache": True},
    {"arch": "nn", "nn_noise": 0.05, "nn_history": 2}],
    ids=["ae", "ae_pair_cache", "nn_noise"])
def test_resume_is_bitwise_exact(env, tmp_path, kw):
    # 6 steps in one go against 3, a checkpoint, and 3 more: the batch
    # stream, the pair gather and the noise stream are functions of
    # (seed, step).
    ta = Trainer(port_cfg(env, tag="full", log_dir=str(tmp_path), **kw),
                 device="cpu")
    ta.train(num_steps=6)
    cb = port_cfg(env, tag="int", log_dir=str(tmp_path), **kw)
    tb = Trainer(cb, device="cpu")
    tb.train(num_steps=3)
    tc = Trainer(cb, run_dir=tb.run_dir, device="cpu", save_cfg=False)
    assert tc.restore_checkpoint() == 3
    tc.train(num_steps=3)
    assert tc.step == ta.step == 6
    for k, v in ta.model.state_dict().items():
        torch.testing.assert_close(tc.model.state_dict()[k], v, atol=0,
                                   rtol=0)
    for k, v in ta.opt.state_dict()["state"].items():
        for name, t in v.items():
            torch.testing.assert_close(tc.opt.state_dict()["state"][k][name],
                                       t, atol=0, rtol=0)


def test_ae_sample_dump_and_pair_batch_check(env, tmp_path):
    t = Trainer(port_cfg(env, test_step=2, ae_pred_w=0.5,
                         log_dir=str(tmp_path)), device="cpu")
    t.train(num_steps=2)
    assert os.listdir(os.path.join(t.run_dir, "sample")) == ["0000002.png"]
    x, y = t.bm.step_batch(1)
    with pytest.raises(ValueError, match="pair batch"):
        t._loss_fn(t.model, torch.from_numpy(x[:9]), torch.from_numpy(y[:9]))


@pytest.mark.parametrize("kw,match", [
    ({"arch": "de", "ae_pred_w": 0.5}, "arch ae"),
    ({"arch": "nn", "nn_history": 4}, "must be < --w_num"),
    ({"arch": "nn", "nn_history": 0}, "nn_history must be"),
    ({"arch": "nn", "nn_field_w": 0.5}, "needs --ae_load_path"),
    ({"arch": "nn", "augment_flip_x": True}, "augment_flip_x applies"),
    ({"arch": "gan"}, "unknown arch")])
def test_refused_flag_combinations(env, tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        Trainer(port_cfg(env, log_dir=str(tmp_path), **kw), device="cpu")
    assert not os.listdir(tmp_path), "nothing written before refusing"
