"""The port's training path (arch "de") against the JAX package.

Inputs are made with numpy from a seed; weights are Flax's init carried
over with ``models/weights.py``, so both frameworks train the same network
on the same (seed, step) batch stream of the same tiny smoke dataset (the
``tests/test_train.py`` sizes).  The JAX trainer runs on conftest's
8-device CPU mesh; its loss does not depend on the mesh.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.config import Config  # noqa: E402
from deepfluids_tpu.datagen import scenes  # noqa: E402
from deepfluids_tpu.models import GeneratorBE as FlaxGeneratorBE  # noqa: E402
from deepfluids_tpu.train import losses as jlosses  # noqa: E402
from deepfluids_tpu.train import state as jax_state  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu_torch.main import main as torch_main  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    GeneratorBE,
    flax_init_,
    flax_shapes,
    flax_to_state_dict,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.ops import cuda_fd, fd  # noqa: E402
from deepfluids_tpu_torch.train import losses as tlosses  # noqa: E402
from deepfluids_tpu_torch.train.state import (  # noqa: E402
    clip_by_global_norm_,
    cosine_lr_schedule,
    make_optimizer,
    set_lr,
)
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402

# The curl annihilates a constant psi, so the gradient of conv_out's bias is
# rounding noise in both frameworks; Adam scales that noise up to lr-sized
# steps.  The bias is held through the fields it cannot change instead.
NULL_PARAM = "conv_out/bias"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    scenes.smoke_pos21_size5(str(root), num_pos=2, num_size=2, num_frames=4,
                             height=32, width=32, name="tiny_smoke")
    return str(root)


def tiny_config(data_dir, log_dir, **kw) -> Config:
    base = dict(arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=data_dir, dataset="tiny_smoke", log_dir=log_dir,
                max_step=50, lr_max=2e-3, lr_min=1e-4, log_step=10,
                test_step=10_000, save_step=10_000, compute_dtype="float32",
                num_worker=2, seed=0)
    base.update(kw)
    return Config(**base)


def _carry(jax_trainer, port_trainer) -> None:
    """The JAX trainer's weights into the port's model."""
    flat = weights_io.flatten_params(jax.device_get(jax_trainer.state.params))
    port_trainer.model.load_state_dict(
        flax_to_state_dict(flat, port_trainer.model))


def _port_grads(model) -> dict:
    return state_dict_to_flax({n: p.grad for n, p in model.named_parameters()})


# --- losses ----------------------------------------------------------------

@pytest.mark.parametrize("use_curl,relative,norm", [
    (True, False, "l1"), (True, False, "l2"), (True, True, "l1"),
    (True, True, "l2"), (False, False, "l1")])
def test_generator_loss_and_grad_match_jax(use_curl, relative, norm):
    rng = np.random.default_rng(1)
    out = rng.standard_normal((4, 16, 12, 1 if use_curl else 2)).astype(
        np.float32)
    x = rng.standard_normal((4, 16, 12, 2)).astype(np.float32)

    def jax_loss(o):
        return jlosses.generator_loss(o, jnp.asarray(x), use_curl, 1.0, 0.7,
                                      relative=relative, norm=norm)[0]

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_()
    loss, aux = tlosses.generator_loss(o, torch.from_numpy(x), use_curl, 1.0,
                                       0.7, relative=relative, norm=norm)
    loss.backward()
    assert set(aux) == {"loss_field", "loss_jac", "pred"}
    # 2e-6: XLA's float32 mean on the CPU is off by up to 1.6e-6 from a
    # float64 evaluation of the same sums (measured); torch's by < 1e-7.
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-6)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-9)


def test_field_loss_zero_at_identity_and_rejects_norm():
    x = torch.ones(2, 8, 8, 2)
    loss, _ = tlosses.field_loss(x, x, 1.0, 1.0)
    assert float(loss) == 0.0
    with pytest.raises(ValueError, match="loss_norm"):
        tlosses.field_loss(x, x, 1.0, 1.0, norm="L1")


def test_loss_3d_names_its_roadmap_item():
    # 3D (Queue A item 6) is ported: the curl and the jacobian of a 5D
    # field go through curl3d_p / jacobian3d_p, also from the generator's
    # permuted (non-contiguous) output.
    psi = torch.randn(2, 3, 4, 5, 6).permute(0, 2, 3, 4, 1)
    assert not psi.is_contiguous()
    torch.testing.assert_close(tlosses.apply_curl(psi),
                               fd.curl3d(psi.contiguous()), atol=0, rtol=0)
    torch.testing.assert_close(tlosses.jacobian_of(psi),
                               fd.jacobian3d(psi.contiguous())[0], atol=0,
                               rtol=0)
    with pytest.raises(ValueError, match="unsupported"):
        tlosses.apply_curl(torch.zeros(1, 2, 3, 4, 4, 4, 3))


def test_non_contiguous_field_goes_through_the_wrapper():
    # --use_curl False: the generator emits a permuted (non-contiguous) view.
    x = torch.randn(2, 2, 16, 12).permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    torch.testing.assert_close(tlosses.jacobian_of(x),
                               fd.jacobian2d(x.contiguous())[0])


# --- schedule, clip, Adam, init ---------------------------------------------

def test_cosine_schedule_matches_jax():
    ours = cosine_lr_schedule(1e-4, 1e-6, 1000)
    theirs = jax_state.cosine_lr_schedule(1e-4, 1e-6, 1000)
    for s in (0, 1, 250, 500, 999, 1000, 5000):
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-6)
    np.testing.assert_allclose(ours(0), 1e-4, rtol=1e-6)
    np.testing.assert_allclose(ours(1000), 1e-6, rtol=1e-5)
    assert ours(5000) == ours(1000)        # clamped past max_step


@pytest.mark.parametrize("max_norm", [0.5, 100.0])   # clipping / not
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in [(3, 4), (5,), (2, 2, 3)]]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(ours, max_norm)
    np.testing.assert_allclose(float(norm), np.sqrt(sum(
        float((g.astype(np.float64) ** 2).sum()) for g in grads)), rtol=1e-6)
    for o, w in zip(ours, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6)
    if max_norm > 1.0:
        for o, g in zip(ours, grads):
            np.testing.assert_array_equal(o.numpy(), g)


@pytest.mark.parametrize("grad_clip", [0.0, 0.5])
def test_adam_schedule_matches_optax(grad_clip):
    # Identical gradient streams, spanning 1e-12 .. 1 in magnitude, into
    # optax's Adam + cosine schedule (+ clip) and the port's.
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(64).astype(np.float32)
    gs = [(rng.standard_normal(64) * np.logspace(-12, 0, 64)).astype(
        np.float32) for _ in range(10)]
    tx = jax_state.make_optimizer(2e-3, 1e-4, 50, 0.5, 0.999, grad_clip)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    for g in gs:
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, lr = make_optimizer([tp]), cosine_lr_schedule(2e-3, 1e-4, 50)
    for k, g in enumerate(gs):
        set_lr(opt, lr(k))
        tp.grad = torch.from_numpy(g.copy())
        if grad_clip:
            clip_by_global_norm_([tp.grad], grad_clip)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-6)


def test_flax_init_statistics():
    model = flax_init_(GeneratorBE((32, 24, 1), num_param=3, filters=64,
                                   num_conv=1), seed=5)
    w = model.conv_0_0.weight.detach().double()
    assert w.numel() >= 10_000
    fan_in = 64 * 3 * 3
    target = 1 / np.sqrt(fan_in)
    assert abs(float(w.std()) - target) < 0.05 * target
    sigma = target / 0.87962566103423978   # of the untruncated normal
    assert float(w.abs().max()) <= 2 * sigma
    assert abs(float(w.mean())) < 0.05 * target
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
    again = flax_init_(GeneratorBE((32, 24, 1), num_param=3, filters=64,
                                   num_conv=1), seed=5)
    other = flax_init_(GeneratorBE((32, 24, 1), num_param=3, filters=64,
                                   num_conv=1), seed=6)
    torch.testing.assert_close(again.conv_0_0.weight, model.conv_0_0.weight,
                               atol=0, rtol=0)
    assert not torch.equal(other.conv_0_0.weight, model.conv_0_0.weight)


def test_state_dict_to_flax_is_the_inverse():
    model = flax_init_(GeneratorBE((32, 24, 1), num_param=3, filters=8,
                                   num_conv=2), seed=0)
    flat = state_dict_to_flax(model.state_dict())
    fm = FlaxGeneratorBE(output_shape=(32, 24, 1), filters=8, num_conv=2)
    template = weights_io.flatten_params(
        fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"])
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in template.items()} == flax_shapes(model)
    back = flax_to_state_dict(flat, model)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, atol=0, rtol=0)


# --- the Trainer against JAX's ----------------------------------------------

def test_one_step_loss_and_grads_match_jax(data_dir, tmp_path):
    c = tiny_config(data_dir, str(tmp_path))
    jt, tt = JaxTrainer(c), Trainer(c, run_dir=str(tmp_path / "port"))
    _carry(jt, tt)
    x, y = jt.bm.step_batch(1)
    f = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0]))
    want, want_g = f(jt.state.params)
    out = tt.model(torch.from_numpy(y))
    loss, aux = tt._loss_fn(tt.model, torch.from_numpy(x),
                            torch.from_numpy(y))
    loss.backward()
    assert set(aux) == {"loss_field", "loss_jac"}
    # The port's float32 loss against float64 arithmetic on the same
    # network output, at 1e-6 ...
    u = fd.curl2d(out.detach().double())
    x64 = torch.from_numpy(x).double()
    ref = (u - x64).abs().mean() + (
        fd.jacobian2d(u)[0] - fd.jacobian2d(x64)[0]).abs().mean()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    # ... and against JAX at 2e-6: on this batch XLA's float32 CPU mean
    # is 1.2e-6 from the float64 value (see test_generator_loss_*).
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-6)
    want_g = weights_io.flatten_params(jax.device_get(want_g))
    got_g = _port_grads(tt.model)
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kw,atol", [
    ({"grad_clip": 0.05}, 1e-5),
    ({"relative_loss": True, "loss_norm": "l2"}, 1e-5),
    # Plain L1: gradients agree at 2e-7 at identical params, but L1's sign
    # gradients make this trajectory sensitive -- the port against itself
    # moves 2.2e-4 in 10 steps under 1e-7 gradient noise (measured) -- so
    # 1e-5 is out of reach for any second implementation; held at 1e-3.
    ({}, 1e-3)])
def test_params_after_10_steps_match_jax(data_dir, tmp_path, kw, atol):
    c = tiny_config(data_dir, str(tmp_path), **kw)
    jt, tt = JaxTrainer(c), Trainer(c, run_dir=str(tmp_path / "port"))
    _carry(jt, tt)
    want_aux = jt.train(num_steps=10)
    got_aux = tt.train(num_steps=10)
    assert tt.step == int(jt.state.step) == 10
    want = weights_io.flatten_params(jax.device_get(jt.state.params))
    got = state_dict_to_flax(tt.model.state_dict())
    for k in want:
        if k != NULL_PARAM:
            np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)
    p = np.random.default_rng(4).uniform(-1, 1, (4, 3)).astype(np.float32)
    np.testing.assert_allclose(tt.generate(p), jt.generate(p),
                               atol=max(atol, 1e-5) * 10)
    for k in ("loss", "loss_field", "loss_jac"):
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=1e-3)


@pytest.mark.parametrize("cache", [False, True])
def test_resume_is_bitwise_exact(data_dir, tmp_path, cache):
    kw = dict(device_data_cache=cache, steps_per_call=2 if cache else 1)
    ta = Trainer(tiny_config(data_dir, str(tmp_path), tag="full", **kw))
    ta.train(num_steps=20)
    cb = tiny_config(data_dir, str(tmp_path), tag="int", **kw)
    tb = Trainer(cb)
    tb.train(num_steps=10)
    tc = Trainer(cb, run_dir=tb.run_dir, save_cfg=False)
    assert tc.restore_checkpoint() == 10
    tc.train(num_steps=10)
    assert tc.step == ta.step == 20
    for k, v in ta.model.state_dict().items():
        torch.testing.assert_close(tc.model.state_dict()[k], v, atol=0,
                                   rtol=0)
    for k, v in ta.opt.state_dict()["state"].items():
        for name, t in v.items():
            torch.testing.assert_close(tc.opt.state_dict()["state"][k][name],
                                       t, atol=0, rtol=0)


def test_checkpoints_keep_three_and_lr_resumes(data_dir, tmp_path):
    c = tiny_config(data_dir, str(tmp_path), save_step=2, log_step=3)
    t = Trainer(c)
    t.train(num_steps=9)
    assert t.checkpoint_steps() == [6, 8, 9]
    t2 = Trainer(c, run_dir=t.run_dir, save_cfg=False)
    assert t2.restore_checkpoint(8) == 8
    assert t2.maybe_resume() == 9
    # the schedule continues at the restored count
    t2.train(num_steps=1)
    assert t2.opt.param_groups[0]["lr"] == t2.lr_fn(9)
    rows = [json.loads(ln) for ln in open(os.path.join(t.run_dir,
                                                       "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [3, 6, 9, 10]
    assert all(set(r) == {"step", "steps_per_sec", "loss", "loss_field",
                          "loss_jac"} for r in rows)


def test_steps_per_call_rounds_up_like_jax(data_dir, tmp_path):
    t = Trainer(tiny_config(data_dir, str(tmp_path), steps_per_call=4))
    t.train(num_steps=6)
    assert t.step == 8


@pytest.mark.parametrize("kw,match", [
    ({"augment_flip_x": True}, "Queue A item 9"),
    ({"input_pipeline": "grain"}, "Queue A item 11"),
    ({"num_model_shards": 2}, "Queue A item 11"),
    ({"num_data_shards": 2}, "Queue A item 11"),
    ({"profile_steps": "1,2"}, "Queue A item 13"),
    ({"use_tensorboard": True}, "Queue A item 13"),
    ({"debug_nans": True}, "Queue A item 13"),
    ({"die_at_step": 3}, "Queue A item 13")])
def test_unported_train_flags_raise(data_dir, tmp_path, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        Trainer(tiny_config(data_dir, str(tmp_path), **kw))
    assert not os.listdir(tmp_path), "nothing written before refusing"


def test_train_then_serve_loads_into_jax(data_dir, tmp_path):
    """``main`` trains (with a checkpoint in the middle and a sample dump),
    resumes to a higher --max_step, then serves; JAX's
    ``weights_io.import_npz`` reads the run's weights.npz and generates the
    fields the port's sweep wrote."""
    env = dict(data_dir=data_dir, log_dir=str(tmp_path), tag="e2e",
               test_batch_size=8)
    before = dict(cuda_fd.launch_counts)
    torch_main(tiny_config(max_step=6, save_step=3, test_step=3, log_step=2,
                           **env), device="cpu")
    run = os.path.join(str(tmp_path), "tiny_smoke_e2e")
    assert sorted(os.listdir(os.path.join(run, "checkpoint"))) == ["3", "6"]
    assert sorted(os.listdir(os.path.join(run, "sample"))) == [
        "0000003.png", "0000006.png"]
    torch_main(tiny_config(max_step=8, log_step=2, load_path=run, **env),
               device="cpu")
    steps = [json.loads(ln)["step"]
             for ln in open(os.path.join(run, "metrics.jsonl"))]
    assert steps == [2, 4, 6, 8]          # the resume started at step 6
    result = torch_main(tiny_config(is_train=False, load_path=run,
                                    test_frames=2, **env), device="cpu")
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"
    files = sorted(glob.glob(os.path.join(run, "test", "*.npz")))
    assert result["num_fields"] == len(files) == 8

    m = Trainer(tiny_config(is_train=False, **env), run_dir=run,
                save_cfg=False).manifest
    fm = FlaxGeneratorBE(output_shape=(32, 32, 1), filters=8, num_conv=1)
    template = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]
    params = weights_io.import_npz(os.path.join(run, "weights.npz"),
                                   template)
    for path in files:
        with np.load(path) as d:
            p = m.normalize_params(d["y"])[None]
            u = jlosses.apply_curl(fm.apply({"params": params},
                                            jnp.asarray(p)))
            want = m.denormalize_field(np.asarray(u)[0])
            assert normalized_l2(d["x"], want) < 1e-3, path
