"""``--augment_flip_x`` (``train/augment.py`` and its trainer wiring)
against the JAX package: the twins of tests/test_train.py's
``TestAugmentFlipX``.

JAX's Bernoulli mask stream cannot be reproduced in torch, so the mask is
drawn with JAX's own key and handed to the port: given the same mask the
flipped batch is bit-equal, and a 3-step run under l2 lands on JAX's
parameters at 1e-5.
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
from deepfluids_tpu.datagen import scenes  # noqa: E402
from deepfluids_tpu.train import augment as jaugment  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu_torch.config import Config as PortConfig  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    flax_to_state_dict,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.train import augment  # noqa: E402
from deepfluids_tpu_torch.train import trainer as trmod  # noqa: E402
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402


class _Manifest:
    def __init__(self, ranges=None, names=None, channels=2,
                 data_type="velocity"):
        self.num_channels = channels
        self.data_type = data_type
        self.param_names = names or ["src_x_pos", "src_radius", "frame"]
        self.num_param = len(self.param_names)
        self.param_ranges = ranges or [[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug_data")
    scenes.smoke_pos21_size5(str(root), num_pos=2, num_size=2, num_frames=4,
                             height=32, width=32, name="tiny_smoke")
    return str(root)


def _kw(data_dir, log_dir, **kw) -> dict:
    base = dict(arch="de", filters=8, num_conv=1, batch_size=8,
                data_dir=data_dir, dataset="tiny_smoke", log_dir=log_dir,
                max_step=50, lr_max=2e-3, lr_min=1e-4, log_step=10,
                test_step=10_000, save_step=10_000, compute_dtype="float32",
                num_worker=2, seed=0, augment_flip_x=True)
    base.update(kw)
    return base


def _port(data_dir, tmp_path, **kw) -> Trainer:
    return Trainer(PortConfig(**_kw(data_dir, str(tmp_path), **kw)),
                   device="cpu")


@pytest.mark.parametrize("manifest,chan,psign", [
    (_Manifest(), [-1, 1], [-1, 1, 1]),
    (_Manifest(ranges=[[0.25, 0.75], [0.06, 0.15], [0.0, 199.0]],
               names=["drop_x_pos", "drop_radius", "frame"], channels=1,
               data_type="levelset"), [1], [-1, 1, 1]),
    (_Manifest(ranges=[[0.5, 1.5], [0.04, 0.12], [0.0, 249.0]],
               names=["inflow_vel", "buoyancy", "frame"], channels=3),
     [-1, 1, 1], [1, 1, 1])], ids=["smoke", "liquid", "smoke3d"])
def test_signs_match_jax(manifest, chan, psign):
    got = augment.flip_signs(manifest)
    want = jaugment.flip_signs(manifest)
    for g, w, ref in zip(got, want, (chan, psign)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), ref)


def test_asymmetric_x_range_refused_as_jax_does():
    bad = _Manifest(ranges=[[0.1, 0.8], [0.04, 0.12], [0.0, 3.0]])
    with pytest.raises(ValueError) as ours:
        augment.flip_signs(bad)
    with pytest.raises(ValueError) as theirs:
        jaugment.flip_signs(bad)
    assert str(ours.value) == str(theirs.value)
    assert "not symmetric" in str(ours.value)


@pytest.mark.parametrize("shape,manifest", [
    ((8, 6, 5, 2), _Manifest()),
    ((8, 3, 4, 5, 3), _Manifest(channels=3)),
    ((8, 6, 5, 1), _Manifest(channels=1, data_type="levelset"))],
    ids=["2d", "3d", "levelset"])
def test_flip_bit_equal_given_jax_mask(shape, manifest):
    rng = jax.random.fold_in(jax.random.PRNGKey(0 ^ 0xF11B), 7)
    mask = np.array(jax.random.bernoulli(rng, 0.5, (shape[0],)))
    assert 0 < mask.sum() < shape[0]           # a mixed mask
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    y = np.random.default_rng(2).uniform(-1, 1, (shape[0], 3)).astype(
        np.float32)
    wx, wy = jaugment.flip_x_batch(jnp.asarray(x), jnp.asarray(y), rng,
                                   *jaugment.flip_signs(manifest))
    gx, gy = augment.flip_x_batch(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(mask),
                                  *augment.flip_signs(manifest))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_double_flip_is_identity():
    signs = augment.flip_signs(_Manifest())
    mask = augment.flip_mask(3, 0, 8)
    x, y = torch.randn(8, 6, 5, 2), torch.randn(8, 3)
    x1, y1 = augment.flip_x_batch(x, y, mask, *signs)
    assert float((x1 - x).abs().max()) > 0      # some frames flipped
    x2, y2 = augment.flip_x_batch(x1, y1, mask, *signs)
    torch.testing.assert_close(x2, x, atol=0, rtol=0)
    torch.testing.assert_close(y2, y, atol=0, rtol=0)


def test_mask_is_a_pure_function_of_seed_and_step():
    a = augment.flip_mask(5, 11, 64)
    assert a.dtype == torch.bool and a.shape == (64,)
    torch.testing.assert_close(augment.flip_mask(5, 11, 64), a)
    assert not torch.equal(augment.flip_mask(5, 12, 64), a)
    assert not torch.equal(augment.flip_mask(6, 11, 64), a)
    share = float(torch.stack([augment.flip_mask(0, s, 64)
                               for s in range(50)]).float().mean())
    assert abs(share - 0.5) < 0.03
    # the global RNG (the batch stream's, the sample dumps') is untouched
    torch.manual_seed(0)
    before = torch.rand(3)
    torch.manual_seed(0)
    augment.flip_mask(0, 1, 8)
    torch.testing.assert_close(torch.rand(3), before)


def test_matches_jax_given_jax_masks(data_dir, tmp_path, monkeypatch):
    """The trainer wiring: with JAX's masks (fold_in of PRNGKey(seed ^
    0xF11B) by the updates done) the port's 3 augmented steps under l2
    land on the JAX trainer's parameters."""
    key = jax.random.PRNGKey(0 ^ 0xF11B)
    monkeypatch.setattr(augment, "flip_mask", lambda seed, step, b, dev: (
        torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(key, step), 0.5, (b,))))))
    kw = dict(loss_norm="l2")
    jt = JaxTrainer(Config(**_kw(data_dir, str(tmp_path), **kw)))
    tt = Trainer(PortConfig(**_kw(data_dir, str(tmp_path), **kw)),
                 run_dir=str(tmp_path / "port"), device="cpu")
    tt.model.load_state_dict(flax_to_state_dict(weights_io.flatten_params(
        jax.device_get(jt.state.params)), tt.model))
    want_aux = jt.train(num_steps=3)
    got_aux = tt.train(num_steps=3)
    want = weights_io.flatten_params(jax.device_get(jt.state.params))
    got = state_dict_to_flax(tt.model.state_dict())
    for k in want:
        if k != "conv_out/bias":      # the curl's null direction
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)
    np.testing.assert_allclose(got_aux["loss"], want_aux["loss"], rtol=1e-4)


@pytest.mark.parametrize("cache", [False, True])
def test_trains_and_resumes_bitwise(data_dir, tmp_path, cache):
    kw = dict(device_data_cache=cache, steps_per_call=2 if cache else 1)
    ta = _port(data_dir, tmp_path, tag="augfull", **kw)
    assert np.isfinite(ta.train(num_steps=12)["loss"])
    cb = PortConfig(**_kw(data_dir, str(tmp_path), tag="augint", **kw))
    tb = Trainer(cb, device="cpu")
    tb.train(num_steps=6)
    tc = Trainer(cb, run_dir=tb.run_dir, device="cpu", save_cfg=False)
    assert tc.restore_checkpoint() == 6
    tc.train(num_steps=6)
    for k, v in ta.model.state_dict().items():
        torch.testing.assert_close(tc.model.state_dict()[k], v, atol=0,
                                   rtol=0)


def test_changes_training_but_not_eval(data_dir, tmp_path):
    t0 = _port(data_dir, tmp_path, tag="noaug", augment_flip_x=False)
    t1 = _port(data_dir, tmp_path, tag="aug")
    t0.train(num_steps=4)
    t1.train(num_steps=4)
    d = [float((a - b).abs().max()) for a, b in zip(
        t0.model.state_dict().values(), t1.model.state_dict().values())]
    assert max(d) > 0
    # evaluate() is augmentation-free: the same weights score the same
    t0.model.load_state_dict(t1.model.state_dict())
    e0, e1 = t0.evaluate(num_samples=8), t1.evaluate(num_samples=8)
    assert e0 == e1


def test_grid_family_holdout_leakage_warns(data_dir, tmp_path, monkeypatch):
    warned: list[str] = []
    monkeypatch.setattr(trmod.log, "warning",
                        lambda msg, *a: warned.append(msg % a))
    _port(data_dir, tmp_path, tag="augleak", eval_holdout_scenes=1)
    assert any("mirror-twin" in m for m in warned)
    warned.clear()
    _port(data_dir, tmp_path, tag="augleak2")
    assert not any("mirror-twin" in m for m in warned)


@pytest.mark.parametrize("kw,match", [
    (dict(arch="nn"), "augment_flip_x applies to arch de/ae"),
    (dict(arch="ae", ae_pred_w=0.5), "unsupported \\(pair batches\\)")])
def test_refused_as_jax_does(data_dir, tmp_path, kw, match):
    for cfg, make in ((Config, JaxTrainer), (PortConfig, Trainer)):
        c = cfg(**_kw(data_dir, str(tmp_path), tag="augno", **kw))
        with pytest.raises(ValueError, match=match):
            make(c) if make is JaxTrainer else make(c, device="cpu")
