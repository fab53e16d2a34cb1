"""The port's Encoder and Autoencoder (arch "ae") against the Flax modules,
on shared weights.

Flax initializes the weights; ``models/weights.py`` carries them over, and
both frameworks run the same numpy-made fields.
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

from deepfluids_tpu.models import Autoencoder as FlaxAutoencoder  # noqa: E402
from deepfluids_tpu.models import Encoder as FlaxEncoder  # noqa: E402
from deepfluids_tpu.models import LatentIntegrator as FlaxIntegrator  # noqa: E402,E501
from deepfluids_tpu_torch.models import (  # noqa: E402
    Autoencoder,
    Encoder,
    LatentIntegrator,
    flax_init_,
    flax_shapes,
    flax_to_state_dict,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.models.autoencoder import same_pads  # noqa: E402
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402


def _fields(shape, batch=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch,) + shape).astype(np.float32)


def _carry(params, model):
    model.load_state_dict(flax_to_state_dict(
        weights_io.flatten_params(params), model))
    return model


def _encoder_pair(shape, filters, num_conv, batch=3, flax_dtype=jnp.float32,
                  torch_dtype=torch.float32):
    """(flax codes, port codes) of the same weights and fields."""
    x = _fields(shape, batch)
    fm = FlaxEncoder(z_num=16, filters=filters, num_conv=num_conv,
                     dtype=flax_dtype)
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = _carry(params, Encoder(shape[:-1], shape[-1], z_num=16,
                                filters=filters, num_conv=num_conv,
                                compute_dtype=torch_dtype))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    return want, got.numpy()


@pytest.mark.parametrize("shape,num_conv", [
    ((32, 32, 2), 1), ((32, 24, 2), 2),
    # 40x30 -> 20x15 -> 10x8: the second stride-2 conv sees an odd axis,
    # where 'SAME' pads (1, 1) instead of (0, 1).
    ((40, 30, 2), 1),
    # 3D: Conv3d stages, the NDHWC flatten
    ((8, 16, 12, 3), 1)])
def test_encoder_matches_flax_f32(shape, num_conv):
    # atol 1e-5: the two frameworks sum the convolutions in other orders.
    want, got = _encoder_pair(shape, 8, num_conv)
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_encoder_matches_flax_flagship_width():
    # 128x96x2, filters 128, num_conv 4, repeat 5 (8x6 before fc_out): the
    # encoder of config #4.
    want, got = _encoder_pair((128, 96, 2), 128, 4, batch=1)
    assert normalized_l2(got, want) < 1e-5


@pytest.mark.parametrize("n,stride,want", [
    (32, 2, (0, 1)), (15, 2, (1, 1)), (8, 2, (0, 1)), (7, 1, (1, 1))])
def test_same_pads_as_xla(n, stride, want):
    assert same_pads((n,), stride) == want


def _ae_pair(pred_hidden, dtype=jnp.float32, torch_dtype=torch.float32,
             shape=(32, 24), num_conv=2):
    x = _fields(shape + (2,), seed=2)
    fm = FlaxAutoencoder(output_shape=shape + (1,), z_num=8, filters=8,
                         num_conv=num_conv, dtype=dtype, num_param=2,
                         pred_hidden=pred_hidden, pred_depth=2)
    params = fm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    tm = _carry(params, Autoencoder(shape + (1,), in_channels=2, z_num=8,
                                    filters=8, num_conv=num_conv,
                                    compute_dtype=torch_dtype, num_param=2,
                                    pred_hidden=pred_hidden, pred_depth=2))
    return x, fm, params, tm


@pytest.mark.parametrize("pred_hidden", [0, 16])
def test_autoencoder_matches_flax_f32(pred_hidden):
    x, fm, params, tm = _ae_pair(pred_hidden)
    psi, z = fm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        t_psi, t_z = tm(torch.from_numpy(x))
        dec = tm.decode(t_z)
    np.testing.assert_allclose(t_psi.numpy(), np.asarray(psi), atol=1e-5)
    np.testing.assert_allclose(t_z.numpy(), np.asarray(z), atol=1e-5)
    np.testing.assert_array_equal(tm.encode(torch.from_numpy(x)).detach(),
                                  t_z)
    np.testing.assert_array_equal(dec.numpy(), t_psi.numpy())
    assert t_psi.shape == (3, 32, 24, 1) and t_z.dtype == torch.float32
    if pred_hidden:
        dp = np.random.default_rng(4).uniform(-0.1, 0.1, (3, 2)).astype(
            np.float32)
        want = fm.apply({"params": params}, z, jnp.asarray(dp),
                        method=fm.predict)
        with torch.no_grad():
            got = tm.predict(t_z, torch.from_numpy(dp))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    else:
        with pytest.raises(ValueError, match="pred_hidden"):
            tm.predict(t_z, t_z[:, :2])


def test_autoencoder_matches_flax_bf16():
    # Both compute in bf16 but round at different places, so agreement is
    # to a few bf16 ulps (the bar of tests/test_torch_generator.py).
    x, fm, params, tm = _ae_pair(0, jnp.bfloat16, torch.bfloat16)
    psi, z = fm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        t_psi, t_z = tm(torch.from_numpy(x))
    assert t_psi.dtype == t_z.dtype == torch.float32
    assert normalized_l2(t_psi.numpy(), np.asarray(psi)) < 2e-2
    assert normalized_l2(t_z.numpy(), np.asarray(z)) < 2e-2


@pytest.mark.parametrize("what", ["ae", "ae_pred", "integrator",
                                  "integrator_h3"])
def test_converter_round_trip_and_flax_keys(what):
    # The port's module names map onto Flax's flat keys both ways.
    if what.startswith("ae"):
        hidden = 16 if what == "ae_pred" else 0
        x, fm, params, tm = _ae_pair(hidden)
    else:
        h = 3 if what == "integrator_h3" else 1
        fm = FlaxIntegrator(z_num=8, num_param=2, hidden=16, depth=2)
        params = fm.init(jax.random.PRNGKey(5), jnp.zeros((1, 8 * h)),
                         jnp.zeros((1, 2)))["params"]
        tm = _carry(params, LatentIntegrator(8, 2, hidden=16, depth=2,
                                             history=h))
    flat = weights_io.flatten_params(params)
    assert {k: v.shape for k, v in flat.items()} == flax_shapes(tm)
    back = state_dict_to_flax(tm.state_dict())
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_flax_init_keeps_the_integrator_head_zero():
    ae = flax_init_(Autoencoder((32, 24, 1), z_num=8, filters=8, num_conv=1,
                                num_param=2, pred_hidden=16), seed=0)
    nn_ = flax_init_(LatentIntegrator(8, 2, hidden=16), seed=0)
    for model, head in ((ae, ae.predictor.fc_out), (nn_, nn_.fc_out)):
        assert not head.weight.any() and not head.bias.any()
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                assert not p.any(), name
            elif "fc_out" not in name or name.startswith(("encoder",
                                                          "decoder")):
                assert p.abs().max() > 0, name
    z = torch.randn(4, 8)
    assert not nn_(z, z[:, :2]).any()      # the identity rollout at init
