"""The port's 3D GeneratorBE (Conv3d, vector potential) against Flax.

Flax initializes the weights; ``models/weights.py`` carries them over
(DHWIO <-> OIDHW), and both frameworks run the same numpy-made parameter
vectors.  The golden files ``tests/golden/generator3d{,_params}.npz`` were
written once by JAX on the CPU: Flax's init (PRNGKey 11) of an (8, 16, 16,
3) generator, filters 8, num_conv 2, and its output through ``curl3d``.
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

from deepfluids_tpu import ops as jops  # noqa: E402
from deepfluids_tpu.models import GeneratorBE as FlaxGeneratorBE  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    GeneratorBE,
    flax_init_,
    flax_shapes,
    flax_to_state_dict,
    load_flax_npz,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.ops import cuda_fd  # noqa: E402
from deepfluids_tpu_torch.train.losses import apply_curl  # noqa: E402
from deepfluids_tpu_torch.utils.parity import (  # noqa: E402
    check_fields,
    normalized_l2,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_SHAPE = (8, 16, 16, 3)


def _pair(shape, filters, num_conv, seed=0, batch=2,
          flax_dtype=jnp.float32, torch_dtype=torch.float32):
    """(flax output, port output) for the same weights and inputs."""
    p = np.random.default_rng(seed).uniform(
        -1, 1, (batch, 3)).astype(np.float32)
    fm = FlaxGeneratorBE(output_shape=shape, filters=filters,
                         num_conv=num_conv, dtype=flax_dtype)
    params = fm.init(jax.random.PRNGKey(seed), jnp.asarray(p))["params"]
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(p)))
    tm = GeneratorBE(shape, num_param=3, filters=filters, num_conv=num_conv,
                     compute_dtype=torch_dtype)
    tm.load_state_dict(flax_to_state_dict(
        weights_io.flatten_params(params), tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(p))
    assert got.dtype == torch.float32
    return want, got.numpy()


@pytest.mark.parametrize("shape,num_conv", [
    ((8, 16, 16, 3), 2), ((8, 16, 16, 3), 1), ((4, 8, 14, 3), 1),
    ((8, 16, 16, 1), 1)])
def test_generator3d_matches_flax_f32(shape, num_conv):
    # atol 1e-5: the two frameworks sum the convolutions in other orders.
    want, got = _pair(shape, 8, num_conv)
    assert got.shape == want.shape == (2,) + shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_generator3d_matches_flax_flagship_width():
    # Config #5's width (filters 128, num_conv 4) on half its grid, 16x32x56
    # (repeat 4 as at 32x64x112, coarse 2x4x7), batch 1: the tier-1 time.
    want, got = _pair((16, 32, 56, 3), 128, 4, batch=1)
    assert got.shape == (1, 16, 32, 56, 3)
    assert normalized_l2(got, want) < 1e-5


def test_generator3d_matches_flax_bf16():
    # Both compute in bf16 but round at different places (the bias add,
    # the accumulation), so agreement is to a few bf16 ulps (2**-8 each).
    want, got = _pair((8, 16, 16, 3), 8, 2, flax_dtype=jnp.bfloat16,
                      torch_dtype=torch.bfloat16)
    assert normalized_l2(got, want) < 2e-2


def test_config5_geometry():
    # The flagship 3D model: repeat 4 from 112, coarse 4x8x14 (fc_in to
    # 448 * 128 features), 3 potential channels.
    m = GeneratorBE((32, 64, 112, 3), num_param=3, filters=128, num_conv=4)
    assert m.repeat == 4 and m.coarse == (4, 8, 14)
    assert m.fc_in.out_features == 4 * 8 * 14 * 128
    assert isinstance(m.conv_3_3, torch.nn.Conv3d)
    assert tuple(m.conv_out.weight.shape) == (3, 128, 3, 3, 3)
    shapes = flax_shapes(m)
    assert shapes["conv_0_0/kernel"] == (3, 3, 3, 128, 128)
    assert shapes["conv_out/kernel"] == (3, 3, 3, 128, 3)


def test_golden_params_equal_fresh_flax_init():
    g = np.load(os.path.join(GOLDEN, "generator3d.npz"))
    fm = FlaxGeneratorBE(output_shape=GOLDEN_SHAPE, filters=8, num_conv=2)
    fresh = fm.init(jax.random.PRNGKey(11), jnp.asarray(g["p"]))
    flat = weights_io.flatten_params(fresh["params"])
    with np.load(os.path.join(GOLDEN, "generator3d_params.npz")) as d:
        assert sorted(d.files) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(d[k], v)
    # ... and the golden fields are JAX's curl3d of its output
    u = jops.curl3d(fm.apply(fresh, jnp.asarray(g["p"])))
    np.testing.assert_allclose(g["u"], np.asarray(u), atol=1e-6)


def test_generator3d_golden_through_curl():
    g = np.load(os.path.join(GOLDEN, "generator3d.npz"))
    tm = GeneratorBE(GOLDEN_SHAPE, num_param=3, filters=8, num_conv=2)
    load_flax_npz(os.path.join(GOLDEN, "generator3d_params.npz"), tm)
    before = dict(cuda_fd.launch_counts)
    with torch.no_grad():
        u = apply_curl(tm(torch.from_numpy(g["p"])))
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"
    assert u.shape == g["u"].shape
    assert check_fields(u.numpy(), g["u"])["passed"]


def test_converter_3d_both_ways():
    # Flax DHWIO -> torch OIDHW elementwise, and back to the same arrays.
    with np.load(os.path.join(GOLDEN, "generator3d_params.npz")) as d:
        flat = {k: d[k] for k in d.files}
    tm = GeneratorBE(GOLDEN_SHAPE, num_param=3, filters=8, num_conv=2)
    sd = flax_to_state_dict(flat, tm)
    k = flat["conv_1_0/kernel"]                       # (kd, kh, kw, in, out)
    w = sd["conv_1_0.weight"].numpy()                 # (out, in, kd, kh, kw)
    assert w.shape == (8, 8, 3, 3, 3)
    assert w[5, 2, 0, 1, 2] == k[0, 1, 2, 2, 5]
    assert w.flags["C_CONTIGUOUS"]
    back = state_dict_to_flax(sd)
    assert list(back) == list(flax_shapes(tm))
    for name, arr in flat.items():
        np.testing.assert_array_equal(back[name], arr)


def test_init_roundtrip_3d():
    # The port's Flax-style init, out to Flax's layout and back unchanged;
    # the Flax template has the same keys and shapes.
    model = flax_init_(GeneratorBE(GOLDEN_SHAPE, num_param=3, filters=8,
                                   num_conv=2), seed=3)
    w = model.conv_0_0.weight.detach().double()
    fan_in = 8 * 27
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    flat = state_dict_to_flax(model.state_dict())
    fm = FlaxGeneratorBE(output_shape=GOLDEN_SHAPE, filters=8, num_conv=2)
    template = weights_io.flatten_params(
        fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"])
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in template.items()}
    back = flax_to_state_dict(flat, model)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, atol=0, rtol=0)


@pytest.mark.parametrize("fault,exc", [
    ("transpose", ValueError), ("missing", KeyError), ("extra", KeyError),
    ("2d_kernel", ValueError)])
def test_converter_3d_rejects(fault, exc):
    with np.load(os.path.join(GOLDEN, "generator3d_params.npz")) as d:
        flat = {k: d[k] for k in d.files}
    if fault == "transpose":     # an OIDHW kernel where DHWIO belongs
        flat["conv_out/kernel"] = flat["conv_out/kernel"].transpose(
            4, 3, 0, 1, 2)
    elif fault == "missing":
        del flat["conv_1_1/bias"]
    elif fault == "extra":
        flat["conv_9_9/kernel"] = flat["conv_0_0/kernel"]
    else:                        # a 2D run's HWIO kernel
        flat["conv_0_0/kernel"] = flat["conv_0_0/kernel"][0]
    tm = GeneratorBE(GOLDEN_SHAPE, num_param=3, filters=8, num_conv=2)
    with pytest.raises(exc):
        flax_to_state_dict(flat, tm)
