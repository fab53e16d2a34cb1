"""The port's GeneratorBE against the Flax module, on shared weights.

Flax initializes the weights; ``models/weights.py`` carries them over, and
both frameworks run the same numpy-made parameter vectors.
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

from deepfluids_tpu.models import GeneratorBE as FlaxGeneratorBE  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    GeneratorBE,
    flax_to_state_dict,
    load_flax_npz,
)
from deepfluids_tpu_torch.train.losses import apply_curl  # noqa: E402
from deepfluids_tpu_torch.utils.parity import (  # noqa: E402
    check_fields,
    normalized_l2,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _pair(shape, filters, num_conv, seed=0, batch=4,
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
    ((32, 24, 1), 2), ((32, 24, 1), 1), ((16, 16, 1), 1), ((16, 16, 1), 2)])
def test_generator_matches_flax_f32(shape, num_conv):
    # atol 1e-5: the two frameworks sum the convolutions in other orders.
    want, got = _pair(shape, 8, num_conv)
    assert got.shape == want.shape == (4,) + shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_generator_matches_flax_flagship_width():
    # 128x96, filters 128, num_conv 4, repeat 5: the served configuration.
    want, got = _pair((128, 96, 1), 128, 4, batch=1)
    assert normalized_l2(got, want) < 1e-5


def test_generator_matches_flax_bf16():
    # Both compute in bf16 but round at different places (the bias add,
    # the accumulation), so agreement is to a few bf16 ulps (2**-8 each).
    want, got = _pair((32, 24, 1), 8, 2, flax_dtype=jnp.bfloat16,
                      torch_dtype=torch.bfloat16)
    assert normalized_l2(got, want) < 2e-2


def test_golden_params_equal_fresh_flax_init():
    g = np.load(os.path.join(GOLDEN, "generator2d.npz"))
    fm = FlaxGeneratorBE(output_shape=(32, 24, 1), filters=8, num_conv=2)
    fresh = weights_io.flatten_params(
        fm.init(jax.random.PRNGKey(7), jnp.asarray(g["p"]))["params"])
    with np.load(os.path.join(GOLDEN, "generator2d_params.npz")) as d:
        assert sorted(d.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(d[k], v)


def test_generator_golden_through_curl():
    g = np.load(os.path.join(GOLDEN, "generator2d.npz"))
    tm = GeneratorBE((32, 24, 1), num_param=3, filters=8, num_conv=2)
    load_flax_npz(os.path.join(GOLDEN, "generator2d_params.npz"), tm)
    with torch.no_grad():
        u = apply_curl(tm(torch.from_numpy(g["p"])))
    assert check_fields(u.numpy(), g["u"])["passed"]


@pytest.mark.parametrize("fault,exc", [
    ("transpose", ValueError), ("missing", KeyError), ("extra", KeyError)])
def test_converter_rejects(fault, exc):
    with np.load(os.path.join(GOLDEN, "generator2d_params.npz")) as d:
        flat = {k: d[k] for k in d.files}
    if fault == "transpose":
        flat["fc_in/kernel"] = flat["fc_in/kernel"].T
    elif fault == "missing":
        del flat["conv_1_0/bias"]
    else:
        flat["conv_9_9/kernel"] = flat["conv_0_0/kernel"]
    tm = GeneratorBE((32, 24, 1), num_param=3, filters=8, num_conv=2)
    with pytest.raises(exc):
        flax_to_state_dict(flat, tm)


@pytest.mark.parametrize("shape,exc,match", [
    ((4, 16, 16, 16, 3), ValueError, r"\(D, H, W, C\)"),
    ((40, 30, 1), ValueError, "divisible"),
    ((6, 32, 32, 3), ValueError, "divisible")])
def test_generator_rejects_shape(shape, exc, match):
    with pytest.raises(exc, match=match):
        GeneratorBE(shape, filters=8, num_conv=1)
