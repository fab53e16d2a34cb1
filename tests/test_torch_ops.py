"""The port's finite-difference ops against the JAX package.

Inputs are made with numpy from a seed and fed to both frameworks.  On the
CPU the curl wrapper runs its plain version; the JAX side runs the Pallas
kernel in interpret mode, as tests/test_ops.py does.  The CUDA kernel
itself is compared with the plain version in tests/test_torch_cuda.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu import ops as jops
from deepfluids_tpu_torch import ops as tops
from deepfluids_tpu_torch.ops import cuda_fd
from deepfluids_tpu_torch.utils.parity import check_fields

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("name,channels", [
    ("curl2d", 1), ("jacobian2d", 2), ("vorticity2d", 2),
    ("divergence2d", 2)])
def test_fd_matches_jax(name, channels):
    x = np.random.default_rng(0).standard_normal(
        (2, 16, 12, channels)).astype(np.float32)
    want = getattr(jops, name)(jnp.asarray(x))
    got = getattr(tops, name)(torch.from_numpy(x))
    if name == "jacobian2d":
        want, got = list(want), list(got)
    else:
        want, got = [want], [got]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16, 12), (1, 128, 96), (3, 8, 8)])
def test_curl2d_fused_cpu_matches_pallas(shape):
    b, h, w = shape
    psi = np.random.default_rng(4).standard_normal(
        (b, h, w, 1)).astype(np.float32)
    want = np.asarray(jops.curl2d_fused(jnp.asarray(psi)))
    before = dict(cuda_fd.launch_counts)
    got = cuda_fd.curl2d_fused(torch.from_numpy(psi))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"


def test_curl2d_fused_cpu_bf16_matches_pallas():
    # Both compute the difference of two bf16 values and round once to
    # bf16, so the results are bit-identical.
    psi = np.random.default_rng(5).standard_normal(
        (2, 16, 12, 1)).astype(np.float32)
    want = jops.curl2d_fused(jnp.asarray(psi, jnp.bfloat16))
    got = cuda_fd.curl2d_fused(torch.from_numpy(psi).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_fd2d_golden():
    g = np.load(os.path.join(GOLDEN, "fd2d.npz"))
    u = cuda_fd.curl2d_fused(torch.from_numpy(g["psi"]))
    assert check_fields(u.numpy(), g["u"])["passed"]
    j, w = tops.jacobian2d(torch.from_numpy(g["u"]))
    assert check_fields(j.numpy(), g["j"])["passed"]
    assert check_fields(w.numpy(), g["w"])["passed"]
    # divergence-free away from the replicated edge
    div = tops.divergence2d(u)[:, :-2, :-2]
    assert float(div.abs().max()) <= 1e-5


@pytest.mark.parametrize("shape,dtype,exc", [
    ((2, 1, 8, 1), torch.float32, ValueError),     # H < 2
    ((2, 8, 1, 1), torch.float32, ValueError),     # W < 2
    ((2, 8, 8, 2), torch.float32, ValueError),     # not one channel
    ((8, 8, 1), torch.float32, ValueError),        # not 4D
    ((2, 8, 8, 1), torch.float64, TypeError),
    ((2, 8, 8, 1), torch.float16, TypeError),
])
def test_curl2d_fused_rejects(shape, dtype, exc):
    with pytest.raises(exc):
        cuda_fd.curl2d_fused(torch.zeros(shape, dtype=dtype))


def test_curl2d_fused_rejects_non_contiguous():
    psi = torch.zeros(2, 8, 8, 1).transpose(1, 2)
    with pytest.raises(ValueError):
        cuda_fd.curl2d_fused(psi)

