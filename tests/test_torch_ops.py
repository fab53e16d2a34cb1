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


# --- backward kernels' plain versions, autograd, the jacobian wrapper ------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [3, 4, 7])
@pytest.mark.parametrize("dim", [-1, -2])
def test_fdt_is_the_transpose_of_fdiff(n, dim):
    # Elementwise against autograd of the forward difference: a lost index
    # at the n-2 / n-1 edge rows would pass a test of sums only.
    shape = [2, 5, 5]
    shape[dim] = n
    x = torch.from_numpy(_rand(shape, n)).double().requires_grad_()
    g = torch.from_numpy(_rand(shape, n + 1)).double()
    (tops.fd._fdiff(x, dim) * g).sum().backward()
    torch.testing.assert_close(tops.fd.fdt(g, dim), x.grad, atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("shape", [(2, 16, 12), (1, 128, 96), (3, 3, 5)])
def test_bwd_plain_matches_pallas(shape):
    from deepfluids_tpu.ops import pallas_fd

    g = _rand(shape + (2,), 10)
    gj, gw = _rand(shape + (4,), 11), _rand(shape + (1,), 12)
    np.testing.assert_allclose(
        tops.fd.curl2d_bwd(torch.from_numpy(g)).numpy(),
        np.asarray(pallas_fd._curl2d_bwd(jnp.asarray(g))), atol=1e-6)
    np.testing.assert_allclose(
        tops.fd.jacobian2d_bwd(torch.from_numpy(gj),
                               torch.from_numpy(gw)).numpy(),
        np.asarray(pallas_fd._jacobian2d_bwd(jnp.asarray(gj),
                                             jnp.asarray(gw))), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16, 12), (1, 128, 96)])
def test_curl2d_p_grad_matches_jax(shape):
    import jax

    from deepfluids_tpu.ops import pallas_fd

    psi, g = _rand(shape + (1,), 20), _rand(shape + (2,), 21)
    _, vjp = jax.vjp(pallas_fd.curl2d_p, jnp.asarray(psi))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    before = dict(cuda_fd.launch_counts)
    p = torch.from_numpy(psi).requires_grad_()
    cuda_fd.curl2d_p(p).backward(torch.from_numpy(g))
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5)
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"


@pytest.mark.parametrize("shape", [(2, 16, 12), (1, 128, 96)])
def test_jacobian2d_p_grad_matches_jax(shape):
    import jax

    from deepfluids_tpu.ops import pallas_fd

    x = _rand(shape + (2,), 30)
    gj, gw = _rand(shape + (4,), 31), _rand(shape + (1,), 32)
    _, vjp = jax.vjp(pallas_fd.jacobian2d_p, jnp.asarray(x))
    want = np.asarray(vjp((jnp.asarray(gj), jnp.asarray(gw)))[0])
    t = torch.from_numpy(x).requires_grad_()
    j, w = cuda_fd.jacobian2d_p(t)
    torch.autograd.backward([j, w], [torch.from_numpy(gj),
                                     torch.from_numpy(gw)])
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-5)


def test_jacobian2d_p_unused_vort_gets_zero_cotangent():
    # The loss uses J only: the vorticity's cotangent is zeros, as in JAX.
    x = torch.from_numpy(_rand((2, 16, 12, 2), 33)).requires_grad_()
    gj = torch.from_numpy(_rand((2, 16, 12, 4), 34))
    j, _ = cuda_fd.jacobian2d_p(x)
    j.backward(gj)
    want = tops.fd.jacobian2d_bwd(gj, torch.zeros(2, 16, 12, 1))
    torch.testing.assert_close(x.grad, want, atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(2, 16, 12), (1, 128, 96), (3, 8, 8)])
def test_jacobian2d_fused_cpu_matches_pallas(shape):
    x = _rand(shape + (2,), 40)
    want = jops.jacobian2d_fused(jnp.asarray(x))
    got = cuda_fd.jacobian2d_fused(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("op", ["jacobian2d_fused", "curl2d_bwd",
                                "jacobian2d_bwd"])
def test_cpu_bf16_matches_pallas(op):
    # f32 math and one rounding on both sides: bit-identical.
    from deepfluids_tpu.ops import pallas_fd

    args = {"jacobian2d_fused": [(2, 16, 12, 2)],
            "curl2d_bwd": [(2, 16, 12, 2)],
            "jacobian2d_bwd": [(2, 16, 12, 4), (2, 16, 12, 1)]}[op]
    xs = [_rand(s, 50 + k) for k, s in enumerate(args)]
    jax_fn = {"jacobian2d_fused": jops.jacobian2d_fused,
              "curl2d_bwd": pallas_fd._curl2d_bwd,
              "jacobian2d_bwd": pallas_fd._jacobian2d_bwd}[op]
    want = jax_fn(*(jnp.asarray(x, jnp.bfloat16) for x in xs))
    got = getattr(cuda_fd, op)(*(torch.from_numpy(x).to(torch.bfloat16)
                                 for x in xs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("fn,shape", [
    ("curl2d_p", (1, 2, 8, 1)), ("curl2d_p", (1, 8, 2, 1)),
    ("jacobian2d_p", (1, 2, 8, 2)), ("jacobian2d_p", (1, 8, 2, 2))])
def test_grad_refused_below_extent_3(fn, shape):
    x = torch.zeros(shape, requires_grad=True)
    with pytest.raises(ValueError, match=">= 3"):
        getattr(cuda_fd, fn)(x)
    with torch.no_grad():     # the forward alone is right at 2
        getattr(cuda_fd, fn)(x)


@pytest.mark.parametrize("fn,args,exc", [
    ("jacobian2d_fused", [(2, 8, 8, 1)], ValueError),     # not 2 channels
    ("jacobian2d_fused", [(2, 1, 8, 2)], ValueError),     # H < 2
    ("jacobian2d_fused", [(8, 8, 2)], ValueError),        # not 4D
    ("curl2d_bwd", [(2, 2, 8, 2)], ValueError),           # H < 3
    ("curl2d_bwd", [(2, 8, 2, 2)], ValueError),           # W < 3
    ("jacobian2d_bwd", [(2, 8, 8, 4), (2, 8, 6, 1)], ValueError),  # mismatch
    ("jacobian2d_bwd", [(2, 8, 8, 3), (2, 8, 8, 1)], ValueError),
])
def test_new_wrappers_reject(fn, args, exc):
    with pytest.raises(exc):
        getattr(cuda_fd, fn)(*(torch.zeros(s) for s in args))


def test_new_wrappers_reject_dtype_and_layout():
    with pytest.raises(TypeError):
        cuda_fd.jacobian2d_fused(torch.zeros(2, 8, 8, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        cuda_fd.curl2d_bwd(torch.zeros(2, 2, 8, 8).permute(0, 2, 3, 1))

