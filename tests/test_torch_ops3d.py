"""The port's 3D finite-difference ops against the JAX package.

Inputs are made with numpy from a seed and fed to both frameworks.  On the
CPU the kernel wrappers run their plain versions; the JAX side runs the
Pallas kernels (#5-#8 of ``pallas_fd.py``) in interpret mode, as
tests/test_ops.py does, at small shapes since interpret mode loops over D.
The CUDA kernels themselves are compared with the plain versions in
tests/test_torch_cuda.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu import ops as jops
from deepfluids_tpu.ops import pallas_fd
from deepfluids_tpu_torch import ops as tops
from deepfluids_tpu_torch.ops import cuda_fd, fd
from deepfluids_tpu_torch.utils.parity import check_fields

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# (2, 5, 6, 7): every extent odd and distinct, so a swapped axis or a lost
# edge index cannot pass; (1, 3, 3, 3): the smallest grid the backward
# kernels take; (1, 8, 12, 16): the fd3d golden's grid.
SMALL = [(2, 5, 6, 7), (1, 3, 3, 3), (1, 8, 12, 16)]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


# The JAX counterpart of each wrapper and its inputs' channels.  JAX's
# jacobian3d backward takes the vorticity cotangent through
# _jacobian3d_p_bwd, which folds it into J's before its kernel.
JAX_OF = {
    "curl3d_fused": pallas_fd.curl3d_fused,
    "jacobian3d_fused": pallas_fd.jacobian3d_fused,
    "curl3d_bwd": pallas_fd._curl3d_bwd,
    "jacobian3d_bwd": lambda gj, gv: pallas_fd._jacobian3d_p_bwd(
        None, (gj, gv))[0],
}
CHANNELS = {"curl3d_fused": [3], "jacobian3d_fused": [3], "curl3d_bwd": [3],
            "jacobian3d_bwd": [9, 3]}


@pytest.mark.parametrize("shape", [(2, 8, 12, 16), (1, 32, 64, 112)])
@pytest.mark.parametrize("name", ["curl3d", "jacobian3d", "vorticity3d",
                                  "divergence3d"])
def test_fd3d_matches_jax(name, shape):
    # The same f32 operations in the same order: 1e-6, the bar of
    # tests/test_ops.py (agreement is exact in practice).
    x = _rand(shape + (3,), 0)
    want = _tuple(getattr(jops, name)(jnp.asarray(x)))
    got = _tuple(getattr(tops, name)(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("shape", SMALL)
@pytest.mark.parametrize("op", list(JAX_OF))
def test_fused3d_cpu_matches_pallas(op, shape):
    xs = [_rand(shape + (c,), 40 + k) for k, c in enumerate(CHANNELS[op])]
    want = _tuple(JAX_OF[op](*(jnp.asarray(x) for x in xs)))
    before = dict(cuda_fd.launch_counts)
    got = _tuple(getattr(cuda_fd, op)(*(torch.from_numpy(x) for x in xs)))
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"
    tol = 1e-5 if op.endswith("_bwd") else 1e-6
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)


@pytest.mark.parametrize("op", list(JAX_OF))
def test_fused3d_cpu_bf16(op):
    # The port computes in f32 from the bf16 inputs and rounds each output
    # once, as the TPU kernels do.  Where JAX also rounds in between (the
    # vorticity from the stored bf16 J; the vorticity cotangent added to
    # J's in bf16), the port is held to JAX's f32 arithmetic on the same
    # bf16 values, rounded once; everything else is bit-identical to JAX's
    # bf16 path.
    xs = [_rand((2, 5, 6, 7, c), 50 + k) for k, c in enumerate(CHANNELS[op])]
    bf = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    in_bf16 = _tuple(JAX_OF[op](*bf))
    in_f32 = _tuple(JAX_OF[op](*(b.astype(jnp.float32) for b in bf)))
    got = _tuple(getattr(cuda_fd, op)(*(torch.from_numpy(x).to(torch.bfloat16)
                                        for x in xs)))
    exact_in_bf16 = {"curl3d_fused": [True], "curl3d_bwd": [True],
                     "jacobian3d_fused": [True, False],
                     "jacobian3d_bwd": [False]}[op]
    for g, wb, wf, exact in zip(got, in_bf16, in_f32, exact_in_bf16):
        assert g.dtype == torch.bfloat16
        want = wb if exact else wf.astype(jnp.bfloat16)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_jacobian3d_bwd_bf16_zero_vort_matches_pallas():
    # With no vorticity cotangent JAX's fold adds zeros: bit-identical.
    gj = jnp.asarray(_rand((2, 5, 6, 7, 9), 60), jnp.bfloat16)
    want = pallas_fd._jacobian3d_bwd(gj)
    got = cuda_fd.jacobian3d_bwd(
        torch.from_numpy(np.array(gj.astype(jnp.float32))).bfloat16(),
        torch.zeros(2, 5, 6, 7, 3, dtype=torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n", [3, 4, 7])
def test_fdt_along_depth_is_the_transpose_of_fdiff(n):
    # Along dim -3 of a [B, D, H, W] volume, elementwise against autograd.
    x = torch.from_numpy(_rand((2, n, 4, 5), n)).double().requires_grad_()
    g = torch.from_numpy(_rand((2, n, 4, 5), n + 1)).double()
    (fd._fdiff(x, -3) * g).sum().backward()
    torch.testing.assert_close(fd.fdt(g, -3), x.grad, atol=1e-12, rtol=0)


@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (1, 8, 12, 16)])
def test_curl3d_p_grad_matches_jax(shape):
    psi, g = _rand(shape + (3,), 20), _rand(shape + (3,), 21)
    _, vjp = jax.vjp(pallas_fd.curl3d_p, jnp.asarray(psi))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    before = dict(cuda_fd.launch_counts)
    p = torch.from_numpy(psi).requires_grad_()
    cuda_fd.curl3d_p(p).backward(torch.from_numpy(g))
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5)
    assert cuda_fd.launch_counts == before, "CPU tensors launch no kernel"


@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (1, 8, 12, 16)])
def test_jacobian3d_p_grad_matches_jax(shape):
    x = _rand(shape + (3,), 30)
    gj, gv = _rand(shape + (9,), 31), _rand(shape + (3,), 32)
    _, vjp = jax.vjp(pallas_fd.jacobian3d_p, jnp.asarray(x))
    want = np.asarray(vjp((jnp.asarray(gj), jnp.asarray(gv)))[0])
    t = torch.from_numpy(x).requires_grad_()
    j, v = cuda_fd.jacobian3d_p(t)
    torch.autograd.backward([j, v], [torch.from_numpy(gj),
                                     torch.from_numpy(gv)])
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-5)


def test_jacobian3d_p_unused_vort_gets_zero_cotangent():
    # The loss uses J only: the vorticity's cotangent is zeros, as in JAX.
    x = torch.from_numpy(_rand((2, 5, 6, 7, 3), 33)).requires_grad_()
    gj = torch.from_numpy(_rand((2, 5, 6, 7, 9), 34))
    j, _ = cuda_fd.jacobian3d_p(x)
    j.backward(gj)
    want = fd.jacobian3d_bwd(gj, torch.zeros(2, 5, 6, 7, 3))
    torch.testing.assert_close(x.grad, want, atol=0, rtol=0)


def test_fd3d_golden():
    g = np.load(os.path.join(GOLDEN, "fd3d.npz"))
    u = cuda_fd.curl3d_fused(torch.from_numpy(g["psi"]))
    assert check_fields(u.numpy(), g["u"])["passed"]
    j, w = cuda_fd.jacobian3d_fused(torch.from_numpy(g["u"]))
    assert check_fields(j.numpy(), g["j"])["passed"]
    assert check_fields(w.numpy(), g["w"])["passed"]
    # divergence-free away from the replicated edge
    div = fd.divergence3d(u)[:, :-2, :-2, :-2]
    assert float(div.abs().max()) <= 1e-5


@pytest.mark.parametrize("op,shapes,exc", [
    ("curl3d_fused", [(2, 8, 8, 3)], ValueError),           # not 5D
    ("curl3d_fused", [(1, 2, 4, 4, 4, 3)], ValueError),     # 6D
    ("curl3d_fused", [(2, 4, 4, 4, 1)], ValueError),        # not 3 channels
    ("curl3d_fused", [(2, 1, 4, 4, 3)], ValueError),        # D < 2
    ("jacobian3d_fused", [(2, 4, 4, 4, 2)], ValueError),
    ("jacobian3d_fused", [(2, 4, 1, 4, 3)], ValueError),    # H < 2
    ("curl3d_bwd", [(2, 2, 4, 4, 3)], ValueError),          # D < 3
    ("curl3d_bwd", [(2, 4, 4, 2, 3)], ValueError),          # W < 3
    ("jacobian3d_bwd", [(2, 4, 4, 4, 9), (2, 4, 4, 3, 3)], ValueError),
    ("jacobian3d_bwd", [(2, 4, 4, 4, 3), (2, 4, 4, 4, 3)], ValueError),
    ("jacobian3d_bwd", [(2, 4, 2, 4, 9), (2, 4, 2, 4, 3)], ValueError),
])
def test_3d_wrappers_reject(op, shapes, exc):
    with pytest.raises(exc):
        getattr(cuda_fd, op)(*(torch.zeros(s) for s in shapes))


def test_3d_wrappers_reject_dtype_and_layout():
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            cuda_fd.curl3d_fused(torch.zeros(2, 4, 4, 4, 3, dtype=dtype))
    with pytest.raises(ValueError, match="does not match"):
        cuda_fd.jacobian3d_bwd(torch.zeros(1, 4, 4, 4, 9),
                               torch.zeros(1, 4, 4, 4, 3,
                                           dtype=torch.bfloat16))
    psi = torch.zeros(2, 3, 4, 4, 4).permute(0, 2, 3, 4, 1)
    assert not psi.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fd.curl3d_fused(psi)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fd.jacobian3d_fused(psi)


@pytest.mark.parametrize("fn", ["curl3d_p", "jacobian3d_p"])
@pytest.mark.parametrize("shape", [(1, 2, 8, 8), (1, 8, 2, 8), (1, 8, 8, 2)])
def test_3d_grad_refused_below_extent_3(fn, shape):
    x = torch.zeros(shape + (3,), requires_grad=True)
    with pytest.raises(ValueError, match=">= 3"):
        getattr(cuda_fd, fn)(x)
    with torch.no_grad():     # the forward alone is right at 2
        getattr(cuda_fd, fn)(x)
