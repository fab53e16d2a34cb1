"""The port's matched (curl-manifold) multigrid projection
(``deepfluids_tpu_torch.datagen.projection``) held against the JAX package's
on the same seeded numpy inputs, on the CPU (where the kernel wrappers take
their plain versions).

Single operators agree to atol 1e-6; the prolongation matrices equal
``jax.image.resize`` probed on an identity; the projections' outputs lie
within 1e-4 (normalized L2) of JAX's: the pinv's entries are not held, modes
near its cut-off may fall either side between LAPACK builds.

The 2D hierarchy is (48, 32) throughout, the grid of the solver tests, so
that the JAX package's eagerly built (and cached) setup is built once for
all of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu.datagen import projection as jproj
from deepfluids_tpu.ops import fd as jfd
from deepfluids_tpu_torch.datagen import projection as tproj
from deepfluids_tpu_torch.ops import cuda_fd, fd as tfd
from deepfluids_tpu_torch.utils.parity import normalized_l2

ATOL = 1e-6


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("shape,axis", [((7, 9), -1), ((7, 9), -2),
                                        ((4, 5, 6), -3), ((3, 2), -1)])
def test_fdiff_adj(shape, axis):
    y = _field(0, shape)
    _close(tproj._fdiff_adj(_t(y), axis), jproj._fdiff_adj(jnp.asarray(y),
                                                           axis))
    if shape[axis] >= 3:    # and it is the package's transposed stencil
        _close(tproj._fdiff_adj(_t(y), axis), tfd.fdt(_t(y), axis).numpy())


@pytest.mark.parametrize("shape", [(8, 10), (4, 6, 5)])
def test_div_f_adj_and_matched_laplacian(shape):
    nd = len(shape)
    p = _field(1, shape)
    _close(tproj.div_f_adj(_t(p), nd), jproj.div_f_adj(jnp.asarray(p), nd))
    _close(tproj.matched_laplacian(_t(p), nd),
           jproj.matched_laplacian(jnp.asarray(p), nd))
    v = _field(2, shape + (nd,))
    _close(tproj.div_f(_t(v)), jproj.div_f(jnp.asarray(v)))
    # D^T is the transpose of D
    lhs = float((tproj.div_f(_t(v)) * _t(p)).sum())
    rhs = float((_t(v) * tproj.div_f_adj(_t(p), nd)).sum())
    assert abs(lhs - rhs) < 1e-3


@pytest.mark.parametrize("batch", [(), (3,)])
def test_curl_adj(batch):
    v = _field(3, batch + (9, 7, 2))
    ours = tproj._curl_adj(_t(v))               # through the kernel wrapper
    plain = tproj._curl_adj_plain(_t(v))        # written out in _fdiff_adj
    _close(ours, plain.numpy())
    for s in np.ndindex(*batch):
        _close(ours[s], jproj._curl_adj(jnp.asarray(v[s])))
    # JAX's own check: it is the VJP of the model's curl
    psi = _field(4, (9, 7))
    _, vjp = jax.vjp(lambda q: jfd.curl2d(q[..., None]), jnp.asarray(psi))
    _close(tproj._curl_adj(_t(v.reshape(-1, 9, 7, 2)[0])),
           vjp(jnp.asarray(v.reshape(-1, 9, 7, 2)[0]))[0])
    _close(tproj._curl(_t(psi)), jproj._curl(jnp.asarray(psi)), atol=0)


@pytest.mark.parametrize("batch", [(), (2,)])
def test_curl3_adj(batch):
    v = _field(5, batch + (5, 6, 7, 3))
    ours = tproj._curl3_adj(_t(v))
    _close(ours, tproj._curl3_adj_plain(_t(v)).numpy())
    for s in np.ndindex(*batch):
        _close(ours[s], jproj._curl3_adj(jnp.asarray(v[s])))
        _, vjp = jax.vjp(jfd.curl3d, jnp.asarray(v[s]))
        _close(ours[s], vjp(jnp.asarray(v[s]))[0])


def test_curl_ops_count_no_launch_on_the_cpu():
    cuda_fd.reset_launch_counts()
    tproj._curl_adj(_t(_field(6, (2, 8, 8, 2))))
    tproj._curl3(_t(_field(6, (4, 6, 6, 3))))
    assert not any(cuda_fd.launch_counts.values())


def test_f64_takes_the_plain_functions_and_other_dtypes_raise(monkeypatch):
    # float64 (the kernels take f32/bf16 only) must not reach the kernel
    # wrappers at all, nor must f32 once the four curl hooks are patched to
    # their plain versions (how the kernels' path is held against them).
    def refuse(*a, **k):
        raise AssertionError("kernel wrapper called")

    for name in ("curl2d_fused", "curl2d_bwd", "curl3d_fused", "curl3d_bwd"):
        monkeypatch.setattr(cuda_fd, name, refuse)
    v = _t(_field(7, (12, 8, 2)))
    out64 = tproj.project_curl2d(v.double(), cycles=3)
    assert out64.dtype == torch.float64
    with pytest.raises(AssertionError, match="kernel wrapper"):
        tproj._curl_adj(v)
    with pytest.raises(TypeError, match="float32 or float64"):
        tproj.project_curl2d(v.bfloat16(), cycles=1)
    with pytest.raises(TypeError, match="float32 or float64"):
        tproj.project_matched(v.half(), cycles=1)
    monkeypatch.setattr(tproj, "_curl", lambda p: tfd.curl2d(p[..., None]))
    monkeypatch.setattr(tproj, "_curl_adj", tproj._curl_adj_plain)
    out32 = tproj.project_curl2d(v, cycles=3)
    assert normalized_l2(out32.numpy(), out64.numpy()) < 1e-5


@pytest.mark.parametrize("n_fine,n_coarse", [(12, 6), (8, 4), (112, 56)])
def test_prolongation_matrix_is_jax_image_resize(n_fine, n_coarse):
    eye = jnp.eye(n_coarse, dtype=jnp.float32)
    # resize the rows of an identity along axis 0: column j is P e_j
    theirs = np.asarray(jax.image.resize(eye, (n_fine, n_coarse),
                                         method="linear"))
    ours = tproj._prolong_matrix(n_fine, n_coarse, torch.float32)
    _close(ours, theirs, atol=1e-7)
    np.testing.assert_allclose(ours.sum(dim=1).numpy(), 1.0, atol=1e-7)


def test_prolong_and_restrict_are_transposes_of_jax_resize():
    setup = tproj._mg_setup("curl_ls", (48, 32), torch.float32, "cpu")
    assert setup["shapes"] == [(48, 32), (24, 16)]
    coarse = setup["shapes"][1]
    e = _field(8, (2,) + coarse)
    up = setup["up"](_t(e), 1)
    for s in range(2):
        _close(up[s], jax.image.resize(jnp.asarray(e[s]), (48, 32),
                                       method="linear"))
    r = _field(9, (2, 48, 32))
    down = setup["down"](_t(r), 1)
    assert abs(float((down * _t(e)).sum()) - float((_t(r) * up).sum())) < 1e-3


@pytest.mark.parametrize("op,shape,chan", [("curl_ls", (12, 8), False),
                                           ("div_lap", (8, 12), False),
                                           ("curl3_ls", (6, 6, 8, 3), True)])
def test_op_diag_against_a_dense_diagonal(op, shape, chan):
    factory = tproj._OPERATORS[op][0]
    A = factory(shape, torch.float32, "cpu")
    dense = tproj._chunked_probe(A, shape, torch.float32, chunk=50)
    strides = (4,) * (len(shape) - 1) + (shape[-1],) if chan else None
    diag = tproj._op_diag(A, shape, torch.float32, strides, chunk=7)
    _close(diag.reshape(-1), torch.diagonal(dense).numpy(), atol=1e-5)
    # the dense probe is the JAX operator's matrix
    jA = jproj._OPERATORS[op][0](shape, jnp.float32)
    jdense = jproj._chunked_probe(jA, shape, jnp.float32)
    _close(dense, jdense, atol=1e-5)


def test_null_vector_and_ring_mask():
    for shape in [(8, 6), (4, 6, 8)]:
        _close(tproj._null_vector(shape, torch.float32),
               jproj._null_vector(shape, jnp.float32), atol=1e-7)
        _close(tproj._ring_mask(shape, torch.float32),
               jproj._ring_mask(shape, jnp.float32), atol=0)
        z = tproj._null_vector(shape, torch.float32)
        assert float(tproj.matched_laplacian(z, len(shape)).abs().max()) < 1e-6


def _plume_like(seed, shape):
    """A velocity field with curl-free and divergent parts, walls zeroed."""
    v = _field(seed, shape)
    nd = shape[-1]
    for k in range(nd):
        ax = -2 - k                        # channel k is normal to this axis
        idx = [slice(None)] * len(shape)
        idx[-1] = k
        for edge in (0, -1):
            idx[ax] = edge
            v[tuple(idx)] = 0.0
    return v


@pytest.fixture(scope="module")
def proj2d():
    v = _plume_like(10, (48, 32, 2))
    out, psi = jproj.project_curl2d(jnp.asarray(v), cycles=8, return_psi=True)
    return v, np.asarray(out), np.asarray(psi)


def test_project_curl2d_matches_jax(proj2d):
    v, jout, jpsi = proj2d
    out, psi = tproj.project_curl2d(_t(v), cycles=8, return_psi=True)
    assert normalized_l2(out.numpy(), jout) < 1e-4
    assert normalized_l2(psi.numpy(), jpsi) < 1e-4


def test_project_curl2d_is_on_the_manifold(proj2d):
    v = _t(proj2d[0])
    out, psi = tproj.project_curl2d(v, cycles=8, return_psi=True)
    # literally curl(psi), psi zero on the ring, no wall through-flow
    assert torch.equal(out, tfd.curl2d(psi[..., None]))
    assert float(psi[0].abs().max()) == float(psi[:, -1].abs().max()) == 0.0
    assert float(out[:, 0, 0].abs().max()) == 0.0
    assert float(out[:, -1, 0].abs().max()) == 0.0
    assert float(out[0, :, 1].abs().max()) == 0.0
    assert float(out[-1, :, 1].abs().max()) == 0.0
    # projecting a field of the manifold gives it back
    again = tproj.project_curl2d(out, cycles=12)
    assert normalized_l2(again.numpy(), out.numpy()) < 1e-3
    # and it is an orthogonal projection: the removed part is normal to it
    removed = v - out
    cos = float((removed * out).sum()) / float(
        removed.norm() * out.norm())
    assert abs(cos) < 1e-2


def test_project_curl2d_batched_equals_per_scene(proj2d):
    v = np.stack([proj2d[0], _plume_like(11, (48, 32, 2))])
    both = tproj.project_curl2d(_t(v), cycles=4)
    for s in range(2):
        alone = tproj.project_curl2d(_t(v[s]), cycles=4)
        _close(both[s], alone.numpy(), atol=1e-6)


def test_project_curl3d_matches_jax_and_is_on_the_manifold():
    v = _plume_like(12, (8, 12, 12, 3))
    jout, jpsi = jproj.project_curl3d(jnp.asarray(v), cycles=6,
                                      return_psi=True)
    out, psi = tproj.project_curl3d(_t(v), cycles=6, return_psi=True)
    assert normalized_l2(out.numpy(), np.asarray(jout)) < 1e-4
    assert torch.equal(out, tfd.curl3d(psi))
    for ax in range(3):
        for edge in (0, -1):
            assert float(psi.select(ax, edge).abs().max()) == 0.0
            # channel 2 - ax is normal to the faces of axis ax
            assert float(out.select(ax, edge)[..., 2 - ax].abs().max()) == 0.0
    both = tproj.project_curl3d(_t(np.stack([v, 2 * v])), cycles=6)
    _close(both[0], out.numpy(), atol=1e-6)


@pytest.mark.parametrize("shape,cycles", [((48, 32, 2), 6),
                                          ((6, 8, 8, 3), 1)])
def test_project_matched_matches_jax(shape, cycles):
    # (6, 8, 8) is too small to coarsen: one level, the pinv alone, which
    # solves in its one cycle.
    v = _field(13, shape)
    theirs = np.asarray(jproj.project_matched(jnp.asarray(v), cycles=cycles))
    ours = tproj.project_matched(_t(v), cycles=cycles)
    assert normalized_l2(ours.numpy(), theirs) < 1e-4
    # the forward-difference divergence is driven down
    before = float(tproj.div_f(_t(v)).norm())
    assert float(tproj.div_f(ours).norm()) < 0.05 * before
    b = np.asarray(jproj.div_f(jnp.asarray(v)))
    assert normalized_l2(
        tproj.solve_matched(_t(b), cycles=cycles).numpy(),
        np.asarray(jproj.solve_matched(jnp.asarray(b), cycles=cycles))) < 1e-3


def test_mg_setup_matches_jax_and_is_cached():
    ours = tproj._mg_setup("curl_ls", (48, 32), torch.float32, "cpu")
    assert ours is tproj._mg_setup("curl_ls", (48, 32), torch.float32, "cpu")
    theirs = jproj._mg_setup("curl_ls", (48, 32), "float32")
    assert [tuple(s) for s in ours["shapes"]] == [
        tuple(s) for s in theirs["shapes"]]
    for d_ours, d_theirs in zip(ours["diags"], theirs["diags"]):
        _close(d_ours, d_theirs, atol=1e-5)
    np.testing.assert_allclose(ours["omegas"], theirs["omegas"], rtol=1e-4)
    # torch.device and its string are one cache entry
    assert ours is tproj._mg_setup("curl_ls", (48, 32), torch.float32,
                                   torch.device("cpu"))
