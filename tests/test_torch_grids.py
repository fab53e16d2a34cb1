"""The port's grid utilities (``deepfluids_tpu_torch.datagen.grids``) held
against the JAX package's on the same seeded numpy inputs, on the CPU.

Single operators agree to atol 1e-6 (random fields of order 1, sample
coordinates on and outside the box edge); the CG solves to rtol 1e-4 of the
solution's scale in f32 and to 1e-9 in f64 (JAX under ``jax_enable_x64``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu.datagen import grids as jgrids
from deepfluids_tpu_torch.datagen import grids as tgrids

ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=atol)


def _coords(rng, n, shape):
    """Coordinates inside, exactly on and outside the edge of [0, n-1]."""
    c = rng.uniform(-2.0, n + 1.0, shape).astype(np.float32)
    flat = c.reshape(-1)
    flat[:6] = [0.0, n - 1.0, -0.5, n - 0.5, n - 1.5, 3.0]
    return c


@pytest.mark.parametrize("seed,h,w,npts", [(0, 12, 9, (40,)),
                                           (1, 7, 16, (5, 6))])
def test_sample2d(seed, h, w, npts):
    rng = _rng(seed)
    q = rng.standard_normal((h, w)).astype(np.float32)
    cy, cx = _coords(rng, h, npts), _coords(rng, w, npts)
    _close(tgrids.sample2d(_t(q), _t(cy), _t(cx)),
           jgrids.sample2d(jnp.asarray(q), jnp.asarray(cy), jnp.asarray(cx)))


def test_sample2d_batched_equals_per_scene():
    rng = _rng(2)
    q = rng.standard_normal((3, 10, 8)).astype(np.float32)
    cy, cx = _coords(rng, 10, (3, 25)), _coords(rng, 8, (3, 25))
    out = tgrids.sample2d(_t(q), _t(cy), _t(cx))
    for s in range(3):
        _close(out[s], jgrids.sample2d(jnp.asarray(q[s]), jnp.asarray(cy[s]),
                                       jnp.asarray(cx[s])))


def test_sample3d():
    rng = _rng(3)
    q = rng.standard_normal((5, 7, 6)).astype(np.float32)
    cz, cy, cx = (_coords(rng, n, (50,)) for n in (5, 7, 6))
    _close(tgrids.sample3d(_t(q), _t(cz), _t(cy), _t(cx)),
           jgrids.sample3d(jnp.asarray(q), jnp.asarray(cz), jnp.asarray(cy),
                           jnp.asarray(cx)))


@pytest.mark.parametrize("channels", [0, 2])
def test_advect2d(channels):
    rng = _rng(4)
    # velocities of a few cells, so departure points leave the box
    vel = (3.0 * rng.standard_normal((14, 11, 2))).astype(np.float32)
    q = rng.standard_normal((14, 11) + ((channels,) if channels else ())
                            ).astype(np.float32)
    _close(tgrids.advect2d(_t(q), _t(vel), 0.7),
           jgrids.advect2d(jnp.asarray(q), jnp.asarray(vel), 0.7))


@pytest.mark.parametrize("channels", [0, 3])
def test_advect3d(channels):
    rng = _rng(5)
    vel = (2.0 * rng.standard_normal((6, 8, 7, 3))).astype(np.float32)
    q = rng.standard_normal((6, 8, 7) + ((channels,) if channels else ())
                            ).astype(np.float32)
    _close(tgrids.advect3d(_t(q), _t(vel), 1.0),
           jgrids.advect3d(jnp.asarray(q), jnp.asarray(vel), 1.0))


def test_advect2d_batched_equals_per_scene():
    rng = _rng(6)
    vel = (2.0 * rng.standard_normal((2, 9, 8, 2))).astype(np.float32)
    out = tgrids.advect2d(_t(vel), _t(vel), 1.0)
    for s in range(2):
        _close(out[s], jgrids.advect2d(jnp.asarray(vel[s]),
                                       jnp.asarray(vel[s]), 1.0))


OPS_2D = ["divergence2d_c", "pressure_project2d", "wall_bc2d"]
OPS_3D = ["divergence3d_c", "pressure_project3d", "wall_bc3d"]


@pytest.mark.parametrize("name", OPS_2D + OPS_3D)
def test_velocity_operators(name):
    # divergence*_c wraps around at the box edge (roll) in both packages.
    rng = _rng(7)
    shape = (12, 10, 2) if name in OPS_2D else (6, 8, 10, 3)
    vel = rng.standard_normal(shape).astype(np.float32)
    ours = getattr(tgrids, name)(_t(vel))
    _close(ours, getattr(jgrids, name)(jnp.asarray(vel)))
    # and with a leading scene axis
    both = getattr(tgrids, name)(_t(np.stack([vel, -vel])))
    _close(both[0], ours.numpy(), atol=1e-7)


@pytest.mark.parametrize("name,shape", [("laplacian2d", (9, 13)),
                                        ("laplacian3d", (5, 6, 7))])
def test_laplacian(name, shape):
    p = _rng(8).standard_normal(shape).astype(np.float32)
    _close(getattr(tgrids, name)(_t(p)), getattr(jgrids, name)(jnp.asarray(p)))


@pytest.mark.parametrize("iters", [1, 17])
def test_pressure_project2d_iters(iters):
    vel = _rng(9).standard_normal((16, 12, 2)).astype(np.float32)
    _close(tgrids.pressure_project2d(_t(vel), iters),
           jgrids.pressure_project2d(jnp.asarray(vel), iters))


def _divergent(seed, shape):
    """A smooth velocity field with divergence (low modes: CG converges in
    few iterations and the comparison is not of rounding noise)."""
    rng = _rng(seed)
    axes = np.meshgrid(*[np.linspace(0, np.pi, n) for n in shape[:-1]],
                       indexing="ij")
    vel = np.stack([np.sin((k + 1) * axes[k % len(axes)])
                    * np.cos(axes[(k + 1) % len(axes)])
                    for k in range(shape[-1])], axis=-1)
    return (vel + 0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("nd", [2, 3])
def test_cg_f32(nd):
    # rtol 1e-4 of the solution's scale, both packages in f32 at tol 1e-5.
    vel = _divergent(10, (16, 12, 2) if nd == 2 else (6, 8, 10, 3))
    solve = f"solve_pressure{nd}d_cg"
    div = np.asarray(getattr(jgrids, f"divergence{nd}d_c")(jnp.asarray(vel)))
    theirs = np.asarray(getattr(jgrids, solve)(jnp.asarray(div), tol=1e-5))
    ours = getattr(tgrids, solve)(_t(div), tol=1e-5)
    assert ours.dtype == torch.float32
    _close(ours, theirs, atol=1e-4 * np.abs(theirs).max())
    proj = f"pressure_project{nd}d_cg"
    theirs = np.asarray(getattr(jgrids, proj)(jnp.asarray(vel), tol=1e-5))
    _close(getattr(tgrids, proj)(_t(vel), tol=1e-5), theirs,
           atol=1e-4 * np.abs(theirs).max())


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("nd", [2, 3])
def test_cg_f64(nd, x64):
    # An f64 input solves in f64 (JAX: under jax_enable_x64): 1e-9.
    vel = _divergent(11, (16, 12, 2) if nd == 2 else (6, 8, 10, 3)
                     ).astype(np.float64)
    solve = f"solve_pressure{nd}d_cg"
    div = np.asarray(getattr(jgrids, f"divergence{nd}d_c")(jnp.asarray(vel)))
    assert div.dtype == np.float64
    theirs = np.asarray(getattr(jgrids, solve)(jnp.asarray(div), tol=1e-12))
    ours = getattr(tgrids, solve)(_t(div), tol=1e-12)
    assert ours.dtype == torch.float64 and theirs.dtype == np.float64
    _close(ours, theirs, atol=1e-9 * np.abs(theirs).max())


def test_cg_freezes_each_scene_on_its_own_stop():
    # A batch of an easy and a hard right-hand side: each scene gets what
    # its own solve gives, though the batch iterates until the last stops.
    easy = _divergent(12, (16, 12, 2))
    hard = _rng(13).standard_normal((16, 12, 2)).astype(np.float32)
    div = tgrids.divergence2d_c(_t(np.stack([easy, hard, 0 * easy])))
    both = tgrids.solve_pressure2d_cg(div, tol=1e-4)
    for s in range(3):
        alone = tgrids.solve_pressure2d_cg(div[s], tol=1e-4)
        _close(both[s], alone.numpy(), atol=1e-6)
    assert torch.isfinite(both).all() and float(both[2].abs().max()) == 0.0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgrids.resolve_device(None)
    assert tgrids.resolve_device("cpu") == torch.device("cpu")
