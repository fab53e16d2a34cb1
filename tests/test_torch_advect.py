"""The port's density rendering (``deepfluids_tpu_torch.infer.advect``) held
against the JAX package's on the same seeded numpy velocities, on the CPU:
frames agree to atol 1e-5 (12 steps of order-1 densities), the sweep to the
same bar, and both refuse what the other refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu.infer import advect as jadvect
from deepfluids_tpu_torch.data import Manifest
from deepfluids_tpu_torch.infer import advect_density, render_density_sweep

ATOL = 1e-5


def _vel(seed, shape):
    return (1.5 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("inject", [True, False])
def test_advect_density_2d(inject):
    vel = _vel(0, (12, 16, 12, 2))
    rng = np.random.default_rng(1)
    rho0 = rng.uniform(size=(16, 12)).astype(np.float32)
    src = (rng.uniform(size=(16, 12)) < 0.1).astype(np.float32)
    theirs = jadvect.advect_density(jnp.asarray(vel), jnp.asarray(rho0),
                                    jnp.asarray(src), dt=0.8, inject=inject)
    ours = advect_density(_t(vel), _t(rho0), _t(src), dt=0.8, inject=inject)
    assert ours.shape == (12, 16, 12)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)


def test_advect_density_without_a_source():
    vel = _vel(2, (5, 10, 8, 2))
    rho0 = np.random.default_rng(3).uniform(size=(10, 8)).astype(np.float32)
    theirs = jadvect.advect_density(jnp.asarray(vel), jnp.asarray(rho0))
    np.testing.assert_allclose(advect_density(_t(vel), _t(rho0)).numpy(),
                               np.asarray(theirs), atol=ATOL)


def test_advect_density_3d():
    vel = _vel(4, (4, 6, 8, 7, 3))
    rng = np.random.default_rng(5)
    rho0 = rng.uniform(size=(6, 8, 7)).astype(np.float32)
    src = (rng.uniform(size=(6, 8, 7)) < 0.1).astype(np.float32)
    theirs = jadvect.advect_density(jnp.asarray(vel), jnp.asarray(rho0),
                                    jnp.asarray(src))
    ours = advect_density(_t(vel), _t(rho0), _t(src))
    assert ours.shape == (4, 6, 8, 7)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)


def test_advect_density_scene_axis_equals_per_scene():
    vel = _vel(6, (3, 5, 10, 8, 2))
    rho0 = np.random.default_rng(7).uniform(size=(3, 10, 8)).astype(
        np.float32)
    both = advect_density(_t(vel), _t(rho0), _t(rho0) * 0.1)
    assert both.shape == (3, 5, 10, 8)
    for s in range(3):
        alone = advect_density(_t(vel[s]), _t(rho0[s]), _t(rho0[s]) * 0.1)
        np.testing.assert_allclose(both[s].numpy(), alone.numpy(), atol=1e-7)


def _manifest(**kw):
    base = dict(param_names=["src_x_pos", "src_radius", "frame"],
                param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 5.0]],
                num_scenes=4, num_frames=6, resolution=[16, 12],
                num_channels=2, v_range=[-2.0, 1.5])
    base.update(kw)
    return Manifest(**base)


def _generate(p, lib):
    """A stand-in generator: smooth fields that depend on every param."""
    yy = lib.linspace(0.0, 1.0, 16)[None, :, None]
    xx = lib.linspace(0.0, 1.0, 12)[None, None, :]
    a, b, t = (p[:, k][:, None, None] for k in range(3))
    u = lib.sin(3.0 * xx + a) * (0.5 + 0.2 * t) + 0.0 * yy
    v = lib.cos(2.0 * yy + b) * 0.7 + 0.1 * t + 0.0 * xx
    return lib.stack([u, v], -1)


def test_render_density_sweep_matches_jax():
    from deepfluids_tpu.data.manifest import Manifest as JManifest
    import dataclasses

    m = _manifest()
    jm = JManifest(**dataclasses.asdict(m))
    scenes = np.array([[0.3, 0.05], [0.7, 0.12]], np.float32)
    theirs = jadvect.render_density_sweep(
        lambda p: _generate(p, jnp), jm, scenes, 6, dt=0.9, source_rate=0.5)
    ours = render_density_sweep(
        lambda p: _generate(p, torch), m, scenes, 6, dt=0.9, source_rate=0.5,
        device="cpu")
    assert isinstance(ours, np.ndarray) and ours.shape == (2, 6, 16, 12)
    assert ours.max() > 0
    np.testing.assert_allclose(ours, theirs, atol=ATOL)


@pytest.mark.parametrize("kw,match", [
    (dict(resolution=[4, 16, 12], num_channels=3), "2D-only"),
    (dict(param_names=["src_x_pos", "frame"],
          param_ranges=[[0.2, 0.8], [0.0, 5.0]]), "non-frame params"),
])
def test_render_density_sweep_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        render_density_sweep(lambda p: p, _manifest(**kw),
                             np.zeros((1, 2), np.float32), 3, device="cpu")


def test_render_density_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_density_sweep(lambda p: _generate(p, torch), _manifest(),
                             np.array([[0.3, 0.05]], np.float32), 2)
