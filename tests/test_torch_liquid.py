"""The port's FLIP liquid solver (``deepfluids_tpu_torch.datagen.liquid2d``)
held against the JAX package's on the CPU, where the P2G scatter adds in
index order in both packages.

Single operators agree to atol 1e-6 on the same seeded inputs; one solver
step from a shared mid-trajectory particle state agrees to a normalized L2
under 1e-5; a 10-frame 48x32 trajectory passes the repo's parity gate
(per-frame normalized L2 under 1e-3); the batched call equals per-scene
calls; particles and their mass are conserved.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu.datagen import liquid2d as jliq
from deepfluids_tpu_torch.datagen import liquid2d as tliq
from deepfluids_tpu_torch.utils.parity import check_fields, normalized_l2

CFG = dict(height=48, width=32, num_frames=10, project_iters=30)
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=atol)


def _particles(seed, h, w, n):
    """Random particles, some on and outside the box edge, with a float
    ``active`` mask."""
    rng = np.random.default_rng(seed)
    py = rng.uniform(-1.0, h, n).astype(np.float32)
    px = rng.uniform(-1.0, w, n).astype(np.float32)
    py[:4] = [0.0, h - 1.0, h - 2.0, 0.5]
    px[:4] = [0.0, w - 1.0, w - 2.0, w - 1.5]
    pvy, pvx = rng.standard_normal((2, n)).astype(np.float32)
    active = (rng.uniform(size=n) < 0.6).astype(np.float32)
    return py, px, pvy, pvx, active


def test_config_defaults_match_jax():
    assert dataclasses.asdict(tliq.Liquid2DConfig()) == dataclasses.asdict(
        jliq.Liquid2DConfig())


def test_initial_levelset_and_seed_particles():
    h, w = 24, 16
    ours = tliq._initial_levelset(h, w, torch.tensor([0.4, 0.6]),
                                  torch.tensor([0.1, 0.15]))
    seeds = tliq._seed_particles(h, w, torch.tensor([0.4, 0.6]),
                                 torch.tensor([0.1, 0.15]), 0.25)
    for s, (px, r) in enumerate([(0.4, 0.1), (0.6, 0.15)]):
        _close(ours[s], jliq._initial_levelset(h, w, jnp.float32(px),
                                               jnp.float32(r)), atol=1e-5)
        theirs = jliq._seed_particles(h, w, jnp.float32(px), jnp.float32(r),
                                      0.25)
        for a, b in zip(seeds, theirs):
            assert a.shape == (2, 4 * h * w)
            _close(a[s], b, atol=0)


def test_p2g():
    h, w = 12, 10
    parts = _particles(0, h, w, 500)
    jvel, jmass = jliq._p2g(*[jnp.asarray(a) for a in parts], h, w)
    vel, mass = tliq._p2g(*[_t(a)[None] for a in parts], h, w)
    _close(mass[0], jmass, atol=1e-6)
    _close(vel[0], jvel, atol=1e-6)
    # mass is conserved by the scatter: each particle's weights sum to 1
    assert abs(float(mass.sum()) - float(parts[4].sum())) < 1e-3
    # two scenes in one call: each as alone
    other = _particles(1, h, w, 500)
    both_v, both_m = tliq._p2g(
        *[_t(np.stack([a, b])) for a, b in zip(parts, other)], h, w)
    _close(both_m[0], mass[0].numpy(), atol=0)
    _close(both_v[0], vel[0].numpy(), atol=0)


def test_box3():
    q = np.random.default_rng(2).standard_normal((9, 7)).astype(np.float32)
    _close(tliq._box3(_t(q)), jliq._box3(jnp.asarray(q)))
    _close(tliq._box3(_t(np.stack([q, -q])))[1], -np.asarray(
        jliq._box3(jnp.asarray(q))))


def _grid_state(seed, h, w):
    rng = np.random.default_rng(seed)
    vel = rng.standard_normal((h, w, 2)).astype(np.float32)
    liquid = np.zeros((h, w), np.float32)
    liquid[: h // 3] = 1.0
    liquid[h // 2: h // 2 + 3, w // 3: w // 3 + 4] = 1.0
    return vel * liquid[..., None], liquid


def test_extrapolate_velocity():
    vel, liquid = _grid_state(3, 16, 12)
    _close(tliq._extrapolate_velocity(_t(vel)[None], _t(liquid)[None])[0],
           jliq._extrapolate_velocity(jnp.asarray(vel), jnp.asarray(liquid)))


@pytest.mark.parametrize("with_src", [False, True])
def test_project_free_surface(with_src):
    vel, liquid = _grid_state(4, 16, 12)
    src = (0.1 * np.random.default_rng(5).uniform(size=(16, 12))
           ).astype(np.float32) if with_src else None
    theirs = jliq._project_free_surface(
        jnp.asarray(vel), jnp.asarray(liquid), 25,
        None if src is None else jnp.asarray(src))
    ours = tliq._project_free_surface(
        _t(vel)[None], _t(liquid)[None], 25,
        None if src is None else _t(src)[None])
    _close(ours[0], theirs, atol=1e-6)


def test_redistance_and_levelset_from_mass():
    phi = (3.0 * np.random.default_rng(6).standard_normal((14, 10))
           ).astype(np.float32)
    _close(tliq._redistance(_t(phi), 6), jliq._redistance(jnp.asarray(phi), 6),
           atol=1e-6)
    mass = np.abs(phi) * 2.0
    _close(tliq._levelset_from_mass(_t(mass)[None], 6)[0],
           jliq._levelset_from_mass(jnp.asarray(mass), 6), atol=1e-6)


@pytest.fixture(scope="module")
def jax_traj():
    phit, velt = jliq.simulate_liquid2d(jnp.float32(0.5), jnp.float32(0.1),
                                        jliq.Liquid2DConfig(**CFG))
    return np.asarray(phit), np.asarray(velt)


@pytest.fixture(scope="module")
def torch_traj():
    phit, velt = tliq.simulate_liquid2d(0.5, 0.1, tliq.Liquid2DConfig(**CFG),
                                        device="cpu")
    return phit, velt


def test_trajectory_passes_the_parity_gate(jax_traj, torch_traj):
    phit, velt = torch_traj
    assert phit.shape == (10, 48, 32, 1) and velt.shape == (10, 48, 32, 2)
    assert check_fields(phit.numpy(), jax_traj[0], 1e-3)["passed"]
    assert check_fields(velt.numpy(), jax_traj[1], 1e-3)["passed"]
    assert torch.isfinite(phit).all()
    assert bool((phit[0] < 0).any()) and bool((phit[-1] < 0).any())


def test_one_step_from_a_shared_state():
    # A mid-trajectory particle state: advance the port 5 steps, then take
    # one step of each package's frame body from it.
    cfg = tliq.Liquid2DConfig(**CFG)
    h, w = cfg.height, cfg.width
    one = torch.tensor([0.5]), torch.tensor([0.1])
    py, px, pvy, pvx, active = tliq._seed_particles(h, w, *one,
                                                    cfg.basin_level)
    state = (py, px, pvy, pvx)
    for _ in range(5):
        state, _ = tliq._step(state, active, cfg)
    new, (phi, vel) = tliq._step(state, active, cfg)

    # JAX's frame body is a closure of simulate_liquid2d: rebuild it from
    # the package's own pieces, in its order.
    jcfg = jliq.Liquid2DConfig(**CFG)
    jpy, jpx, jpvy, jpvx = [jnp.asarray(a[0].numpy()) for a in state]
    jact = jnp.asarray(active[0].numpy())
    vel_p2g, mass = jliq._p2g(jpy, jpx, jpvy, jpvx, jact, h, w)
    liquid = (mass > 0.4).astype(jnp.float32)
    vel_old = jliq._extrapolate_velocity(vel_p2g, liquid)
    jvel = vel_old.at[..., 1].add(-jcfg.dt * jcfg.gravity * liquid)
    jvel = jliq.grids.wall_bc2d(jvel)
    div_src = jcfg.density_relax * jnp.maximum(mass / 4.0 - 1.0, 0.0)
    jvel = jliq._project_free_surface(jvel, liquid, jcfg.project_iters,
                                      div_src)
    jvel = jliq.grids.wall_bc2d(jvel)
    ux, uy = jliq._sample_vec(jvel, jpy, jpx)
    dx_, dy_ = jliq._sample_vec(jvel - vel_old, jpy, jpx)
    a = jcfg.flip_ratio
    npvx = a * (jpvx + dx_) + (1.0 - a) * ux
    npvy = a * (jpvy + dy_) + (1.0 - a) * uy
    mx, my = jliq._sample_vec(jvel, jpy + 0.5 * jcfg.dt * uy,
                              jpx + 0.5 * jcfg.dt * ux)
    npx = jnp.clip(jpx + jnp.clip(jcfg.dt * mx, -jcfg.max_disp,
                                  jcfg.max_disp), 0.5, w - 1.5)
    npy = jnp.clip(jpy + jnp.clip(jcfg.dt * my, -jcfg.max_disp,
                                  jcfg.max_disp), 0.5, h - 1.5)
    _, mass2 = jliq._p2g(npy, npx, npvy, npvx, jact, h, w)
    jphi = jliq._levelset_from_mass(mass2, jcfg.redist_iters)

    assert normalized_l2(vel[0].numpy(), np.asarray(jvel)) < 1e-5
    assert normalized_l2(phi[0].numpy(), np.asarray(jphi)) < 1e-5
    for ours, theirs in zip(new, (npy, npx, npvy, npvx)):
        assert normalized_l2(ours[0].numpy(), np.asarray(theirs)) < 1e-5


def test_particles_and_mass_are_conserved(torch_traj):
    cfg = tliq.Liquid2DConfig(**CFG)
    h, w = cfg.height, cfg.width
    py, px, pvy, pvx, active = tliq._seed_particles(
        h, w, torch.tensor([0.5]), torch.tensor([0.1]), cfg.basin_level)
    count = float(active.sum())
    state = (py, px, pvy, pvx)
    for _ in range(6):
        state, _ = tliq._step(state, active, cfg)
        _, mass = tliq._p2g(*state, active, h, w)
        assert abs(float(mass.sum()) - count) < 1e-4 * count
    # the liquid's area stays near its initial share
    area = (torch_traj[0][..., 0] < 0).float().mean(dim=(1, 2))
    assert bool(((area - area[0]).abs() / area[0] < 0.25).all())


def test_batch_matches_single(torch_traj):
    cfg = tliq.Liquid2DConfig(height=24, width=16, num_frames=4,
                              project_iters=10)
    p1, v1 = tliq.simulate_liquid2d(0.4, 0.1, cfg, device="cpu")
    pb, vb = tliq.simulate_liquid2d_batch([0.4, 0.6], [0.1, 0.1], cfg,
                                          device="cpu")
    assert pb.shape == (2, 4, 24, 16, 1) and vb.shape == (2, 4, 24, 16, 2)
    np.testing.assert_allclose(pb[0].numpy(), p1.numpy(), atol=1e-6)
    np.testing.assert_allclose(vb[0].numpy(), v1.numpy(), atol=1e-6)
    assert not torch.equal(pb[0], pb[1])


def test_simulate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tliq.simulate_liquid2d(0.5, 0.1, tliq.Liquid2DConfig(**CFG))
