"""The port's smoke solvers (``deepfluids_tpu_torch.datagen.smoke2d`` and
``smoke3d``) held against the JAX package's on the CPU.

One solver step from a shared mid-trajectory state agrees to a normalized L2
under 1e-5 (2D: all three projections; 3D); short trajectories (12 frames at
48x32, 6 at 8x16x16) pass the repo's parity gate (per-frame normalized L2
under 1e-3, ``utils.parity.check_fields``); a batched call equals per-scene
calls; the committed golden trajectory is reproduced at the bar JAX's own
parity test uses.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu.datagen import smoke2d as jsmoke2d
from deepfluids_tpu.datagen import smoke3d as jsmoke3d
from deepfluids_tpu_torch.datagen import smoke2d as tsmoke2d
from deepfluids_tpu_torch.datagen import smoke3d as tsmoke3d
from deepfluids_tpu_torch.utils.parity import check_fields, normalized_l2

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CFG2 = dict(height=48, width=32, num_frames=12, project_iters=30)
CFG3 = dict(depth=8, height=16, width=16, num_frames=6, project_iters=20)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_traj2d():
    """JAX's 12-frame 48x32 jacobi trajectory (one compiled scan)."""
    vt, rt = jsmoke2d.simulate_smoke2d(
        jnp.float32(0.5), jnp.float32(0.1), jsmoke2d.Smoke2DConfig(**CFG2))
    return np.asarray(vt), np.asarray(rt)


@pytest.fixture(scope="module")
def jax_traj3d():
    vt, rt = jsmoke3d.simulate_smoke3d(
        jnp.float32(1.0), jnp.float32(0.08), jsmoke3d.Smoke3DConfig(**CFG3))
    return np.asarray(vt), np.asarray(rt)


def test_source_masks_match():
    ours = tsmoke2d._source_mask(48, 32, torch.tensor([0.3, 0.5]),
                                 torch.tensor([0.1, 0.04]), 0.08)
    for s, (px, r) in enumerate([(0.3, 0.1), (0.5, 0.04)]):
        theirs = jsmoke2d._source_mask(48, 32, jnp.float32(px),
                                       jnp.float32(r), jnp.float32(0.08))
        np.testing.assert_allclose(ours[s].numpy(), np.asarray(theirs),
                                   atol=1e-6)
    np.testing.assert_allclose(tsmoke3d._source_mask3(8, 16, 16).numpy(),
                               np.asarray(jsmoke3d._source_mask3(8, 16, 16)),
                               atol=1e-6)


@pytest.mark.parametrize("projection", ["jacobi", "cg", "matched"])
def test_one_step_2d_from_a_shared_state(jax_traj2d, projection):
    vt, rt = jax_traj2d
    vel, rho = vt[7], rt[7]
    kw = dict(CFG2, projection=projection, cg_tol=1e-5)
    mask = jsmoke2d._source_mask(48, 32, jnp.float32(0.5), jnp.float32(0.1),
                                 jnp.float32(0.08))
    jv, jr = jsmoke2d.step((jnp.asarray(vel), jnp.asarray(rho)), mask,
                           jsmoke2d.Smoke2DConfig(**kw))
    tv, tr = tsmoke2d.step((_t(vel)[None], _t(rho)[None]),
                           _t(np.asarray(mask))[None],
                           tsmoke2d.Smoke2DConfig(**kw))
    assert normalized_l2(tv[0].numpy(), np.asarray(jv)) < 1e-5
    assert normalized_l2(tr[0].numpy(), np.asarray(jr)) < 1e-5


def test_one_step_3d_from_a_shared_state(jax_traj3d):
    vt, rt = jax_traj3d
    vel, rho = vt[3], rt[3]
    mask = jsmoke3d._source_mask3(8, 16, 16)
    (jv, jr), _ = jsmoke3d._step3((jnp.asarray(vel), jnp.asarray(rho)),
                                  jnp.float32(1.0), jnp.float32(0.08), mask,
                                  jsmoke3d.Smoke3DConfig(**CFG3))
    tv, tr = tsmoke3d._step3((_t(vel)[None], _t(rho)[None]), 1.0, 0.08,
                             _t(np.asarray(mask)),
                             tsmoke3d.Smoke3DConfig(**CFG3))
    assert normalized_l2(tv[0].numpy(), np.asarray(jv)) < 1e-5
    assert normalized_l2(tr[0].numpy(), np.asarray(jr)) < 1e-5


def test_trajectory_2d_passes_the_parity_gate(jax_traj2d):
    vt, rt = tsmoke2d.simulate_smoke2d(0.5, 0.1,
                                       tsmoke2d.Smoke2DConfig(**CFG2),
                                       device="cpu")
    assert vt.shape == (12, 48, 32, 2) and rt.shape == (12, 48, 32)
    assert check_fields(vt.numpy(), jax_traj2d[0], 1e-3)["passed"]
    assert check_fields(rt.numpy()[..., None], jax_traj2d[1][..., None],
                        1e-3)["passed"]
    assert float(rt[-1].sum()) > float(rt[0].sum())     # density rises


def test_trajectory_2d_matched_passes_the_parity_gate():
    kw = dict(CFG2, projection="matched", num_frames=8, mg_cycles=4)
    jv, jr = jsmoke2d.simulate_smoke2d(jnp.float32(0.4), jnp.float32(0.1),
                                       jsmoke2d.Smoke2DConfig(**kw))
    vt, rt = tsmoke2d.simulate_smoke2d(0.4, 0.1,
                                       tsmoke2d.Smoke2DConfig(**kw),
                                       device="cpu")
    assert check_fields(vt.numpy(), np.asarray(jv), 1e-3)["passed"]
    assert check_fields(rt.numpy()[..., None], np.asarray(jr)[..., None],
                        1e-3)["passed"]


def test_trajectory_2d_moving_source():
    kw = dict(height=32, width=32, num_frames=8, project_iters=20)
    xs = np.linspace(0.3, 0.7, 8).astype(np.float32)
    jv, jr = jsmoke2d.simulate_smoke2d(
        jnp.float32(0.3), jnp.float32(0.1), jsmoke2d.Smoke2DConfig(**kw),
        pos_x_per_frame=jnp.asarray(xs), moving=True)
    vt, rt = tsmoke2d.simulate_smoke2d(
        0.3, 0.1, tsmoke2d.Smoke2DConfig(**kw), pos_x_per_frame=xs,
        moving=True, device="cpu")
    assert vt.shape == (8, 32, 32, 2)
    assert check_fields(vt.numpy(), np.asarray(jv), 1e-3)["passed"]
    assert check_fields(rt.numpy()[..., None], np.asarray(jr)[..., None],
                        1e-3)["passed"]
    # a batch of walks: each scene as alone
    both, _ = tsmoke2d.simulate_smoke2d(
        None, torch.tensor([0.1, 0.1]), tsmoke2d.Smoke2DConfig(**kw),
        pos_x_per_frame=np.stack([xs, xs[::-1].copy()]), moving=True,
        device="cpu")
    np.testing.assert_allclose(both[0].numpy(), vt.numpy(), atol=1e-6)


def test_trajectory_3d_passes_the_parity_gate(jax_traj3d):
    vt, rt = tsmoke3d.simulate_smoke3d(1.0, 0.08,
                                       tsmoke3d.Smoke3DConfig(**CFG3),
                                       device="cpu")
    assert vt.shape == (6, 8, 16, 16, 3) and rt.shape == (6, 8, 16, 16)
    assert check_fields(vt.numpy(), jax_traj3d[0], 1e-3)["passed"]
    assert check_fields(rt.numpy()[..., None], jax_traj3d[1][..., None],
                        1e-3)["passed"]


def test_segments_equal_one_run_3d(jax_traj3d):
    cfg = tsmoke3d.Smoke3DConfig(**CFG3)
    vel = torch.zeros(8, 16, 16, 3)
    rho = torch.zeros(8, 16, 16)
    parts = []
    for _ in range(2):
        vel, rho, vt, rt = tsmoke3d.simulate_smoke3d_segment(
            vel, rho, 1.0, 0.08, cfg, 3)
        parts.append(vt)
    whole, _ = tsmoke3d.simulate_smoke3d(1.0, 0.08, cfg, device="cpu")
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(vel, whole[-1])


def test_batch_matches_single_scene_2d():
    cfg = tsmoke2d.Smoke2DConfig(height=24, width=16, num_frames=4,
                                 project_iters=10)
    v1, r1 = tsmoke2d.simulate_smoke2d(0.4, 0.1, cfg, device="cpu")
    vb, rb = tsmoke2d.simulate_smoke2d_batch([0.4, 0.6], [0.1, 0.1], cfg,
                                             device="cpu")
    assert vb.shape == (2, 4, 24, 16, 2) and rb.shape == (2, 4, 24, 16)
    np.testing.assert_allclose(vb[0].numpy(), v1.numpy(), atol=1e-6)
    np.testing.assert_allclose(rb[0].numpy(), r1.numpy(), atol=1e-6)
    assert not torch.equal(vb[0], vb[1])


def test_batch_matches_single_scene_3d():
    cfg = tsmoke3d.Smoke3DConfig(depth=6, height=8, width=8, num_frames=3,
                                 project_iters=5)
    v1, r1 = tsmoke3d.simulate_smoke3d(1.5, 0.04, cfg, device="cpu")
    vb, rb = tsmoke3d.simulate_smoke3d_batch([0.5, 1.5], [0.12, 0.04], cfg,
                                             device="cpu")
    assert vb.shape == (2, 3, 6, 8, 8, 3)
    np.testing.assert_allclose(vb[1].numpy(), v1.numpy(), atol=1e-6)
    np.testing.assert_allclose(rb[1].numpy(), r1.numpy(), atol=1e-6)


def test_golden_smoke2d_trajectory():
    g = np.load(os.path.join(GOLDEN, "smoke2d.npz"))
    cfg = tsmoke2d.Smoke2DConfig(height=32, width=24, num_frames=6,
                                 project_iters=20)
    vt, rt = tsmoke2d.simulate_smoke2d(0.5, 0.1, cfg, device="cpu")
    assert check_fields(vt.numpy(), g["v"], 1e-3)["passed"]
    assert check_fields(rt.numpy()[..., None], g["r"][..., None],
                        1e-3)["passed"]


@pytest.mark.parametrize("cls", [tsmoke2d.Smoke2DConfig,
                                 tsmoke3d.Smoke3DConfig])
def test_projection_typo_rejected(cls):
    for bad in ("Matched", "leray", "matchd"):
        with pytest.raises(ValueError, match="projection"):
            cls(projection=bad)
    for good in ("jacobi", "cg", "matched"):
        assert cls(projection=good).projection == good


def test_config_defaults_match_jax():
    import dataclasses
    for ours, theirs in [(tsmoke2d.Smoke2DConfig, jsmoke2d.Smoke2DConfig),
                         (tsmoke3d.Smoke3DConfig, jsmoke3d.Smoke3DConfig)]:
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_simulate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsmoke2d.simulate_smoke2d(0.5, 0.1, tsmoke2d.Smoke2DConfig(**CFG2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsmoke3d.simulate_smoke3d(1.0, 0.08, tsmoke3d.Smoke3DConfig(**CFG3))
