"""The port's LatentIntegrator and rollout (arch "nn") against the JAX
package, on shared weights with a randomized head (Flax zero-inits it,
which would make every rollout the identity).
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

from deepfluids_tpu.models import LatentIntegrator as FlaxIntegrator  # noqa: E402,E501
from deepfluids_tpu.models import rollout as jax_rollout  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    LatentIntegrator,
    flax_to_state_dict,
    noise_generator,
    rollout,
)

Z, P, T, B = 8, 2, 30, 3


def _pair(history=1, seed=0):
    """(flax module, its params with a random head, the port's module)."""
    fm = FlaxIntegrator(z_num=Z, num_param=P, hidden=32, depth=2)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, Z * history)),
                     jnp.zeros((1, P)))["params"]
    # A head that moves the code by ~0.05 a step: the trajectory stays
    # O(1) over T steps, so float32 rounding is not amplified past 1e-6.
    head = params["fc_out"]["kernel"]
    params = dict(params, fc_out=dict(params["fc_out"], kernel=jnp.asarray(
        0.02 * np.random.default_rng(seed).standard_normal(head.shape),
        jnp.float32)))
    tm = LatentIntegrator(Z, P, hidden=32, depth=2, history=history)
    tm.load_state_dict(flax_to_state_dict(weights_io.flatten_params(params),
                                          tm))
    return fm, params, tm


def _trajectory(history, seed=1):
    """A start code ([B, Z] or [H, B, Z]) and a smooth [T, B, P] parameter
    trajectory whose first rows match the code's parameter block."""
    rng = np.random.default_rng(seed)
    p = np.cumsum(rng.uniform(-0.05, 0.05, (T, B, P)), axis=0).astype(
        np.float32)
    z = rng.standard_normal((history, B, Z)).astype(np.float32)
    z[:, :, :P] = p[:history]
    return (z if history > 1 else z[0]), p


def test_integrator_matches_flax():
    fm, params, tm = _pair()
    rng = np.random.default_rng(2)
    z = rng.standard_normal((5, Z)).astype(np.float32)
    dp = rng.standard_normal((5, P)).astype(np.float32)
    want = fm.apply({"params": params}, jnp.asarray(z), jnp.asarray(dp))
    with torch.no_grad():
        got = tm(torch.from_numpy(z), torch.from_numpy(dp))
    assert got.shape == (5, Z - P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("history,remat", [(1, False), (1, True),
                                           (3, False), (3, True)])
def test_rollout_matches_jax(history, remat):
    # 30 steps of the integrator (through _rollout_history at H = 3), and
    # the gradient of the whole trajectory, against JAX at 1e-6.
    fm, params, tm = _pair(history)
    z0, p = _trajectory(history)

    def jax_traj(prm):
        return jax_rollout(lambda q, zf, dp: fm.apply({"params": q}, zf, dp),
                           prm, jnp.asarray(z0), jnp.asarray(p), P,
                           remat=remat, history=history)

    want = np.asarray(jax_traj(params))
    got = rollout(tm, torch.from_numpy(z0), torch.from_numpy(p), P,
                  remat=remat, history=history)
    assert got.shape == (T, B, Z)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    # the seed codes' parameter blocks are pinned to the trajectory
    np.testing.assert_array_equal(got[:, :, :P].detach().numpy(), p)
    want_g = weights_io.flatten_params(jax.grad(
        lambda prm: jnp.sum(jax_traj(prm) ** 2))(params))
    torch.sum(got ** 2).backward()
    got_g = {k.replace(".weight", "/kernel").replace(".bias", "/bias"):
             (p_.grad.T if p_.dim() == 2 else p_.grad).numpy()
             for k, p_ in tm.named_parameters()}
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k], g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


def test_noise_is_deterministic_and_corrupts_the_carried_state():
    # With a zero head the integrator adds nothing, so the free block is
    # the start code plus the running sum of the noise it was given,
    # drawn up front as [T-1, B, free] (JAX's layout).
    z0, p = _trajectory(1)
    zero = LatentIntegrator(Z, P, hidden=32)
    for prm in zero.parameters():
        torch.nn.init.zeros_(prm)
    z0, p = torch.from_numpy(z0), torch.from_numpy(p)
    a = rollout(zero, z0, p, P, noise_std=0.1,
                generator=noise_generator(7, 3, "cpu"))
    b = rollout(zero, z0, p, P, noise_std=0.1,
                generator=noise_generator(7, 3, "cpu"))
    c = rollout(zero, z0, p, P, noise_std=0.1,
                generator=noise_generator(7, 4, "cpu"))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    eps = 0.1 * torch.randn((T - 1, B, Z - P),
                            generator=noise_generator(7, 3, "cpu"))
    want = z0[:, P:] + torch.cumsum(eps, 0)
    torch.testing.assert_close(a[1:, :, P:], want, atol=1e-6, rtol=0)
    # noise 0 draws nothing and needs no generator
    torch.testing.assert_close(rollout(zero, z0, p, P)[:, :, P:],
                               z0[:, P:].expand(T, B, Z - P))


def test_noise_generator_is_a_function_of_seed_and_step():
    draw = [torch.rand(4, generator=noise_generator(s, k, "cpu"))
            for s, k in ((123, 0), (123, 0), (123, 1), (124, 0))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])


@pytest.mark.parametrize("z_shape,history,kw,match", [
    ((B, Z), 2, {}, "history"),
    ((3, B, Z), 2, {}, "leading dim"),
    ((B, Z), 1, {"noise_std": 0.1}, "generator")])
def test_rollout_rejects(z_shape, history, kw, match):
    tm = LatentIntegrator(Z, P, hidden=8, history=history)
    with pytest.raises(ValueError, match=match):
        rollout(tm, torch.zeros(z_shape), torch.zeros(T, B, P), P,
                history=history, **kw)


def test_window_loss_takes_jax_arguments():
    """``latent_window_loss(z_pred, z_true, num_param)``, JAX's call, gives
    JAX's value; the third argument is ignored in both."""
    from deepfluids_tpu.train.losses import latent_window_loss as jax_loss
    from deepfluids_tpu_torch.train.losses import latent_window_loss

    rng = np.random.default_rng(5)
    zp, zt = (rng.standard_normal((6, B, Z)).astype(np.float32)
              for _ in range(2))
    want, jaux = jax_loss(jnp.asarray(zp), jnp.asarray(zt), P)
    got, aux = latent_window_loss(torch.from_numpy(zp), torch.from_numpy(zt),
                                  P)
    assert float(got) == pytest.approx(float(want), rel=2e-6)
    assert float(aux["loss_z"]) == pytest.approx(float(jaux["loss_z"]),
                                                 rel=2e-6)
    assert float(latent_window_loss(torch.from_numpy(zp),
                                    torch.from_numpy(zt))[0]) == float(got)
    assert float(latent_window_loss(torch.from_numpy(zp),
                                    torch.from_numpy(zt), 0)[0]) == float(got)
