"""The plain reference against hand-worked values at tiny sizes, and
against the measured program on the CPU in float32 (the test may import
the program; the reference may not)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import synth
from benchmark.references import generator_be as ref

CFG = {"resolution": [16, 12], "filters": 8, "repeat": 2, "num_conv": 2,
       "num_param": 3, "lr_max": 1e-4, "lr_min": 2.5e-6, "max_step": 100,
       "beta1": 0.5, "beta2": 0.999}


def test_fdiff_repeats_the_last_difference():
    x = torch.tensor([0.0, 1.0, 3.0, 6.0])
    assert ref.fdiff(x, 0).tolist() == [1.0, 2.0, 3.0, 3.0]


def test_curl2d_by_hand():
    # psi over a 3 x 3 grid (y down the rows, x along them)
    psi = torch.tensor([[0.0, 1.0, 4.0], [2.0, 2.0, 2.0],
                        [5.0, 3.0, 0.0]])[None, ..., None]
    v = ref.curl(psi)[0]
    # u = dpsi/dy, the last row repeating the one before
    assert v[..., 0].tolist() == [[2.0, 1.0, -2.0], [3.0, 1.0, -2.0],
                                  [3.0, 1.0, -2.0]]
    # v = -dpsi/dx, the last column repeating the one before
    assert v[..., 1].tolist() == [[-1.0, -3.0, -3.0], [0.0, 0.0, 0.0],
                                  [2.0, 3.0, 3.0]]


def test_curl3d_by_hand():
    # a = z, b = 0, c = y: u = dc/dy = 1, v = da/dz = 1, w = 0
    d, h, w = 3, 4, 5
    z, y, _ = torch.meshgrid(torch.arange(d), torch.arange(h),
                             torch.arange(w), indexing="ij")
    psi = torch.stack([z.float(), torch.zeros(d, h, w), y.float()], -1)
    v = ref.curl(psi[None])[0]
    assert torch.equal(v[..., 0], torch.ones(d, h, w))
    assert torch.equal(v[..., 1], torch.ones(d, h, w))
    assert torch.equal(v[..., 2], torch.zeros(d, h, w))


def test_jacobian_order_and_loss_by_hand():
    # u = x, v = 2y over a 3 x 4 grid: J = (1, 0, 0, 2) everywhere
    y, x = torch.meshgrid(torch.arange(3.0), torch.arange(4.0),
                          indexing="ij")
    vel = torch.stack([x, 2 * y], -1)[None]
    j = ref.jacobian(vel)[0]
    assert torch.equal(j, torch.tensor([1.0, 0.0, 0.0, 2.0]).expand(3, 4, 4))
    # zero prediction: mean|0 - vel| + mean|0 - J| = mean(x, 2y) + 3 / 4
    want = float(torch.cat([x, 2 * y]).abs().mean()) + 0.75
    zero = torch.zeros_like(vel)
    got = (torch.mean(torch.abs(zero - vel))
           + torch.mean(torch.abs(ref.jacobian(zero) - ref.jacobian(vel))))
    assert math.isclose(float(got), want, rel_tol=1e-6)


def test_cosine_rate_ends():
    assert ref.cosine_lr(0, CFG) == pytest.approx(1e-4)
    assert ref.cosine_lr(100, CFG) == pytest.approx(2.5e-6)
    assert ref.cosine_lr(500, CFG) == pytest.approx(2.5e-6)
    assert ref.cosine_lr(50, CFG) == pytest.approx(0.5 * (1e-4 + 2.5e-6))


def test_adam_first_step_by_hand():
    # the first Adam step moves each weight by lr * g / (|g| + eps)
    cfg = {**CFG, "resolution": [8, 4], "filters": 2, "num_conv": 1}
    params = {k: v.double() for k, v in synth.weights(
        ref.param_shapes(cfg), 3, "cpu").items()}
    batch = (torch.rand(2, 3, dtype=torch.float64) * 2 - 1,
             torch.randn(2, 8, 4, 2, dtype=torch.float64))
    run = ref.train_steps(params, [batch], cfg)
    for k, g in run["first_grad"].items():
        step = 1e-4 * g / (g.abs() + ref.ADAM_EPS)
        assert torch.allclose(params[k] - run["params"][k], step,
                              rtol=1e-9, atol=1e-15)


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.0625, 0.3])
    q = ref._Fp8.apply(x)
    assert q.tolist()[:3] == [448.0, 1.0, 1.0]     # 1 + 1/16 rounds away
    assert abs(q[3] - 0.3) < 0.3 / 16


def _port_model(cfg):
    from deepfluids_tpu_torch.models import GeneratorBE

    return GeneratorBE(tuple(cfg["resolution"]) + (
        ref.potential_channels(cfg["resolution"]),), num_param=3,
        filters=cfg["filters"], num_conv=cfg["num_conv"],
        repeat=cfg["repeat"], compute_dtype=torch.float32)


@pytest.mark.parametrize("res", [[16, 12], [8, 16, 12]])
def test_reference_matches_the_program_in_float32(res):
    from deepfluids_tpu_torch.ops import fd
    from deepfluids_tpu_torch.train import losses

    cfg = {**CFG, "resolution": res}
    weights = synth.weights(ref.param_shapes(cfg), 5, "cpu")
    model = _port_model(cfg)
    model.load_state_dict(weights)
    p = torch.rand(4, 3) * 2 - 1
    x = torch.randn(4, *res, len(res))
    psi = model(p)
    assert torch.allclose(ref.generator(weights, p, cfg), psi, atol=1e-5)
    assert torch.allclose(ref.curl(psi), losses.apply_curl(psi), atol=1e-6)
    j, _ = (fd.jacobian2d if len(res) == 2 else fd.jacobian3d)(x)
    assert torch.allclose(ref.jacobian(x), j, atol=1e-6)
    want, _ = losses.generator_loss(psi, x, True, 1.0, 1.0)
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    got = ref.loss(leaves, p, x, cfg)
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-5)
    want.backward()
    got.backward()
    # a leaf the curl cancels (the last bias) has a gradient of rounding
    top = max(float(w.grad.abs().max()) for w in model.parameters())
    for name, w in model.named_parameters():
        assert torch.allclose(leaves[name].grad, w.grad, rtol=1e-3,
                              atol=1e-6 * top), name


def test_synthetic_inputs_repeat_from_the_seed():
    cfg = {**CFG, "param_ranges": [[0.2, 0.8], [0.04, 0.12], [0.0, 199.0]],
           "param_counts": [3, 2], "num_frames": 10, "distinct_frames": 4}
    a, pa = synth.blob_fields(cfg, 2**31 + 9, "cpu")
    b, pb = synth.blob_fields(cfg, 2**31 + 9, "cpu")
    c, _ = synth.blob_fields(cfg, 2**31 + 10, "cpu")
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert not torch.equal(a, c)
    assert a.shape == (24, 16, 12, 2) and torch.isfinite(a).all()
    rows_of = synth.staged_rows(cfg)
    # 6 scenes x 10 frames, each scene's frames in runs over its 4 fields
    assert rows_of[:10].tolist() == [0, 0, 0, 1, 1, 2, 2, 2, 3, 3]
    assert rows_of.tolist() == sorted(rows_of.tolist())
    assert len(rows_of) == 60 and set(rows_of.tolist()) == set(range(24))
    s = synth.distinct_rows_seed(2**31 + 9, rows_of, 4, 3)
    rows = np.concatenate([rows_of[synth.batch_rows(s, k, 60, 4)]
                           for k in (1, 2, 3)])
    assert len(set(rows.tolist())) == 12
    w1 = synth.weights(ref.param_shapes(CFG), 4, "cpu")
    w2 = synth.weights(ref.param_shapes(CFG), 4, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


def test_staged_rows_are_linked_files(tmp_path):
    from benchmark import port

    cfg = {**CFG, "name": "tiny", "param_names": ["a", "b", "frame"],
           "param_ranges": [[0.2, 0.8], [0.04, 0.12], [0.0, 9.0]],
           "param_counts": [2, 1], "num_frames": 4, "distinct_frames": 2,
           "num_channels": 2}
    fields = np.arange(4 * 16 * 12 * 2, dtype=np.float32).reshape(
        4, 16, 12, 2)
    params = np.arange(12, dtype=np.float32).reshape(4, 3)
    rows_of = synth.staged_rows(cfg)
    port.write_dataset(str(tmp_path), cfg, fields, params, rows_of, 4)
    files = sorted((tmp_path / "tiny" / "v").iterdir())
    assert [f.name for f in files][:3] == ["0000_0000.npz", "0000_0001.npz",
                                           "0000_0002.npz"]
    assert len(files) == 8
    for k, f in enumerate(files):
        with np.load(f) as d:
            assert np.array_equal(d["x"], fields[rows_of[k]])
            assert np.array_equal(d["y"], params[rows_of[k]])
    # one file a field, the other rows hard links to it
    assert len({f.stat().st_ino for f in files}) == 4


def test_adam_moments_match_torch_adam():
    # the reference's Adam, moments and parameters, against torch's own
    # over two steps, the second taken over half its rows
    cfg = {**CFG, "resolution": [8, 4], "filters": 2, "num_conv": 1}
    params = {k: v.double() for k, v in synth.weights(
        ref.param_shapes(cfg), 3, "cpu").items()}
    batches = [(torch.rand(2, 3, dtype=torch.float64) * 2 - 1,
                torch.randn(2, 8, 4, 2, dtype=torch.float64))
               for _ in range(2)]
    run = ref.train_steps(params, batches, cfg, half_batch=(2,))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(leaves.values(), lr=ref.cosine_lr(0, cfg),
                           betas=(cfg["beta1"], cfg["beta2"]),
                           eps=ref.ADAM_EPS)
    for t, (p, x) in enumerate(batches):
        if t == 1:
            p, x = p[:1], x[:1]
        for g in opt.param_groups:
            g["lr"] = ref.cosine_lr(t, cfg)
        opt.zero_grad()
        ref.loss(leaves, p, x, cfg).backward()
        opt.step()
    for k, w in leaves.items():
        state = opt.state[w]
        assert torch.allclose(run["m"][k], state["exp_avg"], rtol=1e-12,
                              atol=1e-18), k
        assert torch.allclose(run["v"][k], state["exp_avg_sq"], rtol=1e-12,
                              atol=1e-24), k
        assert torch.allclose(run["params"][k], w.detach(), rtol=1e-12,
                              atol=1e-15), k
