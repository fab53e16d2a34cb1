"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no jax, so it also runs on a machine without it; there the repo's
conftest (which configures jax) is left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from deepfluids_tpu_torch.config import Config
from deepfluids_tpu_torch.data import Manifest, save_manifest
from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
from deepfluids_tpu_torch.ops import cuda_fd, fd
from deepfluids_tpu_torch.train.losses import apply_curl
from deepfluids_tpu_torch.train.trainer import Trainer
from deepfluids_tpu_torch.utils.parity import check_fields

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 96), (32, 128, 96), (3, 8, 8),
                                   (2, 16, 12), (2, 2, 2)])
def test_curl2d_kernel_matches_plain(cuda_device, shape, dtype):
    b, h, w = shape
    psi = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, h, w, 1)).astype(np.float32)).to(cuda_device, dtype)
    before = cuda_fd.launch_counts["curl2d_fused"]
    got = cuda_fd.curl2d_fused(psi)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts["curl2d_fused"] == before + 1
    want = fd.curl2d(psi)
    assert got.dtype == dtype and got.shape == (b, h, w, 2)
    # f32 math on both sides: bit-identical in practice; 1e-6 is the bar
    # tests/test_ops.py holds the Pallas kernel to.
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_curl2d_kernel_grad(cuda_device):
    # Differentiable on the card: the backward launches curl2d_bwd.
    psi = torch.randn(2, 16, 12, 1, device=cuda_device, requires_grad=True)
    g = torch.randn(2, 16, 12, 2, device=cuda_device)
    before = dict(cuda_fd.launch_counts)
    cuda_fd.curl2d_p(psi).backward(g)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts["curl2d_fused"] == before["curl2d_fused"] + 1
    assert cuda_fd.launch_counts["curl2d_bwd"] == before["curl2d_bwd"] + 1
    torch.testing.assert_close(psi.grad, fd.curl2d_bwd(g), atol=1e-5,
                               rtol=0)


@pytest.mark.cuda
def test_generator_golden_through_kernel(cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.load(os.path.join(GOLDEN, "generator2d.npz"))
    model = GeneratorBE((32, 24, 1), num_param=3, filters=8, num_conv=2)
    load_flax_npz(os.path.join(GOLDEN, "generator2d_params.npz"), model)
    model.to(cuda_device)
    before = cuda_fd.launch_counts["curl2d_fused"]
    with torch.inference_mode():
        u = apply_curl(model(torch.from_numpy(g["p"]).to(cuda_device)))
    assert cuda_fd.launch_counts["curl2d_fused"] == before + 1
    assert check_fields(u.cpu().numpy(), g["u"])["passed"]


# --- jacobian2d_fused, curl2d_bwd, jacobian2d_bwd --------------------------

SHAPES = [(1, 128, 96), (32, 128, 96), (3, 8, 8), (2, 16, 12), (2, 3, 5)]
BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative to the value, at most


def _inputs(op, b, h, w, device, dtype):
    chans = {"jacobian2d_fused": [2], "curl2d_bwd": [2],
             "jacobian2d_bwd": [4, 1]}[op]
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
        np.float32)).to(device, dtype) for c in chans]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,plain,tol", [
    ("jacobian2d_fused", fd.jacobian2d, 1e-6),
    ("curl2d_bwd", fd.curl2d_bwd, 1e-5),
    ("jacobian2d_bwd", fd.jacobian2d_bwd, 1e-5)])
def test_kernel_matches_plain(cuda_device, op, plain, tol, shape, dtype):
    xs = _inputs(op, *shape, cuda_device, dtype)
    before = cuda_fd.launch_counts[op]
    got = getattr(cuda_fd, op)(*xs)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts[op] == before + 1
    # The plain version on the f32-upcast input, rounded once: the
    # kernel's arithmetic.
    want = plain(*(x.float() for x in xs))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, wt in zip(got, want):
        assert g.dtype == dtype and g.shape == wt.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, wt, atol=tol, rtol=0)
        else:
            err = (g.float() - wt.to(dtype).float()).abs()
            assert bool((err <= BF16_ULP * wt.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 12), (8, 128, 96)])
def test_autograd_matches_plain_autograd(cuda_device, shape):
    rng = np.random.default_rng(8)

    def rand(c):
        return torch.from_numpy(rng.standard_normal(shape + (c,)).astype(
            np.float32)).to(cuda_device)

    psi, gu, x, gj, gw = rand(1), rand(2), rand(2), rand(4), rand(1)
    for fn, plain, inp, cots in [
            (cuda_fd.curl2d_p, fd.curl2d, psi, [gu]),
            (cuda_fd.jacobian2d_p, fd.jacobian2d, x, [gj, gw])]:
        a = inp.clone().requires_grad_()
        b = inp.clone().requires_grad_()
        outs = fn(a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(list(outs), cots)
        ref = plain(b)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.autograd.backward(list(ref), cots)
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_backward_refused_below_extent_3(cuda_device):
    with pytest.raises(ValueError):
        cuda_fd.curl2d_bwd(torch.zeros(1, 2, 8, 2, device=cuda_device))
    with pytest.raises(ValueError):
        cuda_fd.jacobian2d_p(torch.zeros(1, 8, 2, 2, device=cuda_device,
                                         requires_grad=True))


@pytest.mark.cuda
def test_train_step_launch_counts(cuda_device, tmp_path):
    # One Trainer step: curl 1, its backward 1, jacobian 2 (prediction and
    # target), the jacobian's backward 1 (the target needs none).
    ds = tmp_path / "data" / "tiny"
    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]],
        num_scenes=2, num_frames=4, resolution=[32, 24], num_channels=2,
        v_range=[-1.0, 1.0], data_type="velocity"), str(ds))
    os.makedirs(ds / "v")
    rng = np.random.default_rng(9)
    for k in range(8):
        np.savez(ds / "v" / f"{k // 4}_0_{k % 4}.npz",
                 x=rng.standard_normal((32, 24, 2)).astype(np.float32),
                 y=np.array([0.2 + 0.6 * (k // 4), 0.04, k % 4], np.float32))
    c = Config(data_dir=str(tmp_path / "data"), dataset="tiny", filters=8,
               num_conv=1, batch_size=4, num_worker=1, log_dir=str(tmp_path))
    t = Trainer(c, device=cuda_device)
    x, y = t.bm.step_batch(1)
    cuda_fd.reset_launch_counts()
    aux = t._train_step(torch.from_numpy(x).to(cuda_device),
                        torch.from_numpy(y).to(cuda_device))
    torch.cuda.synchronize()
    assert np.isfinite(float(aux["loss"]))
    zeros = dict.fromkeys(cuda_fd.launch_counts, 0)
    assert cuda_fd.launch_counts == {**zeros,
                                     "curl2d_fused": 1, "curl2d_bwd": 1,
                                     "jacobian2d_fused": 2,
                                     "jacobian2d_bwd": 1}


# --- the 3D kernels: curl3d, jacobian3d and their transposes ---------------

# config #5's grid at the training batch, odd extents, the smallest
# backward grid, and (2, 2, 4, 5): below the backward kernels' minimum
SHAPES_3D = [(8, 32, 64, 112), (1, 32, 64, 112), (2, 5, 6, 7), (1, 3, 3, 3),
             (2, 2, 4, 5)]
OPS_3D = {"curl3d_fused": (fd.curl3d, [3], 1e-6),
          "jacobian3d_fused": (fd.jacobian3d, [3], 1e-6),
          "curl3d_bwd": (fd.curl3d_bwd, [3], 1e-5),
          "jacobian3d_bwd": (fd.jacobian3d_bwd, [9, 3], 1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("op", list(OPS_3D))
def test_kernel_3d_matches_plain(cuda_device, op, shape, dtype):
    plain, chans, tol = OPS_3D[op]
    rng = np.random.default_rng(10)
    xs = [torch.from_numpy(rng.standard_normal(shape + (c,)).astype(
        np.float32)).to(cuda_device, dtype) for c in chans]
    if op.endswith("_bwd") and min(shape[1:]) < 3:
        with pytest.raises(ValueError):
            getattr(cuda_fd, op)(*xs)
        return
    before = cuda_fd.launch_counts[op]
    got = getattr(cuda_fd, op)(*xs)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts[op] == before + 1
    want = plain(*(x.float() for x in xs))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, wt in zip(got, want):
        assert g.dtype == dtype and g.shape == wt.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, wt, atol=tol, rtol=0)
        else:
            err = (g.float() - wt.to(dtype).float()).abs()
            assert bool((err <= BF16_ULP * wt.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (8, 32, 64, 112)])
def test_autograd_3d_matches_plain_autograd(cuda_device, shape):
    rng = np.random.default_rng(11)

    def rand(c):
        return torch.from_numpy(rng.standard_normal(shape + (c,)).astype(
            np.float32)).to(cuda_device)

    psi, gu, x, gj, gv = rand(3), rand(3), rand(3), rand(9), rand(3)
    for fn, plain, inp, cots in [
            (cuda_fd.curl3d_p, fd.curl3d, psi, [gu]),
            (cuda_fd.jacobian3d_p, fd.jacobian3d, x, [gj, gv])]:
        a = inp.clone().requires_grad_()
        b = inp.clone().requires_grad_()
        outs = fn(a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(list(outs), cots)
        ref = plain(b)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.autograd.backward(list(ref), cots)
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_generator3d_golden_through_kernel(cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.load(os.path.join(GOLDEN, "generator3d.npz"))
    model = GeneratorBE((8, 16, 16, 3), num_param=3, filters=8, num_conv=2)
    load_flax_npz(os.path.join(GOLDEN, "generator3d_params.npz"), model)
    model.to(cuda_device)
    before = cuda_fd.launch_counts["curl3d_fused"]
    with torch.inference_mode():
        u = apply_curl(model(torch.from_numpy(g["p"]).to(cuda_device)))
    assert cuda_fd.launch_counts["curl3d_fused"] == before + 1
    assert check_fields(u.cpu().numpy(), g["u"])["passed"]


@pytest.mark.cuda
def test_train_step_3d_launch_counts(cuda_device, tmp_path):
    # One 3D Trainer step: curl3d 1, its backward 1, jacobian3d 2, the
    # jacobian's backward 1, and no 2D kernel.
    ds = tmp_path / "data" / "tiny3d"
    save_manifest(Manifest(
        param_names=["inflow_vel", "buoyancy", "frame"],
        param_ranges=[[0.5, 1.5], [0.04, 0.12], [0.0, 3.0]],
        num_scenes=2, num_frames=4, resolution=[8, 16, 16], num_channels=3,
        v_range=[-1.0, 1.0], data_type="velocity"), str(ds))
    os.makedirs(ds / "v")
    rng = np.random.default_rng(12)
    for k in range(8):
        np.savez(ds / "v" / f"{k // 4}_0_{k % 4}.npz",
                 x=rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
                 y=np.array([0.5 + k // 4, 0.04, k % 4], np.float32))
    c = Config(data_dir=str(tmp_path / "data"), dataset="tiny3d", filters=8,
               num_conv=1, batch_size=4, num_worker=1, log_dir=str(tmp_path))
    t = Trainer(c, device=cuda_device)
    x, y = t.bm.step_batch(1)
    cuda_fd.reset_launch_counts()
    aux = t._train_step(torch.from_numpy(x).to(cuda_device),
                        torch.from_numpy(y).to(cuda_device))
    torch.cuda.synchronize()
    assert np.isfinite(float(aux["loss"]))
    zeros = dict.fromkeys(cuda_fd.launch_counts, 0)
    assert cuda_fd.launch_counts == {**zeros,
                                     "curl3d_fused": 1, "curl3d_bwd": 1,
                                     "jacobian3d_fused": 2,
                                     "jacobian3d_bwd": 1}
