"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no jax, so it also runs on a machine without it; there the repo's
conftest (which configures jax) is left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os
import re

import numpy as np
import pytest
import torch

from deepfluids_tpu_torch.config import Config
from deepfluids_tpu_torch.data import Manifest, save_manifest
from deepfluids_tpu_torch.infer import encode_dataset
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


# Besides the serving and training shapes: widths of no multiple of 4 or 8
# (runs of one point), an odd height, and a row wider than a block's
# threads.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 96), (32, 128, 96), (3, 8, 8),
                                   (2, 16, 12), (2, 2, 2), (2, 9, 37),
                                   (3, 7, 13), (2, 5, 96), (1, 5, 1100)])
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

# Besides the serving and training shapes: widths of no multiple of 4 or 8
# (runs of one point: 5, 37, 13, 97), odd heights (a ragged last row
# tile), a row wider than a block's threads, and fields large enough for
# curl2d_bwd's 16-byte runs (1 M points in f32, 0.5 M in bf16; 48 x 129 x
# 96 takes them in bf16 only).
SHAPES = [(1, 128, 96), (32, 128, 96), (3, 8, 8), (2, 16, 12), (2, 3, 5),
          (2, 9, 37), (3, 7, 13), (3, 5, 96), (1, 5, 1100), (96, 128, 96),
          (48, 129, 96), (2, 6, 97)]
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
            # The plain versions' order of operations: bit-equal.
            assert torch.equal(g, wt)
        else:
            err = (g.float() - wt.to(dtype).float()).abs()
            assert bool((err <= BF16_ULP * wt.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 37), (8, 128, 96), (96, 128, 96)])
@pytest.mark.parametrize("op,plain,chans", [
    ("curl2d_fused", fd.curl2d, 1), ("curl2d_bwd", fd.curl2d_bwd, 2)])
def test_curl2d_kernels_unaligned_storage(cuda_device, op, plain, chans,
                                          shape, dtype):
    # Storage one point past an aligned address (a view into a larger
    # buffer): one element for the curl, one (u, v) pair for its transpose,
    # whose wrapper refuses storage not aligned to a point.  No 16-byte run
    # can be taken; f32 stays bit-equal.
    rng = np.random.default_rng(14)
    n = int(np.prod(shape)) * chans
    buf = torch.from_numpy(rng.standard_normal(n + chans).astype(
        np.float32)).to(cuda_device, dtype)
    x = buf[chans:].view(shape + (chans,))
    before = cuda_fd.launch_counts[op]
    got = getattr(cuda_fd, op)(x)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts[op] == before + 1
    want = plain(x.float())
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        _close_to_plain(got, want, dtype, 0.0)
    if chans == 2:
        with pytest.raises(ValueError):
            getattr(cuda_fd, op)(buf[1:n + 1].view(shape + (chans,)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 37), (2, 6, 97), (8, 128, 96),
                                   (96, 128, 96)])
@pytest.mark.parametrize("op", ["jacobian2d_fused", "jacobian2d_bwd"])
def test_jacobian2d_kernels_unaligned_storage(cuda_device, op, shape,
                                              dtype):
    # Every input one point past an aligned address (a view into a larger
    # buffer): (u, v) or the vorticity's cotangent off 16 bytes, so the
    # kernels run in runs of one point; f32 stays bit-equal.
    rng = np.random.default_rng(15)
    xs = []
    for c in {"jacobian2d_fused": [2], "jacobian2d_bwd": [4, 1]}[op]:
        n = int(np.prod(shape)) * c
        buf = torch.from_numpy(rng.standard_normal(n + c).astype(
            np.float32)).to(cuda_device, dtype)
        xs.append(buf[c:].view(shape + (c,)))
    before = cuda_fd.launch_counts[op]
    got = getattr(cuda_fd, op)(*xs)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts[op] == before + 1
    want = cuda_fd._in_f32(getattr(fd, op.replace("_fused", "")),
                           *(x.float() for x in xs))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, wt in zip(got, want):
        if dtype == torch.float32:
            assert torch.equal(g, wt)
        else:
            _close_to_plain(g, wt, dtype, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("shape", [s for s in SHAPES if min(s[1:]) >= 3])
def test_jacobian2d_bwd_kernel_without_vort(cuda_device, shape, skip,
                                            dtype):
    # No vorticity cotangent (the training loss's call): J's alone, equal
    # to the plain version and to the kernel given zeros (atol 0; only the
    # sign of an exact zero may differ).  skip 1 starts the storage one
    # point past an aligned address.
    n = int(np.prod(shape)) * 4
    gj = torch.from_numpy(np.random.default_rng(16).standard_normal(
        n + 4 * skip).astype(np.float32)).to(cuda_device, dtype)[
            4 * skip:].view(shape + (4,))
    zeros = torch.zeros(shape + (1,), dtype=dtype, device=cuda_device)
    before = cuda_fd.launch_counts["jacobian2d_bwd"]
    got = cuda_fd.jacobian2d_bwd(gj, None)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts["jacobian2d_bwd"] == before + 1
    torch.testing.assert_close(got, cuda_fd.jacobian2d_bwd(gj, zeros),
                               atol=0, rtol=0)
    want = fd.jacobian2d_bwd(gj.float(), zeros.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    else:
        _close_to_plain(got, want, dtype, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("used", [0, 1], ids=["j_only", "vort_only"])
@pytest.mark.parametrize("shape", [(2, 16, 12), (8, 128, 96)])
def test_autograd_jacobian2d_one_output_unused(cuda_device, shape, used):
    # The unused output's cotangent arrives as None: J's alone (the kernel
    # reads no vorticity cotangent), or the vorticity's with J's made zeros.
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal(shape + (2,)).astype(
        np.float32)).to(cuda_device)
    cot = torch.from_numpy(rng.standard_normal(
        shape + ((4, 1)[used],)).astype(np.float32)).to(cuda_device)
    grads = []
    for f in (cuda_fd.jacobian2d_p, fd.jacobian2d):
        a = x.clone().requires_grad_()
        f(a)[used].backward(cot)
        grads.append(a.grad)
    # Autograd of the plain ops sums the edge terms in another order.
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=0)
    cots = [cot, torch.zeros(shape + ((1, 4)[used],), device=cuda_device)]
    want = fd.jacobian2d_bwd(*(cots if used == 0 else cots[::-1]))
    torch.testing.assert_close(grads[0], want, atol=0, rtol=0)


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
# backward grid, (2, 2, 4, 5): below the backward kernels' minimum, and for
# the backward kernels' bricks: rows of no 16-byte multiple (W = 37, 113,
# 5), ragged last bricks, D below a brick's planes, and W wider than a
# brick's plane (column tiles)
SHAPES_3D = [(8, 32, 64, 112), (1, 32, 64, 112), (2, 5, 6, 7), (1, 3, 3, 3),
             (2, 2, 4, 5), (2, 9, 13, 37), (1, 33, 65, 113), (3, 4, 7, 5),
             (1, 4, 5, 1100)]
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
            # The plain versions' order of operations: bit-equal.
            assert torch.equal(g, wt)
        else:
            err = (g.float() - wt.to(dtype).float()).abs()
            assert bool((err <= BF16_ULP * wt.abs()).all())


def _close_to_plain(got, want, dtype, tol):
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    else:
        err = (got.float() - want.to(dtype).float()).abs()
        assert bool((err <= BF16_ULP * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 13, 37), (8, 32, 64, 112)])
@pytest.mark.parametrize("op", list(OPS_3D))
def test_kernel_3d_unaligned_storage(cuda_device, op, shape, dtype):
    # Storage one element past an aligned address (a view into a larger
    # buffer): the backward kernels copy such spans element by element.
    plain, chans, tol = OPS_3D[op]
    rng = np.random.default_rng(13)
    xs = [torch.from_numpy(rng.standard_normal(
        int(np.prod(shape)) * c + 1).astype(np.float32)).to(
            cuda_device, dtype)[1:].view(shape + (c,)) for c in chans]
    got = getattr(cuda_fd, op)(*xs)
    torch.cuda.synchronize()
    want = plain(*(x.float() for x in xs))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, wt in zip(got, want):
        _close_to_plain(g, wt, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (2, 9, 13, 37),
                                   (8, 32, 64, 112)])
def test_jacobian3d_bwd_kernel_without_vort(cuda_device, shape, dtype):
    # No vorticity cotangent (the training loss's call): J's alone, against
    # the plain version given zeros.
    gj = torch.from_numpy(np.random.default_rng(14).standard_normal(
        shape + (9,)).astype(np.float32)).to(cuda_device, dtype)
    before = cuda_fd.launch_counts["jacobian3d_bwd"]
    got = cuda_fd.jacobian3d_bwd(gj, None)
    torch.cuda.synchronize()
    assert cuda_fd.launch_counts["jacobian3d_bwd"] == before + 1
    want = fd.jacobian3d_bwd(gj.float(), torch.zeros(
        shape + (3,), device=cuda_device))
    _close_to_plain(got, want, dtype, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("used", [0, 1], ids=["j_only", "vort_only"])
@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (8, 32, 64, 112)])
def test_autograd_jacobian3d_one_output_unused(cuda_device, shape, used):
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal(shape + (3,)).astype(
        np.float32)).to(cuda_device)
    cot = torch.from_numpy(rng.standard_normal(
        shape + ((9, 3)[used],)).astype(np.float32)).to(cuda_device)
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    cuda_fd.jacobian3d_p(a)[used].backward(cot)
    fd.jacobian3d(b)[used].backward(cot)
    torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)


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


def _tiny_mov(tmp_path) -> str:
    """A 2-scene x 4-frame set of 32x24 velocity with (src_x_pos, frame)
    params; returns its data dir."""
    ds = tmp_path / "data" / "tiny_mov"
    save_manifest(Manifest(
        param_names=["src_x_pos", "frame"],
        param_ranges=[[0.2, 0.8], [0.0, 3.0]], num_scenes=2, num_frames=4,
        resolution=[32, 24], num_channels=2, v_range=[-1.0, 1.0],
        data_type="velocity"), str(ds))
    os.makedirs(ds / "v")
    rng = np.random.default_rng(16)
    for k in range(8):
        np.savez(ds / "v" / f"{k // 4}_{k % 4}.npz",
                 x=rng.standard_normal((32, 24, 2)).astype(np.float32),
                 y=np.array([0.2 + 0.6 * (k // 4), k % 4], np.float32))
    return str(tmp_path / "data")


def _mov_config(data_dir: str, **kw) -> Config:
    return Config(**{**dict(arch="ae", data_dir=data_dir,
                            dataset="tiny_mov", z_num=8, filters=8,
                            num_conv=1, batch_size=4, num_worker=1,
                            ae_pred_hidden=16,
                            log_dir=os.path.dirname(data_dir)), **kw})


@pytest.mark.cuda
@pytest.mark.parametrize("ae_pred_w", [0.0, 0.5])
def test_ae_step_and_decode_launch_counts(cuda_device, tmp_path, ae_pred_w):
    # One "ae" Trainer step (also on a --ae_pred_w pair batch) launches a
    # "de" step's kernels; a decoded batch the curl once; the encoder none.
    t = Trainer(_mov_config(_tiny_mov(tmp_path), ae_pred_w=ae_pred_w),
                device=cuda_device)
    x, y = t.bm.step_batch(1)
    zeros = dict.fromkeys(cuda_fd.launch_counts, 0)
    cuda_fd.reset_launch_counts()
    aux = t._train_step(torch.from_numpy(x).to(cuda_device),
                        torch.from_numpy(y).to(cuda_device))
    torch.cuda.synchronize()
    assert np.isfinite(float(aux["loss"]))
    assert cuda_fd.launch_counts == {**zeros,
                                     "curl2d_fused": 1, "curl2d_bwd": 1,
                                     "jacobian2d_fused": 2,
                                     "jacobian2d_bwd": 1}
    cuda_fd.reset_launch_counts()
    z = t.encode(x)
    assert cuda_fd.launch_counts == zeros and z.shape == (len(x), 8)
    fields = t.decode(np.repeat(z, 8, axis=0))
    assert cuda_fd.launch_counts == {**zeros, "curl2d_fused": 1}
    assert fields.shape == (8 * len(x), 32, 24, 2)
    assert np.isfinite(fields).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nn_field_w", [0.0, 0.5])
def test_nn_step_launch_counts(cuda_device, tmp_path, nn_field_w):
    # An "nn" step launches no FD kernel; with --nn_field_w it decodes the
    # predicted codes (the curl and its transpose) and the true ones (the
    # curl, under no_grad) through the frozen AE, and takes the field
    # loss's two jacobians and one jacobian transpose.
    data = _tiny_mov(tmp_path)
    ae = Trainer(_mov_config(data, tag="ae"), device=cuda_device)
    ae.save_checkpoint()
    encode_dataset(ae.encode, ae.c.dataset_dir, 8, batch_size=4)
    t = Trainer(_mov_config(data, arch="nn", tag="nn", w_num=3,
                            nn_field_w=nn_field_w, nn_field_frames=2,
                            ae_load_path=ae.run_dir), device=cuda_device)
    z, p = (torch.from_numpy(a).to(cuda_device)
            for a in t.codes.window_batch(4, 3, step=1))
    zeros = dict.fromkeys(cuda_fd.launch_counts, 0)
    cuda_fd.reset_launch_counts()
    aux = t._train_step(z, p)
    torch.cuda.synchronize()
    assert np.isfinite(float(aux["loss"]))
    want = {**zeros, "curl2d_fused": 2, "curl2d_bwd": 1,
            "jacobian2d_fused": 2, "jacobian2d_bwd": 1} if nn_field_w else zeros
    assert cuda_fd.launch_counts == want


# --- config #3 (levelset), the generator's knobs, sweep_on_device ----------

def _tiny_set(tmp_path, name: str, channels: int) -> str:
    """A 2-scene x 4-frame 32x24 set (velocity, or a levelset under l/)
    with (drop_x_pos, drop_radius, frame) params; its data dir."""
    ds = tmp_path / "data" / name
    levelset = channels == 1
    save_manifest(Manifest(
        param_names=["drop_x_pos", "drop_radius", "frame"],
        param_ranges=[[0.25, 0.75], [0.06, 0.15], [0.0, 3.0]],
        num_scenes=2, num_frames=4, resolution=[32, 24],
        num_channels=channels, v_range=[-1.0, 1.0],
        data_type="levelset" if levelset else "velocity",
        param_counts=[2, 1]), str(ds))
    key = "l" if levelset else "v"
    os.makedirs(ds / key)
    rng = np.random.default_rng(17)
    for k in range(8):
        np.savez(ds / key / f"{k // 4}_0_{k % 4}.npz",
                 x=rng.standard_normal((32, 24, channels)).astype(np.float32),
                 y=np.array([0.25 + 0.5 * (k // 4), 0.06, k % 4],
                            np.float32))
    return str(tmp_path / "data")


KNOB_FLAGS = dict(decoder="grid", grid_levels=4, grid_features=4, grid_rank=8,
                  embed_bands=8, spectral_modes=8, augment_flip_x=True)


@pytest.mark.cuda
def test_knob_step_kernels_match_plain(cuda_device, tmp_path, monkeypatch):
    # A knob step (all knobs and the flip) launches a plain step's kernels,
    # and its f32 loss and gradients equal the step through the plain ops.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    c = Config(data_dir=_tiny_set(tmp_path, "knobs", 2), dataset="knobs",
               filters=8, num_conv=1, batch_size=4, num_worker=1,
               log_dir=str(tmp_path), **KNOB_FLAGS)
    t = Trainer(c, device=cuda_device)
    gen = torch.Generator().manual_seed(19)
    with torch.no_grad():   # non-zero gains and bases
        for n, p in t.model.named_parameters():
            if "gain_" in n or n.startswith("basis_"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x, y = (torch.from_numpy(a).to(cuda_device) for a in t.bm.step_batch(1))
    zeros = dict.fromkeys(cuda_fd.launch_counts, 0)
    cuda_fd.reset_launch_counts()
    aux = t._train_step(x, y)
    torch.cuda.synchronize()
    assert np.isfinite(float(aux["loss"]))
    assert cuda_fd.launch_counts == {**zeros, "curl2d_fused": 1,
                                     "curl2d_bwd": 1, "jacobian2d_fused": 2,
                                     "jacobian2d_bwd": 1}
    results = []
    for plain in (False, True):
        if plain:
            for n in ("curl2d", "jacobian2d"):
                monkeypatch.setattr(cuda_fd, n + "_p", getattr(fd, n))
        t.model.zero_grad(set_to_none=True)
        loss, _ = t._loss_fn(t.model, x, y)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in
                                      t.model.named_parameters()}))
    (lk, gk), (lp, gp) = results
    assert abs(lk - lp) <= 1e-6 * abs(lp)
    # Against the step's gradient scale: a gain's gradient is a cancelling
    # sum of the spectrum, so its own largest entry is no scale (one read
    # 1.4e-5 of it from rounding alone); and conv_out's bias is the curl's
    # null direction.
    scale = max(float(g.abs().max()) for g in gp.values())
    for n in gk:
        assert float((gk[n] - gp[n]).abs().max()) <= 1e-5 * scale, n


@pytest.mark.cuda
def test_liquid_step_makes_zero_launches(cuda_device, tmp_path):
    # Config #3's route: no curl, the scalar gradient in plain torch, so a
    # step (also with the flip, from the device cache) and a generated
    # batch launch no FD kernel.
    c = Config(data_dir=_tiny_set(tmp_path, "liq", 1), dataset="liq",
               data_type="levelset", filters=8, num_conv=1, batch_size=4,
               num_worker=1, log_dir=str(tmp_path), augment_flip_x=True,
               device_data_cache=True)
    t = Trainer(c, device=cuda_device)
    zeros = dict.fromkeys(cuda_fd.launch_counts, 0)
    cuda_fd.reset_launch_counts()
    aux = t.train(num_steps=3)
    fields = t.generate(np.zeros((5, 3), np.float32))
    torch.cuda.synchronize()
    assert np.isfinite(aux["loss"]) and fields.shape == (5, 32, 24, 1)
    assert cuda_fd.launch_counts == zeros


@pytest.mark.cuda
def test_sweep_on_device_pins_its_host_buffer(cuda_device):
    from deepfluids_tpu_torch.infer.sweep import (
        param_grid,
        sweep_generator,
        sweep_on_device,
    )

    m = Manifest(param_names=["pos", "size", "frame"],
                 param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]],
                 num_scenes=6, num_frames=4, resolution=[16, 12],
                 num_channels=2, v_range=[-2.0, 2.0])
    w = torch.randn(3, 16 * 12 * 2, generator=torch.Generator().manual_seed(
        18))

    def apply_fn(p):
        return (p @ w.to(p.device)).view(-1, 16, 12, 2)

    raw = param_grid(m, (3, 2))
    got = sweep_on_device(apply_fn, m, raw, batch_size=5,
                          device=cuda_device)
    assert torch.from_numpy(got).is_pinned()       # one segment, no copy
    want = np.concatenate(list(sweep_generator(apply_fn, m, raw, 5,
                                               device="cpu")))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    seg = sweep_on_device(apply_fn, m, raw, batch_size=4,
                          max_out_bytes=1, device=cuda_device)
    np.testing.assert_allclose(seg, got, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_sweep_ring_copies_run_under_the_card(cuda_device, tmp_path):
    # A card held ~5 ms a batch by torch.cuda._sleep, each batch its own
    # params: more than 2 x RING_SLOTS batches through the ring give
    # sweep_generator's fields (no slot is overwritten before its copy);
    # under the profiler a sweep.host_copy span lies over a kernel row;
    # every copy but the drain's last ones starts with work on the card.
    import json

    from torch.profiler import ProfilerActivity, profile

    from deepfluids_tpu_torch.infer import sweep

    m = Manifest(param_names=["pos", "size", "frame"],
                 param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]],
                 num_scenes=18, num_frames=8, resolution=[128, 96],
                 num_channels=2, v_range=[-2.0, 2.0])
    w = torch.randn(3, 128 * 96 * 2, generator=torch.Generator().manual_seed(
        24)).to(cuda_device)

    def apply_fn(p):
        torch.cuda._sleep(10_000_000)
        return (p @ w).view(-1, 128, 96, 2)

    bs, batches = 16, 2 * sweep.RING_SLOTS + 3
    raw = sweep.param_grid(m, (6, 3))[:bs * batches - 5]   # partial last
    direct = sweep.sweep_on_device(apply_fn, m, raw, batch_size=bs,
                                   device=cuda_device)
    before = dict(sweep.overlap_counts)
    path = str(tmp_path / "t.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = sweep.sweep_on_device(apply_fn, m, raw, batch_size=bs,
                                    max_out_bytes=1, device=cuda_device)
    prof.export_chrome_trace(path)
    counts = {k: v - before[k] for k, v in sweep.overlap_counts.items()}
    assert not torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(got, direct)
    want = np.concatenate(list(sweep.sweep_generator(
        apply_fn, m, raw, bs, device=cuda_device)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert sum(counts.values()) == batches
    assert counts["overlapped"] >= batches - sweep.RING_SLOTS
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    copies = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "sweep.host_copy"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(copies) == batches
    assert any(k["ts"] < c["ts"] + c["dur"] and c["ts"] < k["ts"] + k["dur"]
               for c in copies for k in kernels)


# --- the datagen on the card -------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("ndim,shape", [(2, (3, 32, 24, 2)),
                                        (3, (2, 8, 12, 12, 3))])
def test_matched_projection_kernels_match_plain(cuda_device, ndim, shape,
                                                monkeypatch):
    # The projection's curl and its transpose through the kernels, against
    # the same projection through the plain ops.fd functions, on the card.
    from deepfluids_tpu_torch.datagen import projection

    torch.backends.cuda.matmul.allow_tf32 = False
    v = torch.from_numpy(np.random.default_rng(20).standard_normal(
        shape).astype(np.float32)).to(cuda_device)
    project = (projection.project_curl2d if ndim == 2
               else projection.project_curl3d)
    fwd, bwd = f"curl{ndim}d_fused", f"curl{ndim}d_bwd"
    project(v, cycles=1)                  # builds and caches the hierarchy
    setup = projection._mg_setup("curl_ls" if ndim == 2 else "curl3_ls",
                                 shape[1:-1] if ndim == 2 else shape[1:],
                                 torch.float32, v.device)
    cuda_fd.reset_launch_counts()
    out = project(v, cycles=4)
    # a V(2,2)-cycle: 4 smoothings and a residual on every level but the
    # coarsest, each one application of the fine operator
    want = 4 * 5 * (len(setup["shapes"]) - 1) + 1
    assert cuda_fd.launch_counts[fwd] == cuda_fd.launch_counts[bwd] == want
    assert setup is projection._mg_setup(
        "curl_ls" if ndim == 2 else "curl3_ls",
        shape[1:-1] if ndim == 2 else shape[1:], torch.float32, "cuda")
    # float64 takes the plain functions on the card too (a dtype rule)
    cuda_fd.reset_launch_counts()
    out64 = project(v.double(), cycles=4)
    assert out64.dtype == torch.float64
    assert not any(cuda_fd.launch_counts.values())
    assert float((out.double() - out64).norm() / out64.norm()) < 1e-4
    # and f32 does once the curl hooks are patched to their plain versions
    monkeypatch.setattr(projection, "_curl", lambda p: fd.curl2d(p[..., None]))
    monkeypatch.setattr(projection, "_curl_adj", projection._curl_adj_plain)
    monkeypatch.setattr(projection, "_curl3", fd.curl3d)
    monkeypatch.setattr(projection, "_curl3_adj", projection._curl3_adj_plain)
    plain = project(v, cycles=4)
    assert not any(cuda_fd.launch_counts.values())
    rel = float((out - plain).norm() / plain.norm())
    assert rel <= 1e-6, rel


@pytest.mark.cuda
def test_scene_function_defaults_to_the_card(cuda_device, tmp_path):
    from deepfluids_tpu_torch.data import load_manifest
    from deepfluids_tpu_torch.datagen import scenes

    cuda_fd.reset_launch_counts()
    out = scenes.smoke_pos21_size5(str(tmp_path), num_pos=2, num_size=1,
                                   num_frames=3, height=32, width=24,
                                   projection="matched", name="tiny")
    # the matched projection ran through the kernels: it was on the card
    assert cuda_fd.launch_counts["curl2d_fused"] > 0
    assert cuda_fd.launch_counts["curl2d_bwd"] > 0
    assert load_manifest(out).param_counts == [2, 1]
    ref = scenes.smoke_pos21_size5(str(tmp_path), num_pos=2, num_size=1,
                                   num_frames=3, height=32, width=24,
                                   projection="matched", name="ref",
                                   device="cpu")
    for name in sorted(os.listdir(os.path.join(out, "v"))):
        a = np.load(os.path.join(out, "v", name))["x"]
        b = np.load(os.path.join(ref, "v", name))["x"]
        assert check_fields(a[None], b[None])["passed"], name


def test_datagen_cli_raises_without_a_card(tmp_path):
    # Runs where there is no card: the CLI names the card and writes
    # nothing.  (Where there is one, the CLI's default is exercised above.)
    from deepfluids_tpu_torch.datagen import __main__ as cli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene", "liquid_pos10_size4", "--out", str(tmp_path),
                  "--num-a", "1", "--num-b", "1", "--num-frames", "2"])
    assert not os.listdir(tmp_path)


# --- the train step as a CUDA graph (train/graph.py) -------------------------

def _graph_pair(cfg: Config, device, k: int) -> tuple[Trainer, Trainer]:
    """Two trainers of ``cfg`` at ``--steps_per_call k``: one capturing
    its chunk body as a CUDA graph, one running that body uncaptured."""
    cfg = Config(**{**cfg.__dict__, "steps_per_call": k})
    out = []
    for tag, capture in (("g", True), ("e", False)):
        t = Trainer(Config(**{**cfg.__dict__, "tag": tag}), device=device)
        assert t.capture and t._lr is not None
        t.capture = capture
        out.append(t)
    return tuple(out)


def _same_state(got: Trainer, want: Trainer) -> None:
    assert got.step == want.step
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(got.model.state_dict()[k], v, atol=0,
                                   rtol=0, msg=k)
    ws, gs = want.opt.state_dict()["state"], got.opt.state_dict()["state"]
    for i, st in ws.items():
        for name, v in st.items():
            torch.testing.assert_close(gs[i][name], v, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("what", ["de_flip_clip_cache", "de_stream",
                                  "ae_pair_cache"])
def test_graph_equals_its_body_run_eagerly(cuda_device, tmp_path, what, k):
    # The replays of one captured chunk against the same body eagerly: the
    # same weights, Adam state and losses, bit for bit; the graph's FD
    # launches counted through capture x replays.
    if what.startswith("ae"):
        cfg = _mov_config(_tiny_mov(tmp_path), ae_pred_w=0.5,
                          device_data_cache=True)
    else:
        cfg = Config(data_dir=_tiny_set(tmp_path, "vel", 2), dataset="vel",
                     filters=8, num_conv=1, batch_size=4, num_worker=1,
                     log_dir=str(tmp_path), log_step=4,
                     augment_flip_x=what != "de_stream",
                     grad_clip=0.05 if "clip" in what else 0.0,
                     device_data_cache="cache" in what)
    g, e = _graph_pair(cfg, cuda_device, k)
    cuda_fd.reset_launch_counts()
    got = g.train(num_steps=12)
    torch.cuda.synchronize()
    assert g._chunks.graph is not None
    assert g._chunks.replays == 12 // k - 1
    step = {"curl2d_fused": 1, "curl2d_bwd": 1, "jacobian2d_fused": 2,
            "jacobian2d_bwd": 1}
    assert g._chunks.captured == {n: k * c for n, c in step.items()}
    zeros = dict.fromkeys(cuda_fd.launch_counts, 0)
    assert cuda_fd.launch_counts == {**zeros,
                                     **{n: 12 * c for n, c in step.items()}}
    want = e.train(num_steps=12)
    assert got == want
    _same_state(g, e)


@pytest.mark.cuda
def test_restore_drops_a_captured_graph(cuda_device, tmp_path):
    # A trainer that holds a captured graph restores a checkpoint (new Adam
    # state tensors) and trains on: the uninterrupted run's state.
    cfg = Config(data_dir=_tiny_set(tmp_path, "vel", 2), dataset="vel",
                 filters=8, num_conv=1, batch_size=4, num_worker=1,
                 log_dir=str(tmp_path), device_data_cache=True,
                 save_step=8, augment_flip_x=True)
    g, e = _graph_pair(cfg, cuda_device, 2)
    e.train(num_steps=16)
    g.train(num_steps=8)              # checkpoint at 8
    g.train(num_steps=4)              # a graph captured past it
    assert g._chunks.graph is not None
    assert g.restore_checkpoint(8) == 8 and g._chunks is None
    g.train(num_steps=8)
    assert g._chunks.graph is not None
    _same_state(g, e)


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda_device, tmp_path, monkeypatch):
    # A host read inside the captured body is refused by the capture: the
    # run raises (no eager fallback hides it).
    cfg = Config(data_dir=_tiny_set(tmp_path, "vel", 2), dataset="vel",
                 filters=8, num_conv=1, batch_size=4, num_worker=1,
                 log_dir=str(tmp_path), device_data_cache=True)
    t = Trainer(cfg, device=cuda_device)
    batch = t._cache_batch

    def reads_the_host(idx):
        float(idx.sum())
        return batch(idx)

    monkeypatch.setattr(t, "_cache_batch", reads_the_host)
    with pytest.raises(RuntimeError):
        t.train(num_steps=3)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_graph_spans_in_a_profiled_run(cuda_device, tmp_path):
    # --profile_steps over the warm-up, the capture and four replays: the
    # chunk feed's spans are user_annotation rows on the clock of the
    # kernel rows, none inside the capture; the trajectory is the one of
    # the run without the profiler; metrics.jsonl's host_s holds the
    # capture and the checkpoint.
    import glob
    import json

    from deepfluids_tpu_torch import spans

    spans.take()                  # what earlier tests left behind
    cfg = Config(data_dir=_tiny_set(tmp_path, "vel", 2), dataset="vel",
                 filters=8, num_conv=1, batch_size=4, num_worker=1,
                 log_dir=str(tmp_path), log_step=2, save_step=4,
                 device_data_cache=True, augment_flip_x=True)
    traced = Trainer(Config(**{**cfg.__dict__, "tag": "p",
                               "profile_steps": "1,6",
                               "profile_dir": str(tmp_path / "prof")}),
                     device=cuda_device)
    plain = Trainer(Config(**{**cfg.__dict__, "tag": "q"}),
                    device=cuda_device)
    assert traced.capture and plain.capture
    assert traced.train(num_steps=8) == plain.train(num_steps=8)
    _same_state(traced, plain)
    [path] = glob.glob(str(tmp_path / "prof" / "*.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    rows = sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train.")),
                  key=lambda e: e["ts"])
    named = {}
    for e in rows:
        named.setdefault(e["name"], []).append(e)
    assert len(named["train.block"]) == 6
    assert len(named["train.warmup"]) == len(named["train.capture"]) == 1
    assert len(named["train.replay"]) == 5
    assert len(named["train.fill"]) == 6
    [cap] = named["train.capture"]
    end = cap["ts"] + cap["dur"]
    assert not any(cap["ts"] <= e["ts"] < end for e in rows if e is not cap)
    # each replay's kernels start within a second of its span
    kernels = [e["ts"] for e in events if e.get("cat") == "kernel"]
    for r in named["train.replay"]:
        assert any(r["ts"] <= k <= r["ts"] + 1e6 for k in kernels)
    assert 0 < traced._chunks.capture_s <= cap["dur"] * 1e-6
    with open(os.path.join(traced.run_dir, "metrics.jsonl")) as f:
        host = [json.loads(ln)["host_s"] for ln in f]
    assert host[0]["train.capture"] == pytest.approx(
        traced._chunks.capture_s, abs=2e-6)
    assert host[2]["train.checkpoint"] > 0          # saved after step 4


@pytest.mark.cuda
def test_no_garbage_collection_inside_a_capture(cuda_device, tmp_path,
                                                 monkeypatch):
    # A finished trainer lives on in a reference cycle (the trainer and
    # its StepGraph) until the collector runs; a collection inside another
    # trainer's capture would free that graph there and invalidate the
    # capture. The collector is off in the captured body, on after it.
    import gc

    from deepfluids_tpu_torch.train import graph

    cfg = Config(data_dir=_tiny_set(tmp_path, "vel", 2), dataset="vel",
                 filters=8, num_conv=1, batch_size=4, num_worker=1,
                 log_dir=str(tmp_path), device_data_cache=True)
    t = Trainer(cfg, device=cuda_device)
    body, seen = graph.StepGraph._body, []

    def watched(self):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return body(self)

    monkeypatch.setattr(graph.StepGraph, "_body", watched)
    assert gc.isenabled()
    t.train(num_steps=3)
    assert t._chunks.graph is not None
    assert seen == [(False, True), (True, False)]
    assert gc.isenabled()


# --- the conv stack's memory layout ------------------------------------------

LAYOUT_TRANSPOSE = ("nchwToNhwc", "nhwcToNchw")
# The transposes left in a step: cuDNN's engines for the 2D conv_out, whose
# one output channel makes [B, 1, H, W] the same bytes in either layout,
# convert that map in the forward and its gradient twice in the backward.
# The 3D conv_out (three channels) takes NDHWC engines.
ONE_CHANNEL_TRANSPOSES = {2: 3, 3: 0}


def _transposes(names: list[str]) -> int:
    return sum(any(t in n for t in LAYOUT_TRANSPOSE) for n in names)


def _field_set(tmp_path, name: str, grid: tuple, frames: int) -> str:
    """A one-scene velocity set of ``frames`` random fields of ``grid``
    with (src_x_pos, src_radius, frame) params; its data dir."""
    ds = tmp_path / "data" / name
    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, frames - 1.0]],
        num_scenes=1, num_frames=frames, resolution=list(grid),
        num_channels=len(grid), v_range=[-1.0, 1.0],
        data_type="velocity"), str(ds))
    os.makedirs(ds / "v")
    rng = np.random.default_rng(len(grid))
    for t in range(frames):
        np.savez(ds / "v" / f"0_0_{t}.npz",
                 x=rng.standard_normal(grid + (len(grid),)).astype(
                     np.float32),
                 y=np.array([0.5, 0.08, t], np.float32))
    return str(tmp_path / "data")


def _kernel_rows(fn, tmp_path, tag: str) -> list[str]:
    """The names of the kernels ``fn()`` runs, from a profiler's trace."""
    import json

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = str(tmp_path / f"{tag}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(128, 96), (32, 64, 112)],
                         ids=["2d", "3d"])
def test_conv_stack_runs_without_layout_transposes(cuda_device, tmp_path,
                                                   grid):
    # The flagship step (bf16, batch 8, the device cache) as a captured
    # graph, profiled over one train() call (the eager warm-up step, the
    # capture, two replays): its convs count channels-last, once in the
    # warm-up and once at the capture; no 128-channel map is transposed;
    # the replays stay bit-equal to the body run eagerly.
    from deepfluids_tpu_torch.parallel import layers

    cfg = Config(data_dir=_field_set(tmp_path, "flag", grid, 8),
                 dataset="flag", num_worker=1, log_dir=str(tmp_path),
                 device_data_cache=True)
    g, e = _graph_pair(cfg, cuda_device, 1)
    convs = sum(isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))
                for m in g.model.modules())
    layers.layout_counts.update(channels_last=0, other=0)
    names = _kernel_rows(lambda: g.train(num_steps=3), tmp_path, "step")
    assert g._chunks.graph is not None and g._chunks.replays == 2
    assert layers.layout_counts == {"channels_last": 2 * convs, "other": 0}
    assert any("fprop" in n or "conv" in n.lower() for n in names)
    assert _transposes(names) == 3 * ONE_CHANNEL_TRANSPOSES[len(grid)]
    e.train(num_steps=3)
    _same_state(g, e)


@pytest.mark.cuda
def test_batch_512_forward_runs_without_layout_transposes(cuda_device,
                                                          tmp_path):
    # The sweep's forward: the flagship 2D generator in bf16 at batch 512.
    from deepfluids_tpu_torch.parallel import layers

    model = GeneratorBE((128, 96, 1), num_param=3,
                        compute_dtype=torch.bfloat16).to(cuda_device)
    z = torch.rand((512, 3), device=cuda_device) * 2 - 1
    with torch.no_grad():
        model(z)                                 # cuDNN's first choices
        layers.layout_counts.update(channels_last=0, other=0)
        names = _kernel_rows(lambda: model(z), tmp_path, "forward")
    assert layers.layout_counts == {"channels_last": 21, "other": 0}
    assert _transposes(names) == 1          # conv_out's output, as above


# One autoencoder step of config #4 (128 x 96, 128 filters, 4 convs a stage,
# 5 stages, z_num 16, bf16, batch 8, the device cache), as the card showed
# it: all 46 conv calls of a forward take a channels-last map (the encoder's
# 25 too: its NHWC field permuted, and the F.pad before each stride-2 down
# keeps the layout; its weights stay contiguous), and of the device rows the
# benchmark's ``layout_transpose`` group takes
# (``nchwToNhwc|nhwcToNchw|transpose``) a step runs the decoder's conv_out
# three, as the 2D generator does (ONE_CHANNEL_TRANSPOSES): the encoder adds
# none.
AE_STEP_LAYOUTS = {"channels_last": 46, "other": 0}
AE_STEP_TRANSPOSES = 3
_TRANSPOSE_ROW = re.compile(r"nchwToNhwc|nhwcToNchw|transpose")


@pytest.mark.cuda
def test_ae_graph_step_layouts(cuda_device, tmp_path):
    # One train() call of the graph step (the eager warm-up step, the
    # capture, two replays), profiled: the layouts are counted in the
    # warm-up and at the capture, the transposes run in every step; the
    # replays stay bit-equal to the body run eagerly.
    from deepfluids_tpu_torch.parallel import layers

    cfg = Config(arch="ae", z_num=16,
                 data_dir=_field_set(tmp_path, "mov", (128, 96), 8),
                 dataset="mov", num_worker=1, log_dir=str(tmp_path),
                 device_data_cache=True)
    g, e = _graph_pair(cfg, cuda_device, 1)
    layers.layout_counts.update(channels_last=0, other=0)
    names = _kernel_rows(lambda: g.train(num_steps=3), tmp_path, "ae_step")
    assert g._chunks.graph is not None and g._chunks.replays == 2
    assert layers.layout_counts == {k: 2 * v
                                    for k, v in AE_STEP_LAYOUTS.items()}
    rows = [n for n in names if _TRANSPOSE_ROW.search(n)]
    assert len(rows) == 3 * AE_STEP_TRANSPOSES, sorted(set(rows))
    e.train(num_steps=3)
    _same_state(g, e)


# --- the conv stack's epilogue: bias add + leaky ReLU in one pass ----------

# The maps [B, C, *spatial] of the three cells' conv stacks: the 2D step's
# batch 8 and the sweep's 512 at each stage, the 3D step's 8 at each stage.
EPILOGUE_CELL_SHAPES = (
    [(b, 128, 8 << s, 6 << s) for b in (8, 512) for s in range(5)]
    + [(8, 128, 4 << s, 8 << s, 14 << s) for s in range(4)])


def _epilogue_maps(shape, channels_last, dtype, device, seed):
    """A map of ``shape`` in the layout, a twentieth of it exact zeros of
    either sign, a tenth cancelling its bias exactly; the bias (a zero and
    a negative zero channel); a gradient map of the same layout."""
    from deepfluids_tpu_torch.ops import bias_act

    gen = torch.Generator(device=device).manual_seed(seed)
    nd = len(shape) - 2
    phys = (shape[:1] + shape[2:] + shape[1:2]) if channels_last else shape

    def make():
        x = torch.randn(phys, generator=gen, device=device)
        hit = torch.rand(phys, generator=gen, device=device)
        x = torch.where(hit < 0.025, 0.0, torch.where(hit < 0.05, -0.0, x))
        x = x.to(dtype)
        return x.permute(0, nd + 1, *range(1, nd + 1)) if channels_last else x

    x, g = make(), make()
    b = torch.randn(shape[1], generator=gen, device=device).to(dtype)
    b[0], b[-1] = 0.0, -0.0
    cancel = torch.rand(x.shape, generator=gen, device=device) < 0.1
    x.copy_(torch.where(cancel, -bias_act.add_bias(torch.zeros_like(x), b),
                        x))
    return x, b, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EPILOGUE_CELL_SHAPES + [
    (2, 128, 64, 48), (2, 128, 16, 32, 56), (3, 12, 9, 37), (2, 3, 5, 6, 7),
    (2, 24, 5, 7)])
def test_epilogue_kernels_bit_equal_to_plain(cuda_device, shape, dtype):
    # Both kernels against their plain versions, channels-last (the cells'
    # layout) and contiguous NC(D)HW (the sharded paths), bit for bit; the
    # backward also against the parent's where() of the pre-activation, so
    # at 0 and -0.0 its gradient is 1.
    from deepfluids_tpu_torch.ops import bias_act

    for last in (True, False):
        x, b, g = _epilogue_maps(shape, last, dtype, cuda_device,
                                 seed=len(shape) + shape[1])
        lay = bias_act.layout(x)
        before = dict(bias_act.launch_counts)
        y = bias_act.bias_leaky_relu_fwd(x, b, 0.2)
        dx = bias_act.leaky_relu_bwd(y, g, 0.2)
        torch.cuda.synchronize()
        assert bias_act.launch_counts[f"bias_leaky_relu_fwd.{lay}"] == (
            before[f"bias_leaky_relu_fwd.{lay}"] + 1)
        assert bias_act.launch_counts[f"leaky_relu_bwd.{lay}"] == (
            before[f"leaky_relu_bwd.{lay}"] + 1)
        want = bias_act.bias_leaky_relu_plain(x, b, 0.2)
        assert y.stride() == x.stride()
        assert torch.equal(y, want)
        assert torch.equal(torch.signbit(y), torch.signbit(want))
        assert torch.equal(dx, bias_act.leaky_relu_bwd_plain(y, g, 0.2))
        t = bias_act.add_bias(x, b)
        assert torch.equal(dx, torch.where(t >= 0, g, g * 0.2))
        zero = t == 0
        assert zero.any() and torch.equal(dx[zero], g[zero])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nd", [2, 3])
def test_epilogue_forward_bit_equal_to_aten_on_cudnn_output(cuda_device, nd,
                                                            dtype):
    # The parent's arithmetic on the card: cuDNN's conv output, the bias
    # added by aten's add_, then F.leaky_relu.
    import torch.nn.functional as F

    from deepfluids_tpu_torch.ops import bias_act

    gen = torch.Generator(device=cuda_device).manual_seed(nd)
    shape = (8, 128, 32, 24) if nd == 2 else (8, 128, 8, 16, 28)
    fmt = torch.channels_last if nd == 2 else torch.channels_last_3d
    conv = F.conv2d if nd == 2 else F.conv3d
    x = torch.randn(shape, generator=gen, device=cuda_device).to(
        dtype).contiguous(memory_format=fmt)
    w = (torch.randn((128, 128) + (3,) * nd, generator=gen,
                     device=cuda_device) * (128 * 3 ** nd) ** -0.5).to(
        dtype).contiguous(memory_format=fmt)
    b = (0.1 * torch.randn(128, generator=gen, device=cuda_device)).to(dtype)
    c = conv(x, w, padding=1)
    got = bias_act.bias_leaky_relu_fwd(c, b, 0.2)
    want = F.leaky_relu(c.clone().add_(b.view((1, -1) + (1,) * nd)), 0.2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(128, 96), (32, 64, 112)],
                         ids=["2d", "3d"])
def test_epilogue_launch_counts_forward_and_capture(cuda_device, tmp_path,
                                                    grid):
    # One flagship generator forward launches the forward kernel once a
    # conv_{stage}_{c} (20 in 2D, 16 in 3D), channels-last; a step graph's
    # train() call (the eager warm-up step and the capture) launches each
    # kernel that many times a step, counted once at the capture.
    from deepfluids_tpu_torch.ops import bias_act

    per = {2: 20, 3: 16}[len(grid)]
    model = GeneratorBE(grid + ((1,) if len(grid) == 2 else (3,)),
                        num_param=3,
                        compute_dtype=torch.bfloat16).to(cuda_device)
    z = torch.rand((2, 3), device=cuda_device) * 2 - 1
    bias_act.reset_launch_counts()
    with torch.no_grad():
        model(z)
    torch.cuda.synchronize()
    zeros = dict.fromkeys(bias_act.launch_counts, 0)
    assert bias_act.launch_counts == {
        **zeros, "bias_leaky_relu_fwd.channels_last": per}
    cfg = Config(data_dir=_field_set(tmp_path, "flag", grid, 8),
                 dataset="flag", num_worker=1, log_dir=str(tmp_path),
                 device_data_cache=True)
    g, _ = _graph_pair(cfg, cuda_device, 1)
    bias_act.reset_launch_counts()
    g.train(num_steps=3)
    torch.cuda.synchronize()
    assert g._chunks.graph is not None and g._chunks.replays == 2
    assert bias_act.launch_counts == {
        **zeros, "bias_leaky_relu_fwd.channels_last": 2 * per,
        "leaky_relu_bwd.channels_last": 2 * per}
