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
