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

from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
from deepfluids_tpu_torch.ops import cuda_fd, fd
from deepfluids_tpu_torch.train.losses import apply_curl
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
def test_curl2d_kernel_refuses_grad(cuda_device):
    psi = torch.zeros(1, 8, 8, 1, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        cuda_fd.curl2d_fused(psi)


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
