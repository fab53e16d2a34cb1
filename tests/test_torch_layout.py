"""The generator's memory layout on the CPU: every feature map and conv
weight of ``GeneratorBE`` lies channels-last (NHWC / NDHWC), the layout of
cuDNN's tensor-core convs, so that no conv is wrapped in transposes; the
layout changes no number.  The card's own check (no transpose kernels in
a profiled step) is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from deepfluids_tpu_torch.models import (
    Autoencoder,
    GeneratorBE,
    flax_init_,
    load_flax_npz,
    save_flax_npz,
)
from deepfluids_tpu_torch.models.generator import upscale_nearest
from deepfluids_tpu_torch.parallel import layers

SHAPE = {2: (32, 24, 1), 3: (8, 16, 16, 3)}


def _repeat_interleave(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """The upsample as it was written first: one gather per spatial axis."""
    for dim in range(2, x.dim()):
        x = x.repeat_interleave(factor, dim=dim)
    return x


def _conv_weights(model: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    return {n: p for n, p in model.named_parameters()
            if n.endswith("weight") and p.dim() >= 4}


@pytest.mark.parametrize("last", [False, True], ids=["nchw", "last"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_upscale_nearest_keeps_the_layout(ndim, last):
    gen = torch.Generator().manual_seed(ndim)
    x = torch.randn((2, 6) + (3, 5, 4)[:ndim], generator=gen)
    if last:
        x = x.contiguous(memory_format=layers.memory_format(x.dim()))
    g = torch.randn((2, 6) + (6, 10, 8)[:ndim], generator=gen)
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    y, want = upscale_nearest(a), _repeat_interleave(b)
    assert torch.equal(y, want)
    assert layers.is_channels_last(y) == last
    assert y.is_contiguous() == (not last)
    y.backward(g)
    want.backward(g)
    # a sum of 2**ndim copies, in another order
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def _model(kind: str, dtype: torch.dtype) -> tuple[torch.nn.Module, tuple]:
    """A small generator (or the AE's decoder) and its input's shape."""
    if kind == "ae_decoder":
        ae = Autoencoder((32, 24, 1), in_channels=2, z_num=4, filters=8,
                         num_conv=2, compute_dtype=dtype)
        return flax_init_(ae, 0).decoder, (3, 4)
    nd = int(kind[0])
    knobs = dict(spectral_modes=3, grid_levels=2, grid_features=2,
                 grid_rank=2) if kind.endswith("knobs") else {}
    return flax_init_(GeneratorBE(SHAPE[nd], filters=8, num_conv=2,
                                  compute_dtype=dtype, **knobs), 0), (3, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["2d", "3d", "2d_knobs", "3d_knobs",
                                  "ae_decoder"])
def test_every_generator_conv_runs_channels_last(kind, dtype):
    model, zshape = _model(kind, dtype)
    weights = _conv_weights(model)
    assert weights and all(layers.is_channels_last(w)
                           for w in weights.values())
    convs = len(weights)
    layers.layout_counts.update(channels_last=0, other=0)
    out = model(torch.randn(zshape, generator=torch.Generator()
                            .manual_seed(1)))
    assert layers.layout_counts == {"channels_last": convs, "other": 0}
    assert out.dtype == torch.float32 and out.is_contiguous()
    out.square().sum().backward()
    for name, w in weights.items():
        assert layers.is_channels_last(w.grad), name


def test_weights_npz_is_the_same_in_either_layout(tmp_path):
    # The same weights held contiguous NCHW (as earlier versions of the
    # model held them) and channels-last write the same arrays, and a file
    # loads back into the channels-last layout.
    last = flax_init_(GeneratorBE(SHAPE[2], filters=8, num_conv=2,
                                  spectral_modes=3), 0)
    nchw = GeneratorBE(SHAPE[2], filters=8, num_conv=2, spectral_modes=3)
    for name, w in _conv_weights(nchw).items():
        module = nchw.get_submodule(name.rpartition(".")[0])
        module.weight = torch.nn.Parameter(w.detach().contiguous())
    nchw.load_state_dict(last.state_dict())
    assert not any(layers.is_channels_last(w)
                   for w in _conv_weights(nchw).values())
    paths = [save_flax_npz(m, str(tmp_path / f"{tag}.npz"))
             for tag, m in (("last", last), ("nchw", nchw))]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert a.files == b.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    back = load_flax_npz(paths[1], GeneratorBE(SHAPE[2], filters=8,
                                               num_conv=2, spectral_modes=3))
    for k, v in last.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert all(layers.is_channels_last(w)
               for w in _conv_weights(back).values())
