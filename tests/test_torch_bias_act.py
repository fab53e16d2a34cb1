"""The conv stack's bias add and leaky ReLU in one pass
(``ops/bias_act.py``, ``models/activation.bias_leaky_relu``) on the CPU.

* ``csrc/epilogue.cu`` itself, compiled by g++ against the stand-in CUDA
  headers of ``test_torch_fd2d_emulated.py`` (its kernels use no shared
  memory, barriers or warp intrinsics, so running every thread in turn is
  exact), through the wrapper's own launch helpers: bit-equal to the plain
  versions in every layout, dtype and vector path, exact zeros included.
* The autograd function against the composition it replaces (the conv's
  bias added by aten, then ``activation.leaky_relu``): the same output and
  input gradient bit for bit, the bias gradient to the order of its sum,
  the gradient 1 at 0 and -0.0; against a conv that adds its own bias,
  within a rounding.
* ``GeneratorBE`` (2D and 3D) and the autoencoder forward and backward bit
  for bit against that composition; the smooth stand-in's swap is live.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepfluids_tpu_torch.models import Autoencoder, GeneratorBE, activation
from deepfluids_tpu_torch.models.generator import ACT_SLOPE, flax_init_
from deepfluids_tpu_torch.ops import _build, bias_act
from test_torch_fd2d_emulated import CUDA_BF16_H, CUDA_RUNTIME_H, LAUNCH

SLOPE = 0.2
DTYPES = [torch.float32, torch.bfloat16]
# (spatial, channels-last) of the maps: NHWC, NDHWC, NCHW, NCDHW
LAYOUTS = {"nhwc": ((20, 44), True), "ndhwc": ((4, 10, 22), True),
           "nchw": ((20, 44), False), "ncdhw": ((4, 10, 22), False)}
# 128: the models' width, 16-byte vectors of one pixel whose biases stay in
# a thread's registers; 24: vectors whose first channel moves along the
# grid's stride (C / 8 = 3 does not divide it); 12: no bf16 vectors in
# channels-last; 3: none at all
CHANNELS = [128, 24, 12, 3]

# The device query the epilogue's launch sizing makes: one SM, so a launch
# holds 64 blocks (16 384 threads) and the maps below span more than one
# grid stride of 4 vectors a thread.
EMU_EXTRA = r"""
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return cudaSuccess;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' source for the CPU")
    work = tmp_path_factory.mktemp("epilogue_emu")
    (work / "cuda_runtime.h").write_text(CUDA_RUNTIME_H + EMU_EXTRA)
    (work / "cuda_bf16.h").write_text(CUDA_BF16_H)
    with open(os.path.join(_build.CSRC_DIR, "epilogue.cu")) as f:
        src = f.read()
    assert len(LAUNCH.findall(src)) == 3, "a launch the rewrite missed"
    (work / "epilogue.cc").write_text(LAUNCH.sub(r"emu_launch(\2, &\1, ",
                                                 src))
    lib = work / "libepilogue_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", str(work),
         "-o", str(lib), str(work / "epilogue.cc")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    so.emu_launch_count.argtypes = []
    so.emu_launch_count.restype = ctypes.c_longlong
    for name in ("df_bias_leaky_relu_fwd", "df_leaky_relu_bwd"):
        restype, argtypes = _build._SIGNATURES[name]
        getattr(so, name).restype = restype
        getattr(so, name).argtypes = argtypes
    return so


def _map(spatial, c, channels_last, dtype, seed, batch=5, skip=0):
    """A random ``[batch, c, *spatial]`` map in the layout, its storage
    ``skip`` elements past the allocation, with exact zeros of both signs
    in a twentieth of its entries."""
    rng = np.random.default_rng(seed)
    nd = len(spatial)
    shape = (batch, c) + tuple(spatial)
    phys = ((batch,) + tuple(spatial) + (c,)) if channels_last else shape
    n = int(np.prod(shape))
    a = rng.standard_normal(n + skip).astype(np.float32)
    hit = rng.random(n + skip) < 0.05
    a[hit] = np.where(rng.random(int(hit.sum())) < 0.5, 0.0, -0.0)
    t = torch.from_numpy(a).to(dtype)[skip:].view(phys)
    if channels_last:
        t = t.permute(0, nd + 1, *range(1, nd + 1))
    assert bias_act.layout(t) == ("channels_last" if channels_last and c > 1
                                  else "contiguous")
    return t


def _bias(c, dtype, seed):
    """A random bias with a zero and a negative zero channel."""
    b = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        c).astype(np.float32))
    b[0], b[-1] = 0.0, -0.0
    return b.to(dtype)


def _cancel(x, b):
    """``x``, in place (its layout and storage kept), with a tenth of its
    entries set to ``-bias``: the add is then an exact zero."""
    mask = torch.rand(x.shape, generator=torch.Generator().manual_seed(3))
    want = (-b).view((1, -1) + (1,) * (x.dim() - 2)).expand_as(x)
    return x.copy_(torch.where(mask < 0.1, want, x))


def _launch_fwd(so, x, b):
    before = so.emu_launch_count()
    y = bias_act.run_fwd(so, x, b, SLOPE, None)
    assert so.emu_launch_count() == before + 1, "one launch a call"
    return y


@pytest.mark.parametrize("skip", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("lay", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_emulated_forward_is_bit_equal_to_plain(emulated, dtype, lay, c,
                                                skip):
    spatial, last = LAYOUTS[lay]
    b = _bias(c, dtype, seed=c)
    x = _cancel(_map(spatial, c, last, dtype, seed=c + len(spatial),
                     skip=skip), b)
    assert (x.data_ptr() % 16 == 0) == (skip == 0)
    got = _launch_fwd(emulated, x, b)
    want = bias_act.bias_leaky_relu_plain(x, b, SLOPE)
    assert got.stride() == x.stride()
    assert torch.equal(got, want)
    # the signs of the zeros too
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("skip", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("tail", [0, 5], ids=["whole", "tail"])
@pytest.mark.parametrize("lay", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_emulated_backward_is_bit_equal_to_plain(emulated, dtype, lay, tail,
                                                 skip):
    # tail: a last spatial extent of 44 + 5, so the element count is no
    # multiple of a vector and the last elements go one at a time
    spatial, last = LAYOUTS[lay]
    spatial = spatial[:-1] + (spatial[-1] + tail,)
    c = 128 if tail == 0 else 3
    x = _map(spatial, c, last, dtype, seed=11, skip=skip)
    y = bias_act.bias_leaky_relu_plain(x, _bias(c, dtype, 5), SLOPE)
    g = _map(spatial, c, last, dtype, seed=12, skip=skip)
    before = emulated.emu_launch_count()
    got = bias_act.run_bwd(emulated, y, g, SLOPE, None)
    assert emulated.emu_launch_count() == before + 1
    want = bias_act.leaky_relu_bwd_plain(y, g, SLOPE)
    assert got.stride() == y.stride()
    assert torch.equal(got, want)
    zero = y == 0
    assert zero.any() and torch.equal(got[zero], g[zero])


# -- the autograd function ------------------------------------------------

def _unfused(x, b, slope):
    """The composition the fused function replaces: the conv's bias added
    by aten, then the models' leaky ReLU."""
    return activation.leaky_relu(bias_act.add_bias(x, b), slope)


def _grads(fn, x, b, g):
    x = x.detach().clone().requires_grad_()
    b = b.detach().clone().requires_grad_()
    y = fn(x, b, SLOPE)
    y.backward(g)
    return y.detach(), x.grad, b.grad


@pytest.mark.parametrize("c", [128, 12])
@pytest.mark.parametrize("lay", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fused_equals_the_composition_it_replaces(dtype, lay, c):
    spatial, last = LAYOUTS[lay]
    b = _bias(c, dtype, seed=1)
    x = _cancel(_map(spatial, c, last, dtype, seed=2), b)
    g = _map(spatial, c, last, dtype, seed=4)
    y, dx, db = _grads(activation.bias_leaky_relu, x, b, g)
    wy, wdx, wdb = _grads(_unfused, x, b, g)
    assert y.stride() == x.stride()
    assert torch.equal(y, wy) and torch.equal(dx, wdx)
    assert db.dtype == dtype
    torch.testing.assert_close(db.float(), wdb.float(), rtol=1e-5,
                               atol=1e-5 * float(wdb.float().abs().max()))


@pytest.mark.parametrize("lay", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gradient_is_one_at_zero_and_negative_zero(dtype, lay):
    # As jax.nn.leaky_relu's: 1 where the pre-activation is 0 or -0.0
    # (zero inputs on zero biases, inputs that cancel their bias), where
    # F.leaky_relu's is the slope.
    spatial, last = LAYOUTS[lay]
    b = _bias(8, dtype, seed=6)
    x = _cancel(_map(spatial, 8, last, dtype, seed=7), b)
    t = bias_act.add_bias(x, b)
    zero = t == 0
    assert zero.any() and torch.signbit(t[zero]).any()
    assert (~torch.signbit(t[zero])).any()
    g = torch.ones_like(x)
    _, dx, _ = _grads(activation.bias_leaky_relu, x, b, g)
    assert torch.equal(dx[zero], g[zero])
    assert torch.equal(dx[t < 0], torch.full_like(dx[t < 0], SLOPE))


def _conv_pair(nd, c, dtype, channels_last, seed):
    gen = torch.Generator().manual_seed(seed)
    shape = (2, c) + ((10, 12) if nd == 2 else (4, 6, 5))
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (torch.randn((c, c) + (3,) * nd, generator=gen)
         * (c * 3 ** nd) ** -0.5).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen)).to(dtype)
    if channels_last:
        fmt = torch.channels_last if nd == 2 else torch.channels_last_3d
        x, w = (t.contiguous(memory_format=fmt) for t in (x, w))
    return x, w, b


@pytest.mark.parametrize("c", [128, 12])
@pytest.mark.parametrize("lay", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fused_conv_matches_a_conv_that_adds_its_bias(dtype, lay, c):
    # The parent layer: a conv given its bias, then activation.leaky_relu.
    # The CPU's convolution may start its sum from the bias (before its own
    # rounding), so the outputs differ by a few roundings of the sum: within
    # two ulps of the magnitude of its terms.
    spatial, last = LAYOUTS[lay]
    nd = len(spatial)
    conv = F.conv2d if nd == 2 else F.conv3d
    x, w, b = _conv_pair(nd, c, dtype, last, seed=c + nd)
    runs = []
    for fused in (True, False):
        xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
        if fused:
            y = activation.bias_leaky_relu(conv(xs, ws, padding=1), bs,
                                           SLOPE)
        else:
            y = activation.leaky_relu(conv(xs, ws, bs, padding=1), SLOPE)
        (y.float() * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum(
            ).backward()
        runs.append((y.detach().float(), xs.grad.float(), ws.grad.float(),
                     bs.grad.float()))
    ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8
    y, wy = runs[0][0], runs[1][0]
    mag = bias_act.add_bias(conv(x.float().abs(), w.float().abs(),
                                 padding=1), b.float().abs())
    assert ((y - wy).abs() <= 2 * ulp * mag).all()
    # gradients, by the norm of their distance: as far as the rounding, and
    # in bf16 the kink's other slope at a pre-activation within that
    # rounding of 0, moves them (f32 reads 0 for the input and weight, under
    # 3e-7 for the bias; bf16 up to 1.6e-2 in 3D, where the CPU's two convs
    # also round their backward otherwise)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for got, want in zip(runs[0][1:], runs[1][1:]):
        assert float((got - want).norm() / want.norm()) <= tol


# -- the models -------------------------------------------------------------

@pytest.fixture
def unfused_hook(monkeypatch):
    """Swaps the models' hook for the composition it replaces."""
    def swap():
        monkeypatch.setattr(activation, "bias_leaky_relu", _unfused)
    return swap


def _random_biases(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _step(model, inputs):
    model.zero_grad(set_to_none=True)
    out = model(inputs)
    out = out if isinstance(out, tuple) else (out,)
    sum((o.float() * torch.linspace(-1, 1, o.numel()).view(o.shape)).sum()
        for o in out).backward()
    return ([o.detach() for o in out],
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None})


GRIDS = {"2d": (32, 24, 1), "3d": (8, 16, 16, 3)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_generator_equals_the_composition_it_replaces(grid, dtype,
                                                      unfused_hook):
    # Every conv_{stage}_{c} through the fused function: output and every
    # parameter's gradient bit for bit as with the conv's bias added by
    # aten and then the models' leaky ReLU.
    model = _random_biases(flax_init_(GeneratorBE(
        GRIDS[grid], num_param=3, filters=16, num_conv=2,
        compute_dtype=dtype), 0), 1)
    z = torch.rand((2, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    got = _step(model, z)
    unfused_hook()
    want = _step(model, z)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        torch.testing.assert_close(got[1][k], want[1][k], rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_autoencoder_equals_the_composition_it_replaces(dtype,
                                                        unfused_hook):
    # The encoder's conv_{stage}_{c} and down_{stage} and the decoder's
    # convs through the fused function, bit for bit.
    model = _random_biases(flax_init_(Autoencoder(
        (32, 24, 1), in_channels=2, z_num=8, filters=8, num_conv=2,
        compute_dtype=dtype), 0), 3)
    x = torch.randn((2, 32, 24, 2), generator=torch.Generator().manual_seed(4))
    got = _step(model, x)
    unfused_hook()
    want = _step(model, x)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    for k in want[1]:
        torch.testing.assert_close(got[1][k], want[1][k], rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_smooth_hook_swap_is_live(grid, monkeypatch):
    # The stand-in set on the module reaches every conv: the output moves,
    # and equals the generator run with smooth() of the biased map.
    model = _random_biases(flax_init_(GeneratorBE(
        GRIDS[grid], num_param=3, filters=8, num_conv=2), 0), 5)
    z = torch.rand((2, 3), generator=torch.Generator().manual_seed(6)) * 2 - 1
    leaky = model(z).detach()
    calls = []

    def smooth(x, b, slope):
        calls.append(x.shape)
        return activation.bias_smooth(x, b, slope)

    monkeypatch.setattr(activation, "bias_leaky_relu", smooth)
    out = model(z).detach()
    assert len(calls) == model.repeat * model.num_conv
    assert float((out - leaky).abs().max()) > 1e-3 * float(leaky.abs().max())
    monkeypatch.setattr(activation, "bias_leaky_relu",
                        lambda x, b, s: activation.smooth(
                            bias_act.add_bias(x, b), s))
    assert torch.equal(model(z).detach(), out)


# -- refusals -------------------------------------------------------------

def test_refuses_other_layouts_dtypes_and_biases():
    x = torch.randn(2, 8, 6, 5)
    b = torch.randn(8)
    with pytest.raises(ValueError):                     # N, W, H, C order
        bias_act.bias_leaky_relu_fwd(x.permute(0, 1, 3, 2), b, SLOPE)
    with pytest.raises(ValueError):                     # a strided view
        bias_act.bias_leaky_relu_fwd(x[:, :, ::2], b, SLOPE)
    with pytest.raises(ValueError):                     # [B, C]
        bias_act.bias_leaky_relu_fwd(x[:, :, 0, 0], b, SLOPE)
    with pytest.raises(TypeError):
        bias_act.bias_leaky_relu_fwd(x.double(), b.double(), SLOPE)
    with pytest.raises(ValueError):                     # another width
        bias_act.bias_leaky_relu_fwd(x, b[:4], SLOPE)
    with pytest.raises(ValueError):                     # another dtype
        bias_act.bias_leaky_relu_fwd(x, b.bfloat16(), SLOPE)
    y = bias_act.bias_leaky_relu_fwd(x, b, SLOPE)
    with pytest.raises(ValueError):                     # g in another layout
        bias_act.leaky_relu_bwd(
            y, y.contiguous(memory_format=torch.channels_last), SLOPE)
    # a map of one channel is both layouts, indexed alike
    one = torch.randn(2, 1, 6, 5).contiguous(memory_format=torch.channels_last)
    assert bias_act.layout(one) == "contiguous"


def test_backward_takes_a_gradient_in_another_layout():
    # A gradient that reaches the function in another layout than its
    # output is copied into the output's before the backward pass.
    x = torch.randn(2, 8, 6, 5).contiguous(memory_format=torch.channels_last)
    b = torch.randn(8, requires_grad=True)
    xs = x.clone().requires_grad_()
    y = activation.bias_leaky_relu(xs, b, SLOPE)
    g = torch.randn(y.shape)                             # NCHW
    y.backward(g)
    ws = x.clone().requires_grad_()
    bw = b.detach().clone().requires_grad_()
    _unfused(ws, bw, SLOPE).backward(g)
    assert torch.equal(xs.grad, ws.grad)
    torch.testing.assert_close(b.grad, bw.grad, rtol=1e-6, atol=1e-6)
    assert ACT_SLOPE == SLOPE
