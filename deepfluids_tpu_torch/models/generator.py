"""GeneratorBE — the parameterized field decoder (arch "de"), 2D and 3D.

Counterpart of :mod:`deepfluids_tpu.models.generator`: a BEGAN-style decoder
from a parameter vector to a stream function (2D) or vector potential (3D),

    p -> fc_in -> reshape to the coarse grid [(D0,) H0, W0, filters]
      -> repeat x { num_conv 3x3(x3) convs (leaky ReLU) + skip from the
                    stage input + 2x nearest upsample (except the last) }
      -> conv_out 3x3(x3) to out_channels (no activation), cast to float32,

with the JAX module's beyond-reference knobs, each off by default: a
Fourier embedding of the parameters (``embed_bands``), a learned low-mode
spectral residual after each stage's convs (``spectral_modes``), and the
grid decoder (``grid_levels`` / ``grid_features`` / ``grid_rank``: a
multi-resolution feature grid over the parameters widens ``fc_in``, and
each stage adds a parameter-modulated spatial basis).

The curl that turns the potential into velocity is applied outside the
network (:func:`deepfluids_tpu_torch.train.losses.apply_curl`).

Submodules and parameters carry the Flax names (``fc_in``,
``conv_{stage}_{c}``, ``conv_out``, ``param_grid/grid_{l}``,
``spectral_{stage}/gain_re|gain_im``, ``coef_{stage}``, ``basis_{stage}``,
``inj_{stage}``) so :mod:`.weights` maps one onto the other by name.  Dtypes
follow Flax's ``nn.Dense/nn.Conv(dtype=...)``: parameters stay float32 and
each layer casts its input, kernel and bias to ``compute_dtype``.  Inside,
activations are indexed NCHW (NCDHW in 3D) and lie channels-last in memory,
as do the conv weights: cuDNN's tensor-core convs read and write NHWC, so
an NCHW map would be transposed around every conv, forward and backward.
``fc_in``'s output is viewed ``(B, [D0,] H0, W0, F)``, as Flax reshapes it
(so the weights need no row permutation), and permuted, which is already
channels-last; the upsample keeps the layout, and ``conv_out``'s output
permuted back to ``[B, *spatial, C]`` is contiguous.  Stride-1 ``'SAME'``
convolution with a kernel of 3 is ``padding=1``.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfluids_tpu_torch.models import activation
from deepfluids_tpu_torch.parallel import layers
from deepfluids_tpu_torch.parallel.comm import (
    Shard,
    all_reduce_sum,
    split_rows,
)

ACT_SLOPE = 0.2   # leaky ReLU slope (the JAX module's act_slope default)


def default_repeat(output_shape: Sequence[int]) -> int:
    """Number of conv stages for an output shape (spatial dims + channel):
    ``log2(max spatial extent) - 2`` (128x96 -> 5 stages, coarse 8x6;
    32x64x112 -> 4 stages, coarse 4x8x14)."""
    return int(math.log2(max(output_shape[:-1]))) - 2


@torch.no_grad()
def flax_init_(model: nn.Module, seed: int) -> nn.Module:
    """Flax's default init, in place: every Linear/Conv weight from
    ``lecun_normal`` and every bias zero.

    ``lecun_normal`` is ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``: a normal truncated at +-2 sigma, with sigma
    ``1 / sqrt(fan_in) / 0.8796...`` so that the truncated variance is
    ``1 / fan_in`` (fan_in = in times the kernel's volume for a conv, in
    for a Linear).
    Drawn on the CPU from a ``torch.Generator`` seeded with ``seed``, in
    module order, so the weights are the same on any device; they are not
    JAX's numbers (another generator), only its distribution.  A layer
    flagged ``flax_zero_init`` (the latent integrator's head, Flax's
    ``kernel_init=zeros``) gets a zero kernel.  The raw tables of the
    generator's knobs follow their Flax initializers: a module's own
    parameters are drawn from ``normal(flax_normal_std)`` where it sets
    that attribute (the parameter grid's tables) and are zero otherwise
    (the spectral gains, the grid decoder's bases).
    """
    gen = torch.Generator().manual_seed(seed)
    # The std of a unit normal truncated to [-2, 2] (jax.nn.initializers).
    trunc_std = 0.87962566103423978
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    for module in model.modules():
        if not isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            std = getattr(module, "flax_normal_std", 0.0)
            for p in module.parameters(recurse=False):
                if std:
                    p.copy_(torch.randn(p.shape, generator=gen) * std)
                else:
                    p.zero_()
            continue
        if module.bias is not None:
            module.bias.zero_()
        w = module.weight
        if getattr(module, "flax_zero_init", False):
            w.zero_()
            continue
        fan_in = w[0].numel()      # (out, in) or (out, in, [kd,] kh, kw)
        sigma = 1.0 / math.sqrt(fan_in) / trunc_std
        # Inverse-CDF sampling of the truncated normal.
        u = torch.empty(w.shape, dtype=torch.float64).uniform_(
            lo, hi, generator=gen)
        draw = torch.erfinv(u) * math.sqrt(2.0)
        w.copy_((draw.clamp_(-2.0, 2.0) * sigma).to(w.dtype))
    return model


def fourier_embed(z: torch.Tensor, bands: int) -> torch.Tensor:
    """``[B, P]`` -> ``[B, P * (2 * bands + 1)]``: ``z`` followed by
    ``sin`` and ``cos`` of ``2**k * pi * z`` for ``k < bands`` (per
    parameter, sines then cosines); ``z`` itself when ``bands`` is 0."""
    if bands <= 0:
        return z
    k = 2.0 ** torch.arange(bands, dtype=z.dtype, device=z.device) * math.pi
    ang = z[..., None] * k                                   # [B, P, bands]
    feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([z, feats.reshape(z.shape[:-1] + (-1,))], dim=-1)


class SpectralResidual(nn.Module):
    """A learned filter of each channel's lowest Fourier modes, added back
    to its input: per spatial axis of extent ``n`` the ``K = 2m - 1`` modes
    ``{-(m-1), .., m-1}`` with ``m = min(modes, (n + 1) // 2)``, kept as a
    truncated DFT (one ``[n, K]`` matmul per axis, real and imaginary parts
    carried apart), times the learned complex gains ``gain_re`` /
    ``gain_im`` (Flax layout ``(K_0, .., C)``, zero at init), and back.
    Computed in f32 on an NC(D)HW input; the residual is cast back to the
    input's dtype.

    With ``row_shard`` the input holds the rank's block of rows of the
    first spatial axis, and the transform is distributed over the rows:
    the other axes are contracted first, then the rows with the rank's
    rows of the forward basis, and the partial spectra (``[B, C, K_0,
    ..]``, small) are summed over the group; the gains apply to the whole
    spectrum, and the inverse keeps the rank's rows.  The sum runs in
    another order than the whole field's, so the result is not bit-equal
    to it."""

    def __init__(self, modes: int, spatial: Sequence[int], channels: int):
        super().__init__()
        ks = []
        for ax, n in enumerate(spatial):
            m = min(modes, (n + 1) // 2)
            freqs = np.concatenate([np.arange(m), np.arange(-(m - 1), 0)])
            ang = 2.0 * np.pi * np.outer(np.arange(n), freqs) / n   # [N, K]
            e_c = torch.from_numpy(np.cos(ang).astype(np.float32))
            e_s = torch.from_numpy(np.sin(ang).astype(np.float32))
            # exp(-i ang) forward, [N, K]; exp(+i ang) / N back, [K, N]
            self.register_buffer(f"fw_c{ax}", e_c, persistent=False)
            self.register_buffer(f"fw_s{ax}", -e_s, persistent=False)
            self.register_buffer(f"inv_c{ax}", e_c.T.contiguous() / n,
                                 persistent=False)
            self.register_buffer(f"inv_s{ax}", e_s.T.contiguous() / n,
                                 persistent=False)
            ks.append(len(freqs))
        self.ndim = len(spatial)
        shape = tuple(ks) + (channels,)
        self.gain_re = nn.Parameter(torch.zeros(shape))
        self.gain_im = nn.Parameter(torch.zeros(shape))

    @staticmethod
    def _contract(re, im, bc, bs, dim):
        """``(re + i im) (bc + i bs)`` contracted over axis ``dim``; ``im``
        None is a real input."""
        re = re.movedim(dim, -1)
        rr, ri = re @ bc, re @ bs
        if im is not None:
            im = im.movedim(dim, -1)
            rr, ri = rr - im @ bs, ri + im @ bc
        return rr.movedim(-1, dim), ri.movedim(-1, dim)

    def _basis(self, kind: str, ax: int, rows: slice | None):
        """The ``fw`` (``[N, K]``) or ``inv`` (``[K, N]``) pair of axis
        ``ax``, cut to ``rows`` of the spatial axis when given."""
        c, s = (getattr(self, f"{kind}_{p}{ax}") for p in "cs")
        if rows is None:
            return c, s
        return (c[rows], s[rows]) if kind == "fw" else (c[:, rows],
                                                        s[:, rows])

    def forward(self, x: torch.Tensor,
                row_shard: Shard | None = None) -> torch.Tensor:
        rows = None
        if row_shard is not None and row_shard.active:
            n = x.shape[2]
            rows = slice(row_shard.index * n, (row_shard.index + 1) * n)
        # the row axis last when it is sharded: its sum spans the group
        order = list(range(self.ndim))
        if rows is not None:
            order = order[1:] + order[:1]
        xr, xi = x.float(), None
        for ax in order:
            xr, xi = self._contract(xr, xi, *self._basis(
                "fw", ax, rows if ax == 0 else None), 2 + ax)
        if rows is not None:
            spec = all_reduce_sum(torch.stack([xr, xi]), row_shard)
            xr, xi = spec[0], spec[1]
        # (K_0, .., C) -> (C, K_0, ..), broadcast over the batch
        perm = (self.ndim, *range(self.ndim))
        gr, gi = self.gain_re.permute(perm), self.gain_im.permute(perm)
        xr, xi = xr * gr - xi * gi, xr * gi + xi * gr
        for ax in order:
            xr, xi = self._contract(xr, xi, *self._basis(
                "inv", ax, rows if ax == 0 else None), 2 + ax)
        return x + xr.to(x.dtype)


def _grid_consts(knots: Sequence[int], device=None) -> tuple:
    """The constants of :func:`_interp_grid` for a table of ``knots`` per
    parameter: ``knots - 1`` (f32), the last lower-corner index ``knots -
    2``, the ``2^P`` corners (first parameter slowest) and the flat
    strides."""
    num_p = len(knots)
    return (torch.tensor([k - 1.0 for k in knots], device=device),
            torch.tensor([k - 2 for k in knots], device=device),
            torch.tensor(list(itertools.product((0, 1), repeat=num_p)),
                         device=device),
            torch.tensor([math.prod(knots[d + 1:]) for d in range(num_p)],
                         device=device))


def _interp_grid(table: torch.Tensor, p: torch.Tensor,
                 consts: tuple | None = None) -> torch.Tensor:
    """Multilinear interpolation of ``table`` ``[k_0, .., k_{P-1}, F]``
    (knots over ``[-1, 1]^P``) at the queries ``p`` ``[B, P]`` (clipped to
    the domain) -> ``[B, F]``; ``consts`` are :func:`_grid_consts` of the
    table (made here when None: a copy to the device).

    The ``2^P`` corner gathers are written as a ``[B, prod(k)]`` matrix of
    corner weights times the flattened table, so the table's gradient is a
    matmul: deterministic on the card, where the backward of an indexed
    gather accumulates with atomics."""
    knots = table.shape[:-1]
    scale, hi, corners, strides = consts or _grid_consts(knots, p.device)
    t = torch.clamp((p + 1.0) * 0.5, 0.0, 1.0) * scale          # [B, P]
    i0 = torch.minimum(torch.floor(t).long(), hi).clamp_(0)
    w = (t - i0)[:, None, :]                                     # [B, 1, P]
    flat = ((i0[:, None, :] + corners) * strides).sum(-1)        # [B, 2^P]
    weight = torch.where(corners.bool(), w, 1.0 - w).prod(-1)    # [B, 2^P]
    weights = torch.zeros(p.shape[0], math.prod(knots), dtype=table.dtype,
                          device=p.device).scatter_(
                              1, flat, weight.to(table.dtype))
    return weights @ table.reshape(-1, table.shape[-1])


class MultiResParamGrid(nn.Module):
    """Multi-resolution learned feature grids over the (normalized)
    parameter domain: level ``l`` is a table ``grid_{l}`` of ``base * 2**l
    + 1`` knots per parameter and ``features`` features (Flax's
    ``normal(1e-2)`` init), interpolated multilinearly in f32; the levels'
    features are concatenated.  The interpolation's constants are buffers,
    so a forward copies nothing to the device."""

    flax_normal_std = 1e-2

    def __init__(self, num_param: int, levels: int = 4, features: int = 4,
                 base: int = 2):
        super().__init__()
        self.levels = levels
        for lvl in range(levels):
            knots = (base * 2 ** lvl + 1,) * num_param
            self.register_parameter(f"grid_{lvl}", nn.Parameter(
                torch.zeros(knots + (features,))))
            for name, c in zip(("scale", "hi", "corners", "strides"),
                               _grid_consts(knots)):
                self.register_buffer(f"{name}_{lvl}", c, persistent=False)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        p = p.float()
        return torch.cat([_interp_grid(
            getattr(self, f"grid_{lvl}"), p,
            tuple(getattr(self, f"{n}_{lvl}") for n in
                  ("scale", "hi", "corners", "strides")))
            for lvl in range(self.levels)], dim=-1)


def upscale_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NCHW / NCDHW tensor: every cell
    repeated ``factor`` times along each spatial axis, in the input's
    memory layout (channels-last or contiguous).

    One copy of a broadcast view, its axes in memory order: each spatial
    axis ``n`` is viewed ``(n, 1)`` and expanded to ``(n, factor)``.  The
    backward is a sum over the ``factor`` copies."""
    last = layers.is_channels_last(x)
    y = x.movedim(1, -1) if last else x
    lead = y.shape[:1] if last else y.shape[:2]
    spatial = x.shape[2:]
    tail = y.shape[len(lead) + len(spatial):]
    y = y.reshape(lead + sum(((n, 1) for n in spatial), ()) + tail).expand(
        lead + sum(((n, factor) for n in spatial), ()) + tail)
    y = y.reshape(lead + tuple(n * factor for n in spatial) + tail)
    return y.movedim(-1, 1) if last else y


class GeneratorBE(nn.Module):
    """Parameter vector ``[B, num_param]`` -> field ``[B, *spatial, C]``
    (f32).

    Args:
      output_shape: ``(H, W, out_channels)`` (2D, e.g. ``(128, 96, 1)``) or
        ``(D, H, W, out_channels)`` (3D, e.g. ``(32, 64, 112, 3)``).
      num_param: length of the input vector (Flax infers it at init).
      filters, num_conv, repeat: as in the JAX module; ``repeat=0``
        derives it with :func:`default_repeat`.
      compute_dtype: dtype every layer computes in (float32 or bfloat16).
      embed_bands: > 0 applies :func:`fourier_embed` to the input vector
        (widens ``fc_in``).
      spectral_modes: > 0 adds a zero-init :class:`SpectralResidual` after
        each stage's convs.
      grid_levels, grid_features: both > 0 turn the grid decoder on: a
        :class:`MultiResParamGrid` of the raw vector is concatenated to the
        (embedded) vector before ``fc_in``;
      grid_rank: > 0 (with the grid on) adds each stage's basis injection
        ``inj_k(coef_k(z) . basis_k)`` before its convs: ``coef_k`` a Dense
        in f32 of the widened vector, ``basis_k`` ``(R, *res_k, F)`` zero at
        init, ``inj_k`` a 1x1(x1) conv without a bias in ``compute_dtype``.

    Spatial sharding (the JAX module's ``spatial_mesh``): after
    :meth:`shard_rows`, every feature map whose first spatial extent divides
    by the group size holds the rank's rows (the coarser ones stay
    replicated), and the output is the rank's rows of the field.  On such
    a map a spectral residual is a DFT distributed over the rows
    (:class:`SpectralResidual`) and the basis injection reads the rank's
    rows of its basis.  Conv layers cut by
    :func:`..parallel.mesh.shard_channels_` compute their channels and
    gather the rest (:func:`..parallel.layers.conv`).
    """

    def __init__(self, output_shape: Sequence[int] = (128, 96, 1),
                 num_param: int = 3, filters: int = 128, num_conv: int = 4,
                 repeat: int = 0, compute_dtype: torch.dtype = torch.float32,
                 embed_bands: int = 0, spectral_modes: int = 0,
                 grid_levels: int = 0, grid_features: int = 0,
                 grid_rank: int = 0):
        super().__init__()
        if len(output_shape) not in (3, 4):
            raise ValueError(
                f"GeneratorBE output_shape {tuple(output_shape)}: want "
                "(H, W, C) or (D, H, W, C)")
        self.output_shape = tuple(int(s) for s in output_shape)
        self.filters = filters
        self.num_conv = num_conv
        self.repeat = repeat or default_repeat(self.output_shape)
        self.compute_dtype = compute_dtype
        spatial = self.output_shape[:-1]
        scale = 2 ** (self.repeat - 1)
        self.coarse = tuple(s // scale for s in spatial)
        if any(c * scale != s for c, s in zip(self.coarse, spatial)):
            raise ValueError(f"spatial dims {spatial} must be divisible by "
                             f"2**(repeat-1)={scale}")

        nd = len(spatial)
        conv = nn.Conv2d if nd == 2 else nn.Conv3d
        self._conv_fn = F.conv2d if nd == 2 else F.conv3d
        # (B, *coarse, F) -> (B, F, *coarse) and back at the output
        self._to_nc = (0, nd + 1, *range(1, nd + 1))
        self._to_last = (0, *range(2, nd + 2), 1)

        self.embed_bands = embed_bands
        self.grid_on = grid_levels > 0 and grid_features > 0
        self.inject = self.grid_on and grid_rank > 0
        self.spectral = spectral_modes > 0
        width = num_param * (2 * max(embed_bands, 0) + 1)
        if self.grid_on:
            # The grid interpolates the RAW vector (a table of (knots,)**P).
            self.param_grid = MultiResParamGrid(num_param, grid_levels,
                                                grid_features)
            width += grid_levels * grid_features
        self.fc_in = nn.Linear(width, math.prod(self.coarse) * filters)
        for stage in range(self.repeat):
            res = tuple(c * 2 ** stage for c in self.coarse)
            if self.inject:
                self.add_module(f"coef_{stage}", nn.Linear(width, grid_rank))
                self.register_parameter(f"basis_{stage}", nn.Parameter(
                    torch.zeros((grid_rank,) + res + (grid_features,))))
                self.add_module(f"inj_{stage}",
                                conv(grid_features, filters, 1, bias=False))
            for c in range(num_conv):
                self.add_module(f"conv_{stage}_{c}",
                                conv(filters, filters, 3, padding=1))
            if self.spectral:
                self.add_module(f"spectral_{stage}", SpectralResidual(
                    spectral_modes, res, filters))
        self.conv_out = conv(filters, self.output_shape[-1], 3, padding=1)
        # The conv weights channels-last, as the maps: ``.to``, ``copy_``
        # and ``load_state_dict`` keep a parameter's layout, and the
        # gradients and Adam's moments take it.
        fmt = layers.memory_format(nd + 2)
        for m in self.modules():
            if isinstance(m, conv):
                m.weight = nn.Parameter(
                    m.weight.detach().contiguous(memory_format=fmt))
        self.row_shard: Shard | None = None

    def shard_rows(self, shard: Shard | None) -> None:
        """Shard the feature maps' first spatial axis over ``shard``."""
        self.row_shard = shard

    def _conv(self, layer: nn.Module, x: torch.Tensor, extent: int,
              bias: bool = True) -> torch.Tensor:
        """A 3x3(x3) 'SAME' conv of a map of ``extent`` rows."""
        rs = self.row_shard
        return layers.conv(x, layer, self.compute_dtype, self._conv_fn,
                           row_shard=rs if layers.sharded(extent, rs)
                           else None, bias=bias)

    def _conv_act(self, layer: nn.Module, x: torch.Tensor,
                  extent: int) -> torch.Tensor:
        """:meth:`_conv` followed by the leaky ReLU: the bias-free conv
        output and the bias in one pass
        (:func:`.activation.bias_leaky_relu`)."""
        return activation.bias_leaky_relu(
            self._conv(layer, x, extent, bias=False),
            layer.bias.to(self.compute_dtype), ACT_SLOPE)

    def _basis_inject(self, z: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage``'s injection ``[B, filters, *res]``: the codes
        ``coef(z)`` ``[B, R]`` (f32) times the basis ``[R, *res, F]``
        (f32), projected to ``filters`` by the bias-free 1x1 conv in the
        compute dtype.  On a sharded map the basis is cut to the rank's
        rows; its gradient is then the rank's rows' and the gradient
        reduction sums the group's."""
        coef = getattr(self, f"coef_{stage}")
        basis = getattr(self, f"basis_{stage}")
        if layers.sharded(basis.shape[1], self.row_shard):
            basis = split_rows(basis, self.row_shard, 1)
        a = F.linear(z.float(), coef.weight, coef.bias)
        inj = (a @ basis.reshape(basis.shape[0], -1)).view(
            -1, *basis.shape[1:]).permute(*self._to_nc)
        dt = self.compute_dtype
        return layers.conv(inj.to(dt), getattr(self, f"inj_{stage}"), dt,
                           self._conv_fn, padding=0, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        z_raw = z
        z = fourier_embed(z, self.embed_bands)
        if self.grid_on:
            z = torch.cat([z, self.param_grid(z_raw)], dim=-1)
        x = F.linear(z.to(dt), self.fc_in.weight.to(dt),
                     self.fc_in.bias.to(dt))
        x = x.view(-1, *self.coarse, self.filters).permute(*self._to_nc)
        extent = self.coarse[0]       # the map's first extent, whole
        x = layers.enter(x, self.row_shard)
        x0 = x
        for stage in range(self.repeat):
            if self.inject:
                x = x + self._basis_inject(z, stage)
            for c in range(self.num_conv):
                x = self._conv_act(getattr(self, f"conv_{stage}_{c}"), x,
                                   extent)
            if self.spectral:
                rs = self.row_shard
                x = getattr(self, f"spectral_{stage}")(
                    x, rs if layers.sharded(extent, rs) else None)
            if stage < self.repeat - 1:
                # a sharded map's rows upsample to the rows of the next
                was = layers.sharded(extent, self.row_shard)
                x = upscale_nearest(x + x0, 2)
                extent *= 2
                if not was:
                    x = layers.enter(x, self.row_shard)
                x0 = x
            else:
                x = x + x0
        out = self._conv(self.conv_out, x, extent)
        return out.permute(*self._to_last).float()
