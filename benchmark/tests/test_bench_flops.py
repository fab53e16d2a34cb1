"""The benchmark's FLOP and byte arithmetic against hand counts at small
shapes, and against PyTorch's own FLOP counter on the reference."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, synth
from benchmark.references import generator_be as ref

# coarse 4 x 2, one conv a stage, 2 filters
SMALL = {"resolution": [8, 4], "filters": 2, "repeat": 2, "num_conv": 1,
         "num_param": 3}


def test_forward_flops_by_hand():
    # fc_in 2*3*16 = 96; stage 0: 2*18*2*8 = 576; stage 1: 2*18*2*32 =
    # 2304; conv_out: 2*18*1*32 = 1152
    assert flops.forward_flops(SMALL) == 96 + 576 + 2304 + 1152


def test_train_step_flops_by_hand():
    # forward + weight gradients + input gradients but fc_in's
    assert flops.train_step_flops(SMALL, 3) == 3 * (2 * 4128 + 4128 - 96)


def test_flagship_counts():
    cfg2 = {"resolution": [128, 96], "filters": 128, "repeat": 5,
            "num_conv": 4, "num_param": 3}
    cfg3 = {**cfg2, "resolution": [32, 64, 112], "repeat": 4}
    assert flops.forward_flops(cfg2) == 19_336_826_880
    assert abs(flops.forward_flops(cfg3) / 0.932e12 - 1) < 1e-3
    assert abs(flops.train_step_flops(cfg3, 8) / 22.37e12 - 1) < 1e-3


def test_counts_match_torch_flop_counter():
    for cfg in (SMALL, {**SMALL, "resolution": [4, 8, 4], "num_conv": 2}):
        params = {k: v.requires_grad_(True) for k, v in synth.weights(
            ref.param_shapes(cfg), 1, "cpu").items()}
        p = torch.rand(3, 3)
        with FlopCounterMode(display=False) as fwd:
            out = ref.generator(params, p, cfg)
        assert fwd.get_total_flops() == 3 * flops.forward_flops(cfg)
        with FlopCounterMode(display=False) as both:
            ref.generator(params, p, cfg).sum().backward()
        assert both.get_total_flops() == flops.train_step_flops(cfg, 3)
        assert out.shape == (3, *cfg["resolution"],
                             ref.potential_channels(cfg["resolution"]))


def test_fd_bytes_and_names():
    assert flops.fd_bytes("curl2d_fused", 10, 4) == 120
    assert flops.fd_bytes("jacobian2d_bwd", 10, 2) == 120
    assert flops.fd_bytes("jacobian3d_fused", 2, 4) == 120
    assert flops.fd_kernel("void curl2d_kernel<float, 4, 1>(float const*, "
                           "float*, int)") == "curl2d_fused"
    assert flops.fd_kernel("void jacobian3d_bwd_kernel<__nv_bfloat16, "
                           "false>(...)") == "jacobian3d_bwd"
    assert flops.fd_kernel("void at::native::elementwise_kernel<...>") is None
    assert flops.element_bytes("curl2d_kernel<__nv_bfloat16, 8, 1>") == 2
    assert flops.element_bytes("curl2d_kernel<float, 4, 1>") == 4
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert flops.peaks("cpu") is None
