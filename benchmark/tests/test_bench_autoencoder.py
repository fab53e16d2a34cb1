"""The autoencoder's plain reference (``references/autoencoder.py``) by hand
and against the measured program's ``Autoencoder`` on the CPU in float32,
faults planted in the reference that the comparison must see, its FLOP
count, and the cell ``train_mov_ae`` run whole at a tiny size (the test
may import the program; the reference may not)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, flops_ae, harness, synth, trace
from benchmark.references import autoencoder as ref

from conftest import TINY
from test_bench_faults import _unchanged

CFG = {"resolution": [16, 12], "num_channels": 2, "filters": 8,
       "num_conv": 2, "repeat": 2, "z_num": 6, "num_param": 2, "w1": 1.0,
       "w2": 1.0, "w3": 1.0, "ae_pred_w": 0.0}
FULL = {"resolution": [128, 96], "num_channels": 2, "filters": 128,
        "num_conv": 4, "repeat": 5, "z_num": 16, "num_param": 2}


def test_same_pads_by_hand():
    # last axis first: W 3 (odd) pads (1, 1), H 4 (even) pads (0, 1)
    assert ref.same_pads((4, 3)) == (1, 1, 0, 1)
    assert ref.same_pads((2, 6, 5)) == (1, 1, 0, 1, 0, 1)
    # a stride-2 conv that reads its centre tap: along the even H an
    # output row i reads input row 2i + 1, along the odd W column 2j
    x = torch.arange(12.0).view(1, 1, 4, 3)      # x[r, c] = 3r + c
    centre = torch.zeros(1, 1, 3, 3)
    centre[0, 0, 1, 1] = 1.0
    out = F.conv2d(F.pad(x, ref.same_pads(x.shape[2:])), centre, stride=2)
    assert out[0, 0].tolist() == [[3.0, 5.0], [9.0, 11.0]]


def test_flatten_is_channels_last_by_hand():
    # every conv weight 0 and down_0's bias (1, 2): the last map holds
    # channel 0 at 1 and channel 1 at 2 over its 2 x 2 points; fc_out
    # reads its first four columns, a point's channels side by side
    cfg = {**CFG, "resolution": [4, 4], "filters": 2, "num_conv": 1,
           "z_num": 4}
    params = {k: torch.zeros(s) for k, s in ref.param_shapes(cfg).items()}
    params["encoder.down_0.bias"] = torch.tensor([1.0, 2.0])
    params["encoder.fc_out.weight"] = torch.eye(4, 8)
    z = ref.encoder(params, torch.randn(1, 4, 4, 2), cfg)
    assert z[0].tolist() == [1.0, 2.0, 1.0, 2.0]
    h = torch.arange(8.0).view(1, 2, 2, 2)        # [B, C, H, W]
    assert ref.flatten(h)[0].tolist() == [0, 4, 1, 5, 2, 6, 3, 7]


def _port(cfg):
    from deepfluids_tpu_torch.models.autoencoder import Autoencoder

    return Autoencoder(tuple(cfg["resolution"]) + (1,),
                       in_channels=cfg["num_channels"], z_num=cfg["z_num"],
                       filters=cfg["filters"], num_conv=cfg["num_conv"],
                       repeat=cfg["repeat"], compute_dtype=torch.float32)


def _port_encoder(cfg):
    from deepfluids_tpu_torch.models.autoencoder import Encoder

    return Encoder(tuple(cfg["resolution"]), cfg["num_channels"],
                   z_num=cfg["z_num"], filters=cfg["filters"],
                   num_conv=cfg["num_conv"], repeat=cfg["repeat"],
                   compute_dtype=torch.float32)


def _gaps(cfg, seed: int, ref_cfg=None, whole: bool = True) -> dict:
    """The reference (of ``ref_cfg``, else ``cfg``) against the port in
    float32 on seeded weights: whether the code, the field, the loss and
    every leaf's gradient agree at the tolerances of the generator's
    comparison (``test_bench_reference.py``).  ``whole=False`` compares
    the encoder alone, under the gradient of a fixed sum of the code."""
    from deepfluids_tpu_torch.train import losses

    weights = synth.weights(ref.param_shapes(cfg), seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(4, *cfg["resolution"], 2, generator=gen)
    p = torch.rand(4, cfg["num_param"], generator=gen) * 2 - 1
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    rcfg = ref_cfg or cfg
    if whole:
        model = _port(cfg)
        model.load_state_dict(weights)
        psi, z = model(x)
        want, _ = losses.autoencoder_loss(
            psi, z, x, p, True, cfg["num_param"], cfg["w1"], cfg["w2"],
            cfg["w3"])
        u, zr = ref.forward(leaves, x, rcfg)
        got = ref.loss(leaves, p, x, rcfg)
        # the field: float32 sums in the same order up to the curl's
        # differences, so within a few ulps of its magnitude
        ok = {"field": torch.allclose(u, losses.apply_curl(psi), atol=1e-5),
              "loss": float(got.detach()) == pytest.approx(
                  float(want.detach()), rel=1e-5)}
    else:
        model = _port_encoder(cfg)
        model.load_state_dict({k[len(ref.ENCODER):]: v
                               for k, v in weights.items()
                               if k.startswith(ref.ENCODER)})
        z = model(x)
        zr = ref.encoder(leaves, x, rcfg)
        mix = torch.randn(z.shape, generator=gen)
        want, got = (z * mix).sum(), (zr * mix).sum()
        ok = {}
    # the code: one dense layer over float32 maps, as the field
    ok["z"] = torch.allclose(zr, z, atol=1e-5)
    want.backward()
    got.backward()
    # a leaf the curl cancels (the decoder's last bias) has a gradient of
    # rounding, so each leaf is held to 1e-3 of itself or 1e-6 of the
    # largest gradient; the encoder's leaves see the loss through the
    # decoder and the code's supervision
    top = max(float(w.grad.abs().max()) for w in model.parameters())
    prefix = "" if whole else ref.ENCODER
    for name, w in model.named_parameters():
        ok[name] = torch.allclose(leaves[prefix + name].grad, w.grad,
                                  rtol=1e-3, atol=1e-6 * top)
    return ok


# [16, 12] at repeat 2; [32, 24] at repeat 4 (every extent even until the
# last map); the encoder alone at [16, 12] and repeat 4, where the extent
# 3 is downsampled to 2 through the (1, 1) pad (a decoder needs extents
# that 2**(repeat - 1) divides, so no whole autoencoder has an odd one)
CASES = {"ae_16x12_r2": ({}, True),
         "ae_32x24_r4": ({"resolution": [32, 24], "repeat": 4}, True),
         "encoder_16x12_r4_odd": ({"repeat": 4}, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_the_program_in_float32(case):
    over, whole = CASES[case]
    ok = _gaps({**CFG, **over}, 5, whole=whole)
    assert all(ok.values()), [k for k, v in ok.items() if not v]


def _pads_on_the_wrong_side(monkeypatch):
    # an even extent padded (1, 0): the first sample read from the pad
    real = ref.same_pads

    def wrong(extents):
        pads = real(extents)
        return sum(((1, 0) if p == (0, 1) else p
                    for p in zip(pads[::2], pads[1::2])), ())
    monkeypatch.setattr(ref, "same_pads", wrong)


def _nchw_flatten(monkeypatch):
    monkeypatch.setattr(ref, "flatten",
                        lambda h: h.reshape(h.shape[0], -1))


FAULTS = {"pads_on_the_wrong_side": _pads_on_the_wrong_side,
          "nchw_flatten": _nchw_flatten, "w3_dropped": None}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_in_the_reference_fails_the_comparison(fault, monkeypatch):
    ref_cfg = None
    if fault == "w3_dropped":
        ref_cfg = {**CFG, "w3": 0.0}
    else:
        FAULTS[fault](monkeypatch)
    ok = _gaps(CFG, 5, ref_cfg=ref_cfg)
    assert not all(ok.values())
    assert not ok["loss"]


def test_train_steps_take_the_autoencoder_loss():
    # generator_be's Adam loop, run over this module's loss
    cfg = {**CFG, "lr_max": 1e-4, "lr_min": 2.5e-6, "max_step": 100,
           "beta1": 0.5, "beta2": 0.999}
    params = synth.weights(ref.param_shapes(cfg), 3, "cpu")
    gen = torch.Generator().manual_seed(3)
    batches = [(torch.rand(2, 2, generator=gen) * 2 - 1,
                torch.randn(2, 16, 12, 2, generator=gen)) for _ in range(2)]
    run = ref.train_steps(params, batches, cfg, half_batch=(2,))
    want = [float(ref.loss(params, *batches[0], cfg))]
    assert run["losses"][0] == pytest.approx(want[0], rel=1e-6)
    assert set(run["first_grad"]) == set(params)
    assert all(torch.isfinite(g).all() for g in run["first_grad"].values())
    # the first step moves each leaf by about the rate where it has a
    # gradient (Adam's first step)
    moved = max(float((run["params"][k] - params[k]).abs().max())
                for k in params)
    assert 1e-4 <= moved <= 2.1e-4


def test_flops_by_hand_at_the_published_widths():
    # conv_in at 12 288 points from 2 x 9 inputs; each stage's four convs
    # at 12 288 / 3 072 / 768 / 192 / 48 points; the downs at their
    # outputs; fc_out 6 144 -> 16
    enc = flops_ae.encoder_layers(FULL)
    assert enc[0] == ("encoder.conv_in", 18, 128, 12288)
    assert enc[-1] == ("encoder.fc_out", 6144, 16, 1)
    downs = [(n, p) for n, k, o, p in enc if n.startswith("encoder.down")]
    assert downs == [(f"encoder.down_{s}", 12288 // 4 ** (s + 1))
                     for s in range(4)]
    points = [12288, 3072, 768, 192, 48]
    want = 2 * 18 * 128 * 12288
    want += sum(2 * 4 * 1152 * 128 * n for n in points)
    want += sum(2 * 1152 * 128 * n for n in points[1:])
    want += 2 * 6144 * 16
    enc_fwd = sum(2 * k * o * n for _, k, o, n in enc)
    assert enc_fwd == want
    assert abs(enc_fwd / 20.5e9 - 1) < 0.01
    dec = flops.forward_flops({**FULL, "num_param": 16})
    assert abs(dec / 19.3e9 - 1) < 0.01
    assert flops_ae.forward_flops(FULL) == enc_fwd + dec
    step = flops_ae.train_step_flops(FULL, 8)
    assert step == 8 * (3 * (enc_fwd + dec) - 2 * 18 * 128 * 12288)
    assert abs(step / 0.957e12 - 1) < 0.01


@pytest.mark.parametrize("res", [[8, 4], [4, 8, 4]])
def test_flops_match_torch_flop_counter(res):
    cfg = {**CFG, "resolution": res, "num_channels": len(res), "filters": 2,
           "num_conv": 1, "repeat": 2, "z_num": 3}
    params = {k: v.requires_grad_(True) for k, v in synth.weights(
        ref.param_shapes(cfg), 1, "cpu").items()}
    x = torch.randn(3, *res, len(res))
    with FlopCounterMode(display=False) as fwd:
        _, z = ref.forward(params, x, cfg)
    assert fwd.get_total_flops() == 3 * flops_ae.forward_flops(cfg)
    with FlopCounterMode(display=False) as both:
        u, z = ref.forward(params, x, cfg)
        (u.sum() + z.sum()).backward()
    assert both.get_total_flops() == flops_ae.train_step_flops(cfg, 3)


def test_the_reference_loads_neither_the_program_nor_jax():
    code = ("import sys\n"
            "from benchmark.references import autoencoder\n"
            "from benchmark import harness\n"
            "print(harness.foreign_modules(sys.modules),"
            " 'deepfluids_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] False"


# the configuration has one parameter besides the frame; float32, as the
# training cells' whole runs on the CPU (test_bench_faults.py): the limits
# are the card's, set at the published widths in bfloat16
AE_TINY = {**TINY, "param_counts": [3], "compute_dtype": "float32"}


def test_the_cell_runs_whole_and_reads_correct():
    out = harness.run_cell("train_mov_ae", 2**31 + 4321, 0.3, False,
                           device="cpu", overrides=AE_TINY)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train2d_steps_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    _, layer = harness.cell_metrics(harness.load_spec(), "train_mov_ae")
    assert {m["name"] for m in layer} == {
        "train_mfu.ae", "layout_share.train_ae", "device_idle.train_ae",
        "fd_roofline.train_ae", "feed_idle.train_ae"}
    assert set(out["checks"]) == {"loss_gap", "update_gap", "field_l2"}


def _half_batch(monkeypatch):
    from deepfluids_tpu_torch.train import losses

    real = losses.autoencoder_loss

    def loss(net_out, z, x, y, *a, **kw):
        n = x.shape[0] // 2
        return real(net_out[:n], z[:n], x[:n], y[:n], *a, **kw)
    monkeypatch.setattr(losses, "autoencoder_loss", loss)


def _altered_reconstruction(monkeypatch):
    from deepfluids_tpu_torch.train.trainer import Trainer

    real = Trainer.reconstruct
    monkeypatch.setattr(Trainer, "reconstruct",
                        lambda self, x: real(self, x) * 1.1)


PROGRAM_FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
                  "altered_reconstruction": _altered_reconstruction}


@pytest.mark.parametrize("fault", list(PROGRAM_FAULTS))
def test_correct_sees_a_fault_in_the_program(fault, monkeypatch):
    # a whole run of the cell with the program broken underneath: each
    # parameter left as it was, the loss over half the batch, the
    # reconstructions read 10 % high
    PROGRAM_FAULTS[fault](monkeypatch)
    out = harness.run_cell("train_mov_ae", 2**31 + 1234, 0.3, False,
                           device="cpu", overrides=AE_TINY)
    assert out["correct"] is False, out["checks"]


def test_reconstructions_read_the_seeded_weights_and_training_resumes(
        tmp_path, monkeypatch):
    # set-up reconstructs at the weights both sides start from, then the
    # window trains on from the trained weights, in the same tensors
    from benchmark import compare
    from deepfluids_tpu_torch.train.trainer import Trainer

    seen = []
    real = Trainer.reconstruct

    def spy(self, x):
        seen.append({k: p.detach().clone()
                     for k, p in self.model.named_parameters()})
        return real(self, x)
    monkeypatch.setattr(Trainer, "reconstruct", spy)
    cell = harness.named(harness.load_spec()["workloads"], "train_mov_ae",
                         "workload")
    cfg = {**harness.data_file(harness.DATA, "configs", cell["config"]),
           **AE_TINY}
    traffic = harness.data_file(harness.DATA, "traffic", cell["traffic"])
    d = harness.driver_class(traffic["kind"])(
        cfg, traffic, 2**31 + 77, torch.device("cpu"), str(tmp_path))
    d.setup(None)
    assert seen and all(torch.equal(w[k], v) for w in seen
                        for k, v in d.start.items())
    named = dict(d.trainer.model.named_parameters())
    ptrs = {k: p.data_ptr() for k, p in named.items()}
    assert compare.leaf_norms({k: p.detach() - d.start[k]
                               for k, p in named.items()}) == d.update
    d.trainer.train(num_steps=1)
    assert {k: p.data_ptr() for k, p in named.items()} == ptrs


def test_layout_share_reads_the_transposes_in_the_window(tmp_path):
    # 100 us: two cuDNN layout transposes of 5 and 10 us (the second
    # half outside the window), a conv, and the window's annotation
    events = [("user_annotation", "bench.window", 0.0, 100.0),
              ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 0.0, 50.0),
              ("kernel", "void cudnn::engines_precompiled::"
               "nhwcToNchwKernel<__nv_bfloat16>", 60.0, 5.0),
              ("kernel", "void cudnn::engines_precompiled::"
               "nchwToNhwcKernel<__nv_bfloat16>", 95.0, 10.0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": dur}
        for c, n, ts, dur in events]}))
    ctx = harness.LayerContext(trace.load(str(path)), {}, {}, {},
                               "NVIDIA H100 80GB HBM3")
    reader = harness.load_reader(harness.DATA, "layout_share.train_ae")
    assert reader.read(ctx) == pytest.approx(10.0)
