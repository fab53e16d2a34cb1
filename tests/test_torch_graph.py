"""The port's one train step path (``train/graph.py``) on the CPU.

The CUDA graph itself needs a card (``tests/test_torch_cuda.py``); here
every run takes the graph's body uncaptured from its static inputs, and K
steps a chunk are held bit for bit against one step a chunk, and the host
blocks that fill those inputs (the schedule's table, the x-mirror's masks,
the device cache's indices) against their per-step values and the JAX
package's.  Datasets (and "nn"'s code set) are made with numpy from a seed.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluids_tpu.data import dataset as jdataset
from deepfluids_tpu.train import state as jax_state
from deepfluids_tpu_torch.config import Config
from deepfluids_tpu_torch.data import Manifest, save_manifest
from deepfluids_tpu_torch.data.dataset import (
    step_batch_indices,
    step_batch_indices_block,
)
from deepfluids_tpu_torch.models import generator
from deepfluids_tpu_torch.parallel import comm, mesh
from deepfluids_tpu_torch.train import augment, graph
from deepfluids_tpu_torch.train.state import (
    cosine_lr_schedule,
    cosine_lr_table,
    load_optimizer_state_,
    lr_rows,
    portable_optimizer_state,
)
from deepfluids_tpu_torch.train.trainer import CKPT_FILE, Trainer

GRID_2D, GRID_3D = (32, 24), (8, 16, 16)


def _write_set(root, name: str, grid: tuple, scenes: int, frames: int,
               seed: int) -> None:
    """``scenes`` x ``frames`` random velocity fields of ``grid`` with
    (src_x_pos, src_radius, frame) params; frame files ``<scene>_<t>``."""
    ds = os.path.join(root, name)
    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, frames - 1.0]],
        num_scenes=scenes, num_frames=frames, resolution=list(grid),
        num_channels=len(grid), v_range=[-1.0, 1.0],
        data_type="velocity"), ds)
    os.makedirs(os.path.join(ds, "v"))
    rng = np.random.default_rng(seed)
    for s in range(scenes):
        for t in range(frames):
            np.savez(os.path.join(ds, "v", f"{s}_0_{t}.npz"),
                     x=rng.standard_normal(grid + (len(grid),)).astype(
                         np.float32),
                     y=np.array([0.2 + 0.3 * s, 0.04 + 0.02 * s, t],
                                np.float32))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tiny models gain nothing from more, and
    the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_codes(root, name: str, scenes: int, frames: int, z_num: int,
                 seed: int) -> None:
    """Random ``[frames, z_num]`` code sequences of set ``name``'s scenes,
    with its raw params, where arch "nn" reads them."""
    out = os.path.join(root, name, f"code{z_num}")
    os.makedirs(out)
    rng = np.random.default_rng(seed)
    for s in range(scenes):
        np.savez(os.path.join(out, f"{s}_0.npz"),
                 z=rng.standard_normal((frames, z_num)).astype(np.float32),
                 p=np.array([[0.2 + 0.3 * s, 0.04 + 0.02 * s, t]
                             for t in range(frames)], np.float32))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    _write_set(root, "tiny2d", GRID_2D, scenes=3, frames=5, seed=21)
    _write_codes(root, "tiny2d", scenes=3, frames=5, z_num=8, seed=23)
    _write_set(root, "tiny3d", GRID_3D, scenes=2, frames=3, seed=22)
    return root


def _config(data_dir, log_dir, **kw) -> Config:
    base = dict(arch="de", dataset="tiny2d", filters=8, num_conv=1, z_num=8,
                batch_size=4, data_dir=data_dir, log_dir=log_dir,
                max_step=10, lr_max=2e-3, lr_min=1e-4, log_step=4,
                test_step=10_000, save_step=10_000,
                compute_dtype="float32", num_worker=1, seed=3)
    base.update(kw)
    return Config(**base)


def _trainer(data_dir, log_dir, tag: str, **kw) -> Trainer:
    return Trainer(_config(data_dir, log_dir, tag=tag, **kw), device="cpu")


def _assert_same_state(got: Trainer, want: Trainer) -> None:
    assert got.step == want.step
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(got.model.state_dict()[k], v, atol=0,
                                   rtol=0, msg=k)
    gs, ws = got.opt.state_dict(), want.opt.state_dict()
    assert gs["state"].keys() == ws["state"].keys()
    for i, st in ws["state"].items():
        for name, v in st.items():
            torch.testing.assert_close(gs["state"][i][name], v, atol=0,
                                       rtol=0, msg=f"{i} {name}")


# --- the host blocks ---------------------------------------------------------

@pytest.mark.parametrize("lr_max,lr_min,max_step", [
    (1e-4, 2.5e-6, 100_000), (2e-3, 1e-4, 50), (1e-4, 1e-6, 1000),
    (3e-4, 0.0, 1)])
def test_lr_table_equals_the_schedule_bit_for_bit(lr_max, lr_min, max_step):
    schedule = cosine_lr_schedule(lr_max, lr_min, max_step)
    table = cosine_lr_table(lr_max, lr_min, max_step)
    assert table.dtype == np.float32 and table.shape == (max_step + 1,)
    steps = np.arange(max_step + 4)
    got = lr_rows(table, 0, max_step + 4)
    want = np.array([schedule(int(s)) for s in steps])
    np.testing.assert_array_equal(got.astype(np.float64), want)
    # a chunk anywhere, past the end included, reads the same rows
    for start in (0, max_step // 2, max_step, max_step + 1):
        np.testing.assert_array_equal(lr_rows(table, start, 3),
                                      got[start:start + 3])
    # and the JAX package's schedule, at the existing test's bar
    theirs = jax_state.cosine_lr_schedule(lr_max, lr_min, max_step)
    pick = np.unique(np.linspace(0, max_step + 3, 9).astype(int))
    np.testing.assert_allclose(
        got[pick], [float(theirs(jnp.asarray(int(s)))) for s in pick],
        rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("seed,step,k,batch", [(0, 0, 1, 8), (3, 17, 8, 8),
                                                (11, 5, 32, 64)])
def test_flip_mask_block_rows_are_the_per_step_masks(seed, step, k, batch):
    block = augment.flip_mask_block(seed, step, k, batch)
    assert block.dtype == torch.bool and block.shape == (k, batch)
    for i in range(k):
        assert torch.equal(block[i], augment.flip_mask(seed, step + i,
                                                       batch))


@pytest.mark.parametrize("seed,step,k,n,batch", [(0, 1, 1, 15, 4),
                                                 (3, 9, 8, 210, 8),
                                                 (7, 100, 32, 21000, 64)])
def test_index_block_rows_are_the_per_step_draws(seed, step, k, n, batch):
    block = step_batch_indices_block(seed, step, k, n, batch)
    assert block.dtype == np.int32 and block.shape == (k, batch)
    for i in range(k):
        np.testing.assert_array_equal(
            block[i], step_batch_indices(seed, step + i, n, batch))
        # the JAX package's (seed, step) stream
        np.testing.assert_array_equal(
            block[i], jdataset.step_batch_indices(seed, step + i, n, batch))


@pytest.mark.parametrize("pair", [False, True])
def test_cache_index_block_rows_are_the_eager_gathers(data_dir, tmp_path,
                                                      pair):
    kw = dict(arch="ae", ae_pred_w=0.5) if pair else {}
    t = _trainer(data_dir, str(tmp_path), "idx", device_data_cache=True,
                 **kw)
    pool = t.bm.train_pair_indices if pair else t.bm.train_indices
    block = t._cache_indices(6, 5)
    assert block.shape == (5, 8 if pair else 4)
    for i in range(5):
        idx = pool[step_batch_indices(3, 6 + i, len(pool), 4)]
        if pair:      # [t ; successor]: each pair's frames are one apart
            idx = np.concatenate([idx, t.bm.ds.successor[idx]])
            assert (t.bm.ds.successor[idx[:4]] >= 0).all()
        np.testing.assert_array_equal(block[i], idx)


# --- K steps a chunk against one step a chunk --------------------------------

CASES = {
    "de2d_flip_clip_cache": dict(augment_flip_x=True, grad_clip=0.05,
                                 device_data_cache=True),
    "de2d_flip_stream": dict(augment_flip_x=True),
    "de2d_grain": dict(input_pipeline="grain", grad_clip=0.05),
    "ae_pair_cache": dict(arch="ae", ae_pred_w=0.5, device_data_cache=True),
    "ae_pair_stream": dict(arch="ae", ae_pred_w=0.5, grad_clip=0.05),
    "de3d_cache": dict(dataset="tiny3d", grad_clip=0.05, batch_size=2,
                       device_data_cache=True, cache_dtype="float16"),
    "nn_noise": dict(arch="nn", nn_noise=0.05, nn_history=2, w_num=4,
                     nn_hidden=16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_body_equals_the_eager_steps(data_dir, tmp_path, case):
    # K = 4 over 3 chunks from the static inputs against 12 chunks of one
    # step (what the eager loop was): the same weights, Adam state and
    # reported losses; each update gets its own step's batch, mask, rate
    # and, for "nn", --nn_noise stream.
    kw = CASES[case]
    chunk = _trainer(data_dir, str(tmp_path), "k4", steps_per_call=4, **kw)
    one = _trainer(data_dir, str(tmp_path), "k1", steps_per_call=1, **kw)
    got, want = chunk.train(num_steps=12), one.train(num_steps=12)
    assert chunk.step == 12 and got == want and np.isfinite(got["loss"])
    _assert_same_state(chunk, one)
    static = chunk._chunks.static
    assert static["lr"].shape == (4,)
    assert ("idx" in static) == bool(kw.get("device_data_cache"))
    if "idx" in static:               # the gather's index type
        assert static["idx"].dtype == torch.int64
    assert ("mask" in static) == bool(kw.get("augment_flip_x"))
    if kw.get("arch") == "nn":        # [K, W, B, z_num] code windows
        assert static["x"].shape == (4, 4, 4, 8)
    elif "x" in static:
        rows = 8 if kw.get("arch") == "ae" else kw.get("batch_size", 4)
        assert static["x"].shape[:2] == (4, rows)


def test_debug_nans_names_the_poisoned_step(data_dir, tmp_path,
                                            monkeypatch):
    # --debug_nans at K = 4: a loss made NaN at the 7th update (inside the
    # second chunk) raises naming step 7, before that update is applied:
    # the weights are those of 6 clean steps.
    kw = dict(debug_nans=True, device_data_cache=True)
    t = _trainer(data_dir, str(tmp_path), "nan", steps_per_call=4, **kw)
    loss_fn = t._loss_fn

    def poisoned(model, a, b, step=0):
        loss, aux = loss_fn(model, a, b, step)
        return (loss * float("nan") if step == 6 else loss), aux

    monkeypatch.setattr(t, "_loss_fn", poisoned)
    with pytest.raises(FloatingPointError,
                       match=r"^--debug_nans: step 7: loss is not finite"):
        t.train(num_steps=8)
    want = _trainer(data_dir, str(tmp_path), "clean", **kw)
    want.train(num_steps=6)
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(t.model.state_dict()[k], v, atol=0,
                                   rtol=0, msg=k)


# --- where the graph applies -------------------------------------------------

_TWO = comm.Shard(size=2)


@pytest.mark.parametrize("device,kw,layout,captured,reason", [
    ("cuda", {}, mesh.Layout(), True, "one card, arch de"),
    ("cuda", {"arch": "ae", "ae_pred_w": 0.5, "steps_per_call": 8},
     mesh.Layout(), True, "--steps_per_call 8 steps"),
    ("cuda", {"augment_flip_x": True, "grad_clip": 1.0,
              "input_pipeline": "grain", "dataset": "tiny3d"},
     mesh.Layout(), True, "one card"),
    ("cuda", {"debug_nans": True}, mesh.Layout(), False, "--debug_nans"),
    ("cuda", {"arch": "nn"}, mesh.Layout(), False, "arch nn"),
    ("cuda", {}, mesh.Layout(world=2, data=_TWO), False, "multi-rank"),
    ("cuda", {}, mesh.Layout(world=2, data=_TWO, spatial=True), False,
     "multi-rank"),
    ("cuda", {"arch": "ae"}, mesh.Layout(world=2, model=_TWO), False,
     "multi-rank"),
    ("cpu", {}, mesh.Layout(), False, "cpu")])
def test_choose_path(device, kw, layout, captured, reason):
    c = Config(**kw)
    got, why = graph.should_capture(c, torch.device(device), layout)
    assert got == captured and reason in why, why
    # Adam's rate lives on the device on every one-card de/ae card run,
    # --debug_nans included
    assert graph.device_lr(c, torch.device(device), layout) == (
        captured or kw.get("debug_nans", False))


def test_trainer_takes_the_chosen_path(data_dir, tmp_path):
    for kw in ({}, {"debug_nans": True}):
        t = Trainer(_config(data_dir, str(tmp_path), **kw), device="cpu")
        assert not t.capture and t._lr is None
        assert not t.opt.param_groups[0]["capturable"]


# --- checkpoints -------------------------------------------------------------

def test_checkpoint_round_trip_between_chunk_and_eager(data_dir, tmp_path):
    # 8 steps at K = 4, 8 at K = 1 from its checkpoint, 8 more at K = 4
    # from that one: the uninterrupted K = 1 run's state.
    kw = dict(augment_flip_x=True, device_data_cache=True)
    want = _trainer(data_dir, str(tmp_path), "want", **kw)
    want.train(num_steps=24)
    first = _trainer(data_dir, str(tmp_path), "k4", steps_per_call=4, **kw)
    first.train(num_steps=8)
    run = first.run_dir
    for k, at in ((1, 8), (4, 16)):
        t = Trainer(dataclasses.replace(first.c, steps_per_call=k),
                    run_dir=run, device="cpu", save_cfg=False)
        assert t.restore_checkpoint() == at
        t.train(num_steps=8)
    _assert_same_state(t, want)


def test_resume_from_a_checkpoint_of_the_earlier_format(data_dir, tmp_path):
    # A checkpoint as the trainer wrote it before the graph (the plain
    # Adam's own state_dict) resumes at K = 2.
    kw = dict(grad_clip=0.05, device_data_cache=True)
    want = _trainer(data_dir, str(tmp_path), "want", **kw)
    want.train(num_steps=12)
    old = _trainer(data_dir, str(tmp_path), "old", **kw)
    old.train(num_steps=6)
    path = os.path.join(old.ckpt_dir, "6", CKPT_FILE)
    torch.save({"params": old.model.state_dict(),
                "opt_state": old.opt.state_dict(), "step": old.step}, path)
    t = Trainer(dataclasses.replace(old.c, steps_per_call=2),
                run_dir=old.run_dir, device="cpu", save_cfg=False)
    assert t.restore_checkpoint() == 6
    t.train(num_steps=6)
    _assert_same_state(t, want)


def test_resume_from_a_checkpoint_of_contiguous_conv_weights(data_dir,
                                                             tmp_path):
    # A checkpoint whose conv weights and Adam moments are contiguous NCHW
    # (the layout before the generator kept them channels-last) resumes
    # with the same numbers, each moment laid out as its parameter, and
    # trains on as the uninterrupted run.
    from deepfluids_tpu_torch.parallel import layers

    kw = dict(device_data_cache=True)
    want = _trainer(data_dir, str(tmp_path), "want", **kw)
    want.train(num_steps=12)
    old = _trainer(data_dir, str(tmp_path), "old", **kw)
    old.train(num_steps=6)
    params = {k: v.contiguous() for k, v in old.model.state_dict().items()}
    sd = portable_optimizer_state(old.opt.state_dict())
    sd["state"] = {i: {k: v.contiguous() for k, v in st.items()}
                   for i, st in sd["state"].items()}
    assert any(not layers.is_channels_last(st["exp_avg"])
               for st in sd["state"].values() if st["exp_avg"].dim() >= 4)
    path = os.path.join(old.ckpt_dir, "6", CKPT_FILE)
    torch.save({"params": params, "opt_state": sd, "step": 6}, path)
    t = Trainer(dataclasses.replace(old.c, steps_per_call=2),
                run_dir=old.run_dir, device="cpu", save_cfg=False)
    assert t.restore_checkpoint() == 6
    _assert_same_state(t, old)
    for p in t.model.parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            assert t.opt.state[p][k].stride() == p.stride()
    t.train(num_steps=6)
    _assert_same_state(t, want)


def test_portable_optimizer_state(data_dir, tmp_path):
    # A plain Adam's state_dict is already in the checkpoint's form ...
    t = _trainer(data_dir, str(tmp_path), "k1")
    t.train(num_steps=2)
    sd = t.opt.state_dict()
    port = portable_optimizer_state(sd)
    assert port["param_groups"] == sd["param_groups"]
    for i, st in sd["state"].items():
        for k, v in st.items():
            assert torch.equal(port["state"][i][k], v)
            assert port["state"][i][k].dtype == v.dtype
    # ... a capturable one's (its rate a tensor, its steps on the device)
    # is brought to it, and loads back keeping its own rate tensor.
    params = [torch.nn.Parameter(torch.zeros(3)),
              torch.nn.Parameter(torch.ones(2))]
    lr = torch.tensor(0.5)
    cap = torch.optim.Adam(params, lr=lr, capturable=True)
    state = {i: {"step": torch.tensor(7.0, dtype=torch.float64),
                 "exp_avg": torch.full_like(p, 0.25),
                 "exp_avg_sq": torch.full_like(p, 0.5)}
             for i, p in enumerate(params)}
    sd = {"state": state, "param_groups": cap.state_dict()["param_groups"]}
    port = portable_optimizer_state(sd)
    g = port["param_groups"][0]
    assert g["lr"] == 0.5 and type(g["lr"]) is float and not g["capturable"]
    assert all(s["step"].dtype == torch.float32 and s["step"].device.type
               == "cpu" and float(s["step"]) == 7.0
               for s in port["state"].values())
    load_optimizer_state_(cap, port)
    assert cap.param_groups[0]["lr"] is lr
    assert cap.param_groups[0]["capturable"]
    for p in params:
        assert cap.state[p]["step"].dtype == torch.float32
        assert torch.equal(cap.state[p]["exp_avg"], torch.full_like(p, 0.25))


# --- nothing in the captured body copies from the host -----------------------

def test_grid_decoder_forward_builds_no_constants(monkeypatch):
    # The grid decoder's interpolation reads its registered buffers; the
    # forward must never build them from Python lists (a copy to the card
    # from pageable memory, which a capture forbids).
    model = generator.GeneratorBE((32, 24, 1), num_param=3, filters=8,
                                  num_conv=1, grid_levels=2,
                                  grid_features=2, grid_rank=4)

    def refuse(*a, **k):
        raise AssertionError("_grid_consts called in a forward")

    monkeypatch.setattr(generator, "_grid_consts", refuse)
    out = model(torch.zeros(2, 3))
    assert out.shape == (2, 32, 24, 1)
