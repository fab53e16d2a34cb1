"""The port's training on several ranks against one process, and its
launcher, dry run and a group's exit code.

Two gloo ranks on the CPU are spawned once for the module
(``tools/launch_multihost``'s ``spawn``, a free port) and run every job of
``JOBS`` through the ``Trainer`` API: data parallelism for archs "de" (2D
and 3D), "ae" (with and without ``--ae_pred_w``) and "nn" (``--nn_noise``),
with the x-mirror, relative-loss, device-cache and clipping flags and the
grain stream (``--input_pipeline grain``: each rank keeps its rows), and the
tensor-parallel layout (``--num_model_shards 2``), whose checkpoints must
resume at one rank and the other way round.  Each job starts from weights
written into its run directory, and the same job runs here in one process;
losses must agree within 1e-6 relative and the weights after three steps
within 1e-5 (f32, the l2 loss: plain L1 + Adam trajectories drift apart by
rounding, see ROADMAP Queue C).  The gradient of conv_out's bias is
rounding noise under the curl (it cannot change the field), so Adam makes
it lr-sized noise: that bias is left out of the weight comparisons.

Four more ranks, spawned beside the two, run the rows x channels layout
(``--spatial_shard --num_model_shards 2``, 2 x 2): the generator with the
spectral residuals and the grid decoder's basis injection (random gains
and bases) and the autoencoder; a checkpoint written there is resumed in
one process bit for bit, and a one-process checkpoint is resumed there.

Gradients of one batch are held to the JAX tests' bar (rtol / atol 1e-5),
and, with a smooth activation in place of the leaky ReLU, to 1e-5 of each
parameter's largest entry: at the kink a pre-activation within rounding of
zero takes either slope, so two exact computations that round otherwise
(a haloed block, a cut layer) differ there by a whole point's share.  The
stand-in replaces ``models.activation.bias_leaky_relu``, the hook the
models call (a conv's bias add and the leaky ReLU in one); each comparison
asserts that its loss differs from the leaky one's, so the stand-in is
known to be live.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepfluids_tpu.datagen import scenes
from deepfluids_tpu_torch.config import Config as PortConfig
from deepfluids_tpu_torch.infer import encode_dataset
from deepfluids_tpu_torch.models import activation
from deepfluids_tpu_torch.main import main as torch_main
from deepfluids_tpu_torch.models import state_dict_to_flax
from deepfluids_tpu_torch.tools import dryrun, launch_multihost
from deepfluids_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
STEPS = 3
GRID = 4            # ranks of rows x channels (2 x 2)

# One rank of the module's group: every job of the spec file in turn.
WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from deepfluids_tpu_torch import parallel
from deepfluids_tpu_torch.config import Config
from deepfluids_tpu_torch.models import activation
from deepfluids_tpu_torch.train.trainer import Trainer
parallel.init_distributed("cpu")
rank = parallel.world()[0]
leaky = activation.bias_leaky_relu
for job in json.load(open(sys.argv[1])):
    activation.bias_leaky_relu = (activation.bias_smooth if job.get("smooth")
                                  else leaky)
    t = Trainer(Config(**job["config"]), run_dir=job["run_dir"],
                device="cpu", save_cfg=False)
    if job.get("resume"):
        t.restore_checkpoint()
    else:
        t.restore_weights()
    if job.get("batch"):
        d = np.load(job["batch"])
        loss, grads = t._loss_and_grads(d["a"], d["b"])
        if rank == 0:
            np.savez(job["out"], __loss__=np.float64(loss), **grads)
    if job.get("steps"):
        t.train(job["steps"])
    if job.get("local"):
        np.savez(job["local"] + f".rank{rank}.npz",
                 **{k: v.numpy() for k, v in t.model.state_dict().items()})
print("WORKER_OK", flush=True)
"""


def _kw(data_dir, log_dir, **kw) -> dict:
    base = dict(arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=data_dir, dataset="tiny_smoke", log_dir=log_dir,
                max_step=50, lr_max=2e-3, lr_min=1e-4, log_step=1,
                test_step=10_000, save_step=10_000, compute_dtype="float32",
                num_worker=1, seed=0, loss_norm="l2")
    base.update(kw)
    return base


# name -> (the layout's flags, the job's flags); every job trains STEPS
JOBS = {
    "de2d": ({"num_data_shards": 2}, {}),
    "de2d_flags": ({"num_data_shards": 2},
                   {"augment_flip_x": True, "relative_loss": True,
                    "device_data_cache": True, "grad_clip": 0.05}),
    "de3d": ({"num_data_shards": 2},
             {"dataset": "tiny3d", "batch_size": 4, "relative_loss": True,
              "grad_clip": 0.05}),
    "ae": ({"num_data_shards": 2}, {"arch": "ae"}),
    "ae_pred": ({"num_data_shards": 2},
                {"arch": "ae", "ae_pred_w": 0.5, "device_data_cache": True}),
    "nn": ({"num_data_shards": 2},
           {"arch": "nn", "w_num": 3, "nn_noise": 0.05}),
    "tp": ({"num_model_shards": 2},
           {"augment_flip_x": True, "grad_clip": 0.05}),
    # every rank reads the one global grain stream and keeps its rows
    "dp_grain": ({"num_data_shards": 2}, {"input_pipeline": "grain"}),
}


SMOOTH = {"dp": {"num_data_shards": 2}, "sp": {"spatial_shard": True},
          "tp": {"num_model_shards": 2}}
ROWS_BY_CHANNELS = {"spatial_shard": True, "num_data_shards": 2,
                    "num_model_shards": 2}
# name -> (the one-process run it is held against, its layout, ranks): the
# generator with the spectral residuals and the basis injection under
# --spatial_shard and rows x channels, and the autoencoder under rows x
# channels
SMOOTH_KNOBS = {"sp_knobs": ("knobs", {"spatial_shard": True}, RANKS),
                "sptp_knobs": ("knobs", ROWS_BY_CHANNELS, GRID),
                "sptp_ae": ("ae", ROWS_BY_CHANNELS, GRID)}
KNOBS = {"spectral_modes": 4, "decoder": "grid", "grid_rank": 4}


def _null(key: str) -> bool:
    return key.endswith("conv_out/bias")


def _weights(run_dir: str) -> dict:
    with np.load(os.path.join(run_dir, "weights.npz")) as d:
        return {k: d[k] for k in d.files}


def _losses(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawns the ranks once; each job's directory, weights, one-process
    config and the ranks' results."""
    root = tmp_path_factory.mktemp("mh")
    data, logs = str(root / "data"), str(root / "logs")
    scenes.smoke_pos21_size5(data, num_pos=2, num_size=2, num_frames=4,
                             height=32, width=32, name="tiny_smoke")
    scenes.smoke3_vel5_buo3(data, num_vel=1, num_buo=1, num_frames=4,
                            depth=8, height=16, width=16, name="tiny3d")
    # codes for "nn": an AE at its init encodes the set
    ae = Trainer(PortConfig(**_kw(data, logs, arch="ae", tag="enc")),
                 device="cpu")
    encode_dataset(ae.encode, os.path.join(data, "tiny_smoke"), 8,
                   batch_size=8)
    jobs, runs = [], {}
    for name, (layout, flags) in JOBS.items():
        one = _kw(data, logs, tag=name, **flags)
        model = Trainer(PortConfig(**one), run_dir=str(root / "init" / name),
                        device="cpu", save_cfg=False)
        model.save_checkpoint()          # weights.npz of the init
        run = str(root / "ranks" / name)
        os.makedirs(run)
        shutil.copy(os.path.join(model.run_dir, "weights.npz"), run)
        runs[name] = (one, model.run_dir, run)
        jobs.append({"config": {**one, **layout}, "run_dir": run,
                     "steps": STEPS})
    # a checkpoint of one rank, resumed by the tensor-parallel pair
    one, init, _ = runs["tp"]
    os.makedirs(root / "one_tp")
    shutil.copy(os.path.join(init, "weights.npz"), root / "one_tp")
    t1 = Trainer(PortConfig(**one), run_dir=str(root / "one_tp"),
                 device="cpu", save_cfg=False)
    t1.restore_weights()
    t1.train(2)
    tp_resume = str(root / "ranks" / "tp_resume")
    shutil.copytree(t1.run_dir, tp_resume)
    jobs.append({"config": {**one, "num_model_shards": 2},
                 "run_dir": tp_resume, "resume": True, "steps": 1})
    # the pair's gradients of one global batch, and a 2-step checkpoint
    tp_grads = str(root / "ranks" / "tp_grads")
    shutil.copytree(os.path.join(root, "ranks", "tp"), tp_grads)
    x, y = t1.bm.step_batch(1)
    np.savez(str(root / "batch.npz"), a=x, b=y)
    jobs.append({"config": {**one, "num_model_shards": 2},
                 "run_dir": tp_grads, "batch": str(root / "batch.npz"),
                 "out": str(root / "tp_grads.npz"), "steps": 2})
    # the generator with the knobs, its gains and bases drawn at random
    # (zero at init, where they would prove nothing)
    knobs = _kw(data, logs, tag="knobs", **KNOBS)
    mk = Trainer(PortConfig(**knobs), run_dir=str(root / "init" / "knobs"),
                 device="cpu", save_cfg=False)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for n, p in mk.model.named_parameters():
            if n.split(".")[-1].startswith(("gain_", "basis_")):
                p.copy_(torch.from_numpy(
                    rng.normal(0, 0.05, p.shape).astype(np.float32)))
    mk.save_checkpoint()
    runs["knobs"] = (knobs, mk.run_dir, None)
    # the gradients of each layout with a smooth activation
    grid_jobs = []
    smooth = {name: (runs[base][0], runs[base][1], layout, ranks)
              for name, (base, layout, ranks) in SMOOTH_KNOBS.items()}
    smooth.update({name: (one, init, layout, RANKS)
                   for name, layout in SMOOTH.items()})
    for name, (cfg, start, layout, ranks) in smooth.items():
        run = str(root / "ranks" / f"smooth_{name}")
        os.makedirs(run)
        shutil.copy(os.path.join(start, "weights.npz"), run)
        (jobs if ranks == RANKS else grid_jobs).append(
            {"config": {**cfg, **layout}, "run_dir": run,
             "batch": str(root / "batch.npz"), "smooth": True,
             "out": str(root / f"smooth_{name}.npz")})
    # rows x channels: a 2-step checkpoint (and each rank's own blocks),
    # and a one-process checkpoint resumed for a third step
    sptp_ckpt = str(root / "ranks" / "sptp_ckpt")
    os.makedirs(sptp_ckpt)
    shutil.copy(os.path.join(mk.run_dir, "weights.npz"), sptp_ckpt)
    grid_jobs.append({"config": {**knobs, **ROWS_BY_CHANNELS},
                      "run_dir": sptp_ckpt, "steps": 2,
                      "local": str(root / "sptp_local")})
    one_knobs = str(root / "one_knobs")
    os.makedirs(one_knobs)
    shutil.copy(os.path.join(mk.run_dir, "weights.npz"), one_knobs)
    tk = Trainer(PortConfig(**knobs), run_dir=one_knobs, device="cpu",
                 save_cfg=False)
    tk.restore_weights()
    tk.train(2)
    sptp_resume = str(root / "ranks" / "sptp_resume")
    shutil.copytree(one_knobs, sptp_resume)
    grid_jobs.append({"config": {**knobs, **ROWS_BY_CHANNELS},
                      "run_dir": sptp_resume, "resume": True, "steps": 1})
    # last: --die_at_step kills both ranks at step 2
    die = str(root / "ranks" / "die")
    os.makedirs(die)
    shutil.copy(os.path.join(init, "weights.npz"), die)
    jobs.append({"config": {**runs["de2d"][0], "num_data_shards": 2,
                            "die_at_step": 2, "save_step": 1},
                 "run_dir": die, "steps": 4})

    def spawn(name: str, job_list: list, ranks: int):
        with open(root / f"{name}.json", "w") as f:
            json.dump(job_list, f)
        return launch_multihost.spawn(
            [sys.executable, "-c", WORKER, str(root / f"{name}.json")],
            ranks, "gloo", threads=1, capture=True, timeout=600)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:      # both groups at once
        pair = pool.submit(spawn, "jobs", jobs, RANKS)
        grid = pool.submit(spawn, "grid_jobs", grid_jobs, GRID)
        (rcs, outs), (grcs, gouts) = pair.result(), grid.result()
    assert rcs == [17] * RANKS, (rcs, outs[0][-3000:], outs[1][-3000:])
    assert grcs == [0] * GRID and all("WORKER_OK" in o for o in gouts), (
        grcs, gouts[0][-3000:])
    return {"root": root, "runs": runs, "tp_resume": tp_resume,
            "tp_grads": tp_grads, "batch": (x, y), "die": die,
            "sptp_ckpt": sptp_ckpt, "sptp_resume": sptp_resume,
            "sptp_local": str(root / "sptp_local")}


def _one_process(group, name: str, steps: int = STEPS) -> str:
    """The run directory of job ``name`` trained here in one process."""
    one, init, _ = group["runs"][name]
    run = str(group["root"] / "one" / name)
    if not os.path.isdir(run):
        os.makedirs(run)
        shutil.copy(os.path.join(init, "weights.npz"), run)
        t = Trainer(PortConfig(**one), run_dir=run, device="cpu",
                    save_cfg=False)
        t.restore_weights()
        t.train(steps)
    return run


@pytest.mark.parametrize("name", list(JOBS))
def test_two_ranks_train_as_one_process(group, name):
    one = _one_process(group, name)
    two = group["runs"][name][2]
    got, want = _losses(two), _losses(one)
    assert [r["step"] for r in got] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k.startswith("loss"):
                assert g[k] == pytest.approx(w[k], rel=1e-6), (k, g, w)
    wg, ww = _weights(two), _weights(one)
    assert set(wg) == set(ww)
    moved = 0.0
    for k in ww:
        assert wg[k].shape == ww[k].shape, k
        if not _null(k):
            np.testing.assert_allclose(wg[k], ww[k], atol=1e-5, err_msg=k)
            moved = max(moved, float(np.abs(ww[k] - _weights(
                group["runs"][name][1])[k]).max()))
    assert moved > 1e-4, "the weights did not move"


def test_tensor_parallel_grads_match_one_process(group):
    """The pair's loss and gradients of one batch equal one process's."""
    one, init, _ = group["runs"]["tp"]
    t = Trainer(PortConfig(**one), run_dir=init, device="cpu",
                save_cfg=False)
    t.restore_weights()
    loss, grads = t._loss_and_grads(*group["batch"])
    with np.load(group["root"] / "tp_grads.npz") as d:
        got = {k: d[k] for k in d.files}
    assert float(got.pop("__loss__")) == pytest.approx(loss, rel=1e-5)
    assert set(got) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(SMOOTH) + list(SMOOTH_KNOBS))
def test_layout_grads_match_one_process_without_the_kink(group, name,
                                                        monkeypatch):
    """Data parallel, --spatial_shard and --num_model_shards 2, and the
    generator with the spectral residuals and the basis injection under
    --spatial_shard and rows x channels (2 x 2), and the autoencoder under
    rows x channels: loss and every gradient within 1e-5 of one process's,
    relative to the parameter's largest entry (a smooth activation, so no
    point can take the other slope).  The smooth loss differs from the
    leaky one: the stand-in reached the models."""
    base = SMOOTH_KNOBS[name][0] if name in SMOOTH_KNOBS else "tp"
    one, init, _ = group["runs"][base]
    t = Trainer(PortConfig(**one), run_dir=init, device="cpu",
                save_cfg=False)
    t.restore_weights()
    leaky_loss, _ = t._loss_and_grads(*group["batch"])
    monkeypatch.setattr(activation, "bias_leaky_relu",
                        activation.bias_smooth)
    loss, grads = t._loss_and_grads(*group["batch"])
    # live: the losses differ by far more than the 1e-6 held below
    assert abs(loss - leaky_loss) > 1e-4 * abs(leaky_loss), (loss,
                                                             leaky_loss)
    with np.load(group["root"] / f"smooth_{name}.npz") as d:
        got = {k: d[k] for k in d.files}
    assert float(got.pop("__loss__")) == pytest.approx(loss, rel=1e-6)
    assert set(got) == set(grads)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for k, g in grads.items():
        ref = scale if _null(k) else float(np.abs(g).max())
        err = float(np.abs(got[k] - g).max()) / ref
        assert err < 1e-5, (k, err)


def test_rows_by_channels_checkpoint_is_bit_equal_on_one_process(group):
    """A checkpoint written by the 2 x 2 ranks restores in one process to
    the ranks' own weights, bit for bit: each rank's block of a cut conv
    and every replicated parameter."""
    one, _, _ = group["runs"]["knobs"]
    t = Trainer(PortConfig(**one), run_dir=group["sptp_ckpt"], device="cpu",
                save_cfg=False)
    assert t.restore_checkpoint() == 2
    whole = {k: v.numpy() for k, v in t.model.state_dict().items()}
    cut = 0
    for rank in range(GRID):
        m = rank % 2                   # rank = row index * 2 + model index
        with np.load(f"{group['sptp_local']}.rank{rank}.npz") as d:
            local = {k: d[k] for k in d.files}
        assert set(local) == set(whole)
        for k, w in whole.items():
            if local[k].shape != w.shape:
                n = local[k].shape[0]
                w = w[m * n:(m + 1) * n]
                cut += 1
            np.testing.assert_array_equal(local[k], w, err_msg=k)
    assert cut
    flat = _weights(group["sptp_ckpt"])
    for k, v in state_dict_to_flax(t.model.state_dict()).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


@pytest.mark.parametrize("direction", ["four_to_one", "one_to_four"])
def test_rows_by_channels_checkpoint_resumes_across_layouts(group,
                                                             direction):
    """The 2 x 2 ranks' checkpoint resumes in one process, and one
    process's in the 2 x 2 ranks; both land on the uninterrupted run."""
    one, _, _ = group["runs"]["knobs"]
    want = _weights(_one_process(group, "knobs"))
    if direction == "four_to_one":
        run = str(group["root"] / "resumed_sptp")
        shutil.copytree(group["sptp_ckpt"], run)
        t = Trainer(PortConfig(**one), run_dir=run, device="cpu",
                    save_cfg=False)
        assert t.restore_checkpoint() == 2
        t.train(1)
        got = _weights(run)
    else:
        got = _weights(group["sptp_resume"])
        assert [r["step"] for r in _losses(group["sptp_resume"])][-1] == 3
    assert set(got) == set(want)
    for k in want:
        if not _null(k):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("direction", ["two_to_one", "one_to_two"])
def test_checkpoint_resumes_across_layouts(group, direction):
    """A checkpoint of the tensor-parallel pair resumes in one process,
    and one process's in the pair; both land on the uninterrupted run."""
    one, _, _ = group["runs"]["tp"]
    want = _weights(_one_process(group, "tp"))
    if direction == "two_to_one":
        run = str(group["root"] / "resumed_one")
        shutil.copytree(group["tp_grads"], run)    # the pair's 2 steps
        t = Trainer(PortConfig(**one), run_dir=run, device="cpu",
                    save_cfg=False)
        assert t.restore_checkpoint() == 2
        t.train(1)
        got = _weights(run)
    else:
        got = _weights(group["tp_resume"])
        steps = [r["step"] for r in _losses(group["tp_resume"])]
        assert steps[-1] == 3
    for k in want:
        if not _null(k):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)


def test_every_rank_dies_at_the_fault_step(group):
    """--die_at_step on two ranks: both exit 17 at step 2, before its
    checkpoint, and the sentinel lets a relaunched group pass the step."""
    die = group["die"]
    assert [r["step"] for r in _losses(die)] == [1, 2]
    assert sorted(os.listdir(os.path.join(die, "checkpoint"))) == ["1"]
    assert os.path.exists(os.path.join(die, ".fault_injected"))


def test_launcher_agrees_with_one_process():
    out = subprocess.run(
        [sys.executable, "-m", "deepfluids_tpu_torch.tools.launch_multihost",
         "--device", "cpu", "--num_processes", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "one process agrees" in out.stdout


def test_dryrun_multichip_passes_every_stage():
    lines = dryrun.dryrun_multichip(2, "cpu")
    assert len(lines) == len(dryrun.STAGES)
    assert "TP (1x2) train step ok" in lines[5]


def test_group_exit_code_names_the_fault():
    assert launch_multihost.group_exit_code([0, 0]) == 0
    assert launch_multihost.group_exit_code([1, 17]) == 17
    assert launch_multihost.group_exit_code([0, 3, 1]) == 3
    # a rank that fails stops the group, and 17 wins
    rcs, _ = launch_multihost.spawn(
        [sys.executable, "-c", "import os, sys, time; r = os.environ['RANK']"
         "; sys.exit(17) if r == '1' else time.sleep(60)"], 2, "gloo",
        grace=1.0)
    assert rcs[1] == 17 and rcs[0] != 0
    assert launch_multihost.group_exit_code(rcs) == 17


def test_main_under_world_size_without_a_card_raises(monkeypatch, tmp_path):
    """torchrun's variables and no card: main refuses rather than fall back
    to the CPU."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PortConfig(**_kw(str(tmp_path), str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA card"):
        torch_main(cfg)
    assert not os.listdir(tmp_path)
