"""The port's tools against the JAX package's, on the same data.

``rollout_eval``, ``eval_run``, ``latent_predictability``, ``weights_io``,
``solver_consistency``, ``regen_all`` and ``make_goldens`` of
``deepfluids_tpu_torch.tools`` beside their originals under the repo-root
``tools/``: run data is made with numpy from a seed, weights are carried
across with the converter, and every tool runs with ``--device cpu`` and
``--out`` under ``tmp_path`` (the repo's ``BENCHMARKS.jsonl`` stays as it
is).  Each tolerance is stated where it is used.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import eval_run as j_eval_run  # noqa: E402
from tools import latent_predictability as j_latent  # noqa: E402
from tools import regen_all as j_regen  # noqa: E402
from tools import rollout_eval as j_rollout_eval  # noqa: E402
from tools import weights_io as j_weights_io  # noqa: E402

from deepfluids_tpu.config import Config as JaxConfig  # noqa: E402
from deepfluids_tpu.datagen import scenes as j_scenes  # noqa: E402
from deepfluids_tpu.models import GeneratorBE as FlaxGeneratorBE  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu_torch.config import Config as PortConfig  # noqa: E402
from deepfluids_tpu_torch.data import Manifest, save_manifest  # noqa: E402
from deepfluids_tpu_torch.datagen import scenes as t_scenes  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    GeneratorBE,
    flax_init_,
    flax_to_state_dict,
)
from deepfluids_tpu_torch.tools import (  # noqa: E402
    _record,
    curl_tiles,
    eval_run,
    jacobian_tiles,
    latent_predictability,
    make_goldens,
    regen_all,
    rollout_eval,
    solver_consistency,
    weights_io,
)
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402

STAMP = {"backend": "cpu", "device": "cpu", "power_limit_w": None}
BENCHMARKS = os.path.join(REPO, "BENCHMARKS.jsonl")


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module", autouse=True)
def benchmarks_untouched():
    """No tool of the port writes the JAX package's BENCHMARKS.jsonl."""
    before = _digest(BENCHMARKS)
    yield
    assert _digest(BENCHMARKS) == before


def _last_record(path) -> dict:
    with open(path) as f:
        return json.loads(f.read().strip().splitlines()[-1])


# --- _record ---------------------------------------------------------------

def test_record_stamps_and_appends(tmp_path, capsys):
    out = tmp_path / "sub" / "rec.jsonl"
    for i in range(2):
        rec = _record.write({"metric": "m", "value": i}, "cpu", str(out))
    assert {k: rec[k] for k in STAMP} == STAMP and "ts" in rec
    lines = out.read_text().splitlines()
    assert [json.loads(ln)["value"] for ln in lines] == [0, 1]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert _record.DEFAULT_OUT == "BENCHMARKS_torch.jsonl"


@pytest.mark.parametrize("tool,argv", [
    (eval_run, ["run"]), (rollout_eval, ["run"]),
    (latent_predictability, ["ds", "16"]), (solver_consistency, ["2d"]),
    (regen_all, ["--verify_only"]), (make_goldens, ["--out", "x"]),
    (weights_io, ["run"]), (curl_tiles, []), (jacobian_tiles, [])])
def test_tools_raise_without_a_card(tool, argv):
    # The default device is the card; this machine has none.
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="found none"):
        tool.main(argv)


# --- rollout_eval ----------------------------------------------------------

def _rollout_fixture(tmp_path, scene="0", other="10", frames=8, res=(4, 6),
                     z_num=16, drift=0.0, data_dir=None):
    """A synthetic dataset and nn-run dir in the rollout.npz contract (the
    fixture of tests/test_tools.py); the run dir."""
    rng = np.random.default_rng(3)
    ds = tmp_path / "data" / "toy"
    (ds / "v").mkdir(parents=True)
    code = ds / f"code{z_num}"
    code.mkdir()
    for s in (scene, other):
        np.savez_compressed(code / f"{s}.npz", z=np.zeros((frames, z_num)))
    gt = rng.normal(size=(frames, *res, 2)).astype(np.float32)
    for t in range(frames):
        np.savez_compressed(ds / "v" / f"{scene}_{t}.npz", x=gt[t])
        np.savez_compressed(ds / "v" / f"{other}_{t}.npz", x=gt[t] * 7.0)
    err = rng.normal(size=gt.shape).astype(np.float32)
    err *= drift * np.arange(1, frames + 1,
                             dtype=np.float32)[:, None, None, None]
    run = tmp_path / "logs" / "toy_nn"
    (run / "test").mkdir(parents=True)
    np.savez_compressed(run / "test" / "rollout.npz",
                        z=np.zeros((frames, z_num)), x=gt + err)
    with open(run / "params.json", "w") as f:
        json.dump({"arch": "nn", "dataset": "toy",
                   "data_dir": data_dir or str(tmp_path / "data"),
                   "z_num": z_num}, f)
    return str(run)


@pytest.mark.parametrize("drift,frames", [(0.05, 8), (0.0, 8), (0.02, 13)])
def test_rollout_eval_record_matches_jax_tool(tmp_path, monkeypatch, drift,
                                              frames):
    run = _rollout_fixture(tmp_path, drift=drift, frames=frames)
    monkeypatch.setattr(j_rollout_eval, "ROOT", str(tmp_path))
    want = j_rollout_eval.main([run, "note"])
    out = tmp_path / "port.jsonl"
    got = rollout_eval.main([run, "note", "--device", "cpu", "--out",
                             str(out)])
    assert got == _last_record(out)
    assert {k: got[k] for k in STAMP} == STAMP
    keys = [k for k in want if k != "ts"]
    assert set(keys) <= set(got)
    for k in keys:
        if isinstance(want[k], float):
            # the same numpy arithmetic on the same files: 1e-6
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
        else:
            assert got[k] == want[k], k
    if drift:
        assert got["l2_lastq_median"] > got["l2_firstq_median"]
    else:
        assert got["l2_median"] == 0.0 and got["l2_max"] == 0.0


def test_rollout_eval_relative_data_dir_and_clipping(tmp_path, monkeypatch):
    # A relative data_dir resolves against ROOT, not the current directory;
    # a rollout shorter than the scene clips the horizon.
    run = _rollout_fixture(tmp_path, drift=0.03, data_dir="data")
    p = os.path.join(run, "test", "rollout.npz")
    with np.load(p) as d:
        np.savez_compressed(p, z=d["z"][:5], x=d["x"][:5])
    monkeypatch.setattr(rollout_eval, "ROOT", str(tmp_path))
    monkeypatch.setattr(j_rollout_eval, "ROOT", str(tmp_path))
    monkeypatch.chdir(tmp_path / "logs")
    got = rollout_eval.main([run, "--device", "cpu", "--out",
                             str(tmp_path / "o.jsonl")])
    want = j_rollout_eval.main([run])
    assert got["rollout_steps"] == want["rollout_steps"] == 5
    assert got["scene"] == "0"
    assert got["l2_median"] == pytest.approx(want["l2_median"], abs=1e-6)


# --- eval_run --------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    """A 2 x 2 scene x 4 frame 32 x 32 smoke set, written by the JAX
    datagen."""
    root = tmp_path_factory.mktemp("tools_data")
    j_scenes.smoke_pos21_size5(str(root), num_pos=2, num_size=2,
                               num_frames=4, height=32, width=32,
                               name="tiny_smoke")
    return str(root)


def _tiny_kw(data_dir, log_dir, **kw) -> dict:
    # batch 8: the JAX trainer shards it over conftest's 8 CPU devices
    base = dict(arch="de", filters=8, num_conv=1, batch_size=8,
                data_dir=data_dir, dataset="tiny_smoke", log_dir=log_dir,
                max_step=4, lr_max=2e-3, lr_min=1e-4, log_step=2,
                test_step=10_000, save_step=10_000, compute_dtype="float32",
                num_worker=2, seed=0, test_batch_size=8)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def run_pair(smoke_data, tmp_path_factory):
    """A JAX run trained 4 steps and a port run holding the same weights
    (carried across with the converter) as its checkpoint; (jax run dir,
    port run dir, the JAX trainer's flat params)."""
    logs = str(tmp_path_factory.mktemp("tools_logs"))
    jt = JaxTrainer(JaxConfig(**_tiny_kw(smoke_data, logs, tag="jax")))
    jt.train(num_steps=4)
    flat = j_weights_io.flatten_params(jax.device_get(jt.state.params))
    pt = Trainer(PortConfig(**_tiny_kw(smoke_data, logs, tag="port")),
                 device="cpu")
    pt.model.load_state_dict(flax_to_state_dict(flat, pt.model))
    pt.step = 4
    pt.save_checkpoint()
    return jt.run_dir, pt.run_dir, flat


@pytest.mark.parametrize("pool", ["auto", "train"])
def test_eval_run_record_matches_jax_tool(run_pair, tmp_path, monkeypatch,
                                          capsys, pool):
    jax_run, port_run, _ = run_pair
    monkeypatch.setattr(j_eval_run, "ROOT", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["eval_run.py", jax_run, "12", "n",
                                      "--pool", pool])
    j_eval_run.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = tmp_path / "port.jsonl"
    got = eval_run.main([port_run, "12", "n", "--pool", pool, "--device",
                         "cpu", "--out", str(out)])
    assert got == _last_record(out)
    assert got["metric"] == want["metric"] == "eval_de"
    assert (got["step"], got["num_samples"], got["holdout"], got["note"]) == (
        want["step"], want["num_samples"], want["holdout"], "n")
    assert got["run"] == os.path.basename(port_run)
    # Generated fields of the same weights agree at the 1e-3 parity gate,
    # so their L2 / rmse statistics do within 1e-3 (they are O(1) here).
    for k in ("l2_mean", "l2_median", "l2_max", "rmse"):
        assert got[k] == pytest.approx(want[k], abs=1e-3), k
    assert got["per_scene_l2_median"].keys() == (
        want["per_scene_l2_median"].keys())
    for k, v in want["per_scene_l2_median"].items():
        assert got["per_scene_l2_median"][k] == pytest.approx(v, abs=1e-3)


# --- weights_io ------------------------------------------------------------

def _flax_template():
    fm = FlaxGeneratorBE(output_shape=(32, 32, 1), filters=8, num_conv=1)
    return fm.init(jax.random.PRNGKey(1), jnp.zeros((1, 3)))["params"]


def _port_model(seed=3):
    return flax_init_(GeneratorBE((32, 32, 1), num_param=3, filters=8,
                                  num_conv=1), seed)


def _assert_trees_equal(a, b):
    # (a tree keeps its template's order: Flax sorts, the port's follows
    # its modules)
    fa, fb = weights_io.flatten_params(a), weights_io.flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("mode", ["exact", "by_shape"])
def test_weights_io_port_export_is_read_by_jax(tmp_path, mode):
    model = _port_model()
    path = weights_io.export_npz(weights_io.model_template(model),
                                 str(tmp_path / "w.npz"))
    got = j_weights_io.import_npz(path, _flax_template(), mode=mode)
    _assert_trees_equal(got, weights_io.unflatten_params(
        weights_io.model_template(model)))
    # and the port reads its own file back into a fresh model, bit for bit
    fresh = weights_io.import_into_model(path, _port_model(seed=9), mode=mode)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["exact", "by_shape"])
def test_weights_io_jax_export_is_read_by_port(tmp_path, mode):
    params = jax.device_get(_flax_template())
    path = j_weights_io.export_npz(params, str(tmp_path / "w.npz"))
    model = _port_model()
    got = weights_io.import_npz(path, weights_io.model_template(model),
                                mode=mode)
    _assert_trees_equal(got, params)
    _assert_trees_equal(got, j_weights_io.import_npz(path, _flax_template(),
                                                     mode=mode))
    weights_io.import_into_model(path, model, mode=mode)
    # the loaded model computes what Flax computes (1e-3 parity gate; the
    # same f32 network on the CPU agrees to ~1e-6)
    p = np.random.default_rng(0).uniform(-1, 1, (3, 3)).astype(np.float32)
    fm = FlaxGeneratorBE(output_shape=(32, 32, 1), filters=8, num_conv=1)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(p)))
    with torch.no_grad():
        ours = model(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(ours, want, atol=1e-5)


def _broken(flat: dict, how: str) -> dict:
    flat = dict(flat)
    first = next(iter(flat))
    if how == "missing":
        del flat[first]
    elif how == "extra":
        flat["stale/kernel"] = np.zeros((2, 2), np.float32)
    else:
        k = next(k for k, v in flat.items() if v.ndim == 2)
        flat[k] = flat[k].T.copy()
    return flat


@pytest.mark.parametrize("how,exc,match", [
    ("missing", KeyError, "npz missing 1 params"),
    ("extra", KeyError, "no matching param"),
    ("shape", ValueError, "shape mismatches")])
def test_weights_io_refuses_like_the_original(tmp_path, how, exc, match):
    model = _port_model()
    template = weights_io.model_template(model)
    path = str(tmp_path / "w.npz")
    np.savez_compressed(path, **_broken(template, how))
    for mod, tmpl in ((weights_io, template),
                      (j_weights_io, weights_io.unflatten_params(template))):
        with pytest.raises(exc, match=match):
            mod.import_npz(path, tmpl, mode="exact")
    with pytest.raises(ValueError, match="unknown mode"):
        weights_io.import_npz(path, template, mode="fuzzy")


def test_weights_io_by_shape_warns_and_refuses_leftovers(tmp_path, capsys):
    template = weights_io.model_template(_port_model())
    path = str(tmp_path / "w.npz")
    np.savez_compressed(path, **template)
    weights_io.import_npz(path, template, mode="by_shape")
    assert "ambiguous shape groups by insertion order" in (
        capsys.readouterr().err)
    np.savez_compressed(path, **_broken(template, "extra"))
    with pytest.raises(KeyError, match="unmatched source tensors"):
        weights_io.import_npz(path, template, mode="by_shape")
    np.savez_compressed(path, **_broken(template, "missing"))
    with pytest.raises(KeyError, match="no tensor of shape"):
        weights_io.import_npz(path, template, mode="by_shape")


def test_weights_io_export_run_round_trips(run_pair, tmp_path):
    _, port_run, flat = run_pair
    path = weights_io.main([port_run, str(tmp_path / "x.npz"), "--device",
                            "cpu"])
    t = Trainer(PortConfig(**json.load(open(
        os.path.join(port_run, "params.json")))), run_dir=port_run,
        device="cpu", save_cfg=False)
    for mode in ("exact", "by_shape"):
        got = weights_io.flatten_params(weights_io.import_npz(
            path, weights_io.model_template(t.model), mode=mode))
        assert sorted(got) == sorted(flat)
        for k in flat:      # the JAX run's weights, bit for bit
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


# --- latent_predictability ---------------------------------------------------

@pytest.fixture(scope="module")
def code_set(tmp_path_factory):
    """8 scenes x 40 frames of codes with noisy linear dynamics."""
    ds = tmp_path_factory.mktemp("codes") / "mov"
    save_manifest(Manifest(
        param_names=["src_x_pos", "frame"],
        param_ranges=[[0.2, 0.8], [0.0, 39.0]], num_scenes=8, num_frames=40,
        resolution=[8, 6], num_channels=2, v_range=[-1.0, 1.0]), str(ds))
    os.makedirs(ds / "code16")
    rng = np.random.default_rng(11)
    a = 0.1 * rng.standard_normal((14, 14))
    for s in range(8):
        p = np.stack([0.5 + 0.3 * np.sin(np.linspace(0, 3, 40) + s),
                      np.arange(40.0)], 1)
        z = np.zeros((40, 14))
        z[0] = rng.standard_normal(14)
        for t in range(39):
            z[t + 1] = z[t] + z[t] @ a + 0.05 * rng.standard_normal(14)
        pn = np.stack([(p[:, 0] - 0.5) / 0.3, p[:, 1] / 19.5 - 1], 1)
        np.savez_compressed(ds / "code16" / f"{s}.npz",
                            z=np.concatenate([pn, z], 1).astype(np.float32),
                            p=p.astype(np.float32))
    return str(ds)


@pytest.mark.parametrize("flags", [[], ["--history", "3"], ["--rff", "32"],
                                   ["--history", "2", "--rff", "16"]])
def test_latent_predictability_matches_jax_tool(code_set, tmp_path,
                                                monkeypatch, capsys, flags):
    argv = [code_set, "16", "2", "", "note", *flags]
    monkeypatch.setattr(j_latent, "ROOT", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["latent_predictability.py", *argv])
    j_latent.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = latent_predictability.main(
        argv + ["--device", "cpu", "--out", str(tmp_path / "o.jsonl")])
    for k, v in want.items():
        if k == "ts":
            continue
        # the same numpy fit of the same codes: R^2 within 1e-6
        assert got[k] == (pytest.approx(v, abs=1e-6)
                          if isinstance(v, (float, list)) and k.startswith(
                              "r2") else v), k
    assert 0.0 < got["r2_holdout_median"] <= 1.0
    assert len(got["r2_holdout_per_scene"]) == 2
    # the classes are the original's: same design rows, same fit
    z, p = np.load(os.path.join(code_set, "code16", "0.npz")).values()
    for h in (1, 2):
        for a, b in zip(latent_predictability.design(z, p, h),
                        j_latent.design(z, p, h)):
            np.testing.assert_array_equal(a, b)


# --- solver_consistency ------------------------------------------------------

_JAX_STUDY = """
import json, sys
sys.path.insert(0, "tools")
import solver_consistency as sc
print(json.dumps({
    "2d": sc.run_study(height=32, width=24, frames=12, ensemble=2),
    "3d": sc.run_study_3d(depth=8, height=12, width=16, frames=6,
                          ensemble=2)}))
"""


@pytest.fixture(scope="module")
def jax_studies():
    """The original's records at a tiny grid, from its own process (it
    switches jax to float64 at import, which must not reach this one)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_STUDY], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("study", ["2d", "3d"])
def test_solver_consistency_matches_the_original(jax_studies, study):
    want = jax_studies[study]
    if study == "2d":
        got = solver_consistency.run_study(height=32, width=24, frames=12,
                                           ensemble=2, device="cpu")
    else:
        got = solver_consistency.run_study_3d(depth=8, height=12, width=16,
                                              frames=6, ensemble=2,
                                              device="cpu")
    assert got["metric"] == want["metric"]
    assert (got["resolution"], got["frames"], got["ensemble"]) == (
        want["resolution"], want["frames"], want["ensemble"])
    assert set(want) - {"backend", "ts"} <= set(got)
    # residuals after a projection and distances to the converged field:
    # 1e-4 relative (the records round to 1e-6)
    for key in ("div_residual_vs_unprojected", "vel_rel_l2_to_converged"):
        assert got[key].keys() == want[key].keys()
        for k, v in want[key].items():
            assert got[key][k] == pytest.approx(v, rel=1e-4, abs=2e-6), k
    # the float64 CG is converged on both sides
    assert got["cg_compact_residual_rel"] < 1e-5
    assert want["cg_compact_residual_rel"] < 1e-5
    # trajectory statistics of two f32 solvers that agree to 1e-5 a step,
    # before chaos sets in: 1e-3 absolute
    for k in ("ke_rel_err_early_max", "ke_stat_rel_jacobi_vs_cg",
              "ke_stat_rel_chaos_control", "spectrum_rel_med_jacobi_vs_cg",
              "spectrum_rel_med_chaos_control", "traj_l2_final_over_vscale"):
        assert got[k] == pytest.approx(want[k], abs=1e-3), k
    for k in ("ke_signed_gaps_jacobi_vs_cg", "ke_signed_gaps_chaos_control"):
        assert got[k] == pytest.approx(want[k], abs=1e-3), k


def test_solver_consistency_qualitative_pins(tmp_path):
    # The pins of tests/test_datagen.py TestSolverConsistency at its grid,
    # through the tool's record: converged CG < Jacobi-100 < Jacobi-20, and
    # the Jacobi fields approach the converged one monotonically.
    rec = solver_consistency.main([
        "2d", "--height", "48", "--width", "32", "--frames", "20",
        "--ensemble", "1", "--device", "cpu", "--out",
        str(tmp_path / "o.jsonl")])
    res, dist = rec["div_residual_vs_unprojected"], rec[
        "vel_rel_l2_to_converged"]
    assert res["cg"] < res["jacobi_100"] < res["jacobi_50"] < res[
        "jacobi_20"] < 1.0
    assert dist["jacobi_100"] < dist["jacobi_50"] < dist["jacobi_20"]
    assert rec["cg_compact_residual_rel"] < 1e-5
    assert rec["cut"] == {"frames": 20, "ensemble": 1, "height": 48,
                          "width": 32}
    assert {k: rec[k] for k in STAMP} == STAMP
    # the control twin's gap (the chaos floor) is below the solver's
    assert rec["ke_stat_rel_chaos_control"] <= rec[
        "ke_stat_rel_jacobi_vs_cg"]


def test_solver_consistency_matched_and_helpers():
    rec = solver_consistency.run_study_matched(height=32, width=24, frames=6,
                                               ensemble=2, device="cpu")
    assert rec["metric"] == "solver_consistency_matched2d"
    for k in ("ke_stat_rel_matched_vs_cg", "ke_stat_rel_jacobi_vs_cg",
              "spectrum_rel_med_matched_vs_cg"):
        assert np.isfinite(rec[k])
    assert len(rec["ke_signed_gaps_matched_vs_cg"]) == 2
    # the numpy helpers are the original's (no jax needed to compare them)
    v = np.random.default_rng(0).standard_normal((10, 12, 2))
    k = np.sqrt(sum(f ** 2 for f in np.meshgrid(
        np.fft.fftfreq(10), np.fft.rfftfreq(12), indexing="ij")))
    spec = solver_consistency.energy_spectrum(v)
    assert spec.shape == (16,) and k.max() > 0
    total = sum(np.abs(np.fft.rfftn(v[..., c], axes=(0, 1))) ** 2
                for c in range(2)).sum()
    assert spec.sum() == pytest.approx(total, rel=1e-12)
    vel = torch.from_numpy(v.astype(np.float32))
    assert solver_consistency.div_norm(vel) > 0


# --- regen_all ---------------------------------------------------------------

TINY_SPEC = dataclasses.replace(
    regen_all.FLEET[1], name="tiny", num_a=2, num_b=1, num_frames=3,
    resolution=(32, 32), projection="jacobi")


def test_regen_all_fleet_is_the_original():
    assert [dataclasses.asdict(s) for s in regen_all.FLEET] == [
        dataclasses.asdict(s) for s in j_regen.FLEET]
    spec, cut = regen_all.cut_spec(regen_all.FLEET[3], num_frames=8,
                                   num_a=2, num_b=4)
    assert (spec.num_scenes, spec.num_frames) == (2, 8)
    assert cut == {"num_frames": [400, 8], "num_a": [200, 2]}
    assert regen_all.cut_spec(regen_all.FLEET[0]) == (regen_all.FLEET[0], {})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_regen_all_verify_accepts_both_writers(tmp_path, writer):
    kw = dict(num_pos=2, num_size=1, num_frames=3, height=32, width=32,
              name="tiny")
    if writer == "jax":
        j_scenes.smoke_pos21_size5(str(tmp_path), **kw)
    else:
        t_scenes.smoke_pos21_size5(str(tmp_path), device="cpu", **kw)
    got = regen_all.verify(TINY_SPEC, str(tmp_path))
    want = j_regen.verify(j_regen.DatasetSpec(
        **dataclasses.asdict(TINY_SPEC)), str(tmp_path))
    assert got == want and got["files"] == {"v": 6, "d": 6}
    # a missing file, a wrong frame count and a non-finite frame are refused
    victim = os.path.join(str(tmp_path), "tiny", "d", "0_0_1.npz")
    os.rename(victim, victim + ".gone")
    with pytest.raises(ValueError, match="tiny/d: 5 files, expected 6"):
        regen_all.verify(TINY_SPEC, str(tmp_path))
    os.rename(victim + ".gone", victim)
    with pytest.raises(ValueError, match="manifest scenes/frames"):
        regen_all.verify(dataclasses.replace(TINY_SPEC, num_frames=4),
                         str(tmp_path))
    first = os.path.join(str(tmp_path), "tiny", "v", "0_0_0.npz")
    with np.load(first) as d:
        x, y = d["x"].copy(), d["y"]
    x[0, 0, 0] = np.nan
    np.savez_compressed(first, x=x, y=y)
    with pytest.raises(ValueError, match="non-finite"):
        regen_all.verify(TINY_SPEC, str(tmp_path))


def test_regen_all_cli_generates_verifies_and_refuses(tmp_path, capsys):
    # The real CLI at a cut grid: one datagen child on the CPU (the matched
    # projection at 128x96), then --verify_only, --skip_existing, and a
    # corrupted file count.
    common = ["--only", "smoke_pos21_size5_m", "--num-a", "1", "--num-b",
              "1", "--num-frames", "2", "--data_dir", str(tmp_path / "data"),
              "--log_dir", str(tmp_path / "logs"), "--device", "cpu",
              "--out", str(tmp_path / "fleet.jsonl")]
    regen_all.main(common)
    rec = _last_record(tmp_path / "fleet.jsonl")
    assert rec["metric"] == "datagen_fleet" and rec["ok"]
    assert rec["files"] == {"v": 2, "d": 2} and rec["wall_s"] > 0
    assert rec["cut"] == {"num_frames": [200, 2], "num_a": [21, 1],
                          "num_b": [5, 1]}
    assert rec["projection"] == "matched" and rec["backend"] == "cpu"
    assert "CUT (full -> this run)" in capsys.readouterr().out
    log = (tmp_path / "logs" / "datagen_smoke_pos21_size5_m.log").read_text()
    assert "dataset written to" in log
    regen_all.main(common + ["--verify_only"])
    assert "wall_s" not in _last_record(tmp_path / "fleet.jsonl")
    regen_all.main(common + ["--skip_existing"])
    assert "already verified clean, skipping" in capsys.readouterr().out
    os.remove(tmp_path / "data" / "smoke_pos21_size5_m" / "v" / "0_0_1.npz")
    with pytest.raises(SystemExit, match="1 dataset"):
        regen_all.main(common + ["--verify_only"])
    with pytest.raises(SystemExit, match="1 dataset"):
        # without the cut the full grid is expected
        regen_all.main(common[:2] + common[8:] + ["--verify_only"])


# --- make_goldens ------------------------------------------------------------

def test_make_goldens_check_passes_and_never_writes_the_reference(tmp_path):
    golden = os.path.join(REPO, "tests", "golden")
    before = {f: _digest(os.path.join(golden, f))
              for f in sorted(os.listdir(golden))}
    res = make_goldens.main(["--out", str(tmp_path / "g"), "--check",
                             "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "g")) == [
        "fd2d.npz", "fd3d.npz", "generator2d.npz", "smoke2d.npz"]
    # every dump is under the 1e-3 parity gate (the FD dumps are bit-equal)
    assert set(res["max_l2"]) == {
        "fd2d/u", "fd2d/j", "fd2d/w", "fd3d/u", "fd3d/j", "fd3d/w",
        "smoke2d/v", "smoke2d/r", "generator2d/u"}
    assert max(res["max_l2"].values()) < 1e-3
    assert max(v for k, v in res["max_l2"].items() if k[:2] == "fd") < 1e-6
    with pytest.raises(SystemExit, match="does not write there"):
        make_goldens.main(["--out", golden, "--device", "cpu"])
    assert before == {f: _digest(os.path.join(golden, f))
                      for f in sorted(os.listdir(golden))}


def test_make_goldens_check_catches_a_drifted_dump(tmp_path):
    dumps = make_goldens.compute("cpu")
    dumps["fd2d"]["u"] = dumps["fd2d"]["u"] * 1.01
    with pytest.raises(AssertionError, match="fd2d/u"):
        make_goldens.check(dumps)
    # without the reference's weights the init is the port's own, and the
    # weights are dumped beside the fields
    own = make_goldens.compute("cpu", golden_dir=str(tmp_path))
    assert "generator2d_params" in own
    assert own["generator2d"]["u"].shape == (4, 32, 24, 2)
    np.testing.assert_array_equal(own["generator2d"]["p"],
                                  dumps["generator2d"]["p"])
