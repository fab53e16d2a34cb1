"""The port's twins of the repo root's entry points against the originals.

``deepfluids_tpu_torch.graft_entry.entry`` against ``__graft_entry__.entry``
on shared, non-zero weights (Flax's init with randomized biases: the
flagship's own ``p`` is zeros and its biases are zero, so its output is
exactly zero in both packages and a parity check on it would be vacuous);
``deepfluids_tpu_torch.bench``'s JSON line against ``bench.py``'s keys; and
``deepfluids_tpu_torch/tools/run_predae_pipeline.sh`` against the port's
modules and parsers.
"""

import ast
import inspect
import json
import os
import re
import shlex
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
import __graft_entry__ as jax_entry  # noqa: E402
import weights_io  # noqa: E402

from deepfluids_tpu.models import GeneratorBE as FlaxGeneratorBE  # noqa: E402
from deepfluids_tpu.ops import curl2d as jax_curl2d  # noqa: E402
from deepfluids_tpu_torch import bench, graft_entry  # noqa: E402
from deepfluids_tpu_torch.config import get_config  # noqa: E402
from deepfluids_tpu_torch.main import split_device  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    GeneratorBE,
    flax_to_state_dict,
)
from deepfluids_tpu_torch.tools import dryrun, supervise  # noqa: E402
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402

PIPELINE = os.path.join(REPO, "deepfluids_tpu_torch", "tools",
                        "run_predae_pipeline.sh")


@pytest.fixture(scope="module")
def shared():
    """JAX's side on shared weights: its params with every bias drawn from
    a numpy seed, a random ``p`` of batch 2, JAX's ``entry`` fn on them
    (bf16) and the same weights through JAX's f32 GeneratorBE and curl."""
    fn, (params, p0) = jax_entry.entry()
    assert p0.shape == (8, 3) and not np.any(np.asarray(p0))
    flat = weights_io.flatten_params(params)
    rng = np.random.default_rng(11)
    for k in flat:
        if k.endswith("bias"):
            assert not np.any(flat[k])        # Flax's zero init
            flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(
                np.float32)
    p = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    tree = weights_io.unflatten_params(
        {k: jnp.asarray(v) for k, v in flat.items()})
    bf16 = np.asarray(fn(tree, jnp.asarray(p)), np.float32)
    fm = FlaxGeneratorBE(output_shape=(128, 96, 1), filters=128, num_conv=4,
                         dtype=jnp.float32)
    f32 = np.asarray(jax_curl2d(fm.apply({"params": tree}, jnp.asarray(p))))
    return flat, p, bf16, f32


def _port(flat, p, dtype):
    """The port's entry fn on the shared weights, its model in ``dtype``."""
    fn, (model, p0) = graft_entry.entry("cpu")
    assert p0.shape == (8, 3) and p0.dtype == torch.float32
    assert not torch.any(p0)
    if dtype != model.compute_dtype:
        model = GeneratorBE((128, 96, 1), num_param=3, filters=128,
                            num_conv=4, compute_dtype=dtype)
    model.load_state_dict(flax_to_state_dict(flat, model))
    with torch.inference_mode():
        u = fn(model, torch.from_numpy(p))
    assert u.shape == (2, 128, 96, 2) and u.dtype == torch.float32
    return u.numpy()


def test_entry_matches_jax_bf16(shared):
    """Against the exact field (JAX in f32) at the repo's bf16 bar, 2e-2
    (tests/test_torch_generator.py), and against JAX's own bf16 entry at
    3e-2.  At the flagship's depth (20 convolutions, then the curl's
    differences of neighbouring values) each package's bf16 field is
    1.5-1.8e-2 from the exact one on its own; two such independent
    roundings lie about sqrt(2) times that apart (2.05e-2 here)."""
    flat, p, want_bf16, want = shared
    got = _port(flat, p, torch.bfloat16)
    assert np.abs(want).max() > 0             # not the vacuous zero field
    assert normalized_l2(want_bf16, want) < 2e-2    # JAX's own bf16
    assert normalized_l2(got, want) < 2e-2
    assert normalized_l2(got, want_bf16) < 3e-2


def test_entry_matches_jax_f32(shared):
    # The same weights through both packages' f32 GeneratorBE and curl.
    flat, p, _, want = shared
    assert normalized_l2(_port(flat, p, torch.float32), want) < 1e-5


def test_entry_is_the_flagship_and_defaults_to_the_card():
    fn, (model, p) = graft_entry.entry("cpu")
    assert (model.output_shape, model.filters, model.num_conv,
            model.repeat, model.compute_dtype) == (
        (128, 96, 1), 128, 4, 5, torch.bfloat16)
    assert all(t.device.type == "cpu" for t in model.parameters())
    # Seeded: a second entry holds the same weights.
    again = graft_entry.entry("cpu")[1][0].state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA card"):
        graft_entry.entry()


def test_dry_runs_are_the_tools_own():
    for name in ("dryrun_multichip", "dryrun_multihost"):
        assert getattr(graft_entry, name) is getattr(dryrun, name)
        assert (inspect.signature(getattr(graft_entry, name))
                == inspect.signature(getattr(dryrun, name)))


def _jax_bench_keys() -> list[str]:
    """The keys of the dict ``bench.py`` passes to ``json.dumps``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "json.dumps"
             and n.args and isinstance(n.args[0], ast.Dict)]
    assert len(dumps) == 1
    return [k.value for k in dumps[0].args[0].keys]


# The bench's main() with the work cut by keyword, in a process that
# refuses jax and the JAX package: the port's bench and entry stand alone.
_BENCH = """
import functools, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "deepfluids_tpu"):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
from deepfluids_tpu_torch import bench
bench.run_device_bench = functools.partial(
    bench.run_device_bench, batch=2, chunks=2, iters=1, warmup=1,
    device="cpu")
bench.run_cpu_baseline = functools.partial(
    bench.run_cpu_baseline, iters=1, warmup=0)
bench.main()
"""


def test_bench_prints_jax_bench_keys():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _BENCH], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert list(rec) == _jax_bench_keys()
    assert rec["metric"] == "2d_velocity_fields_per_sec_per_chip"
    assert rec["value"] > 0 and rec["device_rate"] == rec["value"]
    # the subprocess proxy: one rate a window, their median
    assert len(rec["cpu_rates"]) == bench.CPU_WINDOWS
    assert rec["cpu_rates"] == sorted(rec["cpu_rates"])
    assert all(r > 0 for r in rec["cpu_rates"])
    assert rec["cpu_rate_median"] == pytest.approx(
        float(np.median(rec["cpu_rates"])), abs=0.01)
    assert rec["cpu_rate_pinned"] == bench.CPU_RATE_PINNED


def test_bench_takes_its_constants_as_keyword_defaults():
    for fn, names in ((bench.run_device_bench,
                       ("batch", "chunks", "iters", "warmup", "device")),
                      (bench.run_cpu_baseline, ("iters", "windows",
                                                "warmup"))):
        params = inspect.signature(fn).parameters
        assert all(params[n].default is not inspect.Parameter.empty
                   for n in names)
    params = inspect.signature(bench.run_device_bench).parameters
    assert (params["batch"].default, params["chunks"].default,
            params["iters"].default, params["warmup"].default) == (
        bench.BATCH, bench.CHUNKS, bench.ITERS, bench.WARMUP)
    assert params["device"].default is None          # the card


def test_device_bench_reads_back_once_a_call(monkeypatch):
    """One host read a call (the one stream sync), every batch summed."""
    reads, calls = [], []
    real_entry = graft_entry.entry

    def counting_entry(device=None):
        fn, args = real_entry(device)

        def counted(model, p):
            calls.append(p.shape[0])
            return fn(model, p)

        return counted, args

    real_item = torch.Tensor.item

    def item(t):
        reads.append(t.shape)
        return real_item(t)

    monkeypatch.setattr(graft_entry, "entry", counting_entry)
    monkeypatch.setattr(torch.Tensor, "item", item)
    rate = bench.run_device_bench(batch=2, chunks=3, iters=2, warmup=1,
                                  device="cpu")
    assert rate > 0
    assert calls == [2] * (3 * 3)
    assert reads == [torch.Size([])] * 3


def _pipeline_commands() -> list[list[str]]:
    """Each command line of the pipeline, continuations joined, ``$PY``
    and ``$AE`` expanded, redirections dropped."""
    with open(PIPELINE) as f:
        text = f.read().replace("\\\n", " ")
    env = dict(re.findall(r'^(\w+)="?([^"\n]*)"?$', text, re.M))
    cmds = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "echo")) or "=" in line.split(
                " ")[0]:
            continue
        for k, v in env.items():
            line = line.replace(f"${k}", v)
        cmds.append([w for w in shlex.split(line) if w != "2>/dev/null"])
    return cmds


def test_pipeline_is_valid_bash():
    out = subprocess.run(["bash", "-n", PIPELINE], capture_output=True,
                         text=True, timeout=30)
    assert out.returncode == 0, out.stderr


def test_pipeline_runs_the_ports_modules_only():
    mods = []
    for cmd in _pipeline_commands():
        if cmd[0] == "timeout":
            cmd = cmd[2:]
        if cmd[0] in ("set", "cd"):
            continue
        assert cmd[:2] == ["python", "-m"], cmd
        mods.append(cmd[2])
    assert mods and all(m.startswith("deepfluids_tpu_torch.") for m in mods)
    # the reference's stages, in its order
    assert mods == [
        "deepfluids_tpu_torch.tools.supervise",
        "deepfluids_tpu_torch.tools.eval_run",
        "deepfluids_tpu_torch.tools.eval_run",
        "deepfluids_tpu_torch.main",
        "deepfluids_tpu_torch.tools.latent_predictability",
        "deepfluids_tpu_torch.tools.latent_predictability",
        "deepfluids_tpu_torch.tools.supervise",
        "deepfluids_tpu_torch.tools.eval_run"]
    with open(PIPELINE) as f:
        text = f.read()
    assert 'cd "$(dirname "$0")/../.."' in text
    assert "deepfluids_tpu." not in text.replace("deepfluids_tpu_torch", "")


def test_pipeline_argv_parse():
    """Every main and supervise command line is one the port's parsers
    take (parsed, not run)."""
    parsed = 0
    for cmd in _pipeline_commands():
        if cmd[0] == "timeout":
            cmd = cmd[2:]
        if cmd[:3] == ["python", "-m", "deepfluids_tpu_torch.main"]:
            child = cmd[3:]
        elif cmd[:3] == ["python", "-m",
                         "deepfluids_tpu_torch.tools.supervise"]:
            own, child = supervise.parse_args(cmd[3:])
            assert (own.restart_on, own.max_restarts) == ("any", 10)
        else:
            continue
        cfg = get_config(split_device(child)[0])
        assert cfg.dataset == "smoke_mov200_f400_m"
        assert cfg.watchdog_secs in (0.0, 300.0)
        parsed += 1
    assert parsed == 3
