"""The port's supervisor: kill, relaunch and resume.

Counterpart of tests/test_supervise.py.  A training run of
``deepfluids_tpu_torch.main`` is KILLED mid-run by the fault injector
(``--die_at_step``: exit 17 with no checkpoint and no flush), relaunched by
``deepfluids_tpu_torch.tools.supervise`` with ``--load_path``, and must
finish with weights and Adam state BITWISE-identical to an uninterrupted
run's on the CPU (exact resume: the batch order is a pure function of
(seed, step)).  The children are real processes on ``--device cpu``; the
bookkeeping of the relaunch loop is tested against fake children, which is
as fast as the loop itself.
"""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from deepfluids_tpu_torch.datagen import scenes
from deepfluids_tpu_torch.main import cli
from deepfluids_tpu_torch.tools import supervise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("sup")
    scenes.smoke_pos21_size5(str(root / "data"), num_pos=2, num_size=1,
                             num_frames=3, height=32, width=32, name="sup",
                             device="cpu")
    return root


def _flags(root, tag, **extra):
    base = dict(arch="de", filters=8, num_conv=1, batch_size=4,
                data_dir=str(root / "data"), dataset="sup",
                log_dir=str(root / "logs"), tag=tag, max_step=10,
                lr_max=2e-3, lr_min=1e-4, log_step=5, test_step=10_000,
                save_step=5, compute_dtype="float32", num_worker=2, seed=0)
    base.update(extra)
    return [f"--{k}={v}" for k, v in base.items()]


def _state(run_dir, step=10):
    return torch.load(os.path.join(run_dir, "checkpoint", str(step),
                                   "state.pt"), weights_only=True)


def test_supervised_run_survives_kill_and_matches(tiny, capfd):
    # Dies at step 6 (after the step-5 checkpoint), is relaunched with
    # --load_path and completes to step 10.
    rc = supervise.main(["--max_restarts", "2", "--backoff", "0.05", "--",
                         *_flags(tiny, "killed", die_at_step=6),
                         "--device", "cpu"])
    out = capfd.readouterr().out
    assert rc == 0, out[-2000:]
    assert "relaunch #1" in out and "relaunch #2" not in out
    assert "child completed after 1 restart(s)" in out
    run_dir = str(tiny / "logs" / "sup_killed")
    assert os.path.exists(os.path.join(run_dir, ".fault_injected"))
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoint"))) == [
        "10", "5"]

    # The uninterrupted oracle, in this process.
    cli(_flags(tiny, "oracle") + ["--device", "cpu"])
    want = _state(str(tiny / "logs" / "sup_oracle"))
    got = _state(run_dir)
    assert got["step"] == want["step"] == 10
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, atol=0, rtol=0)
    for k, slot in want["opt_state"]["state"].items():
        for name, t in slot.items():
            torch.testing.assert_close(got["opt_state"]["state"][k][name], t,
                                       atol=0, rtol=0)
    # One metrics stream reaching step 10: the killed child's step-5 row,
    # then the relaunched child's.
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [5, 10]
    # params.json holds no device: it is where an invocation runs
    with open(os.path.join(run_dir, "params.json")) as f:
        assert "device" not in json.load(f)


def test_die_at_step_exits_17_once(tiny):
    # The flag alone, without the supervisor: exit 17 after the step's log
    # row, no checkpoint of that step; with the sentinel present the same
    # command runs through.
    cmd = [sys.executable, "-m", "deepfluids_tpu_torch.main",
           *_flags(tiny, "die", max_step=4, die_at_step=3, log_step=1,
                   save_step=2), "--device", "cpu"]
    run_dir = str(tiny / "logs" / "sup_die")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 17, out.stderr[-2000:]
    assert "fault injection: dying at step 3" in out.stderr
    assert os.path.exists(os.path.join(run_dir, ".fault_injected"))
    assert os.listdir(os.path.join(run_dir, "checkpoint")) == ["2"]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert [json.loads(ln)["step"] for ln in f] == [1, 2, 3]
    out = subprocess.run(cmd + ["--load_path", run_dir], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resuming" in out.stderr and "from step 2" in out.stderr
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoint"))) == [
        "2", "4"]


# --- the relaunch loop against fake children -------------------------------

class FakeChildren:
    """Stands in for ``subprocess.run``: child i returns ``codes[i]`` and,
    where ``progress[i]``, appends a metrics row first."""

    def __init__(self, run_dir, codes, progress):
        self.run_dir, self.codes, self.progress = run_dir, codes, progress
        self.cmds = []

    def __call__(self, cmd, cwd=None, **kw):
        i = len(self.cmds)
        self.cmds.append((cmd, cwd))
        if self.progress[i]:
            with open(os.path.join(self.run_dir, "metrics.jsonl"), "a") as f:
                f.write('{"step": %d}\n' % i)
        return types.SimpleNamespace(returncode=self.codes[i])


@pytest.fixture
def fake(tmp_path, monkeypatch):
    def install(codes, progress):
        run_dir = str(tmp_path / "logs" / "sup_fake")
        children = FakeChildren(run_dir, codes, progress)
        monkeypatch.setattr(supervise.subprocess, "run", children)
        monkeypatch.setattr(supervise.time, "sleep", lambda s: None)
        return children
    return install


def test_outage_retries_do_not_consume_restart_budget(fake, tmp_path, capsys,
                                                      monkeypatch):
    # Children that die WITHOUT progress (no card at start-up) are retried
    # with backoff without touching --max_restarts, then given up on once
    # the no-progress window exceeds --max_outage_secs.
    children = fake([1] * 5, [False] * 5)
    clock = iter([0.0, 1.0, 2.0, 100.0, 200.0])
    monkeypatch.setattr(supervise.time, "monotonic", lambda: next(clock))
    rc = supervise.supervise(
        _flags(tmp_path, "fake") + ["--device", "cpu"], max_restarts=0,
        restart_on="any", backoff=0.1, max_outage_secs=20)
    out = capsys.readouterr().out
    assert rc == 1 and len(children.cmds) == 4
    assert "outage retry #2" in out and "outage retry #3" in out
    assert "budget intact, 0/0 restarts used" in out
    assert "no progress for" in out and "relaunch #" not in out


def test_restart_budget_counts_children_that_progressed(fake, tmp_path,
                                                        capsys):
    children = fake([17, 17, 17, 0], [True, True, True, True])
    rc = supervise.supervise(_flags(tmp_path, "fake"), max_restarts=2,
                             backoff=0.0)
    out = capsys.readouterr().out
    assert rc == 17 and len(children.cmds) == 3
    assert "relaunch #2" in out and "giving up (exit 17, 2 restarts)" in out
    # an outage in between resets nothing of the budget and costs none
    children = fake([17, 17, 17, 0], [True, False, True, True])
    rc = supervise.supervise(_flags(tmp_path, "fake"), max_restarts=2,
                             backoff=0.0)
    out = capsys.readouterr().out
    assert rc == 0 and len(children.cmds) == 4
    assert "child completed after 2 restart(s)" in out
    assert "outage retry #1" in out


@pytest.mark.parametrize("restart_on,code,relaunched", [
    ("17", 1, False), ("17", 17, True), ("any", 1, True), ("any", 137, True)])
def test_only_recoverable_exits_are_relaunched(fake, tmp_path, restart_on,
                                               code, relaunched):
    children = fake([code, 0], [True, True])
    rc = supervise.supervise(_flags(tmp_path, "fake"), restart_on=restart_on,
                             backoff=0.0)
    assert rc == (0 if relaunched else code)
    assert len(children.cmds) == (2 if relaunched else 1)


def test_child_command_pins_the_run_dir_and_passes_device(fake, tmp_path):
    children = fake([0], [True])
    args = _flags(tmp_path, "fake") + ["--device", "cpu"]
    assert supervise.main(["--max_restarts", "1", "--", *args]) == 0
    cmd, cwd = children.cmds[0]
    run_dir = str(tmp_path / "logs" / "sup_fake")
    assert cmd == [sys.executable, "-m", "deepfluids_tpu_torch.main", *args,
                   "--load_path", run_dir]
    assert cwd == REPO and os.path.isdir(run_dir)
    # a given --load_path is kept as it is, and "--" is optional
    children = fake([0], [True])
    given = _flags(tmp_path, "fake", load_path=str(tmp_path / "elsewhere"))
    assert supervise.main(given) == 0
    assert children.cmds[0][0][3:] == given


def test_progress_marker_moves_with_metrics_and_checkpoints(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    seen = [supervise._progress_marker(str(run))]
    assert seen[0] == (0, 0.0)
    (run / "metrics.jsonl").write_text('{"step": 1}\n')
    seen.append(supervise._progress_marker(str(run)))
    # the port's checkpoints are checkpoint/<step>/state.pt, renamed into
    # place from <step>.tmp
    for step, mtime in ((5, 1000.0), (10, 2000.0)):
        tmp = run / "checkpoint" / f"{step}.tmp"
        tmp.mkdir(parents=True)
        (tmp / "state.pt").write_bytes(b"x")
        os.replace(tmp, run / "checkpoint" / str(step))
        os.utime(run / "checkpoint" / str(step), (mtime, mtime))
        seen.append(supervise._progress_marker(str(run)))
    assert len(set(seen)) == 4 and seen[3][1] == 2000.0
