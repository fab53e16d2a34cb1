"""Supervised training: the relaunch-on-failure loop as code.

Counterpart of the JAX package's ``tools/supervise.py``.  Wraps ``python -m
deepfluids_tpu_torch.main`` and relaunches it when it dies with exit code 17
(the fault injector's, ``--die_at_step``) or, with ``--restart_on any``, on
any non-zero exit (an out-of-memory kill, a lost card, SIGKILL).  Every
relaunch passes ``--load_path <run_dir>`` so the child resumes from its
latest checkpoint.  The batch order is a pure function of (seed, step), so
on the CPU a supervised run ends bitwise-identical to an uninterrupted one;
on the card the step counts and the restart count are exact and the weights
agree within cuDNN's run-to-run spread.

Usage::

    python -m deepfluids_tpu_torch.tools.supervise [--max_restarts N] \
        [--restart_on 17|any] [--max_outage_secs S] \
        -- --dataset smoke_pos21_size5 --max_step 300000 [--device cpu] ...

Everything after ``--`` goes to ``deepfluids_tpu_torch.main`` verbatim,
``--device`` included.  ``--num_processes N`` (N > 1) runs the child as a
group of N ranks on that device through ``tools/launch_multihost``, which
exits 17 when the ranks die at ``--die_at_step``, so the whole group is
relaunched.

Failures are classified by PROGRESS: a child that advanced
metrics/checkpoints counts against --max_restarts; a child that died
without any progress (the card was not there at start-up) retries with
exponential backoff WITHOUT consuming the budget, bounded only by
--max_outage_secs of continuous no-progress time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

# The directory that holds the package: the child's working directory, so
# ``-m deepfluids_tpu_torch.main`` resolves wherever the supervisor started.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHILD_MODULE = "deepfluids_tpu_torch.main"


def _child_run_dir(child_args: list[str]) -> tuple[str, list[str]]:
    """Resolve the run dir the child will use and pin it via --load_path.

    Without the pin, a crashed child's relaunch would collide with the
    existing run dir and get a NEW timestamped one (utils.rundir), orphaning
    the checkpoint it was supposed to resume from.
    """
    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.main import split_device

    cfg = get_config(split_device(child_args)[0])
    if cfg.load_path:
        return cfg.load_path, child_args
    run_dir = os.path.join(cfg.log_dir, f"{cfg.dataset}_{cfg.tag}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir, child_args + ["--load_path", run_dir]


def _progress_marker(run_dir: str) -> tuple:
    """Cheap monotone progress signature of a run dir: metrics.jsonl size
    plus the newest mtime among ``checkpoint/`` and its ``<step>/`` entries
    (a save renames ``<step>.tmp`` into place, which touches both).
    Advancing between child launches means the child did real work."""
    sig = [0, 0.0]
    m = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(m):
        sig[0] = os.path.getsize(m)
    ck = os.path.join(run_dir, "checkpoint")
    if os.path.isdir(ck):
        sig[1] = max((os.path.getmtime(os.path.join(ck, e))
                      for e in os.listdir(ck)), default=0.0)
    return tuple(sig)


def supervise(child_args: list[str], max_restarts: int = 10,
              restart_on: str = "17", backoff: float = 1.0,
              max_outage_secs: float = 14400.0,
              num_processes: int = 1) -> int:
    """Relaunch loop with OUTAGE AWARENESS: a child that dies without
    having made any progress since its launch (no metrics/checkpoint
    advance, e.g. no card at start-up) does NOT consume the restart budget;
    it retries with exponential backoff (capped at 10 min) until progress
    resumes or the continuous no-progress window exceeds
    ``max_outage_secs``."""
    run_dir, child_args = _child_run_dir(child_args)
    cmd = [sys.executable, "-m", CHILD_MODULE] + child_args
    if num_processes > 1:
        from deepfluids_tpu_torch.main import split_device

        device = (split_device(child_args)[1] or "cuda").split(":")[0]
        cmd = [sys.executable, "-m",
               "deepfluids_tpu_torch.tools.launch_multihost",
               "--num_processes", str(num_processes), "--device", device,
               "--"] + cmd
    restarts = 0
    outage_started: float | None = None
    outage_tries = 0
    while True:
        before = _progress_marker(run_dir)
        rc = subprocess.run(cmd, cwd=_REPO).returncode
        if rc == 0:
            print(f"supervise: child completed after {restarts} restart(s)",
                  flush=True)
            return 0
        recoverable = (restart_on == "any") or rc == 17
        if not recoverable:
            print(f"supervise: giving up (exit {rc}, {restarts} restarts)",
                  flush=True)
            return rc
        progressed = _progress_marker(run_dir) != before
        if progressed:
            outage_started, outage_tries = None, 0
            if restarts >= max_restarts:
                print(f"supervise: giving up (exit {rc}, "
                      f"{restarts} restarts)", flush=True)
                return rc
            restarts += 1
            print(f"supervise: child exit {rc} -> relaunch #{restarts} "
                  f"(resume from {run_dir})", flush=True)
            time.sleep(backoff)
        else:
            now = time.monotonic()
            if outage_started is None:
                outage_started = now
            if now - outage_started > max_outage_secs:
                print(f"supervise: giving up - no progress for "
                      f"{now - outage_started:.0f}s across "
                      f"{outage_tries} outage retries (exit {rc})",
                      flush=True)
                return rc
            outage_tries += 1
            wait = min(600.0, backoff * (2.0 ** min(outage_tries, 10)))
            print(f"supervise: child exit {rc} with NO progress -> outage "
                  f"retry #{outage_tries} in {wait:.0f}s (budget intact, "
                  f"{restarts}/{max_restarts} restarts used)", flush=True)
            time.sleep(wait)


def parse_args(argv: list[str]) -> tuple[argparse.Namespace, list[str]]:
    """(the supervisor's own flags, the child's argv) of a command line."""
    if "--" in argv:
        split = argv.index("--")
        own, child = argv[:split], argv[split + 1:]
    else:
        own, child = [], argv
    p = argparse.ArgumentParser("supervise")
    p.add_argument("--max_restarts", type=int, default=10)
    p.add_argument("--restart_on", choices=("17", "any"), default="17",
                   help="17: only the fault-injection exit code; "
                        "any: every non-zero exit")
    p.add_argument("--backoff", type=float, default=1.0)
    p.add_argument("--max_outage_secs", type=float, default=14400.0,
                   help="give up after this long with NO child progress "
                        "(no-progress failures back off exponentially and "
                        "do not consume --max_restarts)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="ranks of the child (> 1: through launch_multihost)")
    return p.parse_args(own), child


def main(argv: list[str] | None = None) -> int:
    a, child = parse_args(sys.argv[1:] if argv is None else argv)
    return supervise(child, a.max_restarts, a.restart_on, a.backoff,
                     a.max_outage_secs, a.num_processes)


if __name__ == "__main__":
    sys.exit(main())
