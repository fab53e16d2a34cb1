"""Multi-process launch: N ranks on one machine, joined by
``torch.distributed``.

Counterpart of the JAX package's ``tools/launch_multihost.py``.  In torch a
chip and a host are both a process, and a rank is one process with one
device (the JAX launcher's ``--devices_per_process`` has no counterpart):
this spawns ``--num_processes`` ranks,
each given torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` 127.0.0.1, ``MASTER_PORT`` a free port unless ``--port``),
and

  * with no command, runs in every rank data-parallel train steps of the
    port's model stack (``GeneratorBE`` + the curl/jacobian loss through
    the FD kernels + Adam) on a batch split over the ranks, prints each
    rank's losses, asserts the ranks agree and, unless
    ``--no_check_single``, that one process on the same global batch gives
    the same losses within 1e-5;
  * with ``-- <command>``, runs the command in every rank (``python -m
    deepfluids_tpu_torch.main ...``, whose ``main`` joins the group) and
    exits 17 when a rank exited 17 (the fault injector's code, on which
    ``tools/supervise`` relaunches the group), else with the first non-zero
    exit code; when a rank fails the others are stopped.

The ranks run on the card (``cuda:LOCAL_RANK``) over NCCL, or over gloo when
there are more ranks than cards; ``--device cpu`` runs gloo ranks on the
CPU.  Usage::

    python -m deepfluids_tpu_torch.tools.launch_multihost --num_processes 2
    python -m deepfluids_tpu_torch.tools.launch_multihost --num_processes 2 \\
        -- python -m deepfluids_tpu_torch.main --dataset smoke_pos21_size5 \\
        --num_data_shards 2

``torchrun --nproc_per_node N -m deepfluids_tpu_torch.main ...`` starts the
same ranks.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

# The directory that holds the package: the ranks' working directory.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAULT_EXIT = 17
LOSS_TAG = "MHLOSSES"


def free_port() -> int:
    """A TCP port that is free on localhost now (bound to 0, released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device: str, num_processes: int) -> str:
    """NCCL for ranks with a card each, gloo for CPU ranks or for more
    ranks than cards (NCCL refuses two ranks on one device)."""
    if device == "cpu":
        return "gloo"
    import torch

    return "nccl" if num_processes <= torch.cuda.device_count() else "gloo"


def _rank_env(rank: int, world: int, port: int, backend: str,
              threads: int) -> dict:
    from deepfluids_tpu_torch.parallel.mesh import BACKEND_ENV

    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env[BACKEND_ENV] = backend
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    return env


def group_exit_code(rcs: list[int]) -> int:
    """The group's exit code: 17 when a rank exited 17, else the first
    non-zero code, else 0."""
    if FAULT_EXIT in rcs:
        return FAULT_EXIT
    return next((rc for rc in rcs if rc), 0)


def spawn(cmd: list[str], num_processes: int, backend: str,
          port: int | None = None, threads: int = 0, capture: bool = False,
          timeout: float | None = None, grace: float = 20.0
          ) -> tuple[list[int], list[str]]:
    """``cmd`` in ``num_processes`` ranks; ``(exit codes, outputs)`` (the
    outputs are empty unless ``capture``).  When a rank exits non-zero the
    others get ``grace`` seconds to follow before they are killed (a rank
    left waiting in a collective would wait for ever); so are all of them
    past ``timeout``."""
    port = port or free_port()
    procs = []
    for rank in range(num_processes):
        out = subprocess.PIPE if capture else None
        procs.append(subprocess.Popen(
            cmd, cwd=_REPO, env=_rank_env(rank, num_processes, port,
                                          backend, threads),
            stdout=out, stderr=subprocess.STDOUT if capture else None,
            text=True))
    outs = [""] * num_processes
    if capture:
        import threading

        def read(i: int) -> None:
            outs[i] = procs[i].stdout.read()

        readers = [threading.Thread(target=read, args=(i,), daemon=True)
                   for i in range(num_processes)]
        for t in readers:
            t.start()
    start, failed_at = time.monotonic(), None
    while any(p.poll() is None for p in procs):
        now = time.monotonic()
        if failed_at is None and any(p.poll() not in (None, 0)
                                     for p in procs):
            failed_at = now
        late = timeout is not None and now - start > timeout
        if late or (failed_at is not None and now - failed_at > grace):
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.05)
    if capture:
        for t in readers:
            t.join()
    return [p.wait() for p in procs], outs


def run_worker(steps: int, batch: int, device: str) -> list[float]:
    """One rank (or, outside a group, the one-process oracle): data-parallel
    train steps of a small ``GeneratorBE`` (32x32, filters 16, num_conv 2,
    f32) on a global batch of ``batch`` rows drawn from seed 0; returns the
    losses of the global batch."""
    import numpy as np
    import torch

    from deepfluids_tpu_torch import parallel
    from deepfluids_tpu_torch.models import GeneratorBE, flax_init_
    from deepfluids_tpu_torch.parallel import comm
    from deepfluids_tpu_torch.train.losses import generator_loss
    from deepfluids_tpu_torch.train.state import (
        cosine_lr_schedule,
        make_optimizer,
        set_lr,
    )

    if device == "cpu":
        torch.set_num_threads(1)
    dev = parallel.init_distributed(device)
    layout = parallel.make_layout()
    if layout.world > 1:
        print(f"worker {layout.rank}/{layout.world} on {dev}", flush=True)
    model = flax_init_(GeneratorBE((32, 32, 1), num_param=3, filters=16,
                                   num_conv=2), 0).to(dev)
    opt = make_optimizer(model.parameters())
    lr = cosine_lr_schedule(1e-3, 1e-5, 100)
    rng = np.random.default_rng(0)      # the same stream on every rank
    group = layout.batch
    losses = []
    for k in range(steps):
        x = rng.normal(size=(batch, 32, 32, 2)).astype(np.float32)
        y = rng.normal(size=(batch, 3)).astype(np.float32)
        x, y = (torch.from_numpy(parallel.local_rows(t, group)).to(dev)
                for t in (x, y))
        set_lr(opt, lr(k))
        opt.zero_grad(set_to_none=True)
        loss, _ = generator_loss(model(y), x, True, 1.0, 1.0, group=group)
        loss.backward()
        parallel.reduce_grads_(list(model.parameters()), layout)
        opt.step()
        total = comm.all_reduce_(loss.detach().reshape(1), group)
        losses.append(float(total) / group.size)
    print(LOSS_TAG, " ".join(repr(v) for v in losses), flush=True)
    return losses


def _losses(out: str, who: str) -> list[float]:
    for line in out.splitlines():
        if line.startswith(LOSS_TAG):
            return [float(v) for v in line.split()[1:]]
    raise RuntimeError(f"{who} printed no losses:\n{out}")


def launch(num_processes: int = 2, steps: int = 2, port: int | None = None,
           check_single: bool = True, device: str = "cuda",
           backend: str | None = None) -> list[float]:
    """The demo: data-parallel steps in ``num_processes`` ranks, the ranks
    agreeing and (``check_single``) equal to one process within 1e-5;
    returns the agreed losses."""
    backend = backend or default_backend(device, num_processes)
    batch = 2 * num_processes
    worker = [sys.executable, "-m", "deepfluids_tpu_torch.tools."
              "launch_multihost", "--worker", "--steps", str(steps),
              "--batch", str(batch), "--device", device]
    # the one-process oracle runs beside the ranks
    one = subprocess.Popen(
        worker, cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={k: v for k, v in os.environ.items()
                        if k not in ("WORLD_SIZE", "RANK")}
    ) if check_single else None
    rcs, outs = spawn(worker, num_processes, backend, port, capture=True,
                      timeout=900)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        if rc:
            raise RuntimeError(f"rank {rank} failed (exit {rc}):\n{out}")
    multi = [_losses(out, f"rank {r}") for r, out in enumerate(outs)]
    for rank, losses in enumerate(multi[1:], 1):
        if losses != multi[0]:
            raise AssertionError(f"rank {rank} diverged: {losses} != "
                                 f"{multi[0]}")
    print(f"{num_processes} ranks ({device}, {backend}): losses {multi[0]}",
          flush=True)
    if one is not None:
        # the oracle: one process, the same global batch and init
        out, _ = one.communicate(timeout=900)
        if one.returncode:
            raise RuntimeError(f"the one-process run failed:\n{out}")
        single = _losses(out, "the one-process run")
        for a, b in zip(multi[0], single):
            if abs(a - b) >= 1e-5:
                raise AssertionError(f"{num_processes} ranks {multi[0]} != "
                                     f"one process {single}")
        print(f"one process agrees: {single}", flush=True)
    return multi[0]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = []
    if "--" in argv:
        split = argv.index("--")
        argv, cmd = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser("launch_multihost")
    p.add_argument("--num_processes", type=int, default=2)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--port", type=int, default=0,
                   help="MASTER_PORT (default: a free one)")
    p.add_argument("--no_check_single", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the ranks' device (it picks the backend)")
    p.add_argument("--worker", action="store_true",
                   help="internal: run as one rank of the demo")
    p.add_argument("--batch", type=int, default=0,
                   help="internal: the demo's global batch")
    a = p.parse_args(argv)
    if a.worker:
        run_worker(a.steps, a.batch or 2 * a.num_processes, a.device)
        return 0
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("launch_multihost: no CUDA card "
                             "(torch.cuda.is_available() is False); pass "
                             "--device cpu for gloo ranks on the CPU")
    backend = default_backend(a.device, a.num_processes)
    if cmd:
        rcs, _ = spawn(cmd, a.num_processes, backend, a.port or None)
        return group_exit_code(rcs)
    launch(a.num_processes, a.steps, a.port or None,
           check_single=not a.no_check_single, device=a.device,
           backend=backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
