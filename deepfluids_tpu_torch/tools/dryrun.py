"""Multi-rank dry runs: every parallel path of the port in one short run.

Counterpart of ``__graft_entry__.dryrun_multichip`` / ``dryrun_multihost``.
In torch a chip and a host are both a process with one device, so both
functions start ranks through :mod:`.launch_multihost`:

  * :func:`dryrun_multichip` runs ``n`` ranks through the reference's
    stages, each held against the same computation done whole in every
    rank (its one-process oracle):

      1.  a data-parallel train step (batch split, weights replicated,
          gradients averaged): loss and gradients;
      2.  the haloed 2D curl over row-sharded fields, bit for bit the
          whole-field kernel's, and divergence-free;
      2b. the loss through the FD kernels on each rank's rows against the
          plain ops on the whole batch;
      2c. a ``--spatial_shard`` train step (row-sharded model and haloed
          loss): loss and gradients;
      2d. the haloed 3D jacobian, vorticity, curl and divergence;
      2e. tensor parallelism (conv channels over a model group of 2, data
          over the rest, for an even ``n``): the first step's loss equals
          stage 1's;
      2f. the ``--ae_pred_w`` pair step on a batch split as ``[its t rows ;
          its t+1 rows]``: finite, gradients reach the predictor;
      3.  the latent rollout on split rows, equal to the whole rollout;

  * :func:`dryrun_multihost` runs the launcher's data-parallel demo in
    ``n`` processes against one process.

Usage::

    python -m deepfluids_tpu_torch.tools.dryrun multichip 2 [--device cpu]
    python -m deepfluids_tpu_torch.tools.dryrun multihost 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

STAGES = ("1", "2", "2b", "2c", "2d", "2e", "2f", "3")
OK_TAG = "DRYRUN_OK"


def _close(a, b, atol: float, what: str) -> None:
    import torch

    if not torch.allclose(a.float(), b.float(), rtol=atol, atol=atol):
        err = float((a.float() - b.float()).abs().max())
        raise AssertionError(f"{what}: max |diff| {err} > {atol}")


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def run_stages(device: str) -> None:
    """One rank's stages (every rank runs them; rank 0 reports)."""
    import numpy as np
    import torch

    from deepfluids_tpu_torch import parallel
    from deepfluids_tpu_torch.models import (
        Autoencoder,
        GeneratorBE,
        LatentIntegrator,
        flax_init_,
        rollout,
    )
    from deepfluids_tpu_torch.ops import cuda_fd, fd
    from deepfluids_tpu_torch.parallel import comm, halo, mesh
    from deepfluids_tpu_torch.train import losses
    from deepfluids_tpu_torch.train.state import make_optimizer

    if device == "cpu":
        torch.set_num_threads(1)
    # The stages compare layouts, not convolution algorithms: cuDNN picks
    # them by shape (a half batch, a haloed block), and they round
    # otherwise, so the convolutions run as f32 GEMMs here.
    torch.backends.cudnn.enabled = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = parallel.init_distributed(device)
    lay = parallel.make_layout()
    n = lay.world
    data = lay.data

    def ok(stage: str, what: str) -> None:
        if lay.rank == 0:
            print(f"{OK_TAG} {stage} dryrun_multichip({n}): {what}",
                  flush=True)

    def gen(**kw):
        return flax_init_(GeneratorBE((32, 32, 1), num_param=3, filters=16,
                                      num_conv=2, **kw), 0).to(dev)

    rng = np.random.default_rng(0)
    b = 2 * n
    x = torch.from_numpy(rng.normal(size=(b, 32, 32, 2)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32)).to(dev)

    # 1) data parallel: a step on split rows against the whole batch
    model, oracle = gen(), gen()
    xl, yl = (mesh.local_rows(t, data) for t in (x, y))
    loss, _ = losses.generator_loss(model(yl), xl, True, 1.0, 1.0,
                                    group=data)
    loss.backward()
    mesh.reduce_grads_(list(model.parameters()), lay)
    loss0 = float(comm.all_reduce_(loss.detach().reshape(1), data)) / n
    ref, _ = losses.generator_loss(oracle(y), x, True, 1.0, 1.0)
    ref.backward()
    if not np.isfinite(loss0) or abs(loss0 - float(ref)) > 1e-5:
        raise AssertionError(f"DP loss {loss0} != one process {float(ref)}")
    want = _grads(oracle)
    for name, g in _grads(model).items():
        _close(g, want[name], 1e-5, f"DP gradient of {name}")
    make_optimizer(model.parameters()).step()
    ok("1", f"DP train step ok, loss={loss0:.5f} (== one process)")

    # 2) haloed 2D stencils on row-sharded fields
    psi = torch.from_numpy(rng.normal(size=(2, 8 * n, 32, 1)).astype(
        np.float32)).to(dev)
    u_sh = halo.curl2d_sharded(comm.split_rows(psi, data, 1), data)
    u = comm.gather_rows(u_sh, data, 1)
    if not torch.equal(u, cuda_fd.curl2d_fused(psi)):
        raise AssertionError("haloed curl != whole-field kernel")
    div = comm.gather_rows(halo.divergence2d_sharded(u_sh, data), data, 1)
    if float(div[:, :-2, :-2].abs().max()) >= 1e-4:
        raise AssertionError("haloed curl is not divergence-free")
    ok("2", "halo-sharded stencils ok (bit-equal to the whole field)")

    # 2b) the kernels on each rank's rows against the plain ops, whole
    model_b = gen()
    with torch.no_grad():
        lk, _ = losses.generator_loss(model_b(yl), xl, True, 1.0, 1.0,
                                      group=data)
        lk = float(comm.all_reduce_(lk.reshape(1), data)) / n
        pred = fd.curl2d(model_b(y))
        plain = (torch.mean(torch.abs(pred - x))
                 + torch.mean(torch.abs(fd.jacobian2d(pred)[0]
                                        - fd.jacobian2d(x)[0])))
    if abs(lk - float(plain)) >= 1e-4:
        raise AssertionError(f"kernel loss on split rows {lk} != plain "
                             f"ops {float(plain)}")
    ok("2b", "FD kernels on each rank's rows ok (== plain ops, whole)")

    # 2c) a spatially sharded train step against the replicated one
    rows = parallel.Layout(rank=lay.rank, world=n, data=data,
                           spatial=True)
    model_sp, oracle = gen(), gen()
    model_sp.shard_rows(data)
    ls, _ = losses.generator_loss_spatial(
        model_sp(y), comm.split_rows(x, data, 1), True, 1.0, 1.0, data)
    ls.backward()
    mesh.reduce_grads_(list(model_sp.parameters()), rows)
    ls = float(comm.all_reduce_(ls.detach().reshape(1), data))
    ref, _ = losses.generator_loss(oracle(y), x, True, 1.0, 1.0)
    ref.backward()
    if abs(ls - float(ref)) >= 1e-4:
        raise AssertionError(f"spatial loss {ls} != replicated "
                             f"{float(ref)}")
    want = _grads(oracle)
    for name, g in _grads(model_sp).items():
        _close(g, want[name], 1e-4, f"spatial gradient of {name}")
    ok("2c", "spatially-sharded train step ok (loss+grads == replicated)")

    # 2d) haloed 3D stencils
    x3 = torch.from_numpy(rng.normal(size=(1, 2 * n, 8, 12, 3)).astype(
        np.float32)).to(dev)
    x3l = comm.split_rows(x3, data, 1)
    gj, gv = halo.jacobian3d_sharded(x3l, data)
    wj, wv = cuda_fd.jacobian3d_fused(x3)
    u3 = halo.curl3d_sharded(x3l, data)
    for got, whole, what in ((gj, wj, "jacobian"), (gv, wv, "vorticity"),
                             (u3, cuda_fd.curl3d_fused(x3), "curl")):
        if not torch.equal(comm.gather_rows(got, data, 1), whole):
            raise AssertionError(f"haloed 3D {what} != whole-field kernel")
    div3 = comm.gather_rows(halo.divergence3d_sharded(u3, data), data, 1)
    if float(div3[:, :-2, :-2, :-2].abs().max()) >= 1e-4:
        raise AssertionError("haloed 3D curl is not divergence-free")
    ok("2d", "3D sharded stencils ok")

    # 2e) tensor parallelism: conv channels over a model group of 2
    if n % 2 == 0:
        tp = mesh.make_layout(num_data=n // 2, num_model=2)
        model_tp = gen()
        cut = mesh.shard_channels_(model_tp, tp.model)
        if "conv_0_0.weight" not in cut:
            raise AssertionError(f"TP cut no conv kernel: {cut}")
        xt, yt = (mesh.local_rows(t, tp.data) for t in (x, y))
        with torch.no_grad():
            lt, _ = losses.generator_loss(model_tp(yt), xt, True, 1.0, 1.0,
                                          group=tp.data)
            lt = float(comm.all_reduce_(lt.reshape(1), tp.data)) / (
                tp.data.size)
        if abs(lt - loss0) >= 1e-4:
            raise AssertionError(f"TP loss {lt} != DP {loss0}")
        ok("2e", f"TP ({tp.data.size}x{tp.model.size}) train step ok, "
           f"loss={lt:.5f} == DP {loss0:.5f}")
    else:
        ok("2e", "TP skipped (an odd number of ranks)")

    # 2f) the --ae_pred_w pair step on a split pair batch
    ae = flax_init_(Autoencoder((16, 16, 1), in_channels=2, z_num=8,
                                filters=8, num_conv=1, num_param=3,
                                pred_hidden=16), 0).to(dev)
    xp = rng.normal(size=(2 * b, 16, 16, 2)).astype(np.float32)
    yp = rng.normal(size=(2 * b, 3)).astype(np.float32)
    xp, yp = (torch.from_numpy(mesh.local_rows(t, data, pair=True)).to(dev)
              for t in (xp, yp))
    out, z = ae(xp)
    la, _ = losses.autoencoder_loss(out, z, xp, yp, True, 3, 1.0, 1.0, 1.0,
                                    group=data)
    nb = z.shape[0] // 2
    dz = ae.predict(torch.cat([yp[:nb], z[:nb, 3:]], -1),
                    yp[nb:] - yp[:nb])
    la = la + torch.mean(torch.square(z[:nb, 3:] + dz - z[nb:, 3:]))
    la.backward()
    mesh.reduce_grads_(list(ae.parameters()), lay)
    pg = sum(float(p.grad.abs().sum()) for p in ae.predictor.parameters())
    if not np.isfinite(float(la)) or pg <= 0:
        raise AssertionError(f"ae_pred step: loss {float(la)}, predictor "
                             f"gradient {pg}")
    ok("2f", f"prediction-aware AE pair step ok (loss={float(la):.5f}, "
       "predictor grads flow)")

    # 3) the latent rollout on split rows
    m = flax_init_(LatentIntegrator(z_num=8, num_param=2, hidden=32,
                                    depth=1), 1).to(dev)
    p_seq = torch.from_numpy(rng.normal(size=(5, b, 2)).astype(
        np.float32)).to(dev)
    z0 = torch.cat([p_seq[0], torch.zeros(b, 6, device=dev)], -1)
    with torch.no_grad():
        whole = rollout(m, z0, p_seq, 2)
        part = rollout(m, mesh.local_rows(z0, data),
                       mesh.local_rows(p_seq, data, axis=1), 2)
        got = comm.gather_rows(part, data, 1)
    _close(got, whole, 1e-5, "split rollout")
    ok("3", "sharded latent rollout ok (== one process)")


def dryrun_multichip(n: int = 2, device: str = "cuda") -> list[str]:
    """``n`` ranks through every stage (see the module docstring); raises
    unless each rank exits 0 and rank 0 reports every stage.  Returns rank
    0's stage lines."""
    from deepfluids_tpu_torch.tools.launch_multihost import (
        default_backend,
        spawn,
    )

    cmd = [sys.executable, "-m", "deepfluids_tpu_torch.tools.dryrun",
           "--stages", "--device", device]
    rcs, outs = spawn(cmd, n, default_backend(device, n), capture=True,
                      timeout=900)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        if rc:
            raise RuntimeError(f"dryrun_multichip({n}) rank {rank} failed "
                               f"(exit {rc}):\n{out}")
    lines = [ln.split(" ", 2)[2] for ln in outs[0].splitlines()
             if ln.startswith(OK_TAG)]
    done = [ln.split(" ", 2)[1] for ln in outs[0].splitlines()
            if ln.startswith(OK_TAG)]
    if done != list(STAGES):
        raise AssertionError(f"dryrun_multichip({n}): stages {done}, want "
                             f"{list(STAGES)}:\n{outs[0]}")
    for ln in lines:
        print(ln, flush=True)
    return lines


def dryrun_multihost(n_processes: int = 2,
                     device: str = "cuda") -> list[float]:
    """The launcher's data-parallel steps in ``n_processes`` processes (a
    process is a rank with one device), equal to one process on the same
    global batch; returns the losses."""
    from deepfluids_tpu_torch.tools.launch_multihost import launch

    losses = launch(n_processes, steps=2, check_single=True, device=device)
    print(f"dryrun_multihost({n_processes}): DP steps across processes ok, "
          f"losses={losses}", flush=True)
    return losses


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("dryrun")
    p.add_argument("what", nargs="?", choices=("multichip", "multihost"))
    p.add_argument("n", nargs="?", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--stages", action="store_true",
                   help="internal: run as one rank of dryrun_multichip")
    a = p.parse_args(argv)
    if a.stages:
        run_stages(a.device)
    elif a.what == "multihost":
        dryrun_multihost(a.n, device=a.device)
    else:
        dryrun_multichip(a.n, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
