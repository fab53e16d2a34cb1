"""The port's parallel layer against the JAX package's.

  * The haloed FD kernels on simulated shards (a field cut into n blocks in
    one process, each given its neighbours' rows) against
    ``deepfluids_tpu.parallel.halo.*_sharded`` on n devices of conftest's
    CPU mesh, n = 2, 4, 8 (8 cuts the 8 rows into one-row blocks): forward
    within 1e-6, the gradient through the halo within 1e-5.
  * Ranks spawned once for the module (gloo on the CPU, a free port): four
    run the plain sharded ops (divergence, the levelset gradient) and the
    kernels through real exchanges, including one-row blocks, the 3D
    ``--spatial_shard`` trainer on one z-slice a rank (also with
    ``--spectral_modes``: a DFT distributed over one-row blocks), and the
    rows x channels layout (2 rows x 2 channels: ``--spatial_shard
    --num_model_shards 2``) for the generator with the spectral residuals
    and the grid decoder's basis injection, and for the autoencoder; two
    run the 2D generator (plain, with ``--spectral_modes``, with ``--decoder
    grid --grid_rank``) and the autoencoder (32 rows: the encoder's
    stride-2 convs on the successor's row and ``fc_out`` on each rank's
    rows; 36 rows with ``--ae_pred_w``: 9 rows a rank after the first
    stride-2 conv, so the next one gathers the map).  The trainers' loss
    and gradients must equal JAX's spatial ``Trainer`` from the same
    weights (random biases, gains and bases, and the 2D generator and the
    autoencoder also at JAX's init, zero biases, at 36 rows: there the
    encoder meets exact zeros, a zero patch of the field times a zero
    bias, where the leaky ReLU's gradient is 1 in JAX and in the port and
    the slope in ``F.leaky_relu``, 1.8e-3 away; rtol 1e-5 / atol 1e-5, the
    bar of ``tests/test_train.py``), and they train on.
  * The models' leaky ReLU against ``jax.nn.leaky_relu``: the same forward
    and the gradient 1 at exactly 0.
  * The layout's refusals, as the JAX trainer's.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.config import Config  # noqa: E402
from deepfluids_tpu.datagen import scenes  # noqa: E402
from deepfluids_tpu.parallel import halo as jhalo  # noqa: E402
from deepfluids_tpu.parallel.mesh import make_mesh  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu_torch.config import Config as PortConfig  # noqa: E402
from deepfluids_tpu_torch.models import activation  # noqa: E402
from deepfluids_tpu_torch.ops import cuda_fd  # noqa: E402
from deepfluids_tpu_torch.parallel import (  # noqa: E402
    Layout,
    Shard,
    halo,
    local_rows,
    make_layout,
)
from deepfluids_tpu_torch.tools import launch_multihost  # noqa: E402
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402

KERNELS = {   # name: (port forward, port backward, JAX sharded, shapes)
    "curl2d": (cuda_fd.curl2d_fused, cuda_fd.curl2d_bwd,
               jhalo.curl2d_sharded, (2, 8, 12, 1), [(2, 8, 12, 2)]),
    "jacobian2d": (cuda_fd.jacobian2d_fused, halo._jac2d_bwd,
                   jhalo.jacobian2d_sharded, (2, 8, 12, 2),
                   [(2, 8, 12, 4), (2, 8, 12, 1)]),
    "curl3d": (cuda_fd.curl3d_fused, cuda_fd.curl3d_bwd,
               jhalo.curl3d_sharded, (1, 8, 5, 6, 3), [(1, 8, 5, 6, 3)]),
    "jacobian3d": (cuda_fd.jacobian3d_fused, halo._jac3d_bwd,
                   jhalo.jacobian3d_sharded, (1, 8, 5, 6, 3),
                   [(1, 8, 5, 6, 9), (1, 8, 5, 6, 3)]),
}


def _mesh(n: int):
    return make_mesh(num_data=n, devices=jax.devices()[:n])


def _jax_vjp(fn, x: np.ndarray, cot):
    """``fn(x)`` and its VJP with ``cot``, compiled (eager shard_maps are
    20x slower on the CPU)."""
    def f(v, c):
        y, vjp = jax.vjp(fn, v)
        return y, vjp(c)[0]

    return jax.jit(f)(jnp.asarray(x), cot)


def _neighbours(blocks: list[torch.Tensor], i: int):
    last = blocks[i - 1].shape[1] - 1 if i > 0 else 0
    return (blocks[i - 1].narrow(1, last, 1) if i > 0 else None,
            blocks[i + 1].narrow(1, 0, 1) if i < len(blocks) - 1 else None)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", list(KERNELS))
def test_haloed_kernels_on_simulated_shards_match_jax(name, n):
    fwd, bwd, jax_fn, shape, gshapes = KERNELS[name]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    gs = [rng.standard_normal(s).astype(np.float32) for s in gshapes]
    blocks = list(torch.from_numpy(x).chunk(n, 1))
    gblocks = [list(torch.from_numpy(g).chunk(n, 1)) for g in gs]
    outs, grads = [], []
    for i in range(n):
        outs.append(halo.halo_forward(fwd, blocks[i].contiguous(),
                                      _neighbours(blocks, i), i, n))
        gi = [gb[i].contiguous() for gb in gblocks]
        grads.append(halo.halo_backward(
            bwd, gi, [_neighbours(gb, i) for gb in gblocks], i, n))
    mesh = _mesh(n)
    cot = tuple(jnp.asarray(g) for g in gs)
    want, want_dx = _jax_vjp(lambda v: jax_fn(v, mesh), x,
                             cot if len(cot) > 1 else cot[0])
    want = want if isinstance(want, tuple) else (want,)
    got = [torch.cat([o[k] if isinstance(o, tuple) else o for o in outs], 1)
           for k in range(len(want))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(torch.cat(grads, 1).numpy(),
                               np.asarray(want_dx), atol=1e-5)


# -- ranks -------------------------------------------------------------------

# One rank: the sharded ops on the fields of ops.npz (each rank's rows, then
# gathered), and the trainer jobs of the spec file.
WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from deepfluids_tpu_torch import parallel
from deepfluids_tpu_torch.config import Config
from deepfluids_tpu_torch.parallel import comm, halo
from deepfluids_tpu_torch.train.trainer import Trainer
parallel.init_distributed("cpu")
lay = parallel.make_layout()
rank, shard = lay.rank, lay.data
spec = json.load(open(sys.argv[1]))
if spec.get("ops"):
    ops = {"curl2d": halo.curl2d_sharded,
           "jacobian2d": lambda v, s: halo.jacobian2d_sharded(v, s)[0],
           "curl3d": halo.curl3d_sharded,
           "jacobian3d": lambda v, s: halo.jacobian3d_sharded(v, s)[0],
           "divergence2d": halo.divergence2d_sharded,
           "divergence3d": halo.divergence3d_sharded,
           "grad_scalar2d": halo.grad_scalar_sharded,
           "grad_scalar3d": halo.grad_scalar_sharded}
    d, out = np.load(spec["ops"]), {}
    for key in sorted(k for k in d.files if k.startswith("x:")):
        _, name, size = key.split(":")
        x = comm.split_rows(torch.from_numpy(d[key]), shard, 1)
        x.requires_grad_(True)
        y = ops[name](x, shard)
        g = comm.split_rows(torch.from_numpy(d["g:" + name + ":" + size]),
                            shard, 1)
        y.backward(g)
        out["y:" + name + ":" + size] = comm.gather_rows(
            y.detach(), shard, 1).numpy()
        out["dx:" + name + ":" + size] = comm.gather_rows(
            x.grad, shard, 1).numpy()
    if rank == 0:
        np.savez(spec["ops_out"], **out)
for job in spec.get("jobs", []):
    t = Trainer(Config(**job["config"]), run_dir=job["run_dir"],
                device="cpu", save_cfg=False)
    t.restore_weights()
    d = np.load(job["batch"])
    loss, grads = t._loss_and_grads(d["a"], d["b"])
    aux = t.train(2)
    if rank == 0:
        np.savez(job["out"], __loss__=np.float64(loss),
                 __trained__=np.float64(aux["loss"]), **grads)
print("WORKER_OK", flush=True)
"""

OPS = {   # name: (JAX sharded op, channels, 3D)
    "curl2d": (jhalo.curl2d_sharded, 1, False),
    "jacobian2d": (lambda v, m: jhalo.jacobian2d_sharded(v, m)[0], 2,
                   False),
    "curl3d": (jhalo.curl3d_sharded, 3, True),
    "jacobian3d": (lambda v, m: jhalo.jacobian3d_sharded(v, m)[0], 3,
                   True),
    "divergence2d": (jhalo.divergence2d_sharded, 2, False),
    "divergence3d": (jhalo.divergence3d_sharded, 3, True),
    "grad_scalar2d": (jhalo.grad_scalar_sharded, 1, False),
    "grad_scalar3d": (jhalo.grad_scalar_sharded, 1, True),
}
SIZES = (4, 8)      # rows of the sharded axis over 4 ranks: 1 and 2 a rank


def _kw(data_dir, log_dir, **kw) -> dict:
    base = dict(arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=data_dir, dataset="tiny_smoke", log_dir=log_dir,
                max_step=50, lr_max=2e-3, lr_min=1e-4, log_step=10,
                test_step=10_000, save_step=10_000, compute_dtype="float32",
                num_worker=1, seed=0)
    base.update(kw)
    return base


def _jax_loss_and_grads(t, x, y):
    f = jax.jit(jax.value_and_grad(
        lambda p: t._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0]))
    loss, grads = f(t.state.params)
    return float(loss), weights_io.flatten_params(jax.device_get(grads))


def _randomized(key: str, biases: bool) -> bool:
    """Whether a parameter is drawn at random before the comparison: the
    knobs' tables (zero at init, so a comparison there proves nothing)
    and, unless JAX's init is wanted, the biases."""
    leaf = key.split("/")[-1]
    return (leaf.startswith(("gain_", "basis_"))
            or (biases and leaf == "bias"))


def _jax_spatial(data, logs, name: str, ranks: int, flat: dict | None,
                 random_bias: bool, **kw):
    """JAX's spatial ``Trainer`` over ``ranks`` rows, its weights ``flat``
    (None: its init with the randomized entries of :func:`_randomized`),
    and its loss and gradients of batch 1."""
    jt = JaxTrainer(Config(**_kw(data, logs, tag=f"jax_{name}",
                                 spatial_shard=True, num_data_shards=ranks,
                                 **kw)))
    if flat is None:
        rng = np.random.default_rng(11)
        flat = weights_io.flatten_params(jax.device_get(jt.state.params))
        flat = {k: v + rng.normal(0, 0.05, v.shape).astype(v.dtype)
                if _randomized(k, random_bias) else v
                for k, v in flat.items()}
    jt.state = jt.state.replace(params=jax.tree_util.tree_map(
        lambda a, b: jnp.asarray(b, a.dtype), jt.state.params,
        weights_io.unflatten_params(flat)))
    x, y = jt.bm.step_batch(1)
    return jt, flat, (x, y), _jax_loss_and_grads(jt, x, y)


def _spatial_job(root, data, logs, name: str, ranks: int,
                 random_bias: bool = True, model_shards: int = 1,
                 **kw) -> dict:
    """The JAX spatial trainer's loss and gradients of one batch, and a
    port job from its weights over ``ranks`` rows x ``model_shards``
    channel blocks.  The spectral gains and the bases are made random, and
    so are the biases unless ``random_bias`` is False: then a zero bias
    meets a zero patch of the field and a pre-activation is exactly 0,
    where the leaky ReLU's gradient is 1 in JAX and in the port.

    Rows x channels is held against JAX's rows-only spatial Trainer: on a
    (rows, model) mesh JAX returns twice the gradient of every 3x3 conv
    kernel (``want_mesh``, held by
    :func:`test_jax_rows_by_channels_doubles_cut_kernels`)."""
    jt, flat, (x, y), want = _jax_spatial(data, logs, name, ranks, None,
                                          random_bias, **kw)
    run = os.path.join(root, "ranks", name)
    os.makedirs(run)
    weights_io.export_npz(jax.device_get(jt.state.params),
                          os.path.join(run, "weights.npz"))
    np.savez(os.path.join(root, f"{name}_batch.npz"), a=x, b=y)
    cfg = _kw(data, logs, tag=name, spatial_shard=True,
              num_data_shards=ranks, num_model_shards=model_shards, **kw)
    job = {"config": cfg, "run_dir": run,
           "batch": os.path.join(root, f"{name}_batch.npz"),
           "out": os.path.join(root, f"{name}_out.npz"), "want": want}
    if model_shards > 1:
        job["want_mesh"] = _jax_spatial(data, logs, name + "_mesh", ranks,
                                        flat, random_bias,
                                        num_model_shards=model_shards,
                                        **kw)[3]
    return job


def _spawn(root, ranks: int, spec: dict) -> None:
    path = os.path.join(root, f"spec{ranks}.json")
    with open(path, "w") as f:
        json.dump({**spec, "jobs": [{k: v for k, v in j.items()
                                     if not k.startswith("want")}
                                    for j in spec.get("jobs", [])]}, f)
    rcs, outs = launch_multihost.spawn(
        [sys.executable, "-c", WORKER, path], ranks, "gloo", threads=1,
        capture=True, timeout=600)
    assert rcs == [0] * ranks and all("WORKER_OK" in o for o in outs), (
        rcs, outs[0][-3000:])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("par"))
    data, logs = os.path.join(root, "data"), os.path.join(root, "logs")
    scenes.smoke_pos21_size5(data, num_pos=2, num_size=2, num_frames=4,
                             height=32, width=32, name="tiny_smoke")
    scenes.smoke_pos21_size5(data, num_pos=2, num_size=2, num_frames=4,
                             height=36, width=32, name="tiny_odd")
    scenes.smoke3_vel5_buo3(data, num_vel=1, num_buo=1, num_frames=4,
                            depth=4, height=16, width=16, name="tiny3d")
    rng = np.random.default_rng(7)
    fields = {}
    for name, (_, ch, is3d) in OPS.items():
        for rows in SIZES:
            shape = (1, rows, 5, 6, ch) if is3d else (2, rows, 12, ch)
            x = rng.standard_normal(shape).astype(np.float32)
            mesh = _mesh(4)
            op = (lambda fn: lambda v: fn(v, mesh))(OPS[name][0])
            out = jax.eval_shape(op, jax.ShapeDtypeStruct(shape, np.float32))
            g = rng.standard_normal(out.shape).astype(np.float32)
            y, dx = _jax_vjp(op, x, jnp.asarray(g))
            fields[f"x:{name}:{rows}"] = x
            fields[f"g:{name}:{rows}"] = g
            fields[f"want_y:{name}:{rows}"] = np.asarray(y)
            fields[f"want_dx:{name}:{rows}"] = np.asarray(dx)
    np.savez(os.path.join(root, "ops.npz"),
             **{k: v for k, v in fields.items() if not k.startswith("want")})
    knobs = dict(spectral_modes=4, decoder="grid", grid_rank=4)
    jobs4 = {"sp3d": _spatial_job(root, data, logs, "sp3d", 4,
                                  dataset="tiny3d", batch_size=4),
             "sp3d_spectral": _spatial_job(root, data, logs, "sp3d_spectral",
                                           4, dataset="tiny3d", batch_size=4,
                                           spectral_modes=4),
             "sp_tp_knobs": _spatial_job(root, data, logs, "sp_tp_knobs", 2,
                                         model_shards=2, **knobs),
             "sp_tp_ae": _spatial_job(root, data, logs, "sp_tp_ae", 2,
                                      arch="ae", model_shards=2)}
    jobs2 = {"sp2d": _spatial_job(root, data, logs, "sp2d", 2),
             "sp2d_init": _spatial_job(root, data, logs, "sp2d_init", 2,
                                       random_bias=False,
                                       dataset="tiny_odd"),
             "sp2d_spectral": _spatial_job(root, data, logs, "sp2d_spectral",
                                           2, spectral_modes=4),
             "sp2d_grid": _spatial_job(root, data, logs, "sp2d_grid", 2,
                                       decoder="grid", grid_rank=4),
             "sp_ae": _spatial_job(root, data, logs, "sp_ae", 2, arch="ae"),
             "sp_ae_init": _spatial_job(root, data, logs, "sp_ae_init", 2,
                                        arch="ae", random_bias=False,
                                        dataset="tiny_odd"),
             "sp_ae_pred": _spatial_job(root, data, logs, "sp_ae_pred", 2,
                                        arch="ae", ae_pred_w=0.5,
                                        dataset="tiny_odd")}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:      # both groups at once
        done = [pool.submit(_spawn, root, 4, {
                    "ops": os.path.join(root, "ops.npz"),
                    "ops_out": os.path.join(root, "ops_out.npz"),
                    "jobs": list(jobs4.values())}),
                pool.submit(_spawn, root, 2, {"jobs": list(jobs2.values())})]
        for f in done:
            f.result()
    with np.load(os.path.join(root, "ops_out.npz")) as d:
        got = {k: d[k] for k in d.files}
    return {"fields": fields, "got": got, "jobs": {**jobs2, **jobs4}}


@pytest.mark.parametrize("rows", SIZES)
@pytest.mark.parametrize("name", list(OPS))
def test_sharded_ops_through_ranks_match_jax(spawned, name, rows):
    """Four ranks, 1 or 2 rows each: the op and its gradient through the
    exchange, gathered, against JAX's sharded op on four devices."""
    key = f"{name}:{rows}"
    f, got = spawned["fields"], spawned["got"]
    np.testing.assert_allclose(got["y:" + key], f["want_y:" + key],
                               atol=1e-6)
    np.testing.assert_allclose(got["dx:" + key], f["want_dx:" + key],
                               atol=1e-5)


SPATIAL_JOBS = ["sp2d", "sp2d_init", "sp2d_spectral", "sp2d_grid", "sp3d",
                "sp3d_spectral", "sp_ae", "sp_ae_init", "sp_ae_pred",
                "sp_tp_knobs", "sp_tp_ae"]


@pytest.mark.parametrize("name", SPATIAL_JOBS)
def test_spatial_trainer_matches_jax(spawned, name):
    """--spatial_shard, 2D over 2 ranks (16 rows each; the generator also
    with the spectral residuals and with the basis injection; the
    autoencoder also at 18 rows each with --ae_pred_w; both at 18 rows
    each from JAX's zero-bias init), 3D over 4 (one z-slice each, also with the
    spectral residuals), and rows x channels over 4 (2 x 2: the generator
    with every knob of the grid decoder and the spectral residuals, the
    autoencoder): loss and gradients of JAX's spatial Trainer from the
    same weights, then two training steps."""
    job = spawned["jobs"][name]
    want_loss, want = job["want"]
    with np.load(job["out"]) as d:
        got = {k: d[k] for k in d.files}
    assert float(got.pop("__loss__")) == pytest.approx(want_loss, rel=1e-5)
    assert np.isfinite(got.pop("__trained__"))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["sp_tp_knobs", "sp_tp_ae"])
def test_jax_rows_by_channels_doubles_cut_kernels(spawned, name):
    """A fault of the reference, held: JAX's spatial Trainer on a 2 x 2
    (rows, model) mesh gives the loss of the rows-only one, but twice the
    gradient of every 3x3 conv kernel, conv_out's and the encoder's
    stride-2 ones too (the 1x1 injection kernels, biases, dense layers and
    the knobs' tables equal).  The port's rows x channels
    gradients are the true ones: those of JAX's rows-only layout (above)
    and of one process."""
    job = spawned["jobs"][name]
    (loss, want), (mesh_loss, mesh) = job["want"], job["want_mesh"]
    assert mesh_loss == pytest.approx(loss, rel=1e-5)
    doubled = {k for k, w in want.items()      # [3, 3, (3,) in, out]
               if k.endswith("kernel") and w.ndim >= 4 and w.shape[0] == 3}
    assert doubled
    for k, w in want.items():
        np.testing.assert_allclose(mesh[k], 2 * w if k in doubled else w,
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaky_relu_matches_jax_at_zero(dtype):
    """The models' activation: F.leaky_relu's forward, and JAX's gradient,
    1 at exactly 0 and -0.0 (F.leaky_relu's is the slope there)."""
    x = np.array([0.0, -0.0, 0.75, -0.75, 3.0, -3.0], np.float32)
    xt = torch.tensor(x, dtype=getattr(torch, dtype), requires_grad=True)
    y = activation.leaky_relu(xt, 0.2)
    y.sum().backward()
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want_y = jax.nn.leaky_relu(xj, 0.2)
    want_g = jax.vmap(jax.grad(lambda v: jax.nn.leaky_relu(v, 0.2)))(xj)
    assert torch.equal(y.detach(), torch.nn.functional.leaky_relu(
        xt.detach(), 0.2))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want_g, np.float32))
    assert float(xt.grad[0]) == float(xt.grad[1]) == 1.0


# -- refusals and layout ----------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pdata"))
    scenes.smoke_pos21_size5(root, num_pos=1, num_size=1, num_frames=2,
                             height=36, width=32, name="odd")
    return root


def test_spatial_shard_rejects_nn(data_dir, tmp_path):
    c = PortConfig(**_kw(data_dir, str(tmp_path), dataset="odd", arch="nn",
                         spatial_shard=True))
    with pytest.raises(ValueError, match="de/ae only"):
        Trainer(c, device="cpu")


def test_spatial_shard_indivisible_raises(data_dir, tmp_path):
    """36 rows over a data group of 8 (a layout standing for 8 ranks: the
    check comes before any collective)."""
    c = PortConfig(**_kw(data_dir, str(tmp_path), dataset="odd",
                         spatial_shard=True))
    lay = Layout(data=Shard(None, 0, 8), spatial=True)
    with pytest.raises(ValueError, match="divisible"):
        Trainer(c, device="cpu", layout=lay)


def test_layout_of_one_process():
    assert make_layout() == Layout()
    assert make_layout(1, 1, spatial=True).rows is None
    with pytest.raises(ValueError, match="mesh 1x4 needs 4 devices"):
        make_layout(0, 4)


def test_local_rows_of_pair_batches():
    """A pair batch [x_t ; x_{t+1}] is split as [its t rows ; its t+1
    rows], never as a block of the global pair batch."""
    a = np.arange(8)
    assert local_rows(a, Shard(None, 1, 2)).tolist() == [4, 5, 6, 7]
    assert local_rows(a, Shard(None, 1, 2), pair=True).tolist() == [
        2, 3, 6, 7]
    w = torch.arange(12).reshape(2, 6)
    assert local_rows(w, Shard(None, 2, 3), axis=1).tolist() == [
        [4, 5], [10, 11]]
    with pytest.raises(ValueError, match="not divisible"):
        local_rows(np.arange(6), Shard(None, 0, 4))
