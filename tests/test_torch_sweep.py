"""The port's sweep API (``infer/sweep.py``) against the JAX package's:
every knob of ``run_test_sweep`` (``counts=None``, ``save_npz``,
``gif_scenes``, ``write_workers``, ``save_png_every``) writes the files
JAX writes, ``sweep_generator``'s ``denormalize``, and ``sweep_on_device``
against the port's ``sweep_generator`` (f32 on the CPU: atol 1e-6),
directly and through its ring of batch slots, and against JAX's ``sweep_on_device`` on the same
generator weights (normalized L2 < 1e-3, the repo's parity gate).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.data.manifest import Manifest as JaxManifest  # noqa: E402
from deepfluids_tpu.infer import sweep as jsweep  # noqa: E402
from deepfluids_tpu.models import GeneratorBE as FlaxGeneratorBE  # noqa: E402
from deepfluids_tpu.train import losses as jlosses  # noqa: E402
from deepfluids_tpu_torch.data import Manifest  # noqa: E402
from deepfluids_tpu_torch.infer import sweep as tsweep  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    GeneratorBE,
    flax_to_state_dict,
)
from deepfluids_tpu_torch.train.losses import apply_curl  # noqa: E402
from deepfluids_tpu_torch.utils.parity import normalized_l2  # noqa: E402

MANIFESTS = {
    "velocity": dict(param_names=["pos", "size", "frame"],
                     param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]],
                     num_scenes=4, num_frames=4, resolution=[16, 12],
                     num_channels=2, v_range=[-2.0, 2.0]),
    "levelset": dict(param_names=["drop_x_pos", "drop_radius", "frame"],
                     param_ranges=[[0.25, 0.75], [0.06, 0.15], [0.0, 3.0]],
                     num_scenes=4, num_frames=4, resolution=[16, 12],
                     num_channels=1, v_range=[-3.0, 1.5],
                     data_type="levelset", param_counts=[2, 2]),
    "3d": dict(param_names=["inflow_vel", "buoyancy", "frame"],
               param_ranges=[[0.5, 1.5], [0.04, 0.12], [0.0, 2.0]],
               num_scenes=2, num_frames=3, resolution=[4, 8, 6],
               num_channels=3, v_range=[-1.0, 1.0]),
}


def _linear(kind: str, seed: int = 0):
    """(manifest, JAX apply_fn, port apply_fn): the same linear map from
    normalized params to fields in both frameworks."""
    kw = MANIFESTS[kind]
    shape = tuple(kw["resolution"]) + (kw["num_channels"],)
    w = np.random.default_rng(seed).standard_normal(
        (3, int(np.prod(shape)))).astype(np.float32)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    return (Manifest(**kw), JaxManifest(**kw),
            lambda p: (p @ wj).reshape((-1,) + shape),
            lambda p: (p @ wt).reshape((-1,) + shape))


@pytest.mark.parametrize("kind,kw", [
    ("velocity", dict()),                                  # the midpoints
    ("velocity", dict(counts=(2, 2), save_npz=False, gif_scenes=2,
                      save_png_every=2, write_workers=1)),
    ("velocity", dict(counts=(3, 1), gif_scenes=5, write_workers=4)),
    ("velocity", dict(counts=(2, 1), gif_scenes=0, num_frames=2)),
    ("levelset", dict(counts=(2, 2), save_png_every=3, gif_scenes=4)),
    ("3d", dict(counts=(2, 1), save_png_every=1))],
    ids=["midpoints", "no_npz", "gif_clamped", "no_gif", "levelset", "3d"])
def test_run_test_sweep_writes_what_jax_writes(tmp_path, kind, kw):
    m, jm, jfn, tfn = _linear(kind)
    want = jsweep.run_test_sweep(jfn, jm, str(tmp_path / "jax"),
                                 batch_size=3, **kw)
    got = tsweep.run_test_sweep(tfn, m, str(tmp_path / "port"),
                                batch_size=3, device="cpu", **kw)
    assert got["num_fields"] == want["num_fields"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert any(n.endswith(".npz") for n in names) == kw.get("save_npz",
                                                            True)
    for name in names:
        if not name.endswith(".npz"):
            continue
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(b.files) == sorted(a.files) == ["x", "y"]
            assert b["x"].dtype == np.float32
            assert normalized_l2(b["x"], a["x"]) < 1e-3, name
            np.testing.assert_array_equal(b["y"], a["y"])


@pytest.mark.parametrize("denormalize", [True, False])
def test_sweep_generator_denormalize_matches_jax(denormalize):
    m, jm, jfn, tfn = _linear("velocity", seed=1)
    raw = tsweep.param_grid(m, (2, 2))
    want = np.concatenate(list(jsweep.sweep_generator(
        jfn, jm, raw, batch_size=5, denormalize=denormalize)))
    got = np.concatenate(list(tsweep.sweep_generator(
        tfn, m, raw, batch_size=5, denormalize=denormalize, device="cpu")))
    assert got.shape == want.shape == (16, 16, 12, 2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    scale = 1.0 if denormalize else m.v_scale
    np.testing.assert_allclose(
        got * scale, m.denormalize_field(tfn(torch.from_numpy(
            m.normalize_params(raw))).numpy()), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind,counts,batch", [
    ("velocity", (3, 2), 5), ("levelset", (2, 2), 4), ("3d", (2, 2), 4)])
def test_sweep_on_device_matches_sweep_generator(kind, counts, batch):
    m, _, _, tfn = _linear(kind, seed=2)
    raw = tsweep.param_grid(m, counts)
    dev = tsweep.sweep_on_device(tfn, m, raw, batch_size=batch,
                                 device="cpu")
    host = np.concatenate(list(tsweep.sweep_generator(
        tfn, m, raw, batch_size=batch, device="cpu")))
    assert dev.dtype == np.float32
    assert dev.shape == host.shape == (len(raw),) + m.field_shape
    np.testing.assert_allclose(dev, host, atol=1e-6, rtol=0)


R = tsweep.RING_SLOTS


@pytest.mark.parametrize("kind", ["velocity", "3d"])
@pytest.mark.parametrize("batches,extra", [
    (1, 0), (1, -1), (R, 0), (R + 1, 0), (2 * R + 1, 1)],
    ids=["one", "one_partial", "ring", "ring_plus_one", "over_2r_partial"])
def test_sweep_on_device_segments_match_one(kind, batches, extra):
    # A cap below one batch sends every batch through the ring of pinned
    # slots: one batch, exactly RING_SLOTS, one more, and more than twice
    # RING_SLOTS with a partial last batch.  The fields equal the direct
    # return's bit for bit, and every batch is one copy out of the ring.
    m, _, _, tfn = _linear(kind, seed=3)
    n = 4 * batches + extra
    raw = tsweep.param_grid(m, (12, 2))[:n]
    before = sum(tsweep.overlap_counts.values())
    ring = tsweep.sweep_on_device(tfn, m, raw, batch_size=4,
                                  max_out_bytes=1, device="cpu")
    assert sum(tsweep.overlap_counts.values()) == before + -(-n // 4)
    one = tsweep.sweep_on_device(tfn, m, raw, batch_size=4, device="cpu")
    assert sum(tsweep.overlap_counts.values()) == before + -(-n // 4)
    assert ring.shape == one.shape == (n,) + m.field_shape
    np.testing.assert_array_equal(ring, one)


def test_sweep_on_device_matches_jax_on_a_generator():
    """The generator + curl on the same Flax-init weights through JAX's
    ``sweep_on_device`` and the port's: 3 x 2 x 4 fields at batch 5."""
    kw = MANIFESTS["velocity"]
    m, jm = Manifest(**kw), JaxManifest(**kw)
    raw = tsweep.param_grid(m, (3, 2))
    fm = FlaxGeneratorBE(output_shape=(16, 12, 1), filters=8, num_conv=1)
    params = fm.init(jax.random.PRNGKey(4), jnp.zeros((1, 3)))["params"]
    want = jsweep.sweep_on_device(
        lambda prm, p: jlosses.apply_curl(fm.apply({"params": prm}, p)),
        jm, raw, batch_size=5, params=params)
    tm = GeneratorBE((16, 12, 1), num_param=3, filters=8, num_conv=1)
    tm.load_state_dict(flax_to_state_dict(weights_io.flatten_params(params),
                                          tm))
    got = tsweep.sweep_on_device(lambda p: apply_curl(tm(p)), m, raw,
                                 batch_size=5, device="cpu")
    assert got.shape == want.shape == (24, 16, 12, 2)
    assert normalized_l2(got, want) < 1e-3
