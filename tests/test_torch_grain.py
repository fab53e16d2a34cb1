"""``--input_pipeline grain`` of the port against the JAX package's grain
loader and trainer.

The port's stream shuffles each epoch with ``default_rng((seed, epoch))``
where grain uses its compiled ``index_shuffle`` (ROADMAP Queue C, "Streams
that can't match JAX"), so the parity tests hand grain's own order to the
port (``grain_loader.epoch_order`` patched with the record keys of a
``grain.IndexSampler``): then the port's batches must equal JAX's
``make_grain_loader(worker_count=0)`` bit for bit.  Everything else is
the port's own contract: epochs are permutations of the shard's records,
the stream depends on (seed, shard, records, B) and not on the worker
count, a skip is the fresh stream's tail, and no worker outlives a closed
stream.  The dataset has 16 frames and the batch is 3, so batches cross
epoch boundaries.
"""

import gc
import json
import multiprocessing
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import weights_io  # noqa: E402

from deepfluids_tpu.config import Config  # noqa: E402
from deepfluids_tpu.data.dataset import BatchManager  # noqa: E402
from deepfluids_tpu.data.grain_loader import (  # noqa: E402
    make_grain_loader as jax_grain_loader,
)
from deepfluids_tpu.datagen import scenes  # noqa: E402
from deepfluids_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfluids_tpu_torch.config import Config as PortConfig  # noqa: E402
from deepfluids_tpu_torch.config import get_config  # noqa: E402
from deepfluids_tpu_torch.data import grain_loader  # noqa: E402
from deepfluids_tpu_torch.main import main as torch_main  # noqa: E402
from deepfluids_tpu_torch.models import (  # noqa: E402
    flax_to_state_dict,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.train.trainer import Trainer  # noqa: E402

B = 3          # 16 frames: no epoch is a whole number of batches
FRAMES = 16
NULL_PARAM = "conv_out/bias"   # rounding noise under the curl


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    scenes.smoke_pos21_size5(str(root), num_pos=2, num_size=2, num_frames=4,
                             height=32, width=32, name="tiny_smoke")
    return str(root)


@pytest.fixture(scope="module")
def ds(data_dir):
    return os.path.join(data_dir, "tiny_smoke")


@pytest.fixture(scope="module")
def holdout_indices(ds):
    """The train frames of a one-scene holdout (12 of 16)."""
    return BatchManager(ds, B, holdout_scenes=1,
                        num_workers=1).train_indices


def grain_orders(n: int, seed: int, shard_index: int = 0,
                 shard_count: int = 1, epochs: int = 8) -> dict:
    """Epoch -> grain's order of a shard's records (positions in the
    shard): the record keys grain's ``worker_count=0`` loader reads,
    sampler indices ``i * shard_count + shard_index``.  More epochs than a
    test reads: the port's workers prefetch ahead."""
    grain = pytest.importorskip("grain.python")
    sampler = grain.IndexSampler(
        num_records=n, shuffle=True, num_epochs=epochs, seed=seed,
        shard_options=grain.ShardOptions(shard_index=shard_index,
                                         shard_count=shard_count,
                                         drop_remainder=True))
    m = n // shard_count
    keys = np.array([sampler[i * shard_count + shard_index].record_key
                     for i in range(epochs * m)]) - shard_index * m
    return {e: keys[e * m:(e + 1) * m] for e in range(epochs)}


def use_order(monkeypatch, orders: dict, seed: int) -> None:
    """The port's stream in ``orders`` instead of its own shuffle."""
    def order(s, epoch, m):
        assert s == seed and len(orders[epoch]) == m
        return orders[epoch]
    monkeypatch.setattr(grain_loader, "epoch_order", order)


def port_stream(ds, **kw) -> list:
    kw.setdefault("num_epochs", 2)
    return [(x.numpy(), y.numpy())
            for x, y in grain_loader.make_grain_loader(ds, B, **kw)]


def assert_same(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == np.float32 and gx.shape == np.shape(wx)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def frame_ids(ds) -> dict:
    """Normalized params row -> frame index (each frame's params differ)."""
    src = grain_loader._FieldSource(ds)
    return {src[j][1].tobytes(): j for j in range(len(src))}


# --- the loader against JAX's ---------------------------------------------

@pytest.mark.parametrize("case", ["all", "holdout", "shard1of2"])
def test_batches_equal_jax_given_grains_order(ds, holdout_indices,
                                              monkeypatch, case):
    kw = {"all": {}, "holdout": {"indices": holdout_indices},
          "shard1of2": {"shard_index": 1, "shard_count": 2}}[case]
    seed = 5
    n = len(holdout_indices) if case == "holdout" else FRAMES
    use_order(monkeypatch, grain_orders(
        n, seed, kw.get("shard_index", 0), kw.get("shard_count", 1)), seed)
    want = list(jax_grain_loader(ds, B, seed=seed, num_epochs=2,
                                 worker_count=0, **kw))
    assert len(want) == 2 * (n // kw.get("shard_count", 1)) // B
    assert_same(port_stream(ds, seed=seed, worker_count=0, **kw), want)


# --- the port's own stream -------------------------------------------------

@pytest.mark.parametrize("case", ["all", "holdout", "shard0of2",
                                  "shard1of2"])
def test_each_epoch_is_a_permutation_of_the_records(ds, holdout_indices,
                                                    case):
    kw = {"all": {}, "holdout": {"indices": holdout_indices},
          "shard0of2": {"shard_index": 0, "shard_count": 2},
          "shard1of2": {"shard_index": 1, "shard_count": 2}}[case]
    if case == "holdout":
        records = list(holdout_indices)
    else:
        k, s = kw.get("shard_count", 1), kw.get("shard_index", 0)
        m = FRAMES // k
        records = list(range(s * m, (s + 1) * m))
    m, epochs = len(records), 2
    ids = frame_ids(ds)
    got = [ids[row.tobytes()] for _, y in port_stream(
        ds, seed=1, worker_count=0, num_epochs=epochs, **kw) for row in y]
    assert len(got) == epochs * m // B * B       # the partial batch dropped
    for e in range(epochs):
        epoch = got[e * m:(e + 1) * m]
        if len(epoch) == m:
            assert sorted(epoch) == sorted(records)
        else:
            assert len(set(epoch)) == len(epoch) and set(epoch) <= set(
                records)
    # consecutive epochs are shuffled differently
    assert got[:m] != got[m:2 * m]


def test_the_stream_is_a_function_of_the_seed(ds):
    a = port_stream(ds, seed=3, worker_count=0)
    assert_same(port_stream(ds, seed=3, worker_count=0), a)
    b = port_stream(ds, seed=4, worker_count=0)
    assert any(not np.array_equal(x, y) for (x, _), (y, _) in zip(a, b))


def test_epoch_order_is_the_seeded_permutation():
    got = grain_loader.epoch_order(7, 2, 10)
    np.testing.assert_array_equal(
        got, np.random.default_rng((7, 2)).permutation(10))
    assert sorted(got) == list(range(10))
    assert len(grain_loader.epoch_order(2 ** 32 - 1, 0, 4)) == 4


def test_the_worker_count_does_not_change_the_stream(ds, holdout_indices):
    kw = dict(seed=2, indices=holdout_indices, num_epochs=3)
    assert_same(port_stream(ds, worker_count=2, **kw),
                port_stream(ds, worker_count=0, **kw))


@pytest.mark.parametrize("workers,skip", [(0, 2), (2, 2), (0, 6), (2, 6)])
def test_skip_batches_is_the_fresh_streams_tail(ds, workers, skip):
    # 6 batches of 3 are 18 records: the skip itself crosses an epoch.
    fresh = port_stream(ds, seed=0, worker_count=0, num_epochs=3)
    resumed = port_stream(ds, seed=0, worker_count=workers, num_epochs=3,
                          skip_batches=skip)
    assert len(fresh) == 16 and len(resumed) == 16 - skip
    assert_same(resumed, fresh[skip:])


def test_skip_reads_no_skipped_record(ds, monkeypatch):
    read = []
    get = grain_loader._FieldSource.__getitem__
    monkeypatch.setattr(grain_loader._FieldSource, "__getitem__",
                        lambda self, i: read.append(i) or get(self, i))
    it = grain_loader.make_grain_loader(ds, B, seed=0, worker_count=0,
                                        skip_batches=1000)
    next(it)
    it.close()
    assert len(read) == B


@pytest.mark.parametrize("seed", [-1, 2 ** 32])
def test_a_seed_outside_32_bits_raises(ds, seed):
    with pytest.raises(ValueError, match="seed"):
        next(grain_loader.make_grain_loader(ds, B, seed=seed,
                                            worker_count=0))
    with pytest.raises(ValueError, match="seed"):
        grain_loader.epoch_order(seed, 0, 4)


def test_unpinned_batches_without_pin_memory(ds):
    x, y = next(grain_loader.make_grain_loader(ds, B, worker_count=0))
    assert x.device.type == y.device.type == "cpu"
    assert not x.is_pinned() and not y.is_pinned()
    assert x.shape == (B, 32, 32, 2) and y.shape == (B, 3)


def test_pin_memory_without_a_card_raises(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pin_memory needs a CUDA card"):
        next(grain_loader.make_grain_loader(ds, B, worker_count=0,
                                            pin_memory=True))


def _no_children(timeout: float = 10.0) -> list:
    deadline = time.monotonic() + timeout
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    return multiprocessing.active_children()


def test_workers_inherit_no_garbage(ds):
    # An unreachable cycle left at the fork would be freed in a worker by
    # its collector (a CUDA tensor in it aborts the worker): the stream
    # collects in this process before its workers start.
    freed = []

    class Cycle:
        def __del__(self):
            freed.append(os.getpid())

    gc.disable()                 # only an explicit collection frees it
    try:
        cycle = Cycle()
        cycle.me = cycle
        del cycle
        it = grain_loader.make_grain_loader(ds, B, worker_count=2)
        next(it)
        assert freed == [os.getpid()]
        it.close()
    finally:
        gc.enable()
    assert _no_children() == []


@pytest.mark.parametrize("how", ["closed", "exhausted"])
def test_no_worker_outlives_the_stream(ds, how):
    assert not _no_children()
    if how == "closed":
        it = grain_loader.make_grain_loader(ds, B, worker_count=2)
        next(it)
        next(it)
        assert len(multiprocessing.active_children()) == 2
        it.close()
    else:
        assert len(list(grain_loader.make_grain_loader(
            ds, B, worker_count=2, num_epochs=1))) == FRAMES // B
    assert _no_children() == []


# --- the trainer -------------------------------------------------------------

def _kw(data_dir, log_dir, **kw) -> dict:
    base = dict(arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
                data_dir=data_dir, dataset="tiny_smoke", log_dir=log_dir,
                max_step=50, lr_max=2e-3, lr_min=1e-4, log_step=1,
                test_step=10_000, save_step=10_000, compute_dtype="float32",
                num_worker=2, seed=0, input_pipeline="grain")
    base.update(kw)
    return base


def test_trainer_batches_equal_jax_given_grains_order(data_dir, ds,
                                                      holdout_indices,
                                                      tmp_path, monkeypatch):
    # The trainer reads with min(num_worker, 4) = 2 workers; JAX's loader
    # with 0 (grain's order is its worker_count=0 stream).
    c = PortConfig(**_kw(data_dir, str(tmp_path), eval_holdout_scenes=1,
                         seed=9))
    t = Trainer(c, device="cpu")
    np.testing.assert_array_equal(t.bm.train_indices, holdout_indices)
    use_order(monkeypatch, grain_orders(len(holdout_indices), 9), 9)
    want = list(jax_grain_loader(ds, 8, seed=9, worker_count=0,
                                 indices=holdout_indices, num_epochs=3))
    block = t._chunk_blocks(len(want), 0, 1)
    try:
        got = [tuple(rows[0].numpy() for rows in (b["x"], b["y"]))
               for b in map(block, range(len(want)))]
    finally:
        t._stream.close()
    assert_same(got, want)
    assert _no_children() == []


def test_trainer_never_draws_a_holdout_frame(data_dir, ds, tmp_path):
    t = Trainer(PortConfig(**_kw(data_dir, str(tmp_path),
                                 eval_holdout_scenes=1)), device="cpu")
    held = {int(i) for i in t.bm.eval_indices}
    assert len(held) == 4
    ids = frame_ids(ds)
    block = t._chunk_blocks(12, 0, 1)
    try:
        seen = {ids[row.numpy().tobytes()] for k in range(12)
                for row in block(k)["y"][0]}
    finally:
        t._stream.close()
    assert seen == set(range(FRAMES)) - held


def _carry(jax_trainer, port_trainer) -> None:
    flat = weights_io.flatten_params(jax.device_get(jax_trainer.state.params))
    port_trainer.model.load_state_dict(
        flax_to_state_dict(flat, port_trainer.model))


def test_grain_training_matches_jax_given_grains_order(data_dir, tmp_path,
                                                       monkeypatch):
    # 12 train frames at batch 8: the 5 steps cross three epochs.  JAX reads
    # with 0 workers (its stream is then grain's order); the l2 relative
    # loss, held at the bars of test_params_after_10_steps_match_jax.
    kw = dict(eval_holdout_scenes=1, num_worker=0, loss_norm="l2",
              relative_loss=True, seed=4)
    use_order(monkeypatch, grain_orders(12, 4), 4)
    jt = JaxTrainer(Config(**_kw(data_dir, str(tmp_path), **kw)))
    tt = Trainer(PortConfig(**_kw(data_dir, str(tmp_path), num_worker=2,
                                  **{k: v for k, v in kw.items()
                                     if k != "num_worker"})),
                 run_dir=str(tmp_path / "port"), device="cpu")
    _carry(jt, tt)
    want_aux = jt.train(num_steps=5)
    got_aux = tt.train(num_steps=5)
    assert tt.step == int(jt.state.step) == 5
    want = weights_io.flatten_params(jax.device_get(jt.state.params))
    got = state_dict_to_flax(tt.model.state_dict())
    for k in want:
        if k != NULL_PARAM:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)
    for k in ("loss", "loss_field", "loss_jac"):
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=1e-3)
    assert tt._stream is None and _no_children() == []


@pytest.mark.parametrize("arch", ["de", "ae"])
def test_main_trains_on_the_grain_stream(data_dir, tmp_path, arch):
    argv = ["--is_train", "True", "--arch", arch, "--input_pipeline",
            "grain", "--data_dir", data_dir, "--dataset", "tiny_smoke",
            "--log_dir", str(tmp_path), "--tag", arch, "--filters", "8",
            "--num_conv", "1", "--z_num", "8", "--batch_size", "4",
            "--log_step", "2", "--save_step", "3", "--test_step", "3",
            "--compute_dtype", "float32"]
    result = torch_main(get_config(argv + ["--max_step", "6",
                                           "--num_worker", "2"]),
                        device="cpu")
    assert np.isfinite(result["loss"])
    run = os.path.join(str(tmp_path), f"tiny_smoke_{arch}")
    # resumed at the saved step 6 to 9 by the decode-free skip, under
    # another worker count
    torch_main(get_config(argv + ["--max_step", "9", "--load_path", run,
                                  "--num_worker", "0"]), device="cpu")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["step"] for r in rows] == [2, 4, 6, 8, 9]
    assert np.isfinite([r["loss"] for r in rows]).all()
    assert _no_children() == []
