"""The program's native stream draws the rows the training driver checks
against the reference (``synth.batch_rows``), so a training cell that
streams its batches (the users' default flags: no device cache) compares
the same steps as a cached one."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, port, references, synth

from conftest import TINY

STREAM_FLAGS = {"device_data_cache": False, "steps_per_call": 1}


def test_the_stream_draws_the_rows_the_driver_checks(tmp_path):
    cfg = {**harness.data_file(harness.DATA, "configs", "smoke_pos21_size5"),
           **TINY, "compute_dtype": "float32"}
    fields, raw = synth.blob_fields(cfg, 2**31 + 17, "cpu")
    host, params = fields.numpy(), raw.numpy()
    rows_of = synth.staged_rows(cfg)
    data = port.write_dataset(str(tmp_path / "data"), cfg, host, params,
                              rows_of, cfg["num_frames"])
    seed = synth.distinct_rows_seed(2**31 + 17, rows_of,
                                    cfg["batch_size"], 3)
    weights = synth.weights(
        references.load(cfg["reference"]).param_shapes(cfg), 1, "cpu")
    t = port.trainer(cfg, STREAM_FLAGS, data, str(tmp_path / "run"), seed,
                     "cpu", weights, is_train=True)
    assert t.c.input_pipeline == "native"
    scale = port.v_range(host, cfg)[1]
    for step, (x, y) in enumerate(t._host_batches(3, 0), start=1):
        rows = rows_of[synth.batch_rows(seed, step, len(rows_of),
                                        cfg["batch_size"])]
        np.testing.assert_allclose(x, host[rows] / scale, rtol=1e-6)
        want = synth.normalize(torch.from_numpy(params[rows]), cfg)
        np.testing.assert_allclose(y, want.numpy(), rtol=1e-5, atol=1e-6)
    t.bm.close()
