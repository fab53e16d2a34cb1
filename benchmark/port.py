"""The benchmark's calls into the measured program, ``deepfluids_tpu_torch``,
through its public entry points only: the dataset directory it reads
(``args.txt`` and ``v/*.npz``), ``Config``, ``Trainer`` and
``infer.sweep.sweep_on_device``.  Everything else the benchmark makes or
works out itself.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np


def write_dataset(root: str, cfg: dict, fields: np.ndarray,
                  params: np.ndarray, rows_of: np.ndarray,
                  frames: int) -> str:
    """Write a dataset the program reads: ``<root>/<name>/args.txt`` and
    one uncompressed ``v/<scene>_<frame>.npz`` (keys ``x``, the raw field,
    and ``y``, its raw parameters) a row, scene by scene, so that file
    order is row order.  Row ``k`` holds field ``rows_of[k]`` of
    ``fields``/``params``: the first row of a field is written, the others
    are hard links to it.  The manifest's ``v_range`` is the fields' own
    (``cfg["v_range"]`` for a set that only names the space).  Returns the
    data directory (``root``)."""
    ds = os.path.join(root, cfg["name"])
    os.makedirs(os.path.join(ds, "v"))
    written: dict[int, str] = {}
    for k, j in enumerate(rows_of.tolist()):
        scene, frame = divmod(k, frames)
        path = os.path.join(ds, "v", f"{scene:04d}_{frame:04d}.npz")
        if j in written:
            os.link(written[j], path)
        else:
            np.savez(path, x=fields[j], y=params[j])
            written[j] = path
    manifest = {
        "param_names": cfg["param_names"],
        "param_ranges": cfg["param_ranges"],
        "num_scenes": math.prod(cfg["param_counts"]),
        "num_frames": frames,
        "resolution": cfg["resolution"],
        "num_channels": cfg["num_channels"],
        "v_range": v_range(fields, cfg),
        "data_type": "velocity",
        "param_counts": cfg["param_counts"],
    }
    with open(os.path.join(ds, "args.txt"), "w") as f:
        json.dump(manifest, f)
    return root


def v_range(fields: np.ndarray, cfg: dict) -> list[float]:
    """The normalization range a dataset states: its fields' largest
    magnitude both ways, or the configuration's for a set of one field."""
    if fields.shape[0] == 1:
        return list(cfg["v_range"])
    top = float(np.abs(fields).max())
    return [-top, top]


def trainer(cfg: dict, flags: dict, data_dir: str, run_dir: str, seed: int,
            device, weights: dict, is_train: bool):
    """The program's ``Trainer`` of configuration ``cfg`` (plus the
    traffic's ``flags``) on ``device``, its parameters set to
    ``weights``."""
    from deepfluids_tpu_torch.config import Config
    from deepfluids_tpu_torch.train.trainer import Trainer

    keys = ("arch", "filters", "num_conv", "repeat", "batch_size", "lr_max",
            "lr_min", "max_step", "beta1", "beta2", "w1", "w2", "loss_norm",
            "use_curl", "compute_dtype")
    c = Config(**{k: cfg[k] for k in keys}, **flags, data_dir=data_dir,
               dataset=cfg["name"], seed=seed, is_train=is_train,
               log_dir=run_dir)
    t = Trainer(c, run_dir=run_dir, device=device)
    t.model.load_state_dict(weights)
    return t
