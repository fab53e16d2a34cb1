"""Framework-agnostic weight interchange (.npz <-> Flax-layout param tree).

Counterpart of the JAX package's ``tools/weights_io.py``, on the same flat
file:

    { "<slash/joined/param/path>": array, ... }

with conv kernels HWIO / DHWIO and dense kernels (in, out): the Flax layout
that :mod:`deepfluids_tpu_torch.models.weights` converts to and from this
port's ``state_dict``.  A file written here is read by the JAX package's
``weights_io.import_npz`` and the other way round.  Two matching modes:

  * exact    - npz keys equal the template's flattened paths;
  * by_shape - keys are matched to the template's parameters in declaration
               order among same-shape tensors (enough for a 1:1
               architecture like GeneratorBE, where every conv has a distinct
               stage shape or a stable ordering); ambiguities are reported.

``export_run`` writes a run's newest checkpoint in this form;
``import_into_model`` loads a file into a model of the port.

Usage: python -m deepfluids_tpu_torch.tools.weights_io <run_dir> [out.npz]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from typing import Any

import numpy as np

from deepfluids_tpu_torch.tools import _record


def flatten_params(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Param tree -> {'a/b/kernel': array} (declaration order)."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_params(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def export_npz(params: Any, path: str) -> str:
    np.savez_compressed(path, **flatten_params(params))
    return path


def import_npz(path: str, params_template: Any,
               mode: str = "exact") -> dict:
    """Load weights from a flat .npz into the template's tree structure.

    Args:
      params_template: the model's params (shapes + paths), a tree or the
        flat dict :func:`model_template` gives.
      mode: "exact" (keys match) or "by_shape" (order-within-shape match).
    Returns the populated tree; raises on unmatched/leftover tensors.
    """
    ours = flatten_params(params_template)
    with np.load(path) as d:
        theirs = {k: d[k] for k in d.files}

    if mode == "exact":
        missing = sorted(set(ours) - set(theirs))
        if missing:
            raise KeyError(f"npz missing {len(missing)} params, e.g. "
                           f"{missing[:3]}")
        extra = sorted(set(theirs) - set(ours))
        if extra:
            # A typo'd/stale tensor name in the export would otherwise be
            # dropped silently (mirrors by_shape's leftover check).
            raise KeyError(f"npz has {len(extra)} keys with no matching "
                           f"param, e.g. {extra[:3]}")
        bad = [(k, theirs[k].shape, ours[k].shape) for k in ours
               if tuple(theirs[k].shape) != tuple(ours[k].shape)]
        if bad:
            k, got, want = bad[0]
            raise ValueError(
                f"{len(bad)} shape mismatches, e.g. {k}: npz has {got}, "
                f"model wants {want} (a transposed dense kernel would "
                f"import silently without this check)")
        flat = {k: theirs[k].astype(ours[k].dtype) for k in ours}
        return unflatten_params(flat)

    if mode != "by_shape":
        raise ValueError(f"unknown mode {mode!r}")
    # Group both sides by shape; match in insertion order within groups.
    by_shape: dict[tuple, list[str]] = defaultdict(list)
    for k, v in theirs.items():
        by_shape[tuple(v.shape)].append(k)
    # Report ambiguity up front: same-shape groups with >1 member are
    # matched by insertion order, which is only correct if both sides
    # enumerate in the same order; the caller must confirm.
    ambiguous = {shp: ks for shp, ks in by_shape.items() if len(ks) > 1}
    if ambiguous:
        ex_shp = next(iter(ambiguous))
        print(f"weights_io: by_shape matching {len(ambiguous)} ambiguous "
              f"shape groups by insertion order (e.g. {ex_shp}: "
              f"{len(ambiguous[ex_shp])} tensors {ambiguous[ex_shp][:3]}...) "
              f"- verify source enumeration order matches the model's",
              file=sys.stderr)
    flat = {}
    for k, v in ours.items():
        pool = by_shape.get(tuple(v.shape))
        if not pool:
            raise KeyError(f"no tensor of shape {v.shape} left for {k}")
        src = pool.pop(0)
        flat[k] = theirs[src].astype(v.dtype)
    leftover = [k for pool in by_shape.values() for k in pool]
    if leftover:
        raise KeyError(f"{len(leftover)} unmatched source tensors, e.g. "
                       f"{leftover[:3]}")
    return unflatten_params(flat)


# --- the port's models ------------------------------------------------------

def model_template(model) -> dict[str, np.ndarray]:
    """``model``'s weights as the flat Flax-layout dict (module order): the
    template :func:`import_npz` takes and what :func:`export_npz` writes."""
    from deepfluids_tpu_torch.models import state_dict_to_flax

    return state_dict_to_flax(model.state_dict())


def import_into_model(path: str, model, mode: str = "exact"):
    """Load a flat .npz into ``model`` (a module of the port) in place."""
    from deepfluids_tpu_torch.models import flax_to_state_dict

    tree = import_npz(path, model_template(model), mode=mode)
    model.load_state_dict(flax_to_state_dict(flatten_params(tree), model))
    return model


def export_run(run_dir: str, path: str | None = None,
               device=None) -> str:
    """Export the newest checkpoint of a run the port trained
    (``<run>/checkpoint/<step>/state.pt``) to ``path`` (default
    ``<run>/weights_export.npz``); the file's path."""
    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.train.trainer import Trainer

    device = _record.resolve_device(device)
    t = Trainer(load_config(run_dir), run_dir=run_dir, device=device,
                save_cfg=False)
    t.restore_checkpoint()
    path = path or os.path.join(run_dir, "weights_export.npz")
    return export_npz(model_template(t.model), path)


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(
        description="Export a run's newest checkpoint as a flat .npz")
    ap.add_argument("run_dir")
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    a = ap.parse_args(argv)
    path = export_run(a.run_dir, a.path, device=a.device)
    print(f"weights written to {path}")
    return path


if __name__ == "__main__":
    main()
