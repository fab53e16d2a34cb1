"""Why does one latent integrator reach its AE floor and another not?

Counterpart of the JAX package's ``tools/latent_predictability.py`` (pure
numpy).  Mechanism probe for config #4's rollout gap: fit the SIMPLEST
possible integrator, one ridge-regularized linear map
[z_t, p_t, p_{t+1}] -> dz_t, on the TRAINING scenes' code sequences and
score R^2 per latent dim on the HELD-OUT scenes.  If a dataset's holdout
dynamics are much less linearly predictable from its training scenes
(mov's novel random trajectories vs a grid family's shared dynamics),
the integrator-above-AE-floor gap is a DATA novelty property, not an
integrator-capacity one, and no amount of integrator training on the
same codes will close it.

Two controls separate the remaining hypotheses for WHY dz is
unpredictable from [z, p, p+1]:

- ``--history H``: feed H latent steps [z_t, z_{t-1}, ..] (plus the
  matching param window).  If history recovers R^2, the dynamics are
  NON-MARKOVIAN in z: the reconstruction-trained AE discards state the
  dynamics need, and joint AE+dynamics training is the fix.
- ``--rff D``: append D fixed random ReLU features of the base row (a
  one-layer random network, the cheapest nonlinear-capacity control).
  If nonlinearity recovers R^2, a bigger/better-trained MLP integrator
  would too.

Usage: python -m deepfluids_tpu_torch.tools.latent_predictability
           <dataset_dir> <z_num> [holdout_scenes] [suffix] [note]
           [--history H] [--rff D] [--device cpu] [--out file.jsonl]

Reads the ``code<z_num><suffix>/`` files the port's encode pass wrote.  The
fit is numpy on the host: ``--device`` only says where the record was taken
(default the card, raising without one, as every tool of the port).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from deepfluids_tpu_torch.tools import _record


def design(z, p, history=1):
    """Rows [z_t, .., z_{t-H+1}, p_{t-H+1..t}, p_{t+1}], targets dz_t.

    history=1 reproduces the original [z_t, p_t, p_{t+1}] probe exactly.
    """
    h = history
    T = len(z)
    rows = [z[h - 1 - k:T - 1 - k] for k in range(h)]          # z lags
    rows += [p[h - 1 - k:T - 1 - k] for k in range(h)]         # p lags
    rows.append(p[h:])                                         # p_{t+1}
    x = np.concatenate(rows, axis=1)
    y = z[h:] - z[h - 1:-1]
    return x, y


class Ridge:
    """Standardized ridge with intercept (train stats; the supervised
    latent dims duplicate the param columns, so plain normal equations
    are ill-conditioned without standardization + a real bias term)."""

    def fit(self, x, y, lam=1e-3):
        self.mu = x.mean(0)
        self.sd = x.std(0) + 1e-8
        xs = (x - self.mu) / self.sd
        xs = np.concatenate([xs, np.ones((len(xs), 1), xs.dtype)], 1)
        xtx = xs.T @ xs + lam * len(xs) * np.eye(xs.shape[1], dtype=x.dtype)
        self.w = np.linalg.solve(xtx, xs.T @ y)
        return self

    def predict(self, x):
        xs = (x - self.mu) / self.sd
        xs = np.concatenate([xs, np.ones((len(xs), 1), xs.dtype)], 1)
        return xs @ self.w


class RFF:
    """Fixed random ReLU feature lift: x -> [x, relu(x_std @ W)].

    Standardization uses TRAIN stats (set by fit_stats); W is drawn once
    from a fixed seed so train/holdout see the same lift.
    """

    def __init__(self, dim, width, seed=0):
        rng = np.random.default_rng(seed)
        self.w = rng.normal(0, 1.0 / np.sqrt(dim), (dim, width))

    def fit_stats(self, x):
        self.mu = x.mean(0)
        self.sd = x.std(0) + 1e-8
        return self

    def lift(self, x):
        xs = (x - self.mu) / self.sd
        return np.concatenate([x, np.maximum(xs @ self.w, 0.0)], axis=1)


def r2(y, pred):
    ss_res = np.sum((y - pred) ** 2, axis=0)
    ss_tot = np.sum((y - y.mean(0)) ** 2, axis=0) + 1e-12
    return 1.0 - ss_res / ss_tot


def probe(dataset_dir: str, z_num: int, holdout_scenes: int = 5,
          suffix: str = "", note: str = "", history: int = 1,
          rff: int = 0) -> dict:
    """The ``latent_predictability`` record of one code set."""
    from deepfluids_tpu_torch.data import CodeDataset

    dataset_dir = dataset_dir.rstrip("/")
    cd = CodeDataset(dataset_dir, z_num, holdout_scenes=holdout_scenes,
                     suffix=suffix)
    tr = [design(cd.z[i], cd.p[i], history) for i in cd.train_scene_indices]
    ho = [design(cd.z[i], cd.p[i], history) for i in cd.eval_scene_indices]
    xt = np.concatenate([x for x, _ in tr])
    yt = np.concatenate([y for _, y in tr])
    xh = np.concatenate([x for x, _ in ho])
    yh = np.concatenate([y for _, y in ho])
    if rff > 0:
        lift = RFF(xt.shape[1], rff).fit_stats(xt)
        ho = [(lift.lift(x), y) for x, y in ho]
        xt, xh = lift.lift(xt), lift.lift(xh)
    m = Ridge().fit(xt, yt)
    r2_train = r2(yt, m.predict(xt))
    r2_hold = r2(yh, m.predict(xh))
    # Per-scene spread on the holdout (novelty varies by scene).
    per_scene = [float(np.median(r2(y, m.predict(x)))) for x, y in ho]
    return {
        "metric": "latent_predictability",
        "dataset": os.path.basename(dataset_dir),
        "code_set": f"code{z_num}{suffix}",
        "holdout_scenes": holdout_scenes,
        "history": history,
        "rff": rff,
        "r2_train_median": round(float(np.median(r2_train)), 4),
        "r2_holdout_median": round(float(np.median(r2_hold)), 4),
        "r2_holdout_per_scene": [round(v, 4) for v in per_scene],
        "note": note,
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Latent-dynamics predictability probe")
    ap.add_argument("dataset_dir")
    ap.add_argument("z_num", type=int)
    ap.add_argument("holdout_scenes", nargs="?", type=int, default=5)
    ap.add_argument("suffix", nargs="?", default="")
    ap.add_argument("note", nargs="?", default="")
    ap.add_argument("--history", type=int, default=1,
                    help="latent/param lag steps in the design row")
    ap.add_argument("--rff", type=int, default=0,
                    help=">0: append this many fixed random ReLU features")
    _record.add_arguments(ap)
    a = ap.parse_args(argv)
    device = _record.resolve_device(a.device)
    rec = probe(a.dataset_dir, a.z_num, a.holdout_scenes, a.suffix, a.note,
                a.history, a.rff)
    return _record.write(rec, device, a.out)


if __name__ == "__main__":
    main()
