"""Compute the golden fields through the port.

Counterpart of the JAX package's ``tools/make_goldens.py``: the same four
dumps (``fd2d``, ``fd3d``, ``smoke2d``, ``generator2d``) from the same
numpy-seeded inputs, computed by the port (the FD kernels on a card, their
plain versions on the CPU) and written into ``--out <dir>``.  It never
writes into ``tests/golden/``: those files are the JAX reference's.

    python -m deepfluids_tpu_torch.tools.make_goldens --out <dir> [--check]
        [--golden tests/golden] [--device cpu]

``--check`` compares what it computed with the reference's dumps under
``--golden`` at the [B] normalized-L2 < 1e-3 parity gate and exits non-zero
on a failure.  The generator's weights come from
``<golden>/generator2d_params.npz`` through the weight converter when that
file exists (a torch init cannot reproduce the reference's PRNG key);
otherwise from the port's Flax-style init with seed 7, written beside the
dump as ``generator2d_params.npz`` so the dump can be recomputed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from deepfluids_tpu_torch.tools import _record

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
TOL_PARITY = 1e-3
SEED = 20260816


def compute(device, golden_dir: str = GOLDEN_DIR) -> dict[str, dict]:
    """The four dumps as ``{name: {key: array}}``, computed on ``device``
    in full f32 (TF32 off)."""
    from deepfluids_tpu_torch.datagen.smoke2d import (
        Smoke2DConfig,
        simulate_smoke2d,
    )
    from deepfluids_tpu_torch.models import (
        GeneratorBE,
        flax_init_,
        load_flax_npz,
        state_dict_to_flax,
    )
    from deepfluids_tpu_torch.ops import cuda_fd

    device = torch.device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    dumps: dict[str, dict] = {}

    def on(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device)

    def back(t: torch.Tensor) -> np.ndarray:
        return t.float().cpu().numpy()

    with torch.inference_mode():
        # 1) FD operators on a fixed random field.
        psi = rng.standard_normal((2, 32, 24, 1)).astype(np.float32)
        u = cuda_fd.curl2d_fused(on(psi))
        j, w = cuda_fd.jacobian2d_fused(u)
        dumps["fd2d"] = dict(psi=psi, u=back(u), j=back(j), w=back(w))

        psi3 = rng.standard_normal((1, 8, 12, 16, 3)).astype(np.float32)
        u3 = cuda_fd.curl3d_fused(on(psi3))
        j3, w3 = cuda_fd.jacobian3d_fused(u3)
        dumps["fd3d"] = dict(psi=psi3, u=back(u3), j=back(j3), w=back(w3))

        # 2) Datagen solver: 6 frames of the 2D smoke scene at fixed params.
        cfg = Smoke2DConfig(height=32, width=24, num_frames=6,
                            project_iters=20)
        vt, rt = simulate_smoke2d(0.5, 0.1, cfg, device=device)
        dumps["smoke2d"] = dict(v=back(vt), r=back(rt))

        # 3) Generator forward with fixed weights.
        p = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
        model = GeneratorBE((32, 24, 1), num_param=3, filters=8, num_conv=2)
        weights = os.path.join(golden_dir, "generator2d_params.npz")
        if os.path.exists(weights):
            load_flax_npz(weights, model)
        else:
            flax_init_(model, 7)
            dumps["generator2d_params"] = state_dict_to_flax(
                model.state_dict())
        model.to(device)
        out = cuda_fd.curl2d_fused(model(on(p)).float())
        dumps["generator2d"] = dict(p=p, u=back(out))
    return dumps


def check(dumps: dict[str, dict], golden_dir: str = GOLDEN_DIR) -> dict:
    """Each computed field against the reference's dump: ``{"name/key":
    max [B] normalized L2}``; raises where one is not under the gate or an
    input differs."""
    from deepfluids_tpu_torch.utils.parity import check_fields

    inputs = {"fd2d": ("psi",), "fd3d": ("psi",), "generator2d": ("p",)}
    worst, failed = {}, []
    for name in ("fd2d", "fd3d", "smoke2d", "generator2d"):
        with np.load(os.path.join(golden_dir, f"{name}.npz")) as g:
            for key in g.files:
                ours, ref = dumps[name][key], g[key]
                if key in inputs.get(name, ()):
                    if not np.array_equal(ours, ref):
                        failed.append(f"{name}/{key}: the seeded input "
                                      "differs from the reference's")
                    continue
                if name == "smoke2d":
                    # frames are the batch axis of the gate; the density
                    # gets a channel axis
                    ours = ours if key == "v" else ours[..., None]
                    ref = ref if key == "v" else ref[..., None]
                res = check_fields(ours, ref, TOL_PARITY)
                worst[f"{name}/{key}"] = float(res["max_l2"])
                if not res["passed"]:
                    failed.append(f"{name}/{key}: L2 {res['max_l2']:.3e} "
                                  f">= {TOL_PARITY}")
    if failed:
        raise AssertionError("goldens: " + "; ".join(failed))
    return worst


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Compute the golden dumps through the port")
    ap.add_argument("--out", required=True,
                    help="directory the dumps are written into (never "
                         "tests/golden)")
    ap.add_argument("--golden", default=GOLDEN_DIR,
                    help="the reference's dumps (--check, and the "
                         "generator's weights)")
    ap.add_argument("--check", action="store_true",
                    help="compare with the reference's dumps at the 1e-3 "
                         "parity gate")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    a = ap.parse_args(argv)
    device = _record.resolve_device(a.device)
    out = os.path.abspath(a.out)
    if os.path.realpath(out) in (os.path.realpath(a.golden),
                                 os.path.realpath(GOLDEN_DIR)):
        sys.exit(f"make_goldens: --out {a.out} is the reference's golden "
                 "directory; the port does not write there")
    dumps = compute(device, a.golden)
    os.makedirs(out, exist_ok=True)
    for name, arrays in dumps.items():
        np.savez_compressed(os.path.join(out, f"{name}.npz"), **arrays)
    print(f"goldens written to {out}")
    result = {"out": out}
    if a.check:
        result["max_l2"] = check(dumps, a.golden)
        print(f"goldens check: ok  max [B] normalized L2 "
              f"{ {k: f'{v:.2e}' for k, v in result['max_l2'].items()} } "
              f"(gate {TOL_PARITY}) against {a.golden} on {device}")
    return result


if __name__ == "__main__":
    main()
