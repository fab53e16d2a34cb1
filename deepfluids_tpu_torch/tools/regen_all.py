"""Regenerate + verify the full dataset fleet in ONE command.

Counterpart of the JAX package's ``tools/regen_all.py``: the entry point
for all four scene datasets, through the port's datagen.

    python -m deepfluids_tpu_torch.tools.regen_all         # full fleet
    python -m deepfluids_tpu_torch.tools.regen_all --only smoke3_vel5_buo3_m
    python -m deepfluids_tpu_torch.tools.regen_all --verify_only

Each dataset is generated in its OWN subprocess (``python -m
deepfluids_tpu_torch.datagen``, ``--device`` passed through), then verified
structurally (manifest fields, per-key frame-file counts, sampled frame
shapes/finiteness/range-vs-manifest) and recorded (metric=datagen_fleet)
with wall time and a content statistic, so "the fleet exists and is
intact" is a checkable, repeatable fact rather than a disk accident.

Fleet (smoke scenes use projection=matched; liquid is FLIP, no pressure
projection choice), 3D first: it gates the longest downstream training.

    name                  scenes x frames
    smoke3_vel5_buo3_m        15 x 250
    smoke_pos21_size5_m      105 x 200
    liquid_pos10_size4        40 x 200
    smoke_mov200_f400_m      200 x 400

``--num-frames`` / ``--num-a`` / ``--num-b`` cut every selected dataset to
a smaller grid (a rehearsal, a test); the cut is printed and recorded, and
``--verify_only`` must be given the same cut.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import subprocess
import sys
import time

import numpy as np

from deepfluids_tpu_torch.data import load_manifest
from deepfluids_tpu_torch.tools import _record

# The directory that holds the package: the datagen child's working
# directory and the anchor of the default data/ and logs/.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str                   # on-disk dataset dir name
    scene: str                  # datagen --scene
    num_a: int                  # first param count (scenes for smoke_mov)
    num_b: int | None           # second param count (None for smoke_mov)
    num_frames: int
    field_keys: tuple[str, ...]  # subdirs holding one .npz per frame
    resolution: tuple[int, ...]
    num_channels: int
    data_type: str
    projection: str | None      # matched | jacobi | None (liquid)

    @property
    def num_scenes(self) -> int:
        return self.num_a * (self.num_b or 1)


FLEET = (
    DatasetSpec("smoke3_vel5_buo3_m", "smoke3_vel5_buo3", 5, 3, 250,
                ("v", "d"), (32, 64, 112), 3, "velocity", "matched"),
    DatasetSpec("smoke_pos21_size5_m", "smoke_pos21_size5", 21, 5, 200,
                ("v", "d"), (128, 96), 2, "velocity", "matched"),
    DatasetSpec("liquid_pos10_size4", "liquid_pos10_size4", 10, 4, 200,
                ("l", "v"), (128, 96), 1, "levelset", None),
    DatasetSpec("smoke_mov200_f400_m", "smoke_mov", 200, None, 400,
                ("v", "d"), (128, 96), 2, "velocity", "matched"),
)


def cut_spec(spec: DatasetSpec, num_frames: int | None = None,
             num_a: int | None = None,
             num_b: int | None = None) -> tuple[DatasetSpec, dict]:
    """``spec`` at a smaller grid, and the cut as ``{field: [full, cut]}``
    (empty when nothing was cut).  ``num_b`` does not apply to a dataset
    without a second parameter."""
    want = {"num_frames": num_frames, "num_a": num_a,
            "num_b": num_b if spec.num_b is not None else None}
    want = {k: v for k, v in want.items()
            if v is not None and v != getattr(spec, k)}
    cut = {k: [getattr(spec, k), v] for k, v in want.items()}
    return dataclasses.replace(spec, **want), cut


def generate(spec: DatasetSpec, data_dir: str, log_dir: str,
             device: str | None = None) -> float:
    """Run one dataset's generation in a subprocess; return wall seconds."""
    cmd = [sys.executable, "-m", "deepfluids_tpu_torch.datagen",
           "--scene", spec.scene, "--out", os.path.abspath(data_dir),
           "--name", spec.name, "--num-frames", str(spec.num_frames),
           "--num-a", str(spec.num_a)]
    if spec.num_b is not None:
        cmd += ["--num-b", str(spec.num_b)]
    if spec.projection is not None:
        cmd += ["--projection", spec.projection]
    if device is not None:
        cmd += ["--device", str(device)]
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, f"datagen_{spec.name}.log")
    print(f"[regen_all] {spec.name}: {' '.join(cmd)}  (log: {log_path})",
          flush=True)
    t0 = time.time()
    with open(log_path, "w") as log:
        subprocess.run(cmd, cwd=ROOT, stdout=log, stderr=log, check=True)
    return time.time() - t0


def verify(spec: DatasetSpec, data_dir: str,
           sample_frames: int = 8) -> dict:
    """Structural + content verification; raises on any mismatch.

    Checks: manifest fields match the spec, every field key has exactly
    num_scenes*num_frames files, a deterministic sample of frames parses
    with the manifest shape, is finite, and respects v_range.  Returns the
    stats dict the record holds.
    """
    ds_dir = os.path.join(data_dir, spec.name)
    m = load_manifest(ds_dir)
    if (m.num_scenes, m.num_frames) != (spec.num_scenes, spec.num_frames):
        raise ValueError(
            f"{spec.name}: manifest scenes/frames "
            f"{(m.num_scenes, m.num_frames)} != spec "
            f"{(spec.num_scenes, spec.num_frames)}")
    if tuple(m.resolution) != spec.resolution:
        raise ValueError(f"{spec.name}: resolution {m.resolution} != "
                         f"{spec.resolution}")
    if (m.num_channels, m.data_type) != (spec.num_channels, spec.data_type):
        raise ValueError(f"{spec.name}: channels/type mismatch")

    counts, files = {}, None
    expected = spec.num_scenes * spec.num_frames
    for key in spec.field_keys:
        fs = sorted(glob.glob(os.path.join(ds_dir, key, "*.npz")))
        counts[key] = len(fs)
        if len(fs) != expected:
            raise ValueError(f"{spec.name}/{key}: {len(fs)} files, "
                             f"expected {expected}")
        if files is None:
            files = fs
    # Deterministic spread over the primary key's files.
    idx = np.linspace(0, len(files) - 1, sample_frames).astype(int)
    abs_means, abs_max = [], 0.0
    for i in idx:
        with np.load(files[i]) as z:
            x, y = z["x"], z["y"]
        if x.shape != m.field_shape:
            raise ValueError(f"{files[i]}: field shape {x.shape} != "
                             f"manifest {m.field_shape}")
        if y.shape != (m.num_param,):
            raise ValueError(f"{files[i]}: param shape {y.shape}")
        if not np.isfinite(x).all():
            raise ValueError(f"{files[i]}: non-finite values")
        abs_means.append(float(np.abs(x).mean()))
        abs_max = max(abs_max, float(np.abs(x).max()))
    if abs_max > m.v_scale * (1 + 1e-5):
        raise ValueError(f"{spec.name}: sampled |x| max {abs_max} exceeds "
                         f"manifest v_scale {m.v_scale}")
    return {"files": counts, "sample_mean_abs": float(np.mean(abs_means)),
            "sample_max_abs": abs_max, "v_range": list(m.v_range)}


def record(row: dict, device, out: str | None = _record.DEFAULT_OUT) -> dict:
    return _record.write(row, device, out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Regenerate + verify the dataset fleet")
    ap.add_argument("--only", action="append", default=None,
                    choices=[s.name for s in FLEET],
                    help="regenerate only these datasets (repeatable)")
    ap.add_argument("--data_dir", default=os.path.join(ROOT, "data"))
    ap.add_argument("--log_dir", default=os.path.join(ROOT, "logs"))
    ap.add_argument("--verify_only", action="store_true",
                    help="verify what's on disk; generate nothing")
    ap.add_argument("--skip_existing", action="store_true",
                    help="skip generation when the dataset already "
                         "verifies clean (resume a partial fleet regen)")
    ap.add_argument("--num-frames", type=int, default=None,
                    help="cut: frames a scene")
    ap.add_argument("--num-a", type=int, default=None,
                    help="cut: first param count (scenes for smoke_mov)")
    ap.add_argument("--num-b", type=int, default=None,
                    help="cut: second param count")
    _record.add_arguments(ap)
    args = ap.parse_args(argv)
    device = _record.resolve_device(args.device)

    todo = [s for s in FLEET if args.only is None or s.name in args.only]
    failures = []
    for full in todo:
        spec, cut = cut_spec(full, args.num_frames, args.num_a, args.num_b)
        if cut:
            print(f"[regen_all] {spec.name}: CUT (full -> this run) {cut}",
                  flush=True)
        try:
            wall = None
            if not args.verify_only:
                if args.skip_existing:
                    try:
                        verify(spec, args.data_dir)
                        print(f"[regen_all] {spec.name}: already verified "
                              "clean, skipping", flush=True)
                        continue
                    except Exception:  # noqa: BLE001 - any fault: regenerate
                        pass
                wall = generate(spec, args.data_dir, args.log_dir,
                                device=args.device)
            stats = verify(spec, args.data_dir)
            row = {"metric": "datagen_fleet", "dataset": spec.name,
                   "scenes": spec.num_scenes, "frames": spec.num_frames,
                   "projection": spec.projection, "ok": True, **stats}
            if cut:
                row["cut"] = cut
            if wall is not None:
                row["wall_s"] = round(wall, 1)
            record(row, device, args.out)
            print(f"[regen_all] {spec.name}: OK {stats['files']} "
                  f"wall={wall and round(wall)}s", flush=True)
        except Exception as e:  # noqa: BLE001 - reported, then exit non-zero
            failures.append((spec.name, str(e)))
            print(f"[regen_all] {spec.name}: FAILED - {e}", flush=True)
    if failures:
        sys.exit(f"regen_all: {len(failures)} dataset(s) failed: {failures}")
    print("[regen_all] fleet complete", flush=True)


if __name__ == "__main__":
    main()
