"""CLI: generate a dataset.  Replaces ``manta scene/<name>.py``.

Example:
    python -m deepfluids_tpu_torch.datagen --scene smoke_pos21_size5 \
        --out data --num-a 21 --num-b 5 --num-frames 200

Runs on the current CUDA device and raises when there is none, unless
``--device cpu`` is given.
"""

import argparse
import inspect

from deepfluids_tpu_torch.datagen.scenes import SCENES


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line) and write the scene;
    ``--device`` overrides ``device`` (None: the card)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", choices=sorted(SCENES), required=True)
    ap.add_argument("--out", default="data")
    ap.add_argument("--num-a", type=int, default=None,
                    help="first param count (positions / scenes / velocities)")
    ap.add_argument("--num-b", type=int, default=None,
                    help="second param count (sizes / buoyancies)")
    ap.add_argument("--num-frames", type=int, default=None)
    ap.add_argument("--name", default=None, help="override dataset dir name")
    ap.add_argument("--projection", choices=("jacobi", "matched"),
                    default=None,
                    help="pressure projection: 'jacobi' reproduces the "
                         "legacy datasets; 'matched' generates frames on "
                         "the generator's curl manifold")
    ap.add_argument("--device", default=None,
                    help="torch device to simulate on (default: the CUDA "
                         "card; 'cpu' for the plain PyTorch path)")
    args = ap.parse_args(argv)

    kwargs = {}
    if args.projection is not None:
        # Guard keyed on the scene function's own signature (not a scene
        # name list) so it stays correct as scenes are added: any scene
        # without a projection choice rejects cleanly at parse time.
        # (**kwargs-style scene fns pass: they accept any keyword.)
        params = inspect.signature(SCENES[args.scene]).parameters
        accepts = "projection" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in params.values())
        if not accepts:
            ap.error(f"--projection is not supported by scene "
                     f"{args.scene!r} (e.g. the liquid solver is FLIP "
                     "with a free-surface solve)")
        kwargs["projection"] = args.projection
    if args.num_frames is not None:
        kwargs["num_frames"] = args.num_frames
    if args.name:
        kwargs["name"] = args.name
    if args.device is not None or device is not None:
        kwargs["device"] = args.device or device
    fn = SCENES[args.scene]
    if args.scene == "smoke_mov":
        if args.num_a is not None:
            kwargs["num_scenes"] = args.num_a
    else:
        if args.num_a is not None:
            kwargs[{"smoke_pos21_size5": "num_pos",
                    "liquid_pos10_size4": "num_pos",
                    "smoke3_vel5_buo3": "num_vel"}[args.scene]] = args.num_a
        if args.num_b is not None:
            kwargs[{"smoke_pos21_size5": "num_size",
                    "liquid_pos10_size4": "num_size",
                    "smoke3_vel5_buo3": "num_buo"}[args.scene]] = args.num_b
    out = fn(args.out, **kwargs)
    print(f"dataset written to {out}")


if __name__ == "__main__":
    main()
