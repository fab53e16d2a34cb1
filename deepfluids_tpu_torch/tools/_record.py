"""Where a tool's record goes.

Every tool of the port appends its result as one JSON line to ``--out``
(default ``BENCHMARKS_torch.jsonl`` in the current directory) and prints the
same line.  The record says where it was taken: ``backend`` (``cuda`` or
``cpu``), ``device`` (the card's name as nvidia-smi gives it, else ``cpu``),
``power_limit_w`` (the card's power limit, null on the CPU: a card set below
its maximum runs slower under load) and ``ts``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from deepfluids_tpu_torch.datagen.grids import resolve_device

DEFAULT_OUT = "BENCHMARKS_torch.jsonl"

__all__ = ["DEFAULT_OUT", "add_arguments", "card", "resolve_device",
           "stamp", "write"]


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The two flags every tool takes."""
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card, "
                         "raising without one; 'cpu' for the plain PyTorch "
                         "path)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the .jsonl file the record is appended to")


def card(device: torch.device) -> tuple[str, float | None]:
    """(name, power limit in W) of the card behind ``device`` as nvidia-smi
    gives them; ``("cpu", None)`` for the CPU, and the name torch knows with
    a null limit where nvidia-smi cannot be asked."""
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    ids = [v for v in visible.split(",") if v]
    smi_id = ids[index] if index < len(ids) else str(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", smi_id, "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(limit.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return torch.cuda.get_device_name(index), None


def stamp(rec: dict, device: str | torch.device) -> dict:
    """``rec`` with where and when it was taken."""
    device = torch.device(device)
    name, limit = card(device)
    rec.update(backend=device.type, device=name, power_limit_w=limit,
               ts=time.strftime("%Y-%m-%d %H:%M:%S"))
    return rec


def write(rec: dict, device: str | torch.device,
          out: str | None = DEFAULT_OUT) -> dict:
    """Stamp ``rec``, print it as one JSON line and append it to ``out``
    (None: print only)."""
    line = json.dumps(stamp(rec, device))
    print(line, flush=True)
    if out:
        parent = os.path.dirname(os.path.abspath(out))
        os.makedirs(parent, exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    return rec
