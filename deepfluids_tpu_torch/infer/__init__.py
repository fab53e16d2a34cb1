"""Inference of the port: parameter-grid sweeps of the generator."""

from deepfluids_tpu_torch.infer.sweep import (
    param_grid,
    run_test_sweep,
    sweep_generator,
)

__all__ = ["param_grid", "sweep_generator", "run_test_sweep"]
