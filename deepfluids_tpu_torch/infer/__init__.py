"""Inference of the port: parameter-grid sweeps of the generator, the AE
encode pass, the latent rollout and its score against the simulation, and
the density rendering through generated velocities."""

from deepfluids_tpu_torch.infer.advect import (
    advect_density,
    render_density_sweep,
)
from deepfluids_tpu_torch.infer.rollout import (
    encode_dataset,
    rollout_trajectory,
)
from deepfluids_tpu_torch.infer.score import score_rollout_vs_sim
from deepfluids_tpu_torch.infer.sweep import (
    param_grid,
    run_test_sweep,
    sweep_generator,
    sweep_on_device,
)

__all__ = ["advect_density", "render_density_sweep", "param_grid", "sweep_generator", "sweep_on_device",
           "run_test_sweep",
           "encode_dataset", "rollout_trajectory", "score_rollout_vs_sim"]
