"""Pressure-solve self-consistency study.

Counterpart of the JAX package's ``tools/solver_consistency.py`` on the
port's solvers (``datagen/{grids,smoke2d,smoke3d,projection}.py``).  The
production Jacobi sweep is compared against an INDEPENDENT converged solver
(deflated conjugate gradients in float64, ``grids.solve_pressure2d_cg``) on
the identical discretization, on two axes:

1. single-projection accuracy: divergence residual after projecting a
   developed plume velocity field with Jacobi-k for several k vs the CG
   reference, plus the velocity-field distance to the converged projection;
2. trajectory statistics: a full smoke scene integrated with Jacobi-50
   (the production dataset setting) vs the SAME scene integrated with CG
   projection every step: kinetic-energy time series and the
   radially-binned energy spectrum of the late frames.

    python -m deepfluids_tpu_torch.tools.solver_consistency [2d|3d|matched]
        [--full] [--frames N] [--ensemble N] [--height H --width W
        [--depth D]] [--device cpu] [--out file.jsonl]

``3d`` runs the 3D replica (production smoke3 solver, Jacobi-40, vs a
converged 3D deflated-CG oracle at half resolution per axis, ``--full`` at
the production grid); ``matched`` the distance of the matched
(curl-manifold) trajectories to the converged ones, which launches the curl
kernels on a card (f32; the float64 CG takes the plain ops).  The ensemble
advances as one scene batch.  ``--frames`` / ``--ensemble`` cut the study
(the record says so).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from deepfluids_tpu_torch.datagen import grids
from deepfluids_tpu_torch.datagen.smoke2d import (
    Smoke2DConfig,
    simulate_smoke2d,
)
from deepfluids_tpu_torch.datagen.smoke3d import (
    Smoke3DConfig,
    simulate_smoke3d,
)
from deepfluids_tpu_torch.tools import _record


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def div_norm(vel) -> float:
    """Interior L2 norm of central divergence (boundary rows/cols carry the
    Neumann closure and are excluded on BOTH solvers identically)."""
    d = _np(grids.divergence2d_c(torch.as_tensor(vel)))[1:-1, 1:-1]
    return float(np.sqrt(np.mean(d * d)))


def div_norm3(vel) -> float:
    """Interior L2 norm of central divergence in 3D (boundary shells carry
    the Neumann closure on BOTH solvers identically and are excluded)."""
    d = _np(grids.divergence3d_c(torch.as_tensor(vel)))[1:-1, 1:-1, 1:-1]
    return float(np.sqrt(np.mean(d * d)))


def energy_spectrum(vel: np.ndarray, nbins: int = 16) -> np.ndarray:
    """Radially-binned kinetic-energy spectrum of vel [..., C] (2D or 3D:
    rfft over all grid axes, energy summed over velocity components)."""
    grid_axes = tuple(range(vel.ndim - 1))
    e = sum(np.abs(np.fft.rfftn(vel[..., c], axes=grid_axes)) ** 2
            for c in range(vel.shape[-1]))
    freqs = [np.fft.fftfreq(vel.shape[a]) for a in grid_axes[:-1]]
    freqs.append(np.fft.rfftfreq(vel.shape[grid_axes[-1]]))
    k = np.sqrt(sum(f ** 2 for f in np.meshgrid(*freqs, indexing="ij")))
    edges = np.linspace(0, k.max() + 1e-9, nbins + 1)
    out = np.zeros(nbins)
    for i in range(nbins):
        m = (k >= edges[i]) & (k < edges[i + 1])
        out[i] = e[m].sum()
    return out


def _traj_stats(va: np.ndarray, vb: np.ndarray, frames: int) -> dict:
    """Late-window statistical distance between two trajectories: relative
    kinetic-energy gap and radial-spectrum relative error (b = reference)."""
    late = slice(frames // 2, None)
    per_frame = tuple(range(1, va.ndim))
    ke_a = (va ** 2).sum(axis=per_frame)
    ke_b = (vb ** 2).sum(axis=per_frame)
    ke_rel = (ke_a[late].mean() - ke_b[late].mean()) / ke_b[late].mean()
    sp_a = np.mean([energy_spectrum(f) for f in va[late]], axis=0)
    sp_b = np.mean([energy_spectrum(f) for f in vb[late]], axis=0)
    live = sp_b > sp_b.max() * 1e-6          # bins carrying real energy
    sp_rel = np.abs(sp_a - sp_b)[live] / sp_b[live]
    return {"ke": float(ke_rel), "sp_med": float(np.median(sp_rel)),
            "sp_max": float(sp_rel.max())}


def _med(recs: list[dict], k: str) -> float:
    return float(np.median([abs(r[k]) for r in recs]))


def _signed(recs: list[dict]) -> list[float]:
    return [round(r["ke"], 4) for r in recs]


def _single_projection(dirty: torch.Tensor, nd: int,
                       jacobi_iters: tuple[int, ...]) -> dict:
    """Residuals of Jacobi-k and of the float64 CG projection of one dirty
    field, how converged the CG solve itself is on the compact system, and
    each Jacobi field's distance to the converged one."""
    project, project_cg, solve_cg, divergence, laplacian, norm = (
        (grids.pressure_project2d, grids.pressure_project2d_cg,
         grids.solve_pressure2d_cg, grids.divergence2d_c, grids.laplacian2d,
         div_norm) if nd == 2 else
        (grids.pressure_project3d, grids.pressure_project3d_cg,
         grids.solve_pressure3d_cg, grids.divergence3d_c, grids.laplacian3d,
         div_norm3))
    d0 = norm(dirty)
    proj = {f"jacobi_{k}": _np(project(dirty, iters=k))
            for k in jacobi_iters}
    div_d = divergence(dirty)
    with grids.cg_in_float64():
        proj["cg"] = _np(project_cg(dirty, tol=1e-8))
        pcg = solve_cg(div_d, tol=1e-10)
    div_d = _np(div_d)
    compact_res = _np(laplacian(pcg)) - (div_d - div_d.mean())
    cg_compact_rel = float(np.sqrt((compact_res ** 2).mean())
                           / np.sqrt((div_d ** 2).mean()))
    residuals = {name: norm(v) / d0 for name, v in proj.items()}
    vrms = float(np.sqrt((proj["cg"] ** 2).mean()))
    vel_dist = {name: float(np.sqrt(((v - proj["cg"]) ** 2).mean()) / vrms)
                for name, v in proj.items() if name != "cg"}
    return {
        "cg_compact_residual_rel": round(cg_compact_rel, 9),
        "div_residual_vs_unprojected": {k: round(v, 6)
                                        for k, v in residuals.items()},
        "vel_rel_l2_to_converged": {k: round(v, 6)
                                    for k, v in vel_dist.items()},
    }


def _scene_params_2d(ensemble: int) -> tuple[torch.Tensor, torch.Tensor]:
    i = np.arange(ensemble)
    pos = (0.2 + 0.6 * i / max(1, ensemble - 1)).astype(np.float32)
    size = (0.06 + 0.01 * (i % 3)).astype(np.float32)
    return torch.from_numpy(pos), torch.from_numpy(size)


def _study_record(vj: np.ndarray, vc: np.ndarray, vp: np.ndarray,
                  frames: int) -> tuple[dict, np.ndarray]:
    """The trajectory statistics both Jacobi-vs-CG studies share, from the
    ensembles ``[E, T, ...]`` of the Jacobi (vj), CG (vc) and perturbed
    Jacobi (vp) runs; and scene 0's CG trajectory."""
    # Pointwise comparison is chaos-limited: after enough frames ANY
    # perturbation decorrelates the flows, so even late-window time
    # averages of a single developing plume carry realization variance.
    # The control twin (Jacobi vs Jacobi with buoyancy perturbed by 1e-4)
    # measures that chaos floor.  KE gaps are SIGNED per scene: a solver
    # bias shows a consistent sign across the ensemble, chaos variance
    # random signs.
    jc_stats = [_traj_stats(a, b, frames) for a, b in zip(vj, vc)]
    ctrl_stats = [_traj_stats(a, b, frames) for a, b in zip(vp, vj)]
    vj0, vc0 = vj[0], vc[0]
    per_frame = tuple(range(1, vj0.ndim))
    # early deterministic window: before chaos kicks in the two solvers
    # must agree pointwise (scene 0)
    ke_j = (vj0 ** 2).sum(axis=per_frame)
    ke_c = (vc0 ** 2).sum(axis=per_frame)
    early = slice(1, max(2, frames // 5))
    ke_rel_early = np.abs(ke_j[early] - ke_c[early]) / np.maximum(
        ke_c[early], 1e-12)
    traj_l2 = np.sqrt(((vj0 - vc0) ** 2).mean(axis=per_frame))
    vscale = np.sqrt((vc0 ** 2).mean(axis=per_frame)).max()
    return {
        "ensemble": len(vj),
        "ke_rel_err_early_max": round(float(ke_rel_early.max()), 5),
        "ke_stat_rel_jacobi_vs_cg": round(_med(jc_stats, "ke"), 5),
        "ke_stat_rel_chaos_control": round(_med(ctrl_stats, "ke"), 5),
        "ke_signed_gaps_jacobi_vs_cg": _signed(jc_stats),
        "ke_signed_gaps_chaos_control": _signed(ctrl_stats),
        "spectrum_rel_med_jacobi_vs_cg": round(_med(jc_stats, "sp_med"), 5),
        "spectrum_rel_med_chaos_control": round(_med(ctrl_stats, "sp_med"),
                                                5),
        "traj_l2_final_over_vscale": round(float(traj_l2[-1] / vscale), 5),
    }, vc0


def run_study(height: int = 128, width: int = 96, frames: int = 100,
              jacobi_iters: tuple[int, ...] = (20, 50, 100),
              ensemble: int = 5, device=None) -> dict:
    device = _record.resolve_device(device)
    cfg = dict(height=height, width=width, num_frames=frames)
    t0 = time.time()
    pos, size = _scene_params_2d(ensemble)

    def run(**kw) -> np.ndarray:
        return _np(simulate_smoke2d(pos, size, Smoke2DConfig(**cfg, **kw),
                                    device=device)[0])

    vj = run()
    with grids.cg_in_float64():
        vc = run(projection="cg")
    vp = run(buoyancy=0.08 * (1 + 1e-4))
    stats, vc0 = _study_record(vj, vc, vp, frames)

    # single-projection accuracy on the developed final CG frame,
    # re-disturbed: advect once so the field has fresh divergence to remove
    vel = torch.from_numpy(vc0[-1]).to(device)
    single = _single_projection(grids.advect2d(vel, vel, 1.0), 2,
                                jacobi_iters)
    return {"metric": "solver_consistency_2d",
            "resolution": [height, width], "frames": frames, **single,
            **stats, "secs": round(time.time() - t0, 1)}


def run_study_3d(depth: int = 16, height: int = 32, width: int = 56,
                 frames: int = 80,
                 jacobi_iters: tuple[int, ...] = (20, 40, 80),
                 ensemble: int = 3, device=None) -> dict:
    """3D replica of :func:`run_study`, by default at half the production
    resolution per axis (the Jacobi-convergence question is
    resolution-monotone: the production grid is HARDER for a fixed
    iteration count, so gaps measured here are a lower bound).  Production
    smoke3 uses project_iters=40."""
    device = _record.resolve_device(device)
    cfg = dict(depth=depth, height=height, width=width, num_frames=frames)
    t0 = time.time()
    i = np.arange(ensemble)
    inflow = torch.from_numpy(
        (1.0 + 1.0 * i / max(1, ensemble - 1)).astype(np.float32))
    buo = torch.from_numpy((0.05 + 0.01 * (i % 2)).astype(np.float32))

    def run(buoyancy, **kw) -> np.ndarray:
        return _np(simulate_smoke3d(inflow, buoyancy,
                                    Smoke3DConfig(**cfg, **kw),
                                    device=device)[0])

    vj = run(buo)
    with grids.cg_in_float64():
        vc = run(buo, projection="cg")
    vp = run(buo * (1 + 1e-4))
    stats, vc0 = _study_record(vj, vc, vp, frames)
    vel = torch.from_numpy(vc0[-1]).to(device)
    single = _single_projection(grids.advect3d(vel, vel, 1.0), 3,
                                jacobi_iters)
    return {"metric": "solver_consistency_3d",
            "resolution": [depth, height, width], "frames": frames,
            **single, **stats, "secs": round(time.time() - t0, 1)}


def run_study_matched(height: int = 128, width: int = 96, frames: int = 100,
                      ensemble: int = 5, device=None) -> dict:
    """Statistical distance of the MATCHED (Leray/curl-manifold) datagen
    trajectories to the converged-CG reference, with the production-Jacobi
    gap measured on the SAME scenes for context.

    The matched projection differs from cg in boundary handling too (zero
    wall through-flow by construction, no trailing wall_bc), so its gap to
    cg includes that modeling difference: the comparison asks whether the
    matched family sits CLOSER to the converged solve than the production
    Jacobi family it replaced."""
    device = _record.resolve_device(device)
    cfg = dict(height=height, width=width, num_frames=frames)
    t0 = time.time()
    pos, size = _scene_params_2d(ensemble)

    def run(**kw) -> np.ndarray:
        return _np(simulate_smoke2d(pos, size, Smoke2DConfig(**cfg, **kw),
                                    device=device)[0])

    with grids.cg_in_float64():
        vc = run(projection="cg")
    vm = run(projection="matched")
    vj = run()
    vp = run(buoyancy=0.08 * (1 + 1e-4))
    m_stats = [_traj_stats(a, b, frames) for a, b in zip(vm, vc)]
    j_stats = [_traj_stats(a, b, frames) for a, b in zip(vj, vc)]
    ctrl_stats = [_traj_stats(a, b, frames) for a, b in zip(vp, vj)]
    return {
        "metric": "solver_consistency_matched2d",
        "resolution": [height, width],
        "frames": frames,
        "ensemble": ensemble,
        "ke_stat_rel_matched_vs_cg": round(_med(m_stats, "ke"), 5),
        "ke_stat_rel_jacobi_vs_cg": round(_med(j_stats, "ke"), 5),
        "ke_stat_rel_chaos_control": round(_med(ctrl_stats, "ke"), 5),
        "ke_signed_gaps_matched_vs_cg": _signed(m_stats),
        "ke_signed_gaps_jacobi_vs_cg": _signed(j_stats),
        "spectrum_rel_med_matched_vs_cg": round(_med(m_stats, "sp_med"), 5),
        "spectrum_rel_med_jacobi_vs_cg": round(_med(j_stats, "sp_med"), 5),
        "spectrum_rel_med_chaos_control": round(_med(ctrl_stats, "sp_med"),
                                                5),
        "secs": round(time.time() - t0, 1),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Jacobi / matched projection vs a converged float64 CG")
    ap.add_argument("study", nargs="?", default="2d",
                    choices=("2d", "3d", "matched"))
    ap.add_argument("--full", action="store_true",
                    help="3d: the production grid 32x64x112, 150 frames")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--ensemble", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    _record.add_arguments(ap)
    a = ap.parse_args(argv)
    device = _record.resolve_device(a.device)
    dims = ("depth", "height", "width") if a.study == "3d" else (
        "height", "width")
    kw = {k: getattr(a, k) for k in ("frames", "ensemble") + dims
          if getattr(a, k) is not None}
    if a.study == "3d":
        if a.full:
            kw = {"depth": 32, "height": 64, "width": 112, "frames": 150,
                  **kw}
        rec = run_study_3d(device=device, **kw)
    elif a.study == "matched":
        rec = run_study_matched(device=device, **kw)
    else:
        rec = run_study(device=device, **kw)
    if kw:
        rec["cut"] = dict(kw)
    return _record.write(rec, device, a.out)


if __name__ == "__main__":
    main()
