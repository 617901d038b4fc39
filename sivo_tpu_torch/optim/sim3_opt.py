"""Sim3 refinement and RANSAC between two keyframes (port of
``sivo_tpu/optim/sim3_opt.py``; ref: Optimizer.cc:1236-1449
OptimizeSim3, Sim3Solver.cc:115-213).

One Sim3 vertex, a pair of projection edges per matched point (KF2's
points through S12 into KF1's image, KF1's points through S12^-1 into
KF2's), Huber(sqrt(10)), inlier recheck: Gauss-Newton over a 7-dof left
perturbation with forward-mode Jacobians (``sim3.jacobians_at_zero``).

RANSAC solves every 3-point Horn hypothesis at once. The minimal sets
are drawn by Gumbel top-k from an explicit ``torch.Generator``; they
cannot equal the JAX package's ``jax.random`` draws, so the evaluation
of given sets is its own function, ``evaluate_hypotheses``, which the
tests feed the JAX package's sets. Argmax ties go to the first index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sivo_tpu_torch.geometry import sim3
from sivo_tpu_torch.geometry.projection import CameraParams, project

CHI2_TH = 10.0  # ref: LoopClosing.cc:334-337 th2=10
DELTA = 3.16227766017  # sqrt(10), ref: Optimizer.cc:1320 deltaHuber
RANSAC_CHI2 = 9.21  # ref: Sim3Solver CheckInliers


class Sim3Result(NamedTuple):
    g12: sim3.Sim3
    inliers: torch.Tensor  # (N,) bool matched-pair inliers
    n_inliers: torch.Tensor  # () int32


def _residuals(xi, g0: sim3.Sim3, pc1, pc2, uv1, uv2,
               cam: CameraParams) -> torch.Tensor:
    """(..., N, 4): [proj1(S12 pc2) - uv1, proj2(S12^-1 pc1) - uv2] for
    S12 = exp(xi) g0; xi (..., 1, 7) broadcasts over the N points."""
    g = sim3.compose(sim3.exp(xi), g0)
    p1 = sim3.apply(g, pc2)
    p2 = sim3.apply(sim3.inverse(g), pc1)
    return torch.cat([project(cam, p1) - uv1, project(cam, p2) - uv2], -1)


def _chi2_parts(r, sigma2_1, sigma2_2):
    return (torch.sum(r[..., :2] ** 2, dim=-1) / sigma2_1,
            torch.sum(r[..., 2:] ** 2, dim=-1) / sigma2_2)


def optimize_sim3(g_init: sim3.Sim3, pc1, pc2, uv1, uv2, sigma2_1,
                  sigma2_2, valid, cam: CameraParams,
                  fix_scale: bool = True, iterations: int = 10
                  ) -> Sim3Result:
    """Huber Gauss-Newton on the Sim3 (ref: Optimizer.cc:1236-1449);
    ``valid`` selects the active pairs. The final inliers pass chi2 <= 10
    in both images."""
    dev, dt = pc1.device, pc1.dtype
    a = valid.to(dt)
    keep = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:  # stereo: lock the scale coordinate
        keep[6:].fill_(0.0)
    H_mask = keep[:, None] * keep[None, :]
    H_fix = torch.diag(1.0 - keep) + 1e-6 * torch.eye(7, dtype=dt,
                                                      device=dev)
    g = g_init
    for _ in range(iterations):
        g0 = g
        r, (J,) = sim3.jacobians_at_zero(
            lambda xi: _residuals(xi, g0, pc1, pc2, uv1, uv2, cam),
            1, (1,), 7, pc1)  # r (N, 4), J (N, 4, 7)
        c1, c2 = _chi2_parts(r, sigma2_1, sigma2_2)
        s1 = torch.sqrt(torch.clamp(c1, min=1e-12))
        s2 = torch.sqrt(torch.clamp(c2, min=1e-12))
        w1 = torch.where(s1 <= DELTA, 1.0, DELTA / s1) / sigma2_1
        w2 = torch.where(s2 <= DELTA, 1.0, DELTA / s2) / sigma2_2
        w = torch.stack([w1 * a, w1 * a, w2 * a, w2 * a], dim=-1)
        Jw = J * w[..., None]
        H = torch.einsum("nij,nik->jk", Jw, J) * H_mask + H_fix
        b = -torch.einsum("nij,ni->j", Jw, r) * keep
        dx = torch.linalg.solve_ex(H, b)[0]
        g = sim3.compose(sim3.exp(dx), g0)
    r = _residuals(torch.zeros((1, 7), dtype=dt, device=dev), g, pc1, pc2,
                   uv1, uv2, cam)
    c1, c2 = _chi2_parts(r, sigma2_1, sigma2_2)
    inliers = valid & (c1 <= CHI2_TH) & (c2 <= CHI2_TH)
    return Sim3Result(g12=g, inliers=inliers,
                      n_inliers=torch.sum(inliers).to(torch.int32))


def draw_sets(valid: torch.Tensor, generator: torch.Generator | None,
              n_hypotheses: int = 128) -> torch.Tensor:
    """(H, 3) minimal sets among the valid pairs, by Gumbel top-k."""
    n = valid.shape[0]
    u01 = torch.rand((n_hypotheses, n), generator=generator,
                     device=valid.device)
    g = -torch.log(-torch.log(u01.clamp(1e-20, 1.0 - 1e-7)))
    g = torch.where(valid[None, :], g, torch.full_like(g, float("-inf")))
    return torch.topk(g, 3, dim=1).indices


def evaluate_hypotheses(sets: torch.Tensor, pc1, pc2, uv1, uv2, sigma2_1,
                        sigma2_2, valid, cam: CameraParams,
                        fix_scale: bool = True) -> Sim3Result:
    """Horn on each minimal set, reprojection inliers in both images
    (ref: Sim3Solver CheckInliers), the hypothesis with the most
    inliers (first on ties), refined by ``optimize_sim3`` on its
    inliers."""
    hyp = sim3.horn_alignment(pc1[sets], pc2[sets], fix_scale=fix_scale)
    gh = sim3.Sim3(hyp.s[:, None], hyp.R[:, None], hyp.t[:, None])  # (H, 1)
    p1h = sim3.apply(gh, pc2[None])  # (H, N, 3)
    p2h = sim3.apply(sim3.inverse(gh), pc1[None])
    e1 = torch.sum((project(cam, p1h) - uv1[None]) ** 2, dim=-1) / sigma2_1
    e2 = torch.sum((project(cam, p2h) - uv2[None]) ** 2, dim=-1) / sigma2_2
    inl = (e1 < RANSAC_CHI2) & (e2 < RANSAC_CHI2) & valid[None]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)  # first index on ties
    pick = best[None]
    g_best = sim3.Sim3(hyp.s.index_select(0, pick)[0],
                       hyp.R.index_select(0, pick)[0],
                       hyp.t.index_select(0, pick)[0])
    return optimize_sim3(g_best, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2,
                         inl.index_select(0, pick)[0], cam,
                         fix_scale=fix_scale)


def ransac_sim3(pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, valid,
                generator: torch.Generator | None, cam: CameraParams,
                fix_scale: bool = True, n_hypotheses: int = 128
                ) -> Sim3Result:
    """Batched Sim3 RANSAC (replaces Sim3Solver::iterate,
    ref: Sim3Solver.cc:115-213)."""
    sets = draw_sets(valid, generator, n_hypotheses)
    return evaluate_hypotheses(sets, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2,
                               valid, cam, fix_scale)
