"""Sim3 pose-graph (essential graph) optimization (port of
``sivo_tpu/optim/pose_graph.py``; ref: Optimizer.cc:928-1234
OptimizeEssentialGraph).

Sim3 vertices for every keyframe; edges from the loop closure, the
spanning tree, strong covisibility and earlier loops; 20 Gauss-Newton
iterations (the reference's LM with lambda_init 1e-16); fixed vertices
held by identity gauge rows. Edge Jacobians are forward-mode AD of the
residual at zero perturbation (``sim3.jacobians_at_zero``, the JAX
package's ``vmap(jacfwd)``); the normal equations are summed with
``index_add_`` into a dense (7K, 7K) system and solved by LU
(``solve_ex``, no host sync), as the JAX package's ``jnp.linalg.solve``.
float32 with TF32 off (``utils/precision.py``): this system's chains of
near-identity Sim3s amplify reduced-precision round-off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sivo_tpu_torch.geometry import sim3


class PoseGraphProblem(NamedTuple):
    # vertices (K, ...): keyframe Sim3 world->camera
    s: torch.Tensor  # (K,)
    R: torch.Tensor  # (K, 3, 3)
    t: torch.Tensor  # (K, 3)
    fixed: torch.Tensor  # (K,) bool
    valid: torch.Tensor  # (K,) bool
    # edges (E, ...): measurement = relative Sim3 S_ij = S_i * S_j^-1
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    meas_s: torch.Tensor  # (E,)
    meas_R: torch.Tensor  # (E, 3, 3)
    meas_t: torch.Tensor  # (E, 3)
    edge_valid: torch.Tensor  # (E,) bool


def _edge_residual(xi_i, xi_j, Si: sim3.Sim3, Sj: sim3.Sim3,
                   Sm: sim3.Sim3) -> torch.Tensor:
    """r = log(Sm^-1 (exp(xi_i) Si) (exp(xi_j) Sj)^-1), the g2o EdgeSim3
    error with left-multiplicative vertex perturbations."""
    Pi = sim3.compose(sim3.exp(xi_i), Si)
    Pj = sim3.compose(sim3.exp(xi_j), Sj)
    rel = sim3.compose(Pi, sim3.inverse(Pj))
    return sim3.log(sim3.compose(sim3.inverse(Sm), rel))


def optimize_essential_graph(prob: PoseGraphProblem, iterations: int = 20
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Returns the optimized (s (K,), R (K, 3, 3), t (K, 3))."""
    K = prob.s.shape[0]
    E = prob.edge_i.shape[0]
    dev, dt = prob.R.device, prob.R.dtype
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    free = prob.valid & ~prob.fixed
    free7 = free.repeat_interleave(7)
    mask2d = free7[:, None] & free7[None, :]
    damp = torch.diag(torch.where(free7, 1e-6, 1.0).to(dt))
    w = prob.edge_valid.to(dt)
    Sm = sim3.Sim3(prob.meas_s, prob.meas_R, prob.meas_t)
    s, R, t = prob.s, prob.R, prob.t
    for _ in range(iterations):
        Si = sim3.Sim3(s[ei], R[ei], t[ei])
        Sj = sim3.Sim3(s[ej], R[ej], t[ej])
        r, (Ji, Jj) = sim3.jacobians_at_zero(
            lambda a, b: _edge_residual(a, b, Si, Sj, Sm), 2, (E,), 7, R)
        Ji = Ji * w[:, None, None]
        Jj = Jj * w[:, None, None]
        Hij = torch.einsum("eij,eik->ejk", Ji, Jj)
        H = torch.zeros((K * K, 7, 7), dtype=dt, device=dev)
        H.index_add_(0, ei * K + ei, torch.einsum("eij,eik->ejk", Ji, Ji))
        H.index_add_(0, ej * K + ej, torch.einsum("eij,eik->ejk", Jj, Jj))
        H.index_add_(0, ei * K + ej, Hij)
        H.index_add_(0, ej * K + ei, Hij.transpose(-1, -2))
        H2 = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        rw = r * w[:, None]
        b = torch.zeros((K, 7), dtype=dt, device=dev)
        b.index_add_(0, ei, -torch.einsum("eij,ei->ej", Ji, rw))
        b.index_add_(0, ej, -torch.einsum("eij,ei->ej", Jj, rw))
        H2 = torch.where(mask2d, H2, torch.zeros_like(H2)) + damp
        b2 = torch.where(free7, b.reshape(-1), torch.zeros_like(free7, dtype=dt))
        dx = torch.linalg.solve_ex(H2, b2)[0].reshape(K, 7)
        new = sim3.compose(sim3.exp(dx), sim3.Sim3(s, R, t))
        s = torch.where(free, new.s, s)
        R = torch.where(free[:, None, None], new.R, R)
        t = torch.where(free[:, None], new.t, t)
    return s, R, t
