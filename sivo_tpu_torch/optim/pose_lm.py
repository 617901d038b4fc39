"""Motion-only pose optimization by Levenberg-Marquardt (port of
``sivo_tpu/optim/pose_lm.py``; ref: Optimizer.cc:273-491
PoseOptimization).

4 rounds x 10 LM iterations with chi-squared re-classification after
each round (Huber in rounds 1-2), then the 6x6 marginal covariance as
the inverse of the final Gauss-Newton Hessian over inliers. The JAX
``lax.scan`` rounds and iterations are Python loops, and the
``lax.cond`` on the round index is a Python ``if``. All math is float32
with TF32 off; the 6x6 solves use the ``_ex`` forms, which report
singularity in a tensor instead of synchronising to raise.

On the card the ~2,000 small launches of one solve cost its host ~190
ms (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6), so ``optimize_pose``
captures the solve once per input shape,
camera and schedule as a CUDA graph and replays it: the inputs are
copied into the graph's own tensors and the outputs cloned out, and the
result is bit for bit that of ``optimize_pose_eager``, which CPU
tensors run directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams, project_stereo

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = 2.447651936  # sqrt(5.991)
DELTA_STEREO = 2.795531791  # sqrt(7.815)


class PoseObservations(NamedTuple):
    points: torch.Tensor  # (N, 3) world positions of matched map points
    uvr: torch.Tensor  # (N, 3) measured (uL, vL, uR); uR ignored if mono
    sigma2: torch.Tensor  # (N,) per-observation noise (level sigma^2)
    is_stereo: torch.Tensor  # (N,) bool
    valid: torch.Tensor  # (N,) bool


class PoseResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) optimized Tcw
    covariance: torch.Tensor  # (6, 6) marginal covariance
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor  # () final total chi2 over inliers


def _residuals(Tcw, obs: PoseObservations, cam: CameraParams):
    """(N, 3) camera-frame points and (N, 3) residuals at Tcw. Residual-
    only evaluations skip the Jacobian: eager PyTorch would compute and
    discard it, where XLA dropped it from the JAX program."""
    xc = obs.points @ Tcw[:3, :3].T + Tcw[:3, 3]
    return xc, project_stereo(cam, xc) - obs.uvr


def _residuals_jacobians(Tcw, obs: PoseObservations, cam: CameraParams):
    """(N, 3) residuals and (N, 3, 6) Jacobians w.r.t. the left-mult
    twist [trans, rot] on Tcw."""
    xc, r = _residuals(Tcw, obs, cam)
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    j_proj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1),
        torch.stack([cam.fx * iz, zero, (-cam.fx * x + cam.bf) * iz2], dim=-1),
    ], dim=-2)  # (N, 3, 3)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device)
    dxc = torch.cat([eye.expand(xc.shape[:-1] + (3, 3)), -se3.hat(xc)],
                    dim=-1)  # (N, 3, 6)
    return r, j_proj @ dxc


def _chi2(r, obs: PoseObservations):
    w = 1.0 / obs.sigma2
    r2_mono = torch.sum(r[..., :2] ** 2, dim=-1)
    r2_stereo = torch.sum(r ** 2, dim=-1)
    return torch.where(obs.is_stereo, r2_stereo, r2_mono) * w


def _normal_equations(r, J, obs: PoseObservations, active, use_huber: bool,
                      with_jacobian: bool = True):
    """H (6, 6), b (6,) and the total robust chi2 over active obs."""
    chi2 = _chi2(r, obs)
    if use_huber:
        delta = torch.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        inside = s <= delta
        w_huber = torch.where(inside, torch.ones_like(s), delta / s)
        rho = torch.where(inside, chi2, 2.0 * delta * s - delta * delta)
    else:
        w_huber = torch.ones_like(chi2)
        rho = chi2
    total = torch.sum(torch.where(active, rho, torch.zeros_like(rho)))
    if not with_jacobian:
        return None, None, total
    row_mask = torch.cat([
        torch.ones(r.shape[:-1] + (2,), dtype=r.dtype, device=r.device),
        obs.is_stereo[..., None].to(r.dtype),
    ], dim=-1)
    w = (active.to(r.dtype) * w_huber / obs.sigma2)[..., None] * row_mask
    Jw = J * w[..., None]  # (N, 3, 6)
    H = torch.einsum("nij,nik->jk", Jw, J)
    b = -torch.einsum("nij,ni->j", Jw, r)
    return H, b, total


def _lm_iterations(T0, obs, cam, active, use_huber: bool, n_iters: int):
    """One g2o-style LM round: lambda_init = 1e-5 * max diag(H);
    accept/reject steps by chi2."""

    def chi2_at(T):
        r = _residuals(T, obs, cam)[1]
        return _normal_equations(r, None, obs, active, use_huber,
                                 with_jacobian=False)[2]

    r0, J0 = _residuals_jacobians(T0, obs, cam)
    H0, _, _ = _normal_equations(r0, J0, obs, active, use_huber)
    lam = 1e-5 * torch.max(torch.diagonal(H0))
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    T = T0
    best_chi2 = chi2_at(T0)
    for _ in range(n_iters):
        r, J = _residuals_jacobians(T, obs, cam)
        H, b, _ = _normal_equations(r, J, obs, active, use_huber)
        dx = torch.linalg.solve_ex(H + lam * eye6, b)[0]
        T_new = se3.exp(dx) @ T
        new_chi2 = chi2_at(T_new)
        improved = new_chi2 < best_chi2
        T = torch.where(improved, T_new, T)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
        best_chi2 = torch.minimum(new_chi2, best_chi2)
    return T


def optimize_pose(T_init, obs: PoseObservations, cam: CameraParams,
                  rounds: int = 4, iterations: int = 10) -> PoseResult:
    """``optimize_pose_eager``, replayed from a CUDA graph for CUDA
    tensors."""
    if not T_init.is_cuda:
        return optimize_pose_eager(T_init, obs, cam, rounds, iterations)
    key = (T_init.device, T_init.dtype,
           tuple((t.shape, t.dtype) for t in obs), cam, rounds, iterations)
    if key not in _GRAPHS:
        _GRAPHS[key] = _capture(T_init, obs, cam, rounds, iterations)
    graph, T_in, obs_in, out = _GRAPHS[key]
    T_in.copy_(T_init)
    for dst, src in zip(obs_in, obs):
        dst.copy_(src)
    graph.replay()
    return PoseResult(*(t.clone() for t in out))


# (device, input shapes and types, camera, rounds, iterations) ->
# (graph, its input tensors, its output tensors)
_GRAPHS: dict = {}


def _capture(T_init, obs: PoseObservations, cam: CameraParams,
             rounds: int, iterations: int):
    """Capture ``optimize_pose_eager`` on copies of the inputs, after one
    eager run on a side stream (it creates the library handles and
    workspaces the graph then reuses)."""
    T_in = T_init.clone()
    obs_in = PoseObservations(*(t.clone() for t in obs))
    side = torch.cuda.Stream(T_init.device)
    side.wait_stream(torch.cuda.current_stream(T_init.device))
    with torch.cuda.stream(side):
        optimize_pose_eager(T_in, obs_in, cam, rounds, iterations)
    torch.cuda.current_stream(T_init.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = optimize_pose_eager(T_in, obs_in, cam, rounds, iterations)
    return graph, T_in, obs_in, out


def optimize_pose_eager(T_init, obs: PoseObservations, cam: CameraParams,
                        rounds: int = 4, iterations: int = 10
                        ) -> PoseResult:
    """Full PoseOptimization: each round runs LM from the current
    estimate over the current inliers (Huber in rounds 1-2), then
    re-classifies every valid observation by chi2."""
    T, inliers = T_init, obs.valid
    th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    for round_idx in range(rounds):
        T = _lm_iterations(T, obs, cam, inliers, round_idx < 2, iterations)
        r = _residuals(T, obs, cam)[1]
        inliers = obs.valid & (_chi2(r, obs) <= th)

    # marginal covariance = inv(H) at the final estimate over inliers,
    # no robust kernel (g2o computeMarginals, ref: Optimizer.cc:482-487)
    r, J = _residuals_jacobians(T, obs, cam)
    H, _, chi2_total = _normal_equations(r, J, obs, inliers, False)
    n_in = torch.sum(inliers)
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    H_safe = H + torch.where(n_in >= 3, 0.0, 1.0) * eye6
    cov = torch.linalg.inv_ex(H_safe)[0]
    return PoseResult(pose=T, covariance=cov, inliers=inliers,
                      n_inliers=n_in.to(torch.int32), chi2=chi2_total)
