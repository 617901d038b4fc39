"""Information-theoretic feature selection (port of
``sivo_tpu/select/info.py``).

Twist/covariance ordering is [translation, rotation]. All math is
float32; with TF32 off (``utils/precision.py``) every ``@`` is full
float32, the counterpart of the JAX package's HIGHEST matmuls.

``sequential_selection_stereo`` is the JAX package's 512-step
``lax.scan`` written as a Python loop of small device ops. It walks only
the live prefix of the compacted candidates (steps past it accept
nothing and change nothing), which costs one host read of the candidate
count per call.
"""

from __future__ import annotations

import torch

from sivo_tpu_torch.geometry import se3

_LOG2E = 1.4426950408889634  # log2(e)

SEL_CAP = 512  # candidate cap of the sequential walk (see the JAX package)


def mono_jacobian_pose(fx: float, fy: float, p: torch.Tensor) -> torch.Tensor:
    """(..., 3) point -> (..., 2, 6) d(projection)/d(pose twist)."""
    X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
    Z = torch.where(Z.abs() > 1e-12, Z, torch.full_like(Z, 1e-12))
    iz = 1.0 / Z
    iz2 = iz * iz
    zero = torch.zeros_like(X)
    row0 = torch.stack([
        fx * iz, zero, -fx * X * iz2, -fx * X * Y * iz2,
        fx * (1.0 + X * X * iz2), -fx * Y * iz,
    ], dim=-1)
    row1 = torch.stack([
        zero, fy * iz, -fy * Y * iz2, -fy * (1.0 + Y * Y * iz2),
        fy * X * Y * iz2, fy * X * iz,
    ], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def stereo_jacobian_pose(fx: float, fy: float, b: float,
                         p: torch.Tensor) -> torch.Tensor:
    """(..., 3) point -> (..., 3, 6) Jacobian of (uL, vL, uR)."""
    X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
    Z = torch.where(Z.abs() > 1e-12, Z, torch.full_like(Z, 1e-12))
    iz = 1.0 / Z
    iz2 = iz * iz
    zero = torch.zeros_like(X)
    mono = mono_jacobian_pose(fx, fy, torch.stack([X, Y, Z], dim=-1))
    Xb = X - b
    row2 = torch.stack([
        fx * iz, zero, -fx * Xb * iz2, -fx * Xb * Y * iz2,
        fx * (1.0 + X * Xb * iz2), -fx * Y * iz,
    ], dim=-1)
    return torch.cat([mono, row2[..., None, :]], dim=-2)


def _point_projection(fx: float, fy: float, p: torch.Tensor,
                      b: float | None = None) -> torch.Tensor:
    """(..., 3) point -> (..., 2, 3) d(uL, vL)/d(camera point), with the
    row of uR appended when the baseline ``b`` is given."""
    X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
    Z = torch.where(Z.abs() > 1e-12, Z, torch.full_like(Z, 1e-12))
    iz = 1.0 / Z
    iz2 = iz * iz
    zero = torch.zeros_like(X)
    rows = [torch.stack([fx * iz, zero, -fx * X * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * Y * iz2], dim=-1)]
    if b is not None:
        rows.append(torch.stack([fx * iz, zero, -fx * (X - b) * iz2], dim=-1))
    return torch.stack(rows, dim=-2)


def mono_jacobian_point(fx: float, fy: float, p: torch.Tensor,
                        Ccw: torch.Tensor) -> torch.Tensor:
    """(..., 3) point + (3, 3) world->camera rotation -> (..., 2, 3)
    d(projection)/d(world point) (ref: sivo_helpers.cpp:90-113)."""
    return _point_projection(fx, fy, p) @ Ccw


def stereo_jacobian_point(fx: float, fy: float, b: float, p: torch.Tensor,
                          Ccw: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) d(uL, vL, uR)/d(world point) (ref:
    sivo_helpers.cpp:115-136)."""
    return _point_projection(fx, fy, p, b) @ Ccw


def joint_covariance(state_cov: torch.Tensor, jac: torch.Tensor,
                     meas_noise: torch.Tensor) -> torch.Tensor:
    """Joint state + measurement covariance (ref:
    sivo_helpers.cpp:138-180): state_cov (..., 6, 6), jac (..., M, 6),
    meas_noise (..., M, M) -> (..., 6+M, 6+M)."""
    m = jac.shape[-2]
    sj = state_cov @ jac.transpose(-1, -2)  # (..., 6, M)
    js = jac @ state_cov  # (..., M, 6)
    meas_cov = jac @ sj + meas_noise  # (..., M, M)
    batch = torch.broadcast_shapes(state_cov.shape[:-2], jac.shape[:-2],
                                   meas_noise.shape[:-2])
    top = torch.cat([state_cov.expand(batch + (6, 6)),
                     sj.expand(batch + (6, m))], dim=-1)
    bottom = torch.cat([js.expand(batch + (m, 6)),
                        meas_cov.expand(batch + (m, m))], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def mutual_information(joint_cov: torch.Tensor) -> torch.Tensor:
    """MI in bits between the pose state (first 6 dims) and the
    measurement (the rest): 0.5 log2(det(S) det(M) / det(J)) (ref:
    sivo_helpers.cpp:182-219), through slogdet."""
    _, ld_s = torch.linalg.slogdet(joint_cov[..., :6, :6])
    _, ld_m = torch.linalg.slogdet(joint_cov[..., 6:, 6:])
    _, ld_j = torch.linalg.slogdet(joint_cov)
    return 0.5 * (ld_s + ld_m - ld_j) * _LOG2E


def kalman_update_stereo(prev_cov: torch.Tensor, jac: torch.Tensor,
                         meas_noise: torch.Tensor) -> torch.Tensor:
    """Covariance-only Kalman update (ref: sivo_helpers.cpp:221-240)."""
    jt = jac.transpose(-1, -2)
    S = jac @ prev_cov @ jt + meas_noise
    K = prev_cov @ jt @ torch.linalg.inv(S)
    eye = torch.eye(6, dtype=prev_cov.dtype, device=prev_cov.device)
    return (eye - K @ jac) @ prev_cov


def stereo_mutual_information(state_cov: torch.Tensor, jac: torch.Tensor,
                              meas_noise: torch.Tensor) -> torch.Tensor:
    """MI in bits = 0.5 * log2(det(H S H^T + N) / det(N))."""
    hsh = jac @ state_cov @ jac.transpose(-1, -2)
    _, ld_num = torch.linalg.slogdet(hsh + meas_noise)
    _, ld_den = torch.linalg.slogdet(meas_noise)
    return 0.5 * (ld_num - ld_den) * _LOG2E


def entropy_reduction_stereo(
    state_cov: torch.Tensor,
    points: torch.Tensor,
    sigma2: torch.Tensor,
    classification_entropy: torch.Tensor,
    fx: float,
    fy: float,
    baseline: float,
) -> torch.Tensor:
    """SIVO score per candidate: MI(state; stereo obs) - class entropy
    (ref: Tracking.cc:994-1002). ``points`` are camera-frame."""
    jac = stereo_jacobian_pose(fx, fy, baseline, points)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    noise = sigma2[..., None, None] * eye
    mi = stereo_mutual_information(state_cov, jac, noise)
    return mi - classification_entropy


def propagate_covariance_motion(prev_cov: torch.Tensor, motion: torch.Tensor,
                                process_noise: float = 0.01) -> torch.Tensor:
    """``F = I + Ad(T)``, ``P' = F P F^T + q I``."""
    eye = torch.eye(6, dtype=prev_cov.dtype, device=prev_cov.device)
    F = eye + se3.adjoint(motion)
    return F @ prev_cov @ F.T + process_noise * eye


def _det_adj3(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Determinant and adjugate of a 3x3 matrix, the JAX package's
    explicit cofactor formulas: with rows r0, r1, r2 the cofactor rows
    are r1 x r2, r2 x r0, r0 x r1 (one cross-product launch instead of
    ~30 element ops), det = r0 . (r1 x r2), adj = cofactors^T."""
    C = torch.linalg.cross(S.roll(-1, 0), S.roll(-2, 0))
    p = S[0] * C[0]
    return p[0] + p[1] + p[2], C.T


def sequential_selection_stereo(
    state_cov: torch.Tensor,
    points: torch.Tensor,
    sigma2: torch.Tensor,
    classification_entropy: torch.Tensor,
    candidate: torch.Tensor,
    th: float,
    fx: float,
    fy: float,
    baseline: float,
    min_select: int = 32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy sequential SIVO selection: walk candidates in keypoint
    index order; after each accepted feature shrink the covariance with
    the covariance-only Kalman update (arXiv 1811.11946 §III-B).

    Returns (selected (N,) bool, final (6, 6) covariance, walk index of
    the last accept as a float32 scalar, -1 when none).
    """
    n = points.shape[0]
    dev = points.device
    cap = min(SEL_CAP, n)
    idx = torch.arange(n, device=dev)
    comp = torch.sort(torch.where(candidate, idx, torch.full_like(idx, n))
                      ).values[:cap]
    live = comp < n
    comp_c = torch.clamp(comp, 0, n - 1)
    jac = stereo_jacobian_pose(fx, fy, baseline, points[comp_c])
    sig = sigma2[comp_c]
    ent = classification_entropy[comp_c]
    ld_R = 3.0 * torch.log(sig)

    # live slots are a prefix of the walk; past it nothing is accepted
    n_live = int(live.sum())
    cov = state_cov
    count = torch.zeros((), dtype=torch.int32, device=dev)
    accepts = torch.zeros(cap, dtype=torch.bool, device=dev)
    eye3 = torch.eye(3, dtype=cov.dtype, device=dev)
    eye6 = torch.eye(6, dtype=cov.dtype, device=dev)
    for k in range(n_live):
        J = jac[k]
        S = J @ cov @ J.T + sig[k] * eye3
        det, adj = _det_adj3(S)
        mi = 0.5 * (torch.log(torch.clamp(det, min=1e-30)) - ld_R[k]) * _LOG2E
        score = mi - ent[k]
        accept = (score > th) | ((count < min_select) & (score > 0.0))
        K = cov @ J.T @ (adj / det)
        cov_upd = (eye6 - K @ J) @ cov
        cov_upd = 0.5 * (cov_upd + cov_upd.T)
        cov = torch.where(accept, cov_upd, cov)
        count = count + accept.to(torch.int32)
        accepts[k] = accept
    sel = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(accepts, comp, torch.full_like(comp, n)), True)
    walk = torch.arange(cap, device=dev)
    last_accept = torch.max(
        torch.where(accepts, walk, torch.full_like(walk, -1))
    ).float()
    return sel[:n], cov, last_accept
