"""Local bundle adjustment: LM with a Schur complement on the points
(port of ``sivo_tpu/optim/local_ba.py``; ref: Optimizer.cc:493-926
LocalBundleAdjustment).

The covisible keyframe window (+ fixed frontier keyframes) and its
points, padded to fixed caps: 5 Huber iterations, chi-squared outlier
demotion with a positive-depth check, 10 plain iterations, the final
classification, and the newest keyframe's 6x6 marginal covariance as
the matching block of S^-1, S the reduced camera system (g2o's
computeMarginals after point marginalization, ref: Optimizer.cc:876-912).

Each LM build accumulates the per-observation blocks with ``index_add_``
(the JAX ``.at[].add`` scatters), keeps the dense point-camera cross
blocks E as (P, K, 6, 3) indexed by ``p * K + k``, inverts the 3x3 point
blocks in batch and solves the dense 6K x 6K reduced system. The
accept/reject of each LM step is a ``torch.where`` on device tensors, and
the solves use the ``_ex`` forms, so a solve has no host sync. All math
is float32 with TF32 off (``utils/precision.py``), the counterpart of the
JAX package's HIGHEST-precision einsums. On the card the ``index_add_``
sums are float atomics: their order, and so the last bits, vary between
runs.

``global_bundle_adjustment`` is the loop closer's dense full-map solve on
the same machinery (robust kernel off); ``optim/gba_cg.py`` is its
matrix-free counterpart for larger maps. The JAX package's chunked-Schur
global BA is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams, project_stereo

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = 2.447651936
DELTA_STEREO = 2.795531791


class BAProblem(NamedTuple):
    """Padded local BA problem."""

    kf_pose: torch.Tensor  # (K, 4, 4) Tcw
    kf_fixed: torch.Tensor  # (K,) bool: frontier KFs held constant
    kf_valid: torch.Tensor  # (K,) bool
    pt_pos: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    obs_kf: torch.Tensor  # (O,) int index into kf arrays
    obs_pt: torch.Tensor  # (O,) int index into pt arrays
    obs_uvr: torch.Tensor  # (O, 3) measured (uL, vL, uR)
    obs_sigma2: torch.Tensor  # (O,)
    obs_is_stereo: torch.Tensor  # (O,) bool
    obs_valid: torch.Tensor  # (O,) bool


class BAResult(NamedTuple):
    kf_pose: torch.Tensor  # (K, 4, 4) optimized
    pt_pos: torch.Tensor  # (P, 3) optimized
    obs_inlier: torch.Tensor  # (O,) final classification (for erasure,
    #                            ref: Optimizer.cc:822-870)
    newest_cov: torch.Tensor  # (6, 6) marginal of kf index `newest`
    chi2: torch.Tensor  # () final total


def _residuals(kf_pose: torch.Tensor, pt_pos: torch.Tensor,
               prob: BAProblem, cam: CameraParams):
    """Per-observation residuals r (O, 3), camera Jacobians Jc (O, 3, 6),
    point Jacobians Jp (O, 3, 3), camera-frame z (O,)."""
    T = kf_pose[prob.obs_kf.long()]  # (O, 4, 4)
    X = pt_pos[prob.obs_pt.long()]  # (O, 3)
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    xc = (R @ X[..., None])[..., 0] + t
    r = project_stereo(cam, xc) - prob.obs_uvr

    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    j_proj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1),
        torch.stack([cam.fx * iz, zero, (-cam.fx * x + cam.bf) * iz2],
                    dim=-1),
    ], dim=-2)  # (O, 3, 3)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device)
    dxc_dtwist = torch.cat([eye.expand(r.shape[0], 3, 3), -se3.hat(xc)],
                           dim=-1)  # (O, 3, 6)
    Jc = j_proj @ dxc_dtwist
    Jp = j_proj @ R  # dxc/dX = R
    return r, Jc, Jp, xc[:, 2]


def _chi2(r: torch.Tensor, prob: BAProblem) -> torch.Tensor:
    w = 1.0 / prob.obs_sigma2
    r2m = torch.sum(r[:, :2] ** 2, dim=-1)
    r2s = torch.sum(r ** 2, dim=-1)
    return torch.where(prob.obs_is_stereo, r2s, r2m) * w


def _huber(chi2: torch.Tensor, prob: BAProblem):
    """(rho, weight) of the Huber kernel on chi2."""
    delta = torch.where(prob.obs_is_stereo, DELTA_STEREO, DELTA_MONO)
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    inside = s <= delta
    rho = torch.where(inside, chi2, 2.0 * delta * s - delta * delta)
    return rho, torch.where(inside, torch.ones_like(s), delta / s)


def _lm_round(kf_pose, pt_pos, prob: BAProblem, active: torch.Tensor,
              cam: CameraParams, use_huber: bool, n_iters: int,
              lam0_scale: float = 1e-5):
    """One g2o-style LM stage over ``active`` observations. Returns
    (kf_pose, pt_pos, best chi2, S at lambda 0 for the covariance)."""
    K = prob.kf_pose.shape[0]
    P = prob.pt_pos.shape[0]
    dev, dt = kf_pose.device, kf_pose.dtype
    free_kf = prob.kf_valid & ~prob.kf_fixed
    obs_kf, obs_pt = prob.obs_kf.long(), prob.obs_pt.long()
    obs_pk = obs_pt * K + obs_kf  # row of the flattened (P * K) E blocks
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eyeK = torch.eye(K, dtype=dt, device=dev)
    free6 = free_kf.repeat_interleave(6)
    mask2d = free6[:, None] & free6[None, :]
    gauge_diag = torch.diag((~free6).to(dt))
    act = active.to(dt)
    # guard: points with no active observation get identity (delta = 0)
    has_pt = (torch.zeros(P, dtype=dt, device=dev).index_add_(0, obs_pt, act)
              > 0) & prob.pt_valid
    row_mask = torch.cat([
        torch.ones((obs_kf.shape[0], 2), dtype=dt, device=dev),
        prob.obs_is_stereo[:, None].to(dt)], dim=-1)

    def robust_chi2(kp, pp):
        r = _residuals(kp, pp, prob, cam)[0]
        chi2 = _chi2(r, prob)
        rho = _huber(chi2, prob)[0] if use_huber else chi2
        return torch.sum(torch.where(active, rho, torch.zeros_like(rho)))

    def build_and_solve(kp, pp, lam):
        r, Jc, Jp, _ = _residuals(kp, pp, prob, cam)
        chi2 = _chi2(r, prob)
        wh = _huber(chi2, prob)[1] if use_huber else torch.ones_like(chi2)
        w = (act * wh / prob.obs_sigma2)[:, None] * row_mask  # (O, 3)
        Jc_w = Jc * w[..., None]
        Jp_w = Jp * w[..., None]

        # block accumulations (the JAX .at[].add scatters)
        Jc_wT = Jc_w.transpose(-1, -2)
        Jp_wT = Jp_w.transpose(-1, -2)
        Hcc = torch.zeros((K, 6, 6), dtype=dt, device=dev).index_add_(
            0, obs_kf, Jc_wT @ Jc)
        Hpp = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
            0, obs_pt, Jp_wT @ Jp)
        bc = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(
            0, obs_kf, -(Jc_wT @ r[..., None])[..., 0])
        bp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
            0, obs_pt, -(Jp_wT @ r[..., None])[..., 0])
        # per-observation cross blocks scattered into dense E (P, K, 6, 3)
        E = torch.zeros((P * K, 6, 3), dtype=dt, device=dev).index_add_(
            0, obs_pk, Jc_wT @ Jp).reshape(P, K * 6, 3)

        # damped point-block inverses
        Hpp_d = torch.where(has_pt[:, None, None],
                            Hpp + (lam + 1e-9) * eye3, eye3)
        Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]

        # Schur: S = blockdiag(Hcc + lam I) - sum_p E_p Hpp_inv E_p^T
        G = E @ Hpp_inv  # (P, 6K, 3)
        S_red = (G.permute(1, 0, 2).reshape(K * 6, P * 3)
                 @ E.permute(1, 0, 2).reshape(K * 6, P * 3).T)
        Hcc_d = Hcc + lam * eye6
        diag = eyeK[:, None, :, None] * Hcc_d[:, :, None, :]  # (K,6,K,6)
        S = (diag.reshape(K * 6, K * 6) - S_red)
        # gauge: fixed/invalid cameras -> identity rows/cols, zero rhs
        S = torch.where(mask2d, S, torch.zeros_like(S)) + gauge_diag
        b_red = bc.reshape(-1) - torch.einsum("pal,pl->a", G, bp)
        b_red = torch.where(free6, b_red, torch.zeros_like(b_red))
        dc = torch.linalg.solve_ex(S, b_red)[0].reshape(K, 6)
        # back-substitute points
        Etd = torch.einsum("pal,a->pl", E, dc.reshape(-1))
        dp = (Hpp_inv @ (bp - Etd)[..., None])[..., 0]
        dp = torch.where(has_pt[:, None], dp, torch.zeros_like(dp))

        kp_new = torch.where(free_kf[:, None, None], se3.exp(dc) @ kp, kp)
        pp_new = torch.where(prob.pt_valid[:, None], pp + dp, pp)
        return kp_new, pp_new, S

    # initial lambda from the max diagonal (g2o tau * max diag)
    Jc0 = _residuals(kf_pose, pt_pos, prob, cam)[1]
    w0 = (act / prob.obs_sigma2)[:, None, None]
    diag_max = torch.clamp(torch.max(torch.sum(Jc0 * w0 * Jc0, dim=(1, 2))),
                           min=1.0)
    lam = lam0_scale * diag_max
    kp, pp = kf_pose, pt_pos
    best = robust_chi2(kp, pp)
    for _ in range(n_iters):
        kp_new, pp_new, _ = build_and_solve(kp, pp, lam)
        new_chi2 = robust_chi2(kp_new, pp_new)
        improved = new_chi2 < best
        kp = torch.where(improved, kp_new, kp)
        pp = torch.where(improved, pp_new, pp)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
        best = torch.minimum(new_chi2, best)
    # final S at lambda 0 for the covariance
    S_final = build_and_solve(kp, pp, torch.zeros_like(lam))[2]
    return kp, pp, best, S_final


def local_bundle_adjustment(prob: BAProblem, newest: int,
                            cam: CameraParams) -> BAResult:
    """Two-stage local BA (ref: Optimizer.cc:763-820): 5 Huber
    iterations, chi2 outlier demotion (+ positive depth), 10 more
    iterations without the demoted observations, final classification,
    and keyframe ``newest``'s marginal covariance (ref:
    Optimizer.cc:876-912)."""
    active0 = prob.obs_valid
    kp1, pp1, _, _ = _lm_round(prob.kf_pose, prob.pt_pos, prob, active0, cam,
                               use_huber=True, n_iters=5)
    r1, _, _, z1 = _residuals(kp1, pp1, prob, cam)
    th = torch.where(prob.obs_is_stereo, CHI2_STEREO, CHI2_MONO)
    active1 = active0 & (_chi2(r1, prob) <= th) & (z1 > 0)

    kp2, pp2, chi2_total, S = _lm_round(kp1, pp1, prob, active1, cam,
                                        use_huber=False, n_iters=10)
    r2, _, _, z2 = _residuals(kp2, pp2, prob, cam)
    inlier = prob.obs_valid & (_chi2(r2, prob) <= th) & (z2 > 0)

    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    Sinv = torch.linalg.inv_ex(S + 1e-9 * eye)[0]
    i0 = newest * 6
    return BAResult(kf_pose=kp2, pt_pos=pp2, obs_inlier=inlier,
                    newest_cov=Sinv[i0:i0 + 6, i0:i0 + 6],
                    chi2=chi2_total)


def global_bundle_adjustment(prob: BAProblem, cam: CameraParams,
                             iterations: int = 10) -> BAResult:
    """Full-map BA (ref: Optimizer.cc:39-271 GlobalBundleAdjustment via
    LoopClosing::RunGlobalBundleAdjustment): ``iterations`` LM steps with
    the robust kernel off, then the final inlier classification. Its
    size is bounded by the dense (P, K, 6, 3) cross blocks: the loop
    closer takes ``gba_cg`` beyond 64 keyframes, 8192 points or 24576
    observations."""
    kp, pp, chi2_total, S = _lm_round(prob.kf_pose, prob.pt_pos, prob,
                                      prob.obs_valid, cam, use_huber=False,
                                      n_iters=iterations)
    r, _, _, z = _residuals(kp, pp, prob, cam)
    th = torch.where(prob.obs_is_stereo, CHI2_STEREO, CHI2_MONO)
    inlier = prob.obs_valid & (_chi2(r, prob) <= th) & (z > 0)
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    Sinv = torch.linalg.inv_ex(S + 1e-9 * eye)[0]
    return BAResult(kf_pose=kp, pt_pos=pp, obs_inlier=inlier,
                    newest_cov=Sinv[:6, :6], chi2=chi2_total)
