"""Full-map bundle adjustment by matrix-free PCG (port of
``sivo_tpu/optim/gba_cg.py``; ref: Optimizer.cc:39-271, run from
LoopClosing.cc:663-765).

The same damped reduced camera system as the dense Schur solver of
``local_ba``, solved without forming S: block-Jacobi-preconditioned
conjugate gradients whose S v products are three O(n_obs) gather /
``index_add_`` passes,

    S v = (Hcc + lam I) v - E Hpp^-1 E^T v
    (E^T v)_p = sum_{o in p} Jp_o^T W_o (Jc_o v_k(o))
    (E z)_k  = sum_{o in k} Jc_o^T W_o (Jp_o z_p(o)),

so memory is O(n_obs) and no K^2 buffer exists. A fixed CG budget
makes each LM step inexact; the LM accept/reject (chi2 decrease) guards
it. The loop closer paces the solve one LM iteration per poll
(``gba_cg_begin`` / ``gba_cg_step`` / ``gba_cg_finish``). Every step is
device tensors only: no host sync. float32 with TF32 off.
"""

from __future__ import annotations

import torch

from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams
from sivo_tpu_torch.optim.local_ba import (
    CHI2_MONO, CHI2_STEREO, BAProblem, BAResult, _chi2, _residuals)


def _chi2_total(kp, pp, prob: BAProblem, cam: CameraParams) -> torch.Tensor:
    """Total chi2 over the valid observations (the robust kernel is off,
    ref: Optimizer.cc:667 via RunGlobalBundleAdjustment)."""
    chi2 = _chi2(_residuals(kp, pp, prob, cam)[0], prob)
    return torch.sum(torch.where(prob.obs_valid, chi2,
                                 torch.zeros_like(chi2)))


def _solve_step(kp, pp, lam, prob: BAProblem, cam: CameraParams,
                cg_iters: int):
    """One damped Gauss-Newton step by PCG on the implicit Schur
    complement; returns the candidate (kf_pose, pt_pos)."""
    K, P = prob.kf_pose.shape[0], prob.pt_pos.shape[0]
    dev, dt = kp.device, kp.dtype
    free_kf = prob.kf_valid & ~prob.kf_fixed
    okf, opt = prob.obs_kf.long(), prob.obs_pt.long()
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    r, Jc, Jp, _ = _residuals(kp, pp, prob, cam)
    row_mask = torch.cat([torch.ones((r.shape[0], 2), dtype=dt, device=dev),
                          prob.obs_is_stereo[:, None].to(dt)], dim=-1)
    w = (prob.obs_valid.to(dt) / prob.obs_sigma2)[:, None] * row_mask
    Jc_w = Jc * w[..., None]
    Jp_w = Jp * w[..., None]
    Jc_wT, Jp_wT = Jc_w.transpose(-1, -2), Jp_w.transpose(-1, -2)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    Hcc = zeros(K, 6, 6).index_add_(0, okf, Jc_wT @ Jc)
    Hpp = zeros(P, 3, 3).index_add_(0, opt, Jp_wT @ Jp)
    bc = zeros(K, 6).index_add_(0, okf, -(Jc_wT @ r[..., None])[..., 0])
    bp = zeros(P, 3).index_add_(0, opt, -(Jp_wT @ r[..., None])[..., 0])
    has_pt = (zeros(P).index_add_(0, opt, prob.obs_valid.to(dt)) > 0
              ) & prob.pt_valid
    Hpp_d = torch.where(has_pt[:, None, None], Hpp + (lam + 1e-9) * eye3,
                        eye3)
    Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]
    JpT = Jp.transpose(-1, -2)

    def EtV(v):  # (K, 6) -> (P, 3)
        a = (Jc_w @ v[okf][..., None])[..., 0]  # W Jc v_k
        return zeros(P, 3).index_add_(0, opt, (JpT @ a[..., None])[..., 0])

    def EZ(z):  # (P, 3) -> (K, 6)
        a = (Jp @ z[opt][..., None])[..., 0]  # Jp z_p
        return zeros(K, 6).index_add_(0, okf, (Jc_wT @ a[..., None])[..., 0])

    free6 = free_kf[:, None]

    def S_mul(v):
        v = torch.where(free6, v, torch.zeros_like(v))
        hv = (Hcc @ v[..., None])[..., 0] + lam * v
        out = hv - EZ((Hpp_inv @ EtV(v)[..., None])[..., 0])
        return torch.where(free6, out, v)  # identity rows: fixed cameras

    def precond(v):
        return (Minv @ v[..., None])[..., 0]

    b_red = torch.where(free6, bc - EZ((Hpp_inv @ bp[..., None])[..., 0]),
                        torch.zeros_like(bc))
    # block-Jacobi preconditioner: the exact diagonal blocks of S
    # (one observation per (point, keyframe) pair)
    M = Jc_wT @ Jp  # (O, 6, 3)
    diag_red = zeros(K, 6, 6).index_add_(
        0, okf, M @ Hpp_inv[opt] @ M.transpose(-1, -2))
    S_kk = torch.where(free_kf[:, None, None],
                       Hcc + lam * eye6 - diag_red + 1e-9 * eye6, eye6)
    Minv = torch.linalg.inv_ex(S_kk)[0]

    x = torch.zeros_like(b_red)
    res = b_red
    z = precond(res)
    p = z
    rz = torch.sum(res * z)
    for _ in range(cg_iters):
        Sp = S_mul(p)
        pSp = torch.sum(p * Sp)
        alpha = torch.where(pSp > 0, rz / torch.clamp(pSp, min=1e-30),
                            torch.zeros_like(pSp))
        x = x + alpha * p
        res = res - alpha * Sp
        z = precond(res)
        rz_new = torch.sum(res * z)
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
    dc = torch.where(free6, x, torch.zeros_like(x))
    dp = (Hpp_inv @ (bp - EtV(dc))[..., None])[..., 0]
    dp = torch.where(has_pt[:, None], dp, torch.zeros_like(dp))
    kp_new = torch.where(free_kf[:, None, None], se3.exp(dc) @ kp, kp)
    pp_new = torch.where(prob.pt_valid[:, None], pp + dp, pp)
    return kp_new, pp_new


def gba_cg_begin(prob: BAProblem, cam: CameraParams):
    """The initial (kf_pose, pt_pos, lam, best chi2) carry: lam from the
    largest camera diagonal (g2o tau * max diag)."""
    Jc0 = _residuals(prob.kf_pose, prob.pt_pos, prob, cam)[1]
    w0 = (prob.obs_valid / prob.obs_sigma2)[:, None, None]
    diag_max = torch.clamp(torch.max(torch.sum(Jc0 * w0 * Jc0, dim=(1, 2))),
                           min=1.0)
    return (prob.kf_pose, prob.pt_pos, 1e-5 * diag_max,
            _chi2_total(prob.kf_pose, prob.pt_pos, prob, cam))


def gba_cg_step(carry, prob: BAProblem, cam: CameraParams,
                cg_iters: int = 48):
    """One LM iteration (inexact Newton by PCG), accepted if chi2 falls."""
    kp, pp, lam, best = carry
    kp_new, pp_new = _solve_step(kp, pp, lam, prob, cam, cg_iters)
    new_chi2 = _chi2_total(kp_new, pp_new, prob, cam)
    improved = new_chi2 < best
    return (torch.where(improved, kp_new, kp),
            torch.where(improved, pp_new, pp),
            torch.where(improved, lam * 0.5, lam * 4.0),
            torch.minimum(new_chi2, best))


def gba_cg_finish(carry, prob: BAProblem, cam: CameraParams) -> BAResult:
    """The final inlier classification (the loop closer applies poses,
    points and inliers, ref: LoopClosing.cc:683-765)."""
    kp, pp, _, best = carry
    r, _, _, z = _residuals(kp, pp, prob, cam)
    th = torch.where(prob.obs_is_stereo, CHI2_STEREO, CHI2_MONO)
    inlier = prob.obs_valid & (_chi2(r, prob) <= th) & (z > 0)
    return BAResult(kf_pose=kp, pt_pos=pp, obs_inlier=inlier,
                    newest_cov=torch.eye(6, dtype=kp.dtype, device=kp.device),
                    chi2=best)
