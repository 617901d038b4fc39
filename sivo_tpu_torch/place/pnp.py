"""EPnP + batched RANSAC (port of ``sivo_tpu/place/pnp.py``).

On the per-frame path this is the prediction-free seed of the
reference-keyframe anchor in ``runtime/track_step.py``. All hypotheses
run as one batch: minimal sets -> EPnP (control points, barycentric
coordinates, the 12x12 M^T M eigenvectors, the reference's three beta
cases each refined by 5 Gauss-Newton steps, least-reprojection-error
case selection, absolute orientation) -> chi2 inlier counts -> the best
hypothesis, polished by the pose LM on its inliers (ref: PnPsolver.cc).

Minimal sets are drawn by Gumbel top-k from an explicit
``torch.Generator`` (``draw_sets``); they cannot equal the JAX
package's draws, which come from ``jax.random``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sivo_tpu_torch.geometry.projection import CameraParams, project
from sivo_tpu_torch.optim import pose_lm
from sivo_tpu_torch.utils.consts import device_const

MIN_SET = 6  # points per hypothesis


class RansacResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) best Tcw
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def _kabsch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Batched absolute orientation: R, t minimizing ||R src + t - dst||
    (Horn via SVD). src/dst: (..., M, 3). Returns (..., 4, 4)."""
    cs = src.mean(dim=-2, keepdim=True)
    cd = dst.mean(dim=-2, keepdim=True)
    H = (src - cs).transpose(-1, -2) @ (dst - cd)
    # a degenerate hypothesis gives a non-finite H, on which the CPU SVD
    # raises (the JAX package's returns NaN): it is solved as zeros and
    # its pose set to NaN, which the callers' finite checks discard
    finite = torch.isfinite(H).all(dim=-1).all(dim=-1)
    U, _, Vt = torch.linalg.svd(
        torch.where(finite[..., None, None], H, torch.zeros_like(H)))
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.zeros_like(H)
    D[..., 0, 0].fill_(1.0)  # fill_: a scalar setitem would copy from
    D[..., 1, 1].fill_(1.0)  # the host and synchronise
    D[..., 2, 2] = det
    R = V @ (D @ Ut)
    t = cd[..., 0, :] - (R @ cs[..., 0, :, None])[..., 0]
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)
    return torch.where(finite[..., None, None], T,
                       torch.full_like(T, float("nan")))


def _finite_or_zero(A: torch.Tensor) -> torch.Tensor:
    """The batch's matrices, each replaced by zeros if not finite."""
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    return torch.where(finite[..., None, None], A, torch.zeros_like(A))


def _solve_ls(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched least squares of a small (..., 6, k) system via ridge-
    stabilized normal equations."""
    At = A.transpose(-1, -2)
    AtA = At @ A
    Atb = (At @ b[..., None])[..., 0]
    k = AtA.shape[-1]
    eye = torch.eye(k, dtype=AtA.dtype, device=AtA.device)
    return torch.linalg.solve_ex(AtA + 1e-9 * eye, Atb[..., None])[0][..., 0]


def _cols(L: torch.Tensor, cols: tuple[int, ...]) -> torch.Tensor:
    """L[..., cols] with the index set kept on the device."""
    return L.index_select(-1, device_const(cols, torch.int64, L.device))


def _betas_approx_1(L, rho):
    """Case 1: betas10 ~ [b11, b12, b13, b14] (ref: PnPsolver.cc:669-702)."""
    x = _solve_ls(_cols(L, (0, 1, 3, 6)), rho)
    s = torch.where(x[..., 0] < 0, -1.0, 1.0)
    b1 = torch.sqrt(x[..., 0].abs())
    safe = torch.clamp(b1, min=1e-12)
    rest = s[..., None] * x[..., 1:] / safe[..., None]
    return torch.cat([b1[..., None], rest], dim=-1)


def _betas_approx_2(L, rho):
    """Case 2: betas10 ~ [b11, b12, b22] (ref: PnPsolver.cc:704-730)."""
    x = _solve_ls(_cols(L, (0, 1, 2)), rho)
    b11, b12, b22 = x[..., 0], x[..., 1], x[..., 2]
    b1 = torch.sqrt(b11.abs())
    b2 = torch.where((b22 > 0) == (b11 > 0), torch.sqrt(b22.abs()),
                     torch.zeros_like(b22))
    b1 = torch.where(b12 < 0, -b1, b1)
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, z, z], dim=-1)


def _betas_approx_3(L, rho):
    """Case 3: betas10 ~ [b11, b12, b22, b13, b23]
    (ref: PnPsolver.cc:732-763)."""
    x = _solve_ls(_cols(L, (0, 1, 2, 3, 4)), rho)
    b11, b12, b22, b13 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    b1 = torch.sqrt(b11.abs())
    b2 = torch.where((b22 > 0) == (b11 > 0), torch.sqrt(b22.abs()),
                     torch.zeros_like(b22))
    b1 = torch.where(b12 < 0, -b1, b1)
    safe = torch.where(b1.abs() < 1e-12, torch.full_like(b1, 1e-12), b1)
    b3 = b13 / safe
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, b3, z], dim=-1)


def _gn_betas_step(betas, L, rho):
    """One Gauss-Newton step on the 4 betas against the 6 distance
    constraints (ref: PnPsolver.cc:814-863)."""
    b1, b2, b3, b4 = (betas[..., i] for i in range(4))
    b10 = torch.stack([
        b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3,
        b1 * b4, b2 * b4, b3 * b4, b4 * b4,
    ], dim=-1)
    r = rho - torch.einsum("...pk,...k->...p", L, b10)

    def c(i):
        return L[..., i]

    def e(x):
        return x[..., None]

    J = torch.stack([
        2 * e(b1) * c(0) + e(b2) * c(1) + e(b3) * c(3) + e(b4) * c(6),
        e(b1) * c(1) + 2 * e(b2) * c(2) + e(b3) * c(4) + e(b4) * c(7),
        e(b1) * c(3) + e(b2) * c(4) + 2 * e(b3) * c(5) + e(b4) * c(8),
        e(b1) * c(6) + e(b2) * c(7) + e(b3) * c(8) + 2 * e(b4) * c(9),
    ], dim=-1)  # (..., 6, 4)
    return betas + _solve_ls(J, r)


def _epnp(pw: torch.Tensor, uv: torch.Tensor,
          cam: CameraParams) -> torch.Tensor:
    """Batched EPnP: (..., M, 3) world points + (..., M, 2) pixels ->
    (..., 4, 4) Tcw."""
    m = pw.shape[-2]
    dev = pw.device
    c0 = pw.mean(dim=-2)
    centered = pw - c0[..., None, :]
    cov = centered.transpose(-1, -2) @ centered / m
    # a set with a non-finite point makes eigh raise (the JAX package's
    # returns NaN): its matrices are solved as zeros, and its hypothesis
    # comes out NaN from _kabsch, which the callers' finite checks discard
    evals, evecs = torch.linalg.eigh(_finite_or_zero(cov))
    scale = torch.sqrt(torch.clamp(evals, min=1e-10))
    ctrl = torch.cat([
        c0[..., None, :],
        c0[..., None, :] + evecs.transpose(-1, -2) * scale[..., :, None],
    ], dim=-2)  # (..., 4, 3)

    cc = ctrl[..., 1:, :] - ctrl[..., :1, :]
    cc_inv = torch.linalg.inv_ex(cc.transpose(-1, -2))[0]
    a123 = centered @ cc_inv.transpose(-1, -2)  # (..., M, 3)
    a0 = 1.0 - a123.sum(dim=-1, keepdim=True)
    alphas = torch.cat([a0, a123], dim=-1)  # (..., M, 4)

    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros_like(alphas)
    row_u = torch.stack(
        [alphas * cam.fx, zero, alphas * (cam.cx - u)[..., None]], dim=-1
    ).reshape(*alphas.shape[:-1], 12)
    row_v = torch.stack(
        [zero, alphas * cam.fy, alphas * (cam.cy - v)[..., None]], dim=-1
    ).reshape(*alphas.shape[:-1], 12)
    Mm = torch.cat([row_u, row_v], dim=-2)  # (..., 2M, 12)
    MtM = Mm.transpose(-1, -2) @ Mm
    _, vecs = torch.linalg.eigh(_finite_or_zero(MtM))
    batch = MtM.shape[:-2]
    vk = vecs[..., :, :4].transpose(-1, -2).reshape(*batch, 4, 4, 3)

    ia = device_const((0, 0, 0, 1, 1, 2), torch.int64, dev)
    ib = device_const((1, 2, 3, 2, 3, 3), torch.int64, dev)
    dv = vk[..., ia, :] - vk[..., ib, :]  # (..., 4, 6, 3)
    dots = torch.einsum("...kpc,...lpc->...pkl", dv, dv)
    L = torch.stack([
        dots[..., 0, 0], 2 * dots[..., 0, 1], dots[..., 1, 1],
        2 * dots[..., 0, 2], 2 * dots[..., 1, 2], dots[..., 2, 2],
        2 * dots[..., 0, 3], 2 * dots[..., 1, 3], 2 * dots[..., 2, 3],
        dots[..., 3, 3],
    ], dim=-1)  # (..., 6, 10)
    rho = ((ctrl[..., ia, :] - ctrl[..., ib, :]) ** 2).sum(dim=-1)

    betas = torch.stack([
        _betas_approx_1(L, rho), _betas_approx_2(L, rho),
        _betas_approx_3(L, rho),
    ], dim=-2)  # (..., 3 cases, 4)
    Lc, rhoc = L[..., None, :, :], rho[..., None, :]
    for _ in range(5):
        betas = _gn_betas_step(betas, Lc, rhoc)

    cc_cam = torch.einsum("...ck,...kpj->...cpj", betas, vk)
    pc = alphas[..., None, :, :] @ cc_cam  # (..., 3, M, 3)
    flip = pc[..., 2].mean(dim=-1) < 0
    pc = torch.where(flip[..., None, None], -pc, pc)
    pw_b = pw[..., None, :, :].expand(pc.shape)
    poses = _kabsch(pw_b, pc)  # (..., 3, 4, 4)
    pred = project(cam, pw_b @ poses[..., :3, :3].transpose(-1, -2)
                   + poses[..., None, :3, 3])
    err = ((pred - uv[..., None, :, :]) ** 2).sum(dim=-1).sum(dim=-1)
    finite = torch.isfinite(poses.reshape(*poses.shape[:-2], 16)).all(-1)
    err = torch.where(finite, err, torch.full_like(err, float("inf")))
    best = torch.argmin(err, dim=-1)
    return torch.gather(
        poses, -3, best[..., None, None, None].expand(*best.shape, 1, 4, 4)
    )[..., 0, :, :]


def draw_sets(valid: torch.Tensor, generator: torch.Generator | None,
              n_hypotheses: int = 256) -> torch.Tensor:
    """(H, MIN_SET) minimal sets among the valid points, by Gumbel
    top-k."""
    u01 = torch.rand((n_hypotheses, valid.shape[0]), generator=generator,
                     device=valid.device)
    g = -torch.log(-torch.log(u01.clamp(1e-20, 1.0 - 1e-7)))  # Gumbel
    g = torch.where(valid[None, :], g, torch.full_like(g, float("-inf")))
    return torch.topk(g, MIN_SET, dim=1).indices


def ransac_pnp(
    pw: torch.Tensor,  # (N, 3) world points
    uv: torch.Tensor,  # (N, 2) measured pixels
    sigma2: torch.Tensor,  # (N,) per-point noise (level sigma^2)
    valid: torch.Tensor,  # (N,) bool
    generator: torch.Generator | None,
    cam: CameraParams,
    n_hypotheses: int = 256,
    min_inliers: int = 10,
    chi2_th: float = 5.991,
) -> RansacResult:
    """All-hypotheses-at-once RANSAC; inliers by the per-octave chi2
    radius (ref: PnPsolver.cc:131-270, :241-258)."""
    n = pw.shape[0]
    dev = pw.device
    sets = draw_sets(valid, generator, n_hypotheses)  # (H, MIN_SET)
    poses = _epnp(pw[sets], uv[sets], cam)  # (H, 4, 4)

    R, t = poses[:, :3, :3], poses[:, :3, 3]
    pc = torch.einsum("hij,nj->hni", R, pw) + t[:, None, :]
    err2 = ((project(cam, pc) - uv[None]) ** 2).sum(dim=-1)
    inl = ((err2 / sigma2[None]) < chi2_th) & (pc[..., 2] > 0) & valid[None]
    counts = inl.sum(dim=1)
    finite = torch.isfinite(poses.reshape(n_hypotheses, -1)).all(dim=1)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts)

    # polish: pose LM over the best hypothesis' inliers, mono residuals
    obs = pose_lm.PoseObservations(
        points=pw,
        uvr=torch.cat([uv, -torch.ones((n, 1), device=dev)], dim=-1),
        sigma2=sigma2,
        is_stereo=torch.zeros(n, dtype=torch.bool, device=dev),
        valid=inl.index_select(0, best[None])[0],
    )
    best_pose = poses.index_select(0, best[None])[0]
    res = pose_lm.optimize_pose(best_pose, obs, cam, rounds=2,
                                iterations=5)
    n_in = res.inliers.sum()
    return RansacResult(pose=res.pose, inliers=res.inliers,
                        n_inliers=n_in.to(torch.int32),
                        ok=n_in >= min_inliers)
