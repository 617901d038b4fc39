"""Bundle adjustment with the points sharded over the ranks of a
``torch.distributed`` process group (port of
``sivo_tpu/parallel/sharded_ba.py``).

Each rank owns a slice of the points and their observations, builds its
partial camera Hessian and its partial Schur complement, and one
``all_reduce`` (SUM) of a single flat buffer per LM iteration gives every
rank the reduced camera system, which each solves redundantly (it is
6K x 6K) before back-substituting its own points: the "points
partitioned per device, Schur reduction as a psum" design of the JAX
package's ``shard_map`` over mesh axis "ba". Cameras are replicated; the
per-iteration communication is (6K)^2 + 48K floats and one χ² scalar,
whatever the point count.

The solver is the JAX package's sharded one, which differs from the
single-device ``local_ba._lm_round``: λ starts at 1e-4, ``λ + 1e-9``
damps the point blocks and ``λ`` the camera diagonal, the accept test
reads the plain χ² even under Huber, ``newest_cov`` comes from the last
iteration's S (λ included) and the final χ² sums the inliers only. The
accept step is a ``torch.where`` on device tensors and the solves use
the ``_ex`` forms, so a solve has no host sync beyond what the backend's
collectives make.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams
from sivo_tpu_torch.optim.local_ba import (
    BAProblem,
    BAResult,
    CHI2_MONO,
    CHI2_STEREO,
    _chi2,
    _huber,
    _residuals,
)
from sivo_tpu_torch.parallel import ranks

LAMBDA0 = 1e-4


def partition_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Reorder the observations by point shard so that shard ``s``'s
    slots ``[s * O_loc, (s + 1) * O_loc)`` reference only its points
    ``[s * P_loc, (s + 1) * P_loc)`` (points keep their positions). A
    shard's observations beyond ``O_loc`` are dropped, as in the JAX
    package: spread the valid points over the shards first."""
    P_total = prob.pt_pos.shape[0]
    O_total = prob.obs_kf.shape[0]
    if P_total % n_shards or O_total % n_shards:
        raise ValueError(f"point and observation caps ({P_total}, "
                         f"{O_total}) must divide by {n_shards} shards")
    P_loc = P_total // n_shards
    O_loc = O_total // n_shards

    obs_pt = prob.obs_pt.cpu().numpy()
    obs_ok = prob.obs_valid.cpu().numpy()
    # slot indices: shard s's observations occupy [s*O_loc, (s+1)*O_loc)
    perm = np.zeros(O_total, np.int64)  # destination slot -> source obs
    valid_out = np.zeros(O_total, bool)
    for s in range(n_shards):
        src = np.where(
            obs_ok
            & (obs_pt >= s * P_loc)
            & (obs_pt < (s + 1) * P_loc)
        )[0]
        n = min(len(src), O_loc)  # overflow beyond O_loc is dropped
        dst = s * O_loc
        perm[dst: dst + n] = src[:n]
        valid_out[dst: dst + n] = True

    dev = prob.obs_kf.device
    idx = torch.from_numpy(perm).to(dev)

    def take_obs(x):
        return x[idx]

    return prob._replace(
        obs_kf=take_obs(prob.obs_kf),
        obs_pt=take_obs(prob.obs_pt),
        obs_uvr=take_obs(prob.obs_uvr),
        obs_sigma2=take_obs(prob.obs_sigma2),
        obs_is_stereo=take_obs(prob.obs_is_stereo),
        obs_valid=torch.from_numpy(valid_out).to(dev),
    )


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' slices of ``x`` concatenated in rank order (bools
    travel as uint8)."""
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts).to(x.dtype)


def sharded_bundle_adjustment(
    prob: BAProblem,
    cam: CameraParams,
    group=None,
    iterations: int = 10,
    use_huber: bool = False,
) -> BAResult:
    """BA with the points and observations split over the ranks of
    ``group`` (None: the default group), ``iterations`` LM steps.

    Every rank is given the whole problem, pre-partitioned with
    ``partition_problem`` for the group's size, and works on its own
    slice: rank ``r`` owns points ``[r * P_loc, (r + 1) * P_loc)`` and
    observations ``[r * O_loc, (r + 1) * O_loc)``. Every rank returns
    the global ``BAResult``: poses, covariance and χ² are replicated,
    the points and the inlier flags are gathered.
    """
    if not dist.is_initialized():
        raise RuntimeError("sharded_bundle_adjustment needs an initialized "
                           "torch.distributed process group")
    if iterations < 1:
        raise ValueError("iterations must be at least 1")
    n_shards = dist.get_world_size(group)
    rank = dist.get_rank(group)
    K = prob.kf_pose.shape[0]
    P_total = prob.pt_pos.shape[0]
    O_total = prob.obs_kf.shape[0]
    if P_total % n_shards or O_total % n_shards:
        raise ValueError(f"point and observation caps ({P_total}, "
                         f"{O_total}) must divide by {n_shards} ranks")
    P_loc = P_total // n_shards
    O_loc = O_total // n_shards
    pts = slice(rank * P_loc, (rank + 1) * P_loc)
    obs = slice(rank * O_loc, (rank + 1) * O_loc)
    obs_valid = prob.obs_valid[obs]
    # local point indices; padding slots point at local point 0 (their
    # weight is 0)
    obs_pt = torch.where(obs_valid, prob.obs_pt[obs].long() - rank * P_loc,
                         torch.zeros_like(prob.obs_pt[obs], dtype=torch.long))
    loc = BAProblem(
        kf_pose=prob.kf_pose, kf_fixed=prob.kf_fixed,
        kf_valid=prob.kf_valid, pt_pos=prob.pt_pos[pts],
        pt_valid=prob.pt_valid[pts], obs_kf=prob.obs_kf[obs].long(),
        obs_pt=obs_pt, obs_uvr=prob.obs_uvr[obs],
        obs_sigma2=prob.obs_sigma2[obs],
        obs_is_stereo=prob.obs_is_stereo[obs], obs_valid=obs_valid)

    dev, dt = prob.kf_pose.device, prob.kf_pose.dtype
    free_kf = prob.kf_valid & ~prob.kf_fixed
    free6 = free_kf.repeat_interleave(6)
    mask2d = free6[:, None] & free6[None, :]
    gauge_diag = torch.diag((~free6).to(dt))
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eyeK = torch.eye(K, dtype=dt, device=dev)
    obs_kf = loc.obs_kf
    obs_pk = obs_pt * K + obs_kf  # row of the flattened (P_loc * K) E
    act = obs_valid.to(dt)
    has_pt = (torch.zeros(P_loc, dtype=dt, device=dev).index_add_(
        0, obs_pt, act) > 0) & loc.pt_valid
    row_mask = torch.cat([
        torch.ones((O_loc, 2), dtype=dt, device=dev),
        loc.obs_is_stereo[:, None].to(dt)], dim=-1)
    sizes = (K * 36, K * 6, 36 * K * K, 6 * K)  # Hcc, bc, S_part, b_part

    def chi2_sum(kp, pp):
        """The global plain χ² over the valid observations."""
        c = _chi2(_residuals(kp, pp, loc, cam)[0], loc)
        return _all_sum(torch.sum(torch.where(obs_valid, c,
                                              torch.zeros_like(c)))[None],
                        group)[0]

    def build_and_solve(kp, pp, lam):
        r, Jc, Jp, _ = _residuals(kp, pp, loc, cam)
        if use_huber:
            wh = _huber(_chi2(r, loc), loc)[1]
        else:
            wh = torch.ones_like(act)
        w = (act * wh / loc.obs_sigma2)[:, None] * row_mask  # (O_loc, 3)
        Jc_wT = (Jc * w[..., None]).transpose(-1, -2)
        Jp_wT = (Jp * w[..., None]).transpose(-1, -2)
        # partial camera blocks and this rank's points
        Hcc = torch.zeros((K, 6, 6), dtype=dt, device=dev).index_add_(
            0, obs_kf, Jc_wT @ Jc)
        bc = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(
            0, obs_kf, -(Jc_wT @ r[..., None])[..., 0])
        Hpp = torch.zeros((P_loc, 3, 3), dtype=dt, device=dev).index_add_(
            0, obs_pt, Jp_wT @ Jp)
        bp = torch.zeros((P_loc, 3), dtype=dt, device=dev).index_add_(
            0, obs_pt, -(Jp_wT @ r[..., None])[..., 0])
        E = torch.zeros((P_loc * K, 6, 3), dtype=dt, device=dev).index_add_(
            0, obs_pk, Jc_wT @ Jp).reshape(P_loc, K * 6, 3)
        Hpp_d = torch.where(has_pt[:, None, None],
                            Hpp + (lam + 1e-9) * eye3, eye3)
        Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]
        G = E @ Hpp_inv  # (P_loc, 6K, 3)
        S_part = (G.permute(1, 0, 2).reshape(K * 6, P_loc * 3)
                  @ E.permute(1, 0, 2).reshape(K * 6, P_loc * 3).T)
        b_part = torch.einsum("pal,pl->a", G, bp)

        # ONE collective: the reduced camera system
        buf = _all_sum(torch.cat([Hcc.reshape(-1), bc.reshape(-1),
                                  S_part.reshape(-1), b_part]), group)
        Hcc, bc, S_red, b_sub = torch.split(buf, sizes)
        Hcc_d = Hcc.reshape(K, 6, 6) + lam * eye6
        diag = eyeK[:, None, :, None] * Hcc_d[:, :, None, :]  # (K,6,K,6)
        S = diag.reshape(K * 6, K * 6) - S_red.reshape(K * 6, K * 6)
        S = torch.where(mask2d, S, torch.zeros_like(S)) + gauge_diag
        b_red = torch.where(free6, bc - b_sub, torch.zeros_like(bc))
        dc = torch.linalg.solve_ex(S, b_red)[0].reshape(K, 6)

        Etd = torch.einsum("pal,a->pl", E, dc.reshape(-1))
        dp = (Hpp_inv @ (bp - Etd)[..., None])[..., 0]
        dp = torch.where(has_pt[:, None], dp, torch.zeros_like(dp))
        kp_new = torch.where(free_kf[:, None, None], se3.exp(dc) @ kp, kp)
        return kp_new, pp + dp, S

    kp, pp = prob.kf_pose, loc.pt_pos
    best = chi2_sum(kp, pp)
    lam = torch.full((), LAMBDA0, dtype=dt, device=dev)
    for _ in range(iterations):
        kp_new, pp_new, S = build_and_solve(kp, pp, lam)
        new_chi2 = chi2_sum(kp_new, pp_new)
        improved = new_chi2 < best
        kp = torch.where(improved, kp_new, kp)
        pp = torch.where(improved, pp_new, pp)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
        best = torch.minimum(new_chi2, best)

    # final classification and the first keyframe's covariance
    r, _, _, z = _residuals(kp, pp, loc, cam)
    chi2 = _chi2(r, loc)
    th = torch.where(loc.obs_is_stereo, CHI2_STEREO, CHI2_MONO)
    inlier = obs_valid & (chi2 <= th) & (z > 0)
    eye = torch.eye(K * 6, dtype=dt, device=dev)
    cov = torch.linalg.inv_ex(S + 1e-9 * eye)[0][:6, :6]
    total = _all_sum(torch.sum(torch.where(inlier, chi2,
                                           torch.zeros_like(chi2)))[None],
                     group)[0]
    return BAResult(kf_pose=kp, pt_pos=_all_gather(pp, group),
                    obs_inlier=_all_gather(inlier, group),
                    newest_cov=cov, chi2=total)


def _solve_rank(rank: int, device: torch.device, path: str,
                cam: CameraParams, iterations: int,
                use_huber: bool) -> dict:
    prob = BAProblem(*(t.to(device) for t in torch.load(path)))
    res = sharded_bundle_adjustment(prob, cam, iterations=iterations,
                                    use_huber=use_huber)
    return {k: v.cpu() for k, v in res._asdict().items()}


def solve_on_ranks(prob: BAProblem, cam: CameraParams, n_ranks: int,
                   work_dir: str, *, backend: str,
                   devices: Sequence[str | torch.device],
                   iterations: int = 10,
                   use_huber: bool = False) -> list[BAResult]:
    """``sharded_bundle_adjustment`` on ``n_ranks`` spawned ranks
    (``parallel.ranks.spawn``): ``prob``, partitioned for ``n_ranks``,
    goes to them as ``work_dir/sharded_ba_problem.pt``. Returns every
    rank's result (CPU tensors), in rank order."""
    path = os.path.join(work_dir, "sharded_ba_problem.pt")
    torch.save(tuple(t.cpu() for t in prob), path)
    out = ranks.spawn(_solve_rank, n_ranks,
                      (path, cam, iterations, use_huber),
                      backend=backend, devices=devices)
    return [BAResult(**o) for o in out]
