"""Two-view triangulation of new map points (port of
``sivo_tpu/ops/triangulation.py``; ref: LocalMapping.cc:198-472
CreateNewMapPoints and ORBmatcher.cc:631 SearchForTriangulation).

For the new keyframe against each of B covisible neighbours at once:
unassigned keypoints are matched under the epipolar constraint (masked
Hamming matrix + point-to-line distance), every match is triangulated by
a batched DLT SVD, and the reference's acceptance cascade runs
(parallax, positive depth in both views, chi-squared reprojection in
both views, scale consistency) with the SIVO semantic gate (classes
agree and static, confidence above threshold, entropy reduction under
the keyframe covariance; ref: LocalMapping.cc:448-452, 474-545).

The Hamming matrix is a float32 matmul of the unpacked 0/1 bits (exact
with TF32 off, as ``utils/precision.py`` sets it), as the JAX package
computes it outside any Pallas kernel. The batched 4x4 SVD runs in
float32 and is the one host sync of a triangulation on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams, project_stereo
from sivo_tpu_torch.ops.orb import unpack_bits
from sivo_tpu_torch.select import info as info_ops
from sivo_tpu_torch.utils.consts import device_const

TH_LOW = 50.0


class TriangulationResult(NamedTuple):
    xw: torch.Tensor  # (B, N, 3) new point positions (world)
    kp1: torch.Tensor  # (B, N) keypoint slot in KF1
    kp2: torch.Tensor  # (B, N) keypoint slot in KF2 (matched)
    accepted: torch.Tensor  # (B, N) bool


def _intrinsics(cam: CameraParams, device: torch.device) -> torch.Tensor:
    return device_const(((cam.fx, 0.0, cam.cx), (0.0, cam.fy, cam.cy),
                         (0.0, 0.0, 1.0)), torch.float32, device)


def fundamental_matrix(T1w: torch.Tensor, T2w: torch.Tensor,
                       cam: CameraParams) -> torch.Tensor:
    """F12 from world->camera poses (ref: LocalMapping.cc:639-654
    ComputeF12); ``T2w`` may carry a leading batch dimension."""
    R1, t1 = T1w[:3, :3], T1w[:3, 3]
    R2, t2 = T2w[..., :3, :3], T2w[..., :3, 3]
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = t1 - (R12 @ t2[..., None])[..., 0]
    Kinv = torch.linalg.inv_ex(_intrinsics(cam, T1w.device))[0]
    return Kinv.T @ ((se3.hat(t12) @ R12) @ Kinv)


def _hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor
                    ) -> torch.Tensor:
    """(..., N, 256) x (..., M, 256) 0/1 float -> (..., N, M) distances."""
    dot = bits_a @ bits_b.transpose(-1, -2)
    na = bits_a.sum(-1)[..., :, None]
    nb = bits_b.sum(-1)[..., None, :]
    return na + nb - 2.0 * dot


def triangulate_neighbors(
    T1w, xy1, level1, desc1, free1, ur1, sem_class1, sem_conf1, sem_ent1,
    cov1,  # KF1 (the new keyframe); desc1 (N, 32) packed uint8
    T2w, xy2, level2, desc2, free2, sem_class2, nb_valid,  # (B, ...)
    th_confidence: float, th_entropy: float, cam: CameraParams,
    scale_factor: float = 1.2, n_levels: int = 8,
) -> TriangulationResult:
    """All B covisible neighbours at once (the JAX package's vmap over
    the pair program is a batch dimension here). ``ur1`` is unused, as
    in the JAX package."""
    del ur1
    dev = xy1.device
    B, N = xy2.shape[0], xy1.shape[0]
    scales = scale_factor ** torch.arange(n_levels, dtype=torch.float32,
                                          device=dev)
    sigma2_1 = scales[level1.long()] ** 2  # (N,)
    sigma2_2 = scales[level2.long()] ** 2  # (B, N)

    # epipolar search (the baseline check is the caller's)
    F12 = fundamental_matrix(T1w, T2w, cam)  # (B, 3, 3)
    d = _hamming_matrix(unpack_bits(desc1)[None], unpack_bits(desc2))
    ones1 = torch.ones((N, 1), device=dev)
    # epipolar line of kp1 in image 2, row-wise x1^T F12
    # (ref: ORBmatcher.cc CheckDistEpipolarLine)
    lines = torch.cat([xy1, ones1], dim=-1) @ F12  # (B, N, 3)
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    num = a * xy2[:, None, :, 0] + b * xy2[:, None, :, 1] + c
    den = a * a + b * b
    dsqr = num * num / torch.clamp(den, min=1e-12)
    # ref: ORBmatcher.cc:136-160 -- dsqr < 3.84 sigma2[octave2]
    epi_ok = dsqr < 3.84 * sigma2_2[:, None, :]
    ok = epi_ok & free1[None, :, None] & free2[:, None, :]
    d = torch.where(ok, d, torch.full_like(d, float("inf")))
    best_j = torch.argmin(d, dim=-1)  # (B, N), first index on ties
    best_d = torch.gather(d, -1, best_j[..., None])[..., 0]
    matched = best_d < TH_LOW  # ref: ORBmatcher.cc:689

    def take(x):  # (B, N, ...) gathered at best_j
        idx = best_j.reshape(best_j.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(best_j.shape + x.shape[2:]))

    xy2m = take(xy2)
    lvl2m = take(level2)
    sig2m = take(sigma2_2)

    # rays + parallax (ref: LocalMapping.cc:285-325)
    def rays(xy, R):
        xn = torch.stack([(xy[..., 0] - cam.cx) / cam.fx,
                          (xy[..., 1] - cam.cy) / cam.fy,
                          torch.ones_like(xy[..., 0])], dim=-1)
        return xn @ R  # world-frame ray (R^T xn)

    r1 = rays(xy1, T1w[:3, :3])[None]  # (1, N, 3)
    r2 = rays(xy2m, T2w[:, :3, :3])  # (B, N, 3)
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.sqrt(torch.sum(r1 * r1, dim=-1))
        * torch.sqrt(torch.sum(r2 * r2, dim=-1)), min=1e-12)
    parallax_ok = (cos_par > 0) & (cos_par < 0.9998)

    # DLT triangulation (ref: LocalMapping.cc:327-352)
    Kc = _intrinsics(cam, dev)
    P1 = Kc @ T1w[:3, :4]  # (3, 4)
    P2 = Kc @ T2w[:, :3, :4]  # (B, 3, 4)
    A = torch.stack([
        (xy1[:, 0, None] * P1[2] - P1[0]).expand(B, N, 4),
        (xy1[:, 1, None] * P1[2] - P1[1]).expand(B, N, 4),
        xy2m[..., 0, None] * P2[:, None, 2] - P2[:, None, 0],
        xy2m[..., 1, None] * P2[:, None, 2] - P2[:, None, 1],
    ], dim=2)  # (B, N, 4, 4)
    # float32 SVD (TF32 off): the null vector's error scales the depth
    Vh = torch.linalg.svd(A)[2]
    xh = Vh[..., 3, :]
    w = xh[..., 3]
    w = torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    xw = xh[..., :3] / w[..., None]

    # acceptance cascade (ref: LocalMapping.cc:354-447)
    xc1 = se3.transform(T1w, xw)
    xc2 = se3.transform(T2w[:, None], xw)
    z_ok = (xc1[..., 2] > 0) & (xc2[..., 2] > 0)
    p1 = project_stereo(cam, xc1)
    p2 = project_stereo(cam, xc2)
    e1 = torch.sum((p1[..., :2] - xy1) ** 2, dim=-1)
    e2 = torch.sum((p2[..., :2] - xy2m) ** 2, dim=-1)
    chi_ok = (e1 <= 5.991 * sigma2_1) & (e2 <= 5.991 * sig2m)
    # scale consistency (ref: :427-443)
    o1 = -(T1w[:3, :3].T @ T1w[:3, 3][:, None])[:, 0]
    o2 = -(T2w[:, :3, :3].transpose(-1, -2) @ T2w[:, :3, 3, None])[..., 0]
    d1 = torch.linalg.vector_norm(xw - o1, dim=-1)
    d2 = torch.linalg.vector_norm(xw - o2[:, None], dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-12)
    ratio_oct = scales[level1.long()] / scales[lvl2m.long()]
    rf = 1.5 * scale_factor
    scale_ok = (ratio_dist < ratio_oct * rf) & (ratio_dist > ratio_oct / rf)

    # SIVO semantic gate; the information Jacobian is evaluated at the
    # CAMERA-frame point (the JAX package's deliberate divergence from
    # LocalMapping.cc:506-513, see its module)
    cls2m = take(sem_class2)
    sem_ok = ((sem_class1 == cls2m) & (sem_class1 <= 8)
              & (sem_conf1 >= th_confidence))
    scores = info_ops.entropy_reduction_stereo(
        cov1, xc1, sigma2_1, sem_ent1, cam.fx, cam.fy, cam.bf / cam.fx)
    ent_ok = scores >= th_entropy

    accepted = (matched & parallax_ok & z_ok & chi_ok & scale_ok & sem_ok
                & ent_ok & free1 & nb_valid[:, None])
    return TriangulationResult(
        xw=xw,
        kp1=torch.arange(N, dtype=torch.int32, device=dev).expand(B, N),
        kp2=best_j.to(torch.int32),
        accepted=accepted,
    )
