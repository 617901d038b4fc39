"""Descriptor matching by masked Hamming search (port of
``sivo_tpu/ops/matching.py``).

Every search reduces to kernel K2 (``ops/kernel_match.py``): per source
row, the best and second-best Hamming distance over the destination
columns that pass a window / octave / right-u mask. Descriptors are
packed (N, 32) uint8.

Constants (ref: ORBmatcher.cc:37-39): TH_HIGH=100, TH_LOW=50,
HISTO_LENGTH=30; rotation consistency keeps the top-3 histogram bins.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sivo_tpu_torch.ops import kernel_match
from sivo_tpu_torch.ops.orb import top_k_stable

TH_HIGH = 100.0
TH_LOW = 50.0
HISTO_LENGTH = 30


def _top2_masked(
    a_u8, b_u8, u, v, ur, radius, lvl_lo, lvl_hi, r_valid,
    x, y, c_ur, c_level, c_valid, use_ur: bool,
):
    """Best/second-best masked Hamming per row: kernel K2 on every CUDA
    tensor, whatever the shapes (the kernel handles ragged N and M)."""
    row = kernel_match.pack_row_attr(u, v, ur, radius, lvl_lo, lvl_hi,
                                     r_valid)
    col = kernel_match.pack_col_attr_t(x, y, c_ur, c_level, c_valid)
    return kernel_match.masked_hamming_top2(
        a_u8.contiguous(), b_u8.contiguous(), row, col, use_ur=use_ur
    )


class MatchResult(NamedTuple):
    """src -> dst assignment after conflict resolution."""

    dst_for_src: torch.Tensor  # (Ns,) int32 index into dst, -1 = none
    src_for_dst: torch.Tensor  # (Nd,) int32 index into src, -1 = none
    n_matches: torch.Tensor  # () int32


def rotation_consistency_mask(angle_src: torch.Tensor,
                              angle_dst: torch.Tensor,
                              matched: torch.Tensor) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 most popular
    of 30 bins (ref: ORBmatcher.cc:1545-1580)."""
    rot = (angle_src - angle_dst) * (180.0 / math.pi)
    rot = torch.where(rot < 0.0, rot + 360.0, rot)
    bins = torch.clamp(
        torch.round(rot * (HISTO_LENGTH / 360.0)).to(torch.int32),
        0, HISTO_LENGTH,
    ) % HISTO_LENGTH
    bins = bins.long()
    hist = torch.zeros(HISTO_LENGTH, device=matched.device)
    hist = hist.index_add(0, bins, matched.float())
    top3_val, top3_idx = top_k_stable(hist, 3)
    keep_top = torch.cat([
        torch.ones(1, dtype=torch.bool, device=matched.device),
        top3_val[1:] >= 0.1 * top3_val[0],  # ref: drop bins 2/3 below 10%
    ])
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool,
                           device=matched.device).scatter(0, top3_idx,
                                                          keep_top)
    return matched & keep_bin[bins]


def _resolve(best_d: torch.Tensor, best_j: torch.Tensor,
             matched: torch.Tensor, nd: int) -> MatchResult:
    """Resolve dst-side conflicts: when several src rows picked the same
    dst, the smallest distance wins, ties to the lowest src index. Two
    segment-min scatters (``scatter_reduce(..., "amin")``)."""
    ns = best_d.shape[0]
    dev = best_d.device
    col = torch.where(matched, best_j.long(),
                      torch.full_like(best_j, nd, dtype=torch.long))
    dval = torch.where(matched, best_d, torch.full_like(best_d, float("inf")))
    dmin = torch.full((nd + 1,), float("inf"), device=dev).scatter_reduce(
        0, col, dval, "amin", include_self=True)
    idx = torch.arange(ns, device=dev)
    is_min = matched & (dval == dmin[col])
    imin = torch.full((nd + 1,), ns, device=dev).scatter_reduce(
        0, col, torch.where(is_min, idx, torch.full_like(idx, ns)), "amin",
        include_self=True)
    won = is_min & (imin[col] == idx)
    dst_has = torch.isfinite(dmin[:nd])
    minus1 = torch.full_like(best_j, -1)
    return MatchResult(
        dst_for_src=torch.where(won, best_j, minus1).to(torch.int32),
        src_for_dst=torch.where(dst_has, imin[:nd],
                                torch.full_like(imin[:nd], -1)
                                ).to(torch.int32),
        n_matches=torch.sum(won).to(torch.int32),
    )


def search_by_projection_frame(
    prev_desc: torch.Tensor,  # (Np, 32) uint8 prev-frame descriptors
    prev_has_point: torch.Tensor,  # (Np,) bool
    prev_level: torch.Tensor,  # (Np,) int32
    prev_angle: torch.Tensor,  # (Np,) radians
    proj_uvr: torch.Tensor,  # (Np, 3) map points projected into current
    proj_z: torch.Tensor,  # (Np,) camera-frame z
    cur_xy: torch.Tensor,  # (Nc, 2)
    cur_level: torch.Tensor,
    cur_angle: torch.Tensor,
    cur_desc: torch.Tensor,  # (Nc, 32) uint8
    cur_ur: torch.Tensor,  # (Nc,) right-u or -1
    cur_valid: torch.Tensor,
    scales: torch.Tensor,  # (L,) scale factors
    th: float,
    forward: torch.Tensor,  # () bool: tlc.z > baseline
    backward: torch.Tensor,  # () bool: -tlc.z > baseline
    check_rotation: bool = True,
) -> MatchResult:
    """Motion-model frame-to-frame search (ref: ORBmatcher.cc:1278-1417)."""
    lvl_p = prev_level.float()
    big = torch.full_like(lvl_p, 1e9)
    lvl_lo = torch.where(forward, lvl_p,
                         torch.where(backward, -big, lvl_p - 1.0))
    lvl_hi = torch.where(forward, big,
                         torch.where(backward, lvl_p, lvl_p + 1.0))
    best_d, _, best_j, _ = _top2_masked(
        prev_desc, cur_desc,
        proj_uvr[:, 0], proj_uvr[:, 1], proj_uvr[:, 2],
        th * scales[prev_level.long()], lvl_lo, lvl_hi,
        prev_has_point & (proj_z > 0),
        cur_xy[:, 0], cur_xy[:, 1], cur_ur, cur_level.float(), cur_valid,
        use_ur=True,  # stereo right-u agreement (ref: :1344-1350)
    )
    matched = best_d <= TH_HIGH
    if check_rotation:
        matched = rotation_consistency_mask(
            prev_angle, cur_angle[best_j.long()], matched
        )
    return _resolve(best_d, best_j, matched, cur_desc.shape[0])


def search_by_projection_points(
    pt_desc: torch.Tensor,  # (Np, 32) uint8 distinctive descriptors
    pt_visible: torch.Tensor,  # (Np,) frustum-check result
    pt_uvr: torch.Tensor,  # (Np, 3) predicted projection
    pt_level: torch.Tensor,  # (Np,) predicted octave
    pt_view_cos: torch.Tensor,  # (Np,)
    cur_xy: torch.Tensor,
    cur_level: torch.Tensor,
    cur_desc: torch.Tensor,
    cur_ur: torch.Tensor,
    cur_valid: torch.Tensor,
    scales: torch.Tensor,
    th: torch.Tensor | float = 1.0,
    nn_ratio: float = 0.8,
    accept_th: float = TH_HIGH,
) -> MatchResult:
    """Local-map-points-to-frame search (ref: ORBmatcher.cc:44-159):
    radius 2.5 if viewCos > 0.998 else 4.0, times th and the predicted
    level's scale; candidate levels [pred-1, pred]; the ratio test
    applies only when best and second are on the same level."""
    r = torch.where(pt_view_cos > 0.998, 2.5, 4.0) * th
    lvl_p = pt_level.float()
    best_d, second_d, best_j, second_j = _top2_masked(
        pt_desc, cur_desc,
        pt_uvr[:, 0], pt_uvr[:, 1], pt_uvr[:, 2],
        r * scales[pt_level.long()], lvl_p - 1.0, lvl_p, pt_visible,
        cur_xy[:, 0], cur_xy[:, 1], cur_ur, cur_level.float(), cur_valid,
        use_ur=True,
    )
    best_lvl = cur_level[best_j.long()]
    second_lvl = cur_level[second_j.long()]
    ratio_ok = (best_lvl != second_lvl) | (best_d <= nn_ratio * second_d)
    matched = (best_d <= accept_th) & ratio_ok
    return _resolve(best_d, best_j, matched, cur_desc.shape[0])


def search_by_sim3(
    g12_s: torch.Tensor,  # () scale
    g12_R: torch.Tensor,  # (3, 3)
    g12_t: torch.Tensor,  # (3,)
    pc1: torch.Tensor,  # (N1, 3) camera-1-frame positions of kp1 points
    has1: torch.Tensor,  # (N1,) bool kp1 has a map point
    xy1: torch.Tensor,
    level1: torch.Tensor,
    desc1: torch.Tensor,  # (N1, 32) uint8
    pc2: torch.Tensor,  # (N2, 3)
    has2: torch.Tensor,
    xy2: torch.Tensor,
    level2: torch.Tensor,
    desc2: torch.Tensor,
    scales: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    th: float = 7.5,  # ref: LoopClosing.cc:329
) -> torch.Tensor:
    """Guided Sim3 correspondence search (ref: ORBmatcher.cc:1055-1276
    SearchBySim3): each side's points are projected into the other
    camera through g12 / g12^-1 and matched by K2 in a window of
    ``th * scale`` at their level +-1 (no right-u test: ``ur`` is a zero
    column), best distance at most TH_HIGH; only MUTUAL agreements stay.
    Two K2 searches. Returns (N1,) int32: the kp2 index per kp1, or -1."""

    def directed(pa, has_a, level_a, desc_a, xy_b, level_b, desc_b,
                 has_b_kp, s, R, t):
        pb = s * (pa @ R.T) + t  # a-side points in b's camera
        z = torch.clamp(pb[..., 2], min=1e-9)
        u = fx * pb[..., 0] / z + cx
        v = fy * pb[..., 1] / z + cy
        lvl_a = level_a.float()
        zeros_a = torch.zeros_like(u)
        best_d, _, best, _ = _top2_masked(
            desc_a, desc_b, u, v, zeros_a,
            th * scales[level_a.long()], lvl_a - 1.0, lvl_a + 1.0,
            has_a & (pb[..., 2] > 0),
            xy_b[:, 0], xy_b[:, 1], torch.zeros_like(xy_b[:, 0]),
            level_b.float(), has_b_kp,
            use_ur=False,
        )
        return torch.where(best_d <= TH_HIGH, best, torch.full_like(best, -1))

    sinv = 1.0 / g12_s
    Rinv = g12_R.T
    tinv = -sinv * (Rinv @ g12_t)
    m21 = directed(  # kp2 -> kp1 via g12 (p1 = g12(p2))
        pc2, has2, level2, desc2, xy1, level1, desc1, has1,
        g12_s, g12_R, g12_t)
    m12 = directed(  # kp1 -> kp2 via g12^-1
        pc1, has1, level1, desc1, xy2, level2, desc2, has2,
        sinv, Rinv, tinv)
    # mutual agreement (ref: ORBmatcher.cc:1243-1270)
    idx = torch.arange(pc1.shape[0], device=pc1.device, dtype=torch.int32)
    back = m21[torch.clamp(m12, 0, m21.shape[0] - 1).long()]
    mutual = (m12 >= 0) & (back == idx)
    return torch.where(mutual, m12, torch.full_like(m12, -1)).to(torch.int32)


def search_brute_force(
    src_desc: torch.Tensor,
    src_valid: torch.Tensor,
    src_angle: torch.Tensor,
    dst_desc: torch.Tensor,
    dst_valid: torch.Tensor,
    dst_angle: torch.Tensor,
    nn_ratio: float = 0.7,
    check_rotation: bool = True,
) -> MatchResult:
    """Global descriptor matching with ratio + rotation checks (stands in
    for SearchByBoW, ref: ORBmatcher.cc:161-284)."""
    ns, nd = src_desc.shape[0], dst_desc.shape[0]
    dev = src_desc.device
    zeros_s = torch.zeros(ns, device=dev)
    zeros_d = torch.zeros(nd, device=dev)
    best_d, second_d, best_j, _ = _top2_masked(
        src_desc, dst_desc,
        zeros_s, zeros_s, zeros_s, torch.full((ns,), float("inf"), device=dev),
        torch.full((ns,), -1e9, device=dev), torch.full((ns,), 1e9, device=dev),
        src_valid,
        zeros_d, zeros_d, zeros_d, zeros_d, dst_valid,
        use_ur=False,
    )
    matched = (best_d <= TH_LOW) & (best_d <= nn_ratio * second_d)
    if check_rotation:
        matched = rotation_consistency_mask(
            src_angle, dst_angle[best_j.long()], matched
        )
    return _resolve(best_d, best_j, matched, nd)
