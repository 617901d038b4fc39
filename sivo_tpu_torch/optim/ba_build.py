"""Host assembly of a padded full-map ``BAProblem`` from the MapState
and the write-back of its solution (port of
``sivo_tpu/optim/ba_build.py``; ref: Optimizer.cc:39-271
GlobalBundleAdjustment's graph building and data recovery).

The JAX package's ``o_chunk`` layout serves its chunked-Schur solver,
which the port leaves out; both solvers here (the dense Schur LM and the
PCG) take observations in any order.
"""

from __future__ import annotations

import numpy as np
import torch

from sivo_tpu_torch.optim.local_ba import BAProblem
from sivo_tpu_torch.runtime import device_map
from sivo_tpu_torch.utils.transfer import to_device


def build_problem(m, kfs: list[int], fixed: np.ndarray, k_cap: int,
                  pt_cap: int, obs_cap: int, scale_factor: float,
                  device: torch.device) -> tuple[BAProblem, dict] | None:
    """A padded BA problem over the given keyframes and the points they
    see, uploaded to ``device``. Returns (problem, ctx), ctx holding the
    index maps ``apply_solution`` needs, or None if there is nothing to
    optimize. Keyframes beyond ``k_cap`` are dropped from the end;
    points beyond ``pt_cap`` and observations beyond ``obs_cap`` keep
    the most recent."""
    kfs = list(kfs)[:k_cap]
    fixed = np.asarray(fixed[: len(kfs)], bool)
    pt_ids = m.points_seen_by(np.asarray(kfs, np.int64))
    if len(pt_ids) == 0 or len(kfs) < 2:
        return None
    truncated_pts = max(0, len(pt_ids) - pt_cap)
    if len(pt_ids) > pt_cap:
        pt_ids = pt_ids[-pt_cap:]  # prefer recent points

    obs = m.observations()
    rows = obs[np.isin(obs[:, 0], kfs) & np.isin(obs[:, 1], pt_ids)]
    truncated_obs = max(0, len(rows) - obs_cap)
    if len(rows) > obs_cap:
        rows = rows[-obs_cap:]
    o = len(rows)
    if o == 0:
        return None

    fixed_pad = np.zeros(k_cap, bool)
    fixed_pad[: len(kfs)] = fixed
    if not fixed_pad.any():
        fixed_pad[len(kfs) - 1] = True  # gauge
    valid_kf = np.zeros(k_cap, bool)
    valid_kf[: len(kfs)] = True
    poses = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
    poses[: len(kfs)] = m.kf_pose[kfs]
    pts = np.zeros((pt_cap, 3), np.float32)
    pts[: len(pt_ids)] = m.pt_pos[pt_ids]
    valid_pt = np.zeros(pt_cap, bool)
    valid_pt[: len(pt_ids)] = m.pt_valid[pt_ids]

    kf_slot = np.zeros(m.max_keyframes, np.int64)
    kf_slot[kfs] = np.arange(len(kfs))
    pt_slot = np.zeros(m.max_points, np.int64)
    pt_slot[pt_ids] = np.arange(len(pt_ids))
    obs_kf = np.zeros(obs_cap, np.int64)
    obs_pt = np.zeros(obs_cap, np.int64)
    obs_uvr = np.zeros((obs_cap, 3), np.float32)
    obs_sigma2 = np.ones(obs_cap, np.float32)
    obs_stereo = np.zeros(obs_cap, bool)
    obs_valid = np.zeros(obs_cap, bool)
    obs_kf[:o] = kf_slot[rows[:, 0]]
    obs_pt[:o] = pt_slot[rows[:, 1]]
    for k in kfs:
        sel = rows[:, 0] == k
        if not sel.any():
            continue
        kp = rows[sel, 2]
        data = m.kf_data[k]
        ur = data.u_right[kp]
        obs_uvr[:o][sel] = np.stack(
            [data.xy[kp, 0], data.xy[kp, 1], np.maximum(ur, 0.0)], axis=-1)
        obs_sigma2[:o][sel] = scale_factor ** (
            2.0 * data.level[kp].astype(np.float32))
        obs_stereo[:o][sel] = ur > 0
    obs_valid[:o] = True

    prob = BAProblem(*(to_device(a, device) for a in (
        poses, fixed_pad, valid_kf, pts, valid_pt, obs_kf, obs_pt, obs_uvr,
        obs_sigma2, obs_stereo, obs_valid)))
    ctx = {"kfs": kfs, "fixed": fixed_pad, "pt_ids": pt_ids, "rows": rows,
           "o": o, "truncated_obs": truncated_obs,
           "truncated_pts": truncated_pts}
    return prob, ctx


def apply_solution(m, tracker, ctx: dict, out: dict,
                   pt_pos_dev: torch.Tensor) -> None:
    """Write a fetched BA solution back to the host map and the device
    mirror (ref: Optimizer.cc:240-270), erasing outlier observations
    (ref: Optimizer.cc:822-870). ``out`` holds the host copies of the
    solution (kf_pose, pt_pos, inlier); ``pt_pos_dev`` is the solved
    points' device tensor, written to the device map without a round
    trip through the host."""
    kfs, fixed, pt_ids = ctx["kfs"], ctx["fixed"], ctx["pt_ids"]
    for i, k in enumerate(kfs):
        if not fixed[i]:
            m.kf_pose[k] = out["kf_pose"][i]
    m.pt_pos[pt_ids] = out["pt_pos"][: len(pt_ids)]
    ids_pad = np.full(out["pt_pos"].shape[0], -1, np.int32)
    ids_pad[: len(pt_ids)] = pt_ids
    tracker.dmap = device_map.set_positions(
        tracker.dmap, to_device(ids_pad, tracker.device), pt_pos_dev)
    bad = ctx["rows"][~out["inlier"][: ctx["o"]]]
    if len(bad):
        m.erase_observations(bad)
