"""Tracking: the host-side per-frame orchestrator (port of
``sivo_tpu/runtime/tracking.py``).

All numerics run on the device in ``track_step``; the host copies the
72-float summary back once per frame (``.cpu()``), runs the state
machine and the keyframe decision, and does keyframe bookkeeping at
keyframe rate. State machine (ref: Tracking.h:89-95):
NOT_INITIALIZED -> OK <-> LOST.

This slice runs without a local mapper: the Tracker completes each
keyframe's host bookkeeping itself (``finish_kf_host``), as the JAX
package's Tracker does when ``mapper`` is None.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.geometry.projection import CameraParams, unproject_stereo
from sivo_tpu_torch.runtime import device_map, kf_store as kfs_mod
from sivo_tpu_torch.runtime import track_step as ts
from sivo_tpu_torch.runtime.frame import Frame
from sivo_tpu_torch.runtime.map_state import KeyFrameData, MapState
from sivo_tpu_torch.select import info as info_ops


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def merge_local_ids(new_ids: torch.Tensor,
                    prev_ids: torch.Tensor) -> torch.Tensor:
    """Prepend a fresh keyframe's point ids to the local-map id list:
    a stable compaction of the -1 padding, truncated to the list's
    capacity."""
    cat = torch.cat([new_ids, prev_ids])
    order = torch.argsort((cat < 0).to(torch.int32), stable=True)
    return cat[order][: prev_ids.shape[0]]


def make_camera(cfg: SystemConfig) -> CameraParams:
    c = cfg.camera
    return CameraParams(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf,
                        width=c.width, height=c.height)


def init_selection(frame: Frame, cam: CameraParams, scale_factor: float,
                   init_cov: float = 1e-6
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Initialization-time entropy selection at the identity pose, batch
    scored against the initial covariance with gate 0 bits
    (ref: Tracking.cc:453-579). Returns (sel_mask, xw)."""
    cov = torch.eye(6, device=frame.xy.device) * init_cov
    xc = unproject_stereo(cam, frame.xy, frame.depth)
    sigma2 = scale_factor ** (2.0 * frame.level.float())
    candidate = frame.semantic & (frame.depth > 0)
    scores = info_ops.entropy_reduction_stereo(
        cov, xc, sigma2, frame.sem_entropy, cam.fx, cam.fy, cam.bf / cam.fx,
    )
    return candidate & (scores > 0.0), xc  # pose = identity: xw = xc


@dataclass
class FrameRecord:
    """Host-side per-frame trajectory record."""

    pose: np.ndarray  # (4, 4) Tcw at track time
    rel_pose: np.ndarray  # (4, 4) Tcr w.r.t. reference KF
    ref_kf: int
    timestamp: float
    frame_id: int
    lost: bool = False


@dataclass(eq=False)
class Ticket:
    """A dispatched frame whose summary has not been consumed yet."""

    frame: Frame
    result: ts.StepResult
    timestamp: float
    frame_id: int


@dataclass
class Tracker:
    cfg: SystemConfig
    map: MapState
    device: torch.device
    seed: int = 0  # seeds the anchor's RANSAC generator
    state: TrackingState = TrackingState.NO_IMAGES_YET
    frame_count: int = 0
    last_kf_id: int = -1
    last_kf_frame_id: int = -1
    trajectory: list = field(default_factory=list)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.cam = make_camera(self.cfg)
        n = self.cfg.orb.max_keypoints
        dev = self.device
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(self.seed)
        self.carry: Optional[ts.TrackCarry] = None
        self.dmap = device_map.make_device_map(self.map.max_points, dev)
        self.kf_store = kfs_mod.make_kf_store(self.map.max_keyframes, n, dev)
        self._ref_desc_u8 = torch.zeros((n, 32), dtype=torch.uint8,
                                        device=dev)
        self._ref_angle = torch.zeros(n, device=dev)
        self._ref_pt_idx = torch.full((n,), -1, dtype=torch.int32,
                                      device=dev)
        self._local_ids_dev = torch.full((ts.LOCAL_CAND,), -1,
                                         dtype=torch.int32, device=dev)
        self.local_cap_binds = 0
        self.last_pose = np.eye(4, dtype=np.float32)
        self.last_cov = np.eye(6, dtype=np.float32) * 1e-6
        self.last_summary: Optional[np.ndarray] = None
        self._kf_host_pending: dict[int, tuple] = {}
        self._rot_rate = 0.0
        # where in the SEL_CAP walk the last greedy accept fell, 16 bins
        self.sel_last_accept_hist = [0] * 16

    # -- public API ---------------------------------------------------------

    def track(self, frame: Frame, timestamp: float) -> Optional[np.ndarray]:
        """Per-frame API (ref: Tracking.cc:229-451 Track()): the frame's
        pose (4, 4) Tcw, or None if tracking failed."""
        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED):
            return self.track_init(frame, timestamp)
        return self.retire(self.dispatch(frame, timestamp))

    def track_init(self, frame: Frame,
                   timestamp: float) -> Optional[np.ndarray]:
        """Initialization frames (ref: Tracking.cc:241)."""
        fid = self.frame_count
        self.frame_count += 1
        ok = self._stereo_initialization(frame, timestamp, fid)
        return self.last_pose if ok else None

    def dispatch(self, frame: Frame, timestamp: float) -> Ticket:
        """Run the tracking step for this frame on the device."""
        fid = self.frame_count
        self.frame_count += 1
        # anchor cadence: every 2nd frame, the frame right after a
        # keyframe, and whenever rotation deviation is building
        s = self.last_summary
        rot_building = s is not None and float(s[ts.S_ROT_DEV]) > 0.012
        run_anchor = ((fid % 2 == 0) or (fid - self.last_kf_frame_id <= 1)
                      or rot_building)
        result = ts.track_step(
            self.carry, self.dmap, frame,
            float(self.cfg.semantic.th_entropy_reduction),
            self._ref_pt_idx,
            3 if self.map.n_keyframes > 2 else 2,
            self._ref_desc_u8, self._ref_angle, self._local_ids_dev,
            run_anchor, self.cam, self.generator,
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels,
            float(self.cfg.tracking.motion_search_th),
            float(self.cfg.tracking.max_accel_m),
            bool(self.cfg.semantic.sequential_selection),
            int(self.cfg.semantic.seq_min_select),
        )
        self.dmap = result.dmap
        self.carry = result.carry
        return Ticket(frame=frame, result=result, timestamp=timestamp,
                      frame_id=fid)

    def retire(self, ticket: Ticket) -> Optional[np.ndarray]:
        """Consume a ticket's summary (one device->host copy) and run
        the host policy: state machine, trajectory record, keyframe
        decision and insertion."""
        summary = ticket.result.summary.cpu().numpy()
        self.last_summary = summary
        fid, timestamp = ticket.frame_id, ticket.timestamp

        last_acc = float(summary[ts.S_SEL_LAST_ACCEPT])
        if last_acc >= 0:
            b = min(int(last_acc) * 16 // info_ops.SEL_CAP, 15)
            self.sel_last_accept_hist[b] += 1
        if summary[ts.S_OK] < 0.5:
            self.state = TrackingState.LOST
            self.trajectory.append(FrameRecord(
                pose=self.last_pose.copy(),
                rel_pose=self._rel_pose(self.last_pose),
                ref_kf=self.last_kf_id, timestamp=timestamp, frame_id=fid,
                lost=True,
            ))
            return None

        self.state = TrackingState.OK
        pose = summary[ts.S_POSE].reshape(4, 4).astype(np.float32)
        dR = pose[:3, :3] @ self.last_pose[:3, :3].T
        self._rot_rate = float(
            np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))
        )
        self.last_pose = pose
        self.last_cov = summary[ts.S_COV].reshape(6, 6).astype(np.float32)

        want_kf = self._need_new_keyframe(summary, fid)
        if want_kf and self.map.n_keyframes < self.map.max_keyframes:
            self._create_new_keyframe(ticket.frame, ticket.result,
                                      timestamp, fid)
            n_sel = int(summary[ts.S_N_SELECTED])
            self.map.n_points = min(self.map.n_points + n_sel,
                                    self.map.max_points)
            self.finish_kf_host(self.last_kf_id)
        self.trajectory.append(FrameRecord(
            pose=pose, rel_pose=self._rel_pose(pose), ref_kf=self.last_kf_id,
            timestamp=timestamp, frame_id=fid,
        ))
        return pose

    # -- initialization -----------------------------------------------------

    def _stereo_initialization(self, frame: Frame, timestamp: float,
                               fid: int) -> bool:
        """ref: Tracking.cc:453-579 (batch-scored, as in the JAX package)."""
        sel, xw = init_selection(frame, self.cam, self.cfg.orb.scale_factor,
                                 self.cfg.tracking.init_covariance)
        if int(frame.semantic.sum()) <= self.cfg.tracking.min_init_keypoints:
            self.state = TrackingState.NOT_INITIALIZED
            return False
        pose = np.eye(4, dtype=np.float32)
        cov = np.eye(6, dtype=np.float32) * self.cfg.tracking.init_covariance
        self.last_pose, self.last_cov = pose, cov
        n = frame.capacity
        dev = self.device
        minus1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.carry = ts.TrackCarry(
            pose=torch.from_numpy(pose).to(dev),
            cov=torch.from_numpy(cov).to(dev),
            velocity=torch.eye(4, device=dev),
            has_velocity=torch.zeros((), dtype=torch.bool, device=dev),
            pt_idx=minus1, desc_u8=frame.desc_u8, level=frame.level,
            angle=frame.angle, valid=frame.valid,
        )
        self._insert_keyframe_device(frame, sel, xw, minus1, timestamp, fid,
                                     pose, cov)
        self.finish_kf_host(self.last_kf_id)
        self.state = TrackingState.OK
        self.trajectory.append(FrameRecord(
            pose=pose, rel_pose=np.eye(4, dtype=np.float32),
            ref_kf=self.last_kf_id, timestamp=timestamp, frame_id=fid,
        ))
        return True

    # -- keyframe policy ----------------------------------------------------

    def _rel_pose(self, pose: np.ndarray) -> np.ndarray:
        """Tcr = Tcw * Twr w.r.t. the current reference keyframe."""
        if self.last_kf_id < 0:
            return pose.copy()
        Trw = self.map.kf_pose[self.last_kf_id]
        return (pose.astype(np.float64)
                @ np.linalg.inv(Trw.astype(np.float64))).astype(np.float32)

    def _need_new_keyframe(self, summary: np.ndarray, fid: int) -> bool:
        """ref: Tracking.cc:825-919 with the SIVO 30/70 close-point rule,
        plus the JAX package's cadence, young-map and turn clauses. With
        no mapper the mapper is always idle and its queue empty."""
        cfg = self.cfg.tracking
        n_tracked = summary[ts.S_N_TRACKED]
        n_ref = summary[ts.S_N_REF]
        need_close = (summary[ts.S_N_CLOSE_TRACKED] < cfg.close_tracked_max
                      and summary[ts.S_N_CLOSE_FREE] > cfg.close_nontracked_min)
        max_frames = int(self.cfg.camera.fps)
        th_ref = cfg.th_ref_ratio if self.map.n_keyframes >= 2 else 0.25
        c1a = fid >= self.last_kf_frame_id + max_frames
        c1b = fid >= self.last_kf_frame_id + cfg.min_frames_between_kf
        c1c = n_tracked < n_ref * 0.25 or need_close
        c2 = (n_tracked < n_ref * th_ref or need_close) and n_tracked > 15
        c_cadence = c1a and n_tracked > 15
        c_young = (self.map.n_keyframes < 3
                   and fid >= self.last_kf_frame_id + 3 and n_tracked > 15)
        c_turn = (self._rot_rate > 0.03
                  and fid >= self.last_kf_frame_id + 3 and n_tracked > 15)
        return bool(((c1a or c1b or c1c) and c2) or c_cadence or c_young
                    or c_turn)

    def _create_new_keyframe(self, frame: Frame, result: ts.StepResult,
                             timestamp: float, fid: int) -> None:
        """ref: Tracking.cc:921-1031 CreateNewKeyFrame."""
        self._insert_keyframe_device(frame, result.sel_mask, result.xw,
                                     result.pt_idx, timestamp, fid,
                                     self.last_pose, self.last_cov)
        # the carry refers to this frame's keypoints: give it the new ids
        self.carry = self.carry._replace(pt_idx=self._kf_new_pt_idx)

    def _insert_keyframe_device(self, frame: Frame, sel_mask, xw, pt_idx,
                                timestamp: float, fid: int,
                                pose: np.ndarray, cov: np.ndarray) -> None:
        """Device map update + host bookkeeping (keyframe rate)."""
        self.dmap = device_map.observe_points(self.dmap, pt_idx,
                                              frame.sem_class, frame.desc_u8)
        cam_center = -pose[:3, :3].T @ pose[:3, 3]
        self.dmap, new_ids = device_map.add_points(
            self.dmap, sel_mask, xw, frame.desc_u8, frame.sem_class,
            frame.level, torch.from_numpy(cam_center).to(self.device),
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels,
        )
        combined_idx = torch.where(new_ids >= 0, new_ids, pt_idx)
        self._kf_new_pt_idx = combined_idx

        kf_slot = self.map.n_keyframes
        kfs_mod.insert(
            self.kf_store, kf_slot, xy=frame.xy, level=frame.level,
            angle=frame.angle, desc_u8=frame.desc_u8, u_right=frame.u_right,
            semantic=frame.semantic, sem_class=frame.sem_class,
            sem_confidence=frame.sem_confidence,
            sem_entropy=frame.sem_entropy,
        )
        host = {
            "xy": frame.xy, "level": frame.level, "angle": frame.angle,
            "desc_u8": frame.desc_u8, "u_right": frame.u_right,
            "depth": frame.depth, "sem_class": frame.sem_class,
            "sem_confidence": frame.sem_confidence,
            "sem_entropy": frame.sem_entropy, "semantic": frame.semantic,
            "pt_idx": combined_idx, "new_ids": new_ids, "sel": sel_mask,
            "xw": xw,
        }
        kf_idx = self.map.add_keyframe(pose, cov, None)
        if kf_idx != kf_slot:
            raise RuntimeError(f"keyframe slot {kf_idx} != {kf_slot}")
        self._kf_host_pending[kf_idx] = (host, fid, timestamp, pose.copy())
        self.last_kf_id = kf_idx
        self.last_kf_frame_id = fid
        self._ref_desc_u8 = frame.desc_u8
        self._ref_angle = frame.angle
        self._ref_pt_idx = combined_idx
        self._local_ids_dev = merge_local_ids(combined_idx,
                                              self._local_ids_dev)

    def finish_kf_host(self, kf_idx: int) -> None:
        """Complete a keyframe's host bookkeeping: keypoint snapshot,
        point mirroring, observations, spanning tree, local map."""
        pending = self._kf_host_pending.pop(kf_idx, None)
        if pending is None:
            return
        dev_arrays, fid, timestamp, pose = pending
        host = {k: v.cpu().numpy() for k, v in dev_arrays.items()}
        data = KeyFrameData(
            frame_id=fid, timestamp=timestamp, xy=host["xy"],
            level=host["level"], angle=host["angle"],
            desc_u8=host["desc_u8"], desc_bits=None,
            u_right=host["u_right"], depth=host["depth"],
            sem_class=host["sem_class"],
            sem_confidence=host["sem_confidence"],
            sem_entropy=host["sem_entropy"], semantic=host["semantic"],
        )
        self.map.kf_data[kf_idx] = data
        pt_ids_np = host["pt_idx"].astype(np.int64)
        new_ids_np = host["new_ids"].astype(np.int64)
        dropped = int((host["sel"] & (new_ids_np < 0)).sum())
        if dropped:
            self.points_dropped = getattr(self, "points_dropped", 0) + dropped
        kp_new = np.where(new_ids_np >= 0)[0]
        if len(kp_new):
            self.map.mirror_points(
                new_ids_np[kp_new], host["xw"][kp_new],
                data.desc_u8[kp_new], data.sem_class[kp_new], kf_idx,
                kp_new, data.level[kp_new],
                cam_center=-pose[:3, :3].T @ pose[:3, 3],
            )
        kp_obs = np.where((pt_ids_np >= 0) & (new_ids_np < 0))[0]
        if len(kp_obs):
            self.map.add_observations(kf_idx, pt_ids_np[kp_obs], kp_obs)
        self.map.update_spanning_tree(kf_idx)
        if kf_idx == self.last_kf_id:
            self.refresh_local_map(kf_idx)

    def refresh_local_map(self, kf_idx: int) -> None:
        """Recompute and upload the covisible local-map point ids
        (ref: Tracking.cc:1087-1235 UpdateLocalMap)."""
        ids = self.map.local_point_ids(kf_idx, ts.LOCAL_CAND)
        if len(ids) == ts.LOCAL_CAND:
            self.local_cap_binds += 1
        pad = np.full(ts.LOCAL_CAND, -1, np.int32)
        pad[: len(ids)] = ids
        self._local_ids_dev = torch.from_numpy(pad).to(self.device)
