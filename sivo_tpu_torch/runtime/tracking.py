"""Tracking: the host-side per-frame orchestrator (port of
``sivo_tpu/runtime/tracking.py``).

All numerics run on the device in ``track_step``; the host copies the
72-float summary back once per frame, runs the state machine and the
keyframe decision, and does keyframe bookkeeping at keyframe rate.
State machine (ref: Tracking.h:89-95): NOT_INITIALIZED -> OK <-> LOST.

``dispatch`` enqueues a frame's tracking step and starts the copy of its
summary into pinned host memory (``utils/transfer.HostCopy``);
``retire`` waits for that copy and runs the host policy. ``System``
keeps up to ``pipeline_depth`` frames in flight between the two. With a
``mapper`` (set by ``System``) the keyframe decision honours its
backpressure and the mapper completes each keyframe's host bookkeeping
at admission; without one the Tracker completes it at insertion.
"""

from __future__ import annotations

import contextlib
import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams, unproject_stereo
from sivo_tpu_torch.runtime import device_map, kf_store as kfs_mod
from sivo_tpu_torch.runtime import track_step as ts
from sivo_tpu_torch.runtime.frame import Frame
from sivo_tpu_torch.runtime.map_state import KeyFrameData, MapState
from sivo_tpu_torch.select import info as info_ops
from sivo_tpu_torch.utils.transfer import HostCopy, to_device


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
    summary_copy: HostCopy
    # world corrections (BA) applied after this frame was dispatched:
    # its summary pose is in the old world frame and is re-chained at
    # retire (Tcw_new = Tcw_old @ correction)
    correction: Optional[np.ndarray] = None


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
    # localization mode: track against the frozen map, never insert
    # keyframes (ref: System.cc:220-243)
    only_tracking: bool = False

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
        self._inflight: list[Ticket] = []  # dispatched, not retired (FIFO)
        self.kf_created: Optional[int] = None  # set by retire()
        self.mapper = None  # set by System: keyframe backpressure
        self.timer = None  # optional StageTimer
        # keyframe requests shed at full keyframe capacity, counted once
        # per run of consecutive sheds
        self.kf_cap_skips = 0
        self._kf_cap_shedding = False

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
        """Enqueue the tracking step for this frame and start the copy
        of its summary to the host."""
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
        tk = Ticket(frame=frame, result=result, timestamp=timestamp,
                    frame_id=fid,
                    summary_copy=HostCopy({"summary": result.summary}))
        self._inflight.append(tk)
        return tk

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    def take_inflight(self) -> Optional[Ticket]:
        """Pop the OLDEST in-flight ticket (FIFO)."""
        return self._inflight.pop(0) if self._inflight else None

    def apply_world_correction(self, ref_pose_old: np.ndarray,
                               ref_pose_new: np.ndarray) -> None:
        """Re-anchor the carry pose after BA moved the map
        (ref: Tracking.cc:641-646 UpdateLastFrame): carry.pose becomes
        carry.pose @ Tref_old^-1 @ Tref_new, the camera-to-reference
        pose the correction preserves (the velocity Tcl is invariant
        under the right-multiplication). Frames already in flight
        re-chain their summary pose at retire."""
        delta = (np.linalg.inv(ref_pose_old.astype(np.float64))
                 @ ref_pose_new.astype(np.float64))
        if np.allclose(delta, np.eye(4), atol=1e-9):
            return
        if self.carry is not None:
            delta_f = to_device(delta.astype(np.float32), self.device)
            self.carry = self.carry._replace(pose=self.carry.pose @ delta_f)
        self.last_pose = (self.last_pose.astype(np.float64)
                          @ delta).astype(np.float32)
        for tk in self._inflight:
            tk.correction = (delta if tk.correction is None
                             else tk.correction @ delta)

    def retire(self, ticket: Ticket) -> Optional[np.ndarray]:
        """Wait for a ticket's summary copy and run the host policy:
        state machine, trajectory record, keyframe decision and
        insertion. Returns the frame's pose, or None if tracking failed."""
        if ticket in self._inflight:
            self._inflight.remove(ticket)
        # frames dispatched after this one mean the device carry has
        # moved on: a keyframe made from this frame must not rewrite the
        # carry's point ids (they index another frame's keypoints)
        stale = len(self._inflight) > 0
        self.kf_created = None
        with (self.timer.stage("track.retire.wait") if self.timer is not None
              else contextlib.nullcontext()):
            summary = ticket.summary_copy.result()["summary"]
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
        if ticket.correction is not None:
            pose = (pose.astype(np.float64)
                    @ ticket.correction).astype(np.float32)
        dR = pose[:3, :3] @ self.last_pose[:3, :3].T
        self._rot_rate = float(
            np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))
        )
        self.last_pose = pose
        self.last_cov = summary[ts.S_COV].reshape(6, 6).astype(np.float32)

        want_kf = self._need_new_keyframe(summary, fid)
        if want_kf and self.map.n_keyframes >= self.map.max_keyframes:
            # full keyframe store: shed the insertion and keep tracking
            # (compaction restores headroom); the request re-fires each
            # frame, and a run of sheds counts as one event
            if not self._kf_cap_shedding:
                self.kf_cap_skips += 1
            self._kf_cap_shedding = True
        elif want_kf:
            self._kf_cap_shedding = False
            self._create_new_keyframe(ticket.frame, ticket.result,
                                      timestamp, fid, stale=stale,
                                      correction=ticket.correction)
            # reserve the device's mints on the host counter now, in
            # dispatch order: the host mirror lands only at
            # finish_kf_host, and a triangulation applied in between
            # must not mint the same ids (mirror_points' max() makes
            # this idempotent)
            n_sel = int(summary[ts.S_N_SELECTED])
            self.map.n_points = min(self.map.n_points + n_sel,
                                    self.map.max_points)
            self.kf_created = self.last_kf_id
            if self.mapper is None:
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
        if self.mapper is None:
            self.finish_kf_host(self.last_kf_id)
        self.state = TrackingState.OK
        self.trajectory.append(FrameRecord(
            pose=pose, rel_pose=np.eye(4, dtype=np.float32),
            ref_kf=self.last_kf_id, timestamp=timestamp, frame_id=fid,
        ))
        self.kf_created = self.last_kf_id
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
        plus the JAX package's cadence, young-map and turn clauses and
        the mapper's backpressure (no mapper: always idle, queue empty)."""
        if self.only_tracking:  # ref: Tracking.cc:826-828
            return False
        cfg = self.cfg.tracking
        n_tracked = summary[ts.S_N_TRACKED]
        n_ref = summary[ts.S_N_REF]
        need_close = (summary[ts.S_N_CLOSE_TRACKED] < cfg.close_tracked_max
                      and summary[ts.S_N_CLOSE_FREE] > cfg.close_nontracked_min)
        max_frames = int(self.cfg.camera.fps)
        th_ref = cfg.th_ref_ratio if self.map.n_keyframes >= 2 else 0.25
        mapper_idle = self.mapper is None or not self.mapper.busy
        queue_len = 0 if self.mapper is None else self.mapper.queue_len
        c1a = fid >= self.last_kf_frame_id + max_frames
        # the reference's c1b needs an idle mapper; the pipelined
        # mapper's equivalent is an empty admission queue
        c1b = (fid >= self.last_kf_frame_id + cfg.min_frames_between_kf
               and queue_len == 0)
        c1c = n_tracked < n_ref * 0.25 or need_close
        c2 = (n_tracked < n_ref * th_ref or need_close) and n_tracked > 15
        c_cadence = c1a and n_tracked > 15
        c_young = (self.map.n_keyframes < 3
                   and fid >= self.last_kf_frame_id + 3 and n_tracked > 15)
        c_turn = (self._rot_rate > 0.03
                  and fid >= self.last_kf_frame_id + 3 and n_tracked > 15)
        decision = bool(((c1a or c1b or c1c) and c2) or c_cadence or c_young
                        or c_turn)
        # backpressure (ref: Tracking.cc:901-916): a busy mapper admits
        # a keyframe only while its queue is short
        if decision and not mapper_idle:
            decision = queue_len < 3
        return decision

    def _create_new_keyframe(self, frame: Frame, result: ts.StepResult,
                             timestamp: float, fid: int, stale: bool = False,
                             correction: Optional[np.ndarray] = None
                             ) -> None:
        """ref: Tracking.cc:921-1031 CreateNewKeyFrame."""
        xw = result.xw
        if correction is not None:
            # the frame ran in the pre-correction world frame: with
            # Tcw_new = Tcw_old @ delta, world points move by delta^-1
            delta_inv = np.linalg.inv(correction.astype(np.float64))
            xw = se3.transform(
                to_device(delta_inv.astype(np.float32), self.device), xw)
        self._insert_keyframe_device(frame, result.sel_mask, xw,
                                     result.pt_idx, timestamp, fid,
                                     self.last_pose, self.last_cov)
        if not stale:
            # the carry still refers to this frame's keypoints: give it
            # the new ids (in flight, newer frames pick them up through
            # the local map instead)
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
            frame.level, to_device(cam_center, self.device),
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
        host = HostCopy({
            "xy": frame.xy, "level": frame.level, "angle": frame.angle,
            "desc_u8": frame.desc_u8, "u_right": frame.u_right,
            "depth": frame.depth, "sem_class": frame.sem_class,
            "sem_confidence": frame.sem_confidence,
            "sem_entropy": frame.sem_entropy, "semantic": frame.semantic,
            "pt_idx": combined_idx, "new_ids": new_ids, "sel": sel_mask,
            "xw": xw,
        })
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
        """Complete a keyframe's host bookkeeping from its copy:
        keypoint snapshot, point mirroring, observations, spanning tree,
        local map."""
        pending = self._kf_host_pending.pop(kf_idx, None)
        if pending is None:
            return
        host_copy, fid, timestamp, pose = pending
        host = host_copy.result()
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
        self._local_ids_dev = to_device(pad, self.device)

    def refresh_local_map_latest(self) -> None:
        """Refresh around the newest keyframe whose host bookkeeping is
        complete (the mapper calls this after creating points)."""
        k = self.last_kf_id
        if k >= 0 and self.map.kf_data[k] is not None:
            self.refresh_local_map(k)
