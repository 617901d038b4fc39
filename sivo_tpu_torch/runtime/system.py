"""System: the top-level session (port of ``sivo_tpu/runtime/system.py``;
ref: System.cc).

Owns the SegNet, the frontend statics, the host map, the tracker and the
local mapper, and exposes the per-frame ``track_stereo`` API and the
shutdown outputs (the BA-corrected KITTI trajectory, the
keyframes_points counts). The reference's threads become host
orchestration plus the device stream: ``track_frame(pipeline=True)``
keeps ``pipeline_depth`` frames in flight, and the mapper's stages run
on the device between frames.

Loop closing and relocalization through the keyframe database are not
ported yet: a lost frame resets the session while the map has at most 5
keyframes, as the JAX package does without a loop closer, and otherwise
stays lost.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.io import trajectory as traj_io
from sivo_tpu_torch.models import segnet as segnet_mod
from sivo_tpu_torch.runtime import compact as compact_mod
from sivo_tpu_torch.runtime import frame as frame_mod
from sivo_tpu_torch.runtime import track_step as ts
from sivo_tpu_torch.runtime.map_state import MapState
from sivo_tpu_torch.runtime.mapping import LocalMapper
from sivo_tpu_torch.runtime.tracking import Tracker, TrackingState
from sivo_tpu_torch.utils.profiling import StageTimer


@dataclass
class System:
    cfg: SystemConfig
    # the card unless the caller passes a CPU device (the tests do)
    device: Optional[torch.device] = None
    # SegNet basic state dict; None: segnet.init_params(seed=0)
    segnet_params: Optional[dict] = None
    max_keyframes: int = 2048
    max_points: int = 131072
    # frames in flight in track_frame(pipeline=True); keyframe and loss
    # decisions lag by as many frames
    pipeline_depth: int = 2

    def __post_init__(self):
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("System runs on a CUDA card; none is "
                                   "available (pass a CPU device to run "
                                   "on the CPU)")
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(self.device)
        self.statics = frame_mod.make_statics(self.cfg)
        self.model = segnet_mod.SegNet(
            num_classes=self.cfg.semantic.num_classes,
            dtype=segnet_mod.dtype_of(self.cfg.semantic.cnn_dtype))
        if self.segnet_params is None:
            self.segnet_params = segnet_mod.init_params(
                seed=0, num_classes=self.cfg.semantic.num_classes)
        self.model.load_state_dict(self.segnet_params)
        self.model = self.model.to(self.device).eval()
        self.map = MapState(
            max_keyframes=self.max_keyframes, max_points=self.max_points,
            kp_capacity=self.cfg.orb.max_keypoints,
            n_levels=self.cfg.orb.n_levels,
            scale_factor=self.cfg.orb.scale_factor)
        self.timer = StageTimer()
        self._make_tracker_and_mapper()
        # SegNet's MC-dropout masks
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(42)
        self.crisis_frames = 0
        self.n_resets = 0
        self._prev_tracked = 0.0

    def _make_tracker_and_mapper(self, frame_count: int = 0) -> None:
        self.tracker = Tracker(cfg=self.cfg, map=self.map,
                               device=self.device, frame_count=frame_count)
        self.tracker.timer = self.timer
        self.mapper = LocalMapper(
            cfg=self.cfg, map=self.map, cam=self.tracker.cam,
            timer=self.timer, on_kf_culled=self._on_kf_culled,
            kf_protected=self._protected_kfs)
        self.tracker.mapper = self.mapper  # keyframe backpressure

    def _protected_kfs(self) -> set:
        """Keyframes the culler must not erase: the tracker's current
        reference keyframe, through which every later frame record
        chains (the JAX package adds the loop-edge holders)."""
        return {self.tracker.last_kf_id}

    def _on_kf_culled(self, k: int) -> None:
        """Re-express the trajectory records referencing a culled
        keyframe through its nearest live ancestor now, while the poses
        are still mutually consistent (the reference freezes mTcp at
        SetBadFlag and walks the chain at save time, KeyFrame.cc:552-563
        + System.cc:303-311)."""
        m = self.map
        a, hops = k, 0
        while a > 0 and not m.kf_valid[a] and hops <= m.n_keyframes:
            p = int(m.kf_parent[a])
            a = p if 0 <= p < a else a - 1
            hops += 1
        if not (m.kf_valid[a] or a == 0):
            a = 0
        delta = (m.kf_pose[k].astype(np.float64)
                 @ np.linalg.inv(m.kf_pose[a].astype(np.float64)))
        for r in self.tracker.trajectory:
            if r.ref_kf == k:
                r.rel_pose = (r.rel_pose.astype(np.float64)
                              @ delta).astype(np.float32)
                r.ref_kf = int(a)

    # -- per-frame API --------------------------------------------------------

    def track_stereo(self, img_left_color: np.ndarray,
                     img_right_gray: np.ndarray, timestamp: float,
                     sem_override: tuple | None = None
                     ) -> Optional[np.ndarray]:
        """ref: System.cc:172-218 TrackStereo; returns THIS frame's pose
        (4, 4) Tcw, or None. ``sem_override``: see
        ``frame.build_frame``."""
        f = frame_mod.build_frame(
            self.model, self.statics, img_left_color, img_right_gray,
            self.generator, sem_override=sem_override, device=self.device)
        return self.track_frame(f, timestamp)

    def track_frame(self, f, timestamp: float, pipeline: bool = False,
                    pre_retire=None) -> Optional[np.ndarray]:
        """Track a built Frame.

        ``pipeline=False`` keeps the reference's synchronous semantics
        (returns this frame's pose). ``pipeline=True`` dispatches this
        frame and retires the frame from ``pipeline_depth`` calls ago,
        returning its pose: the summary copy of each frame overlaps the
        next frames' work. Crisis mode retires synchronously while the
        tracked count collapses, so keyframes land at once.
        ``pre_retire`` runs between the dispatch and the retire (a
        caller's next-frame work).
        """
        with self.timer.stage("track"):
            if self.tracker.state in (TrackingState.NO_IMAGES_YET,
                                      TrackingState.NOT_INITIALIZED):
                while self.tracker.inflight_count:
                    self._retire_one()
                pose = self.tracker.track_init(f, timestamp)
                if self.tracker.kf_created is not None:
                    self._on_keyframe(self.tracker.kf_created)
                return pose
            if compact_mod.should_compact(self):
                self._compact()
            with self.timer.stage("track.dispatch"):
                self.tracker.dispatch(f, timestamp)
            self._advance_mapping()
            if pre_retire is not None:
                pre_retire()
            if not pipeline:
                return self._retire_one()
            s = self.tracker.last_summary
            trk = float(s[ts.S_N_TRACKED]) if s is not None else 0.0
            prev_trk, self._prev_tracked = self._prev_tracked, trk
            # the absolute floor scales with the selection regime: the
            # sequential selection tracks ~1/5 the points of batch mode
            floor = 96 if self.cfg.semantic.sequential_selection else 256
            collapse = prev_trk > 0 and trk < 0.78 * prev_trk
            crisis = s is not None and (
                collapse or trk < 32
                or (trk < floor and not self.tracker.only_tracking))
            if crisis:
                self.crisis_frames += 1
            depth = 0 if crisis else self.pipeline_depth
            pose_prev = None
            while self.tracker.inflight_count > depth:
                pose_prev = self._retire_one()
            return pose_prev

    def _retire_one(self) -> Optional[np.ndarray]:
        """Retire the oldest in-flight frame: host policy, keyframe
        admission to the mapper, and the lost path."""
        tk = self.tracker.take_inflight()
        if tk is None:
            return None
        # the reference relocalizes only frames that enter Track()
        # already lost (ref: Tracking.cc:271-272)
        was_lost = self.tracker.state == TrackingState.LOST
        with self.timer.stage("track.retire"):
            pose = self.tracker.retire(tk)
        if (self.tracker.kf_created is not None
                and not self.tracker.only_tracking):
            self._on_keyframe(self.tracker.kf_created)
        if pose is None and was_lost:
            pose = self._relocalize(tk.frame, tk.timestamp)
        return pose

    def _on_keyframe(self, kf_idx: int) -> None:
        with self.timer.stage("mapping"):
            self.mapper.on_keyframe(kf_idx)

    def _advance_mapping(self) -> None:
        with self.timer.stage("map.advance"):
            self.mapper.advance(self.tracker)

    def flush(self) -> Optional[np.ndarray]:
        """Complete all in-flight work: retire the pipelined frames and
        drain the mapper (call before reading the map or shutting
        down). Returns the last retired pose, if any."""
        pose = None
        while self.tracker.inflight_count:
            p = self._retire_one()
            pose = p if p is not None else pose
        self.mapper.drain(self.tracker)
        # keyframes the mapper never admitted still need their host
        # bookkeeping
        for kf_idx in list(self.tracker._kf_host_pending):
            self.tracker.finish_kf_host(kf_idx)
        return pose

    def _compact(self) -> None:
        """Reclaim culled point and keyframe slots (runtime/compact.py);
        needs drained pipelines, so it flushes first."""
        with self.timer.stage("compact"):
            self.flush()
            compact_mod.compact_map(self)

    def activate_localization_mode(self) -> None:
        """Track against the frozen map without inserting keyframes
        (ref: System.cc:220-231)."""
        self.flush()
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self) -> None:
        """ref: System.cc:233-243."""
        self.tracker.only_tracking = False

    def _relocalize(self, f, timestamp: float) -> Optional[np.ndarray]:
        """Lost with at most 5 keyframes: reset the session, as the
        reference does (ref: Tracking.cc:417-425). Relocalization from
        the keyframe database comes with loop closing, not yet ported."""
        del f, timestamp
        if self.map.n_keyframes <= 5:
            self.reset()
        return None

    def reset(self) -> None:
        """Full session reset (ref: Tracking.cc:1398-1435 +
        System::Reset). Frame ids stay sequence-global, so trajectory
        records keep aligning with the sequence."""
        self.n_resets += 1
        self.map.clear()
        self._make_tracker_and_mapper(frame_count=self.tracker.frame_count)

    # -- shutdown / outputs ----------------------------------------------------

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    def n_lost(self) -> int:
        return sum(1 for r in self.tracker.trajectory if r.lost)

    def frame_poses(self) -> np.ndarray:
        """Per-frame poses re-chained through their (BA-corrected)
        reference keyframes (ref: System.cc:303-321)."""
        self.flush()
        recs = self.tracker.trajectory
        if not recs:
            return np.zeros((0, 4, 4), np.float32)
        return traj_io.chained_frame_poses(
            [r.rel_pose for r in recs], [max(r.ref_kf, 0) for r in recs],
            self.map.kf_pose[: self.map.n_keyframes])

    def save_trajectory_kitti(self, path: str) -> None:
        """ref: System.cc:274-336."""
        traj_io.save_trajectory_kitti(path, self.frame_poses())

    def shutdown(self, counts_path: str = "keyframes_points.txt") -> None:
        """ref: System.cc:245-272."""
        self.flush()
        n_pts = int(self.map.pt_valid[: self.map.n_points].sum())
        traj_io.save_keyframes_points(counts_path, self.map.n_keyframes,
                                      n_pts)
