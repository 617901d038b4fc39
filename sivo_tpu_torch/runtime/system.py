"""System: the top-level session (port of ``sivo_tpu/runtime/system.py``;
ref: System.cc).

Owns the SegNet, the frontend statics, the host map, the tracker and the
local mapper, and exposes the per-frame ``track_stereo`` API and the
shutdown outputs (the BA-corrected KITTI trajectory, the
keyframes_points counts). The reference's threads become host
orchestration plus the device stream: ``track_frame(pipeline=True)``
keeps ``pipeline_depth`` frames in flight, and the mapper's stages run
on the device between frames.

With a vocabulary (``System(..., vocabulary=voc)`` or
``attach_vocabulary``) the session runs the loop closer
(``runtime/loopclosing.py``) on every keyframe whose mapping completed,
and a lost frame relocalizes through the keyframe database: BoW
candidates, a K2 brute force against each, EPnP RANSAC, then K2
projection rounds and pose polishing (ref: Tracking.cc:1237-1396).
Lost with at most 5 keyframes, the session resets (ref:
Tracking.cc:417-425); without a vocabulary it otherwise stays lost.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.geometry.projection import frustum_check, predict_scale
from sivo_tpu_torch.io import trajectory as traj_io
from sivo_tpu_torch.models import segnet as segnet_mod
from sivo_tpu_torch.ops import kernel_match, matching
from sivo_tpu_torch.optim import pose_lm
from sivo_tpu_torch.place import pnp as pnp_mod
from sivo_tpu_torch.place import vocabulary as voc_mod
from sivo_tpu_torch.runtime import compact as compact_mod
from sivo_tpu_torch.runtime import frame as frame_mod
from sivo_tpu_torch.runtime import track_step as ts
from sivo_tpu_torch.runtime.loopclosing import LoopCloser
from sivo_tpu_torch.runtime.map_state import MapState
from sivo_tpu_torch.runtime.mapping import LocalMapper
from sivo_tpu_torch.runtime.tracking import Tracker, TrackingState
from sivo_tpu_torch.utils.profiling import StageTimer
from sivo_tpu_torch.utils.transfer import HostCopy, to_device


@dataclass
class System:
    cfg: SystemConfig
    # the card unless the caller passes a CPU device (the tests do)
    device: Optional[torch.device] = None
    # "basic" or "standard" (ref: the two prototxts)
    segnet_variant: str = "basic"
    # that variant's SegNet state dict; None: segnet.init_params(seed=0)
    segnet_params: Optional[dict] = None
    max_keyframes: int = 2048
    max_points: int = 131072
    # frames in flight in track_frame(pipeline=True); keyframe and loss
    # decisions lag by as many frames
    pipeline_depth: int = 2
    # place.vocabulary.Vocabulary: enables loop closing and
    # relocalization
    vocabulary: Optional[voc_mod.Vocabulary] = None

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
            variant=self.segnet_variant,
            num_classes=self.cfg.semantic.num_classes,
            dtype=segnet_mod.dtype_of(self.cfg.semantic.cnn_dtype))
        if self.segnet_params is None:
            self.segnet_params = segnet_mod.init_params(
                seed=0, num_classes=self.cfg.semantic.num_classes,
                variant=self.segnet_variant)
        self.model.load_state_dict(self.segnet_params)
        self.model = self.model.to(self.device).eval()
        self.map = MapState(
            max_keyframes=self.max_keyframes, max_points=self.max_points,
            kp_capacity=self.cfg.orb.max_keypoints,
            n_levels=self.cfg.orb.n_levels,
            scale_factor=self.cfg.orb.scale_factor)
        self.timer = StageTimer()
        self.loop_closer: Optional[LoopCloser] = None
        self._make_tracker_and_mapper()
        # SegNet's MC-dropout masks
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(42)
        self.crisis_frames = 0
        self.compactions = 0
        self.n_resets = 0
        self._prev_tracked = 0.0
        self.reloc_attempts = 0
        self.reloc_successes = 0
        # K2 searches of relocalization, and the launches they made
        self.reloc_k2_searches = 0
        self.reloc_k2_launches = 0
        # the database's candidates at each relocalization attempt
        self.reloc_candidates: list[list[int]] = []

    def _make_tracker_and_mapper(self, frame_count: int = 0) -> None:
        self.tracker = Tracker(cfg=self.cfg, map=self.map,
                               device=self.device, frame_count=frame_count)
        self.tracker.timer = self.timer
        self.mapper = LocalMapper(
            cfg=self.cfg, map=self.map, cam=self.tracker.cam,
            timer=self.timer, on_kf_culled=self._on_kf_culled,
            kf_protected=self._protected_kfs)
        self.tracker.mapper = self.mapper  # keyframe backpressure
        if self.vocabulary is not None:
            self.loop_closer = LoopCloser(cfg=self.cfg, map=self.map,
                                          cam=self.tracker.cam,
                                          voc=self.vocabulary,
                                          timer=self.timer)

    def attach_vocabulary(self, voc: voc_mod.Vocabulary) -> None:
        """Enable loop closing and relocalization with a vocabulary given
        after construction (the reference loads it first,
        System.cc:75-82); keyframes made before are not in the
        database."""
        self.vocabulary = voc
        self.loop_closer = LoopCloser(cfg=self.cfg, map=self.map,
                                      cam=self.tracker.cam, voc=voc,
                                      timer=self.timer)

    def _protected_kfs(self) -> set:
        """Keyframes the culler must not erase: the tracker's current
        reference keyframe, through which every later frame record
        chains, and the loop-edge holders (ref: KeyFrame.cc:459-476)."""
        prot = {self.tracker.last_kf_id}
        if self.loop_closer is not None:
            prot |= {k for i, j, _ in self.loop_closer.loop_edges
                     for k in (i, j)}
        return prot

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
        if self.loop_closer is not None:
            self.loop_closer.on_keyframe_culled(k)

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
        self._run_loop_closer([])

    def _advance_mapping(self) -> None:
        with self.timer.stage("map.advance"):
            done = self.mapper.advance(self.tracker)
        self._run_loop_closer(done)

    def _run_loop_closer(self, kf_indices, block: bool = False) -> None:
        """Loop closing for the keyframes whose mapping completed: their
        BoW quantization is enqueued now, detection runs when the words
        have landed (ref: LocalMapping.cc:90 InsertKeyFrame -> the
        LoopClosing::Run queue)."""
        if self.loop_closer is None:
            return
        with self.timer.stage("loop_closing"):
            for kf_idx in kf_indices:
                self.loop_closer.begin_keyframe(self.tracker, kf_idx)
            self.loop_closer.poll(self.tracker, block=block)

    def flush(self) -> Optional[np.ndarray]:
        """Complete all in-flight work: retire the pipelined frames and
        drain the mapper (call before reading the map or shutting
        down). Returns the last retired pose, if any."""
        pose = None
        while self.tracker.inflight_count:
            p = self._retire_one()
            pose = p if p is not None else pose
        done = self.mapper.drain(self.tracker)
        self._run_loop_closer(done, block=True)
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
            if self.loop_closer is not None:
                # an in-flight GBA holds pre-compaction ids
                self.loop_closer.finish_gba(self.tracker)
            compact_mod.compact_map(self)
        self.compactions += 1

    def activate_localization_mode(self) -> None:
        """Track against the frozen map without inserting keyframes
        (ref: System.cc:220-231)."""
        self.flush()
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self) -> None:
        """ref: System.cc:233-243."""
        self.tracker.only_tracking = False

    def seed_localization_pose(self, pose_tcw: np.ndarray,
                               ref_kf: int) -> None:
        """Re-seed tracking at a known pose and reference keyframe (for
        replays that jump in time against a frozen map): clears the
        velocity model and re-anchors the reference keyframe and the
        local map, as relocalization does. A culled ``ref_kf`` is
        replaced by the live keyframe nearest the pose."""
        m, tr = self.map, self.tracker
        ref_kf = int(ref_kf)
        if not m.kf_valid[ref_kf]:
            valid = np.where(m.kf_valid[: m.n_keyframes])[0]
            c = -pose_tcw[:3, :3].T @ pose_tcw[:3, 3]
            centers = np.stack([m.kf_camera_center(int(k)) for k in valid])
            ref_kf = int(valid[np.argmin(((centers - c) ** 2).sum(1))])
        self._anchor_at(ref_kf)
        tr.carry = tr.carry._replace(
            pose=to_device(pose_tcw.astype(np.float32), tr.device),
            has_velocity=torch.zeros((), dtype=torch.bool, device=tr.device))

    def _anchor_at(self, kf_idx: int) -> None:
        """Make ``kf_idx`` the tracker's reference keyframe: its
        descriptors, angles and point ids for the anchor, and its
        covisible local map."""
        tr = self.tracker
        tr.last_kf_id = kf_idx
        tr._ref_desc_u8 = tr.kf_store.desc_u8[kf_idx].clone()
        tr._ref_angle = tr.kf_store.angle[kf_idx].clone()
        pts = self.mapper._kf_point_ids(kf_idx)
        tr._ref_pt_idx = to_device(pts.astype(np.int32), tr.device)
        tr.refresh_local_map(kf_idx)

    @contextlib.contextmanager
    def _reloc_search(self, n: int):
        """Count ``n`` K2 searches of relocalization and their launches."""
        before = kernel_match.LAUNCHES
        yield
        self.reloc_k2_searches += n
        self.reloc_k2_launches += kernel_match.LAUNCHES - before

    def _relocalize(self, f, timestamp: float) -> Optional[np.ndarray]:
        """Relocalization from the keyframe database
        (ref: Tracking.cc:1237-1396): BoW candidates, a K2 brute force
        against each, EPnP RANSAC, a coarse K2 projection round (window
        10) and pose polishing, a fine round (window 3) when the coarse
        one lands 15-49 inliers; accept at 50 inliers. Lost with at most
        5 keyframes, the session resets (ref: Tracking.cc:417-425)."""
        del timestamp
        if self.map.n_keyframes <= 5:
            self.reset()
            return None
        lc = self.loop_closer
        if lc is None:
            return None
        self.reloc_attempts += 1
        tr, m = self.tracker, self.map
        dev = tr.device
        words, _ = voc_mod.transform(lc.voc, f.desc_u8, f.semantic)
        bow = voc_mod.bow_vector(lc.voc, words.cpu().numpy())
        cands = lc.db.detect_relocalization_candidates(bow,
                                                       lc._covis_groups())
        self.reloc_candidates.append(list(cands))
        sf = self.cfg.orb.scale_factor
        sigma2 = sf ** (2.0 * f.level.to(torch.float32))
        store = tr.kf_store
        for cand in cands[:5]:
            pts = lc._kf_point_ids(cand)
            with self._reloc_search(1):
                res_bf = matching.search_brute_force(
                    store.desc_u8[cand], to_device(pts >= 0, dev),
                    store.angle[cand], f.desc_u8, f.semantic, f.angle,
                    nn_ratio=0.75)  # ref: Tracking.cc:1255
            src = HostCopy({"src": res_bf.src_for_dst}).result()["src"]
            hit = src >= 0
            if hit.sum() < 15:  # ref: Tracking.cc:1283
                continue
            pt_ids = np.full(f.capacity, -1, np.int64)
            pt_ids[hit] = pts[src[hit]]

            def points_of(ids):
                has = ids >= 0
                pw = np.zeros((f.capacity, 3), np.float32)
                pw[has] = m.pt_pos[ids[has]]
                return to_device(pw, dev), to_device(has, dev)

            pw_d, has_d = points_of(pt_ids)
            gen = torch.Generator(device=dev)
            gen.manual_seed(tr.frame_count)
            res = pnp_mod.ransac_pnp(pw_d, f.xy, sigma2, has_d, gen, tr.cam)
            if not bool(res.ok):
                continue
            # projection round (ref: Tracking.cc:1342-1385): grow the
            # match set from the candidate's covisible local map
            ids = m.local_point_ids(cand, ts.LOCAL_CAND)
            pad = np.full(ts.LOCAL_CAND, -1, np.int32)
            pad[: len(ids)] = ids
            pad_d = to_device(pad, dev)

            def project_round(pose, th):
                proj = self._reloc_project(pad_d, pose, f, th)
                merged = pt_ids.copy()
                fill = (merged < 0) & (proj >= 0)
                merged[fill] = proj[fill]
                return merged

            pt_ids = project_round(res.pose, 10.0)  # ref window th=10
            pw_d, has_d = points_of(pt_ids)
            obs = pose_lm.PoseObservations(
                points=pw_d, uvr=torch.cat([f.xy, f.u_right[:, None]], -1),
                sigma2=sigma2, is_stereo=f.u_right > 0, valid=has_d)
            final = pose_lm.optimize_pose(res.pose, obs, tr.cam)
            n_in = int(final.n_inliers)
            if 15 <= n_in < 50:
                # fine round (ref: Tracking.cc:1360-1385): a narrow
                # window around the polished pose
                pt_ids = project_round(final.pose, 3.0)
                pw_d, has_d = points_of(pt_ids)
                obs = obs._replace(points=pw_d, valid=has_d)
                final = pose_lm.optimize_pose(final.pose, obs, tr.cam)
                n_in = int(final.n_inliers)
            if n_in < 50:
                continue
            # success: rebuild the tracker's state at the new pose
            self.reloc_successes += 1
            out = HostCopy({"pose": final.pose, "cov": final.covariance,
                            "inl": final.inliers}).result()
            pose, cov = out["pose"], out["cov"]
            pt_ids[~out["inl"]] = -1
            tr.last_pose, tr.last_cov = pose, cov
            tr.state = TrackingState.OK
            # re-anchor the reference keyframe and the local map at the
            # relocalization site
            self._anchor_at(cand)
            tr.carry = tr.carry._replace(
                pose=final.pose, cov=final.covariance,
                has_velocity=torch.zeros((), dtype=torch.bool, device=dev),
                pt_idx=to_device(pt_ids.astype(np.int32), dev),
                desc_u8=f.desc_u8, level=f.level, angle=f.angle,
                valid=f.valid)
            if tr.trajectory:
                tr.trajectory[-1].pose = pose
                tr.trajectory[-1].rel_pose = tr._rel_pose(pose)
                tr.trajectory[-1].ref_kf = cand
                tr.trajectory[-1].lost = False
            return pose
        return None

    def _reloc_project(self, local_ids: torch.Tensor, pose: torch.Tensor,
                       f, th: float) -> np.ndarray:
        """Relocalization projection round (ref: Tracking.cc:1342-1385):
        SearchByProjection of the local map around ``pose``, one K2
        search. Returns (N,) point id per keypoint, or -1."""
        dm = self.tracker.dmap
        sf, nl = self.cfg.orb.scale_factor, self.cfg.orb.n_levels
        cand = torch.clamp(local_ids, 0, dm.capacity - 1).long()
        visible, uvr, dist, view_cos = frustum_check(
            self.tracker.cam, pose, dm.pt_pos[cand], dm.pt_normal[cand],
            dm.pt_min_dist[cand], dm.pt_max_dist[cand])
        visible = visible & (local_ids >= 0) & dm.pt_valid[cand]
        lvl = predict_scale(dist, dm.pt_max_dist[cand] / 1.2, sf, nl)
        scales = sf ** torch.arange(nl, dtype=torch.float32,
                                    device=pose.device)
        with self._reloc_search(1):
            res = matching.search_by_projection_points(
                dm.pt_desc_u8[cand], visible, uvr, lvl, view_cos, f.xy,
                f.level, f.desc_u8, f.u_right, f.semantic, scales, th=th,
                nn_ratio=0.8)
        hit = res.src_for_dst >= 0
        ids = torch.where(
            hit, cand[torch.clamp(res.src_for_dst, 0, cand.shape[0] - 1)
                      .long()].to(torch.int32),
            torch.full_like(res.src_for_dst, -1))
        return HostCopy({"ids": ids}).result()["ids"].astype(np.int64)

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
