"""Local mapping: the per-keyframe refinement pipeline (port of
``sivo_tpu/runtime/mapping.py``; ref: LocalMapping.cc:55-114).

Per keyframe: point culling, epipolar triangulation of new points
(CreateNewMapPoints with the SIVO CheckSemantics gate), two-way
SearchInNeighbors fusion of duplicates (ref: LocalMapping.cc:547-637),
local BA and keyframe culling. The reference runs this on its own
thread; here each keyframe advances through two pipeline stages, as in
the JAX package: phase 1 (cull counters, triangulation, fusion) and,
once phase 1 has been applied, BA. A stage's device outputs are copied
to pinned host memory behind a recorded CUDA event (``HostCopy``);
``advance`` applies a stage once its event has completed, so on the card
the stage's device work overlaps the next frames' tracking. On the CPU
every stage is complete when ``advance`` looks, and ``drain`` runs the
pipeline to its end.

Fusion runs kernel K2 through ``matching.search_by_projection_points``,
one search for each covisible neighbour and one in reverse;
``fuse_searches`` counts them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.geometry.projection import (
    CameraParams, frustum_check, predict_scale)
from sivo_tpu_torch.ops import matching
from sivo_tpu_torch.ops import triangulation as tri
from sivo_tpu_torch.optim import local_ba
from sivo_tpu_torch.runtime import device_map
from sivo_tpu_torch.runtime import kf_store as kfs_mod
from sivo_tpu_torch.runtime.map_state import MapState
from sivo_tpu_torch.utils.profiling import StageTimer
from sivo_tpu_torch.utils.transfer import HostCopy, to_device

# Local-BA window caps: the reference's window is data-sized
# (Optimizer.cc:496-559); fixed shapes need caps.
MAX_BA_KF = 16
MAX_BA_PT = 4096  # covisible-window points (recent-first beyond this)
MAX_BA_OBS = 8192
FUSE_NEIGHBORS = 10
P_CAP = 2048  # fusion candidate points per direction
CULL_WINDOW = 8192  # recent-point id window examined per keyframe
ID_UPLOAD_CAP = 4096  # ids per count / kill upload, as in the JAX package


def fuse_search(tracker, cam: CameraParams, cfg: SystemConfig,
                pt_ids: torch.Tensor, pt_alive: torch.Tensor, slot: int,
                pose: np.ndarray) -> torch.Tensor:
    """Project the candidate points into keyframe ``slot`` at ``pose``
    and match them there (ref: ORBmatcher Fuse, ORBmatcher.cc:787-930):
    one K2 search. Used by the mapper's fusion and the loop closer's
    SearchAndFuse. Returns (N,) int32 index into the candidates per
    keypoint, or -1."""
    dev = tracker.device
    dm, store = tracker.dmap, tracker.kf_store
    sf, nl = cfg.orb.scale_factor, cfg.orb.n_levels
    ids = pt_ids.long()
    maxd = dm.pt_max_dist[ids]
    visible, uvr, dist, view_cos = frustum_check(
        cam, to_device(pose, dev), dm.pt_pos[ids], dm.pt_normal[ids],
        dm.pt_min_dist[ids], maxd)
    lvl = predict_scale(dist, maxd / 1.2, sf, nl)
    scales = sf ** torch.arange(nl, dtype=torch.float32, device=dev)
    res = matching.search_by_projection_points(
        dm.pt_desc_u8[ids], visible & pt_alive & dm.pt_valid[ids], uvr,
        lvl, view_cos, store.xy[slot], store.level[slot],
        store.desc_u8[slot], store.u_right[slot], store.semantic[slot],
        scales, th=3.0, nn_ratio=1.0, accept_th=matching.TH_LOW)
    return res.src_for_dst


@dataclass
class LocalMapper:
    """Two-stage pipelined mapper (see the module docstring)."""

    cfg: SystemConfig
    map: MapState
    cam: CameraParams
    timer: StageTimer
    # System's hooks: each culled keyframe is reported; the protected
    # keyframes are never culled
    on_kf_culled: Callable[[int], None]
    kf_protected: Callable[[], set]

    def __post_init__(self):
        self._phase1 = None
        self._ba = None
        # keyframes not yet admitted to phase 1 (the reference's
        # mlNewKeyFrames, LocalMapping.cc:116-125); the tracker's
        # keyframe decision reads queue_len for backpressure
        self._queue: list[int] = []
        self._admit_waited = False
        self._kfs_since_ba = 0
        # times a fixed capacity truncated real work, by cap
        self.cap_binds: dict[str, int] = {}
        self.fuse_searches = 0  # K2 searches run by fusion
        self.points_triangulated = 0  # points minted by triangulation
        self.ba_solves = 0  # local BA solves applied
        # admissions deferred a frame because the keyframe's host
        # bookkeeping copy had not landed
        self.admit_waits = 0

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        return (self._phase1 is not None or self._ba is not None
                or bool(self._queue))

    def _bind(self, cap: str, n: int = 1) -> None:
        self.cap_binds[cap] = self.cap_binds.get(cap, 0) + n

    def on_keyframe(self, kf_idx: int) -> None:
        """Enqueue a new keyframe (ref: LocalMapping.cc:116-120); it is
        admitted by a later ``advance``, once its host bookkeeping copy
        has had a frame to land."""
        self._queue.append(kf_idx)

    def _admit(self, tracker) -> None:
        """Move the oldest queued keyframe into phase 1 after completing
        its host bookkeeping. A keyframe whose bookkeeping copy has not
        landed waits one frame, unless another keyframe is queued."""
        pending = tracker._kf_host_pending.get(self._queue[0])
        if (pending is not None and not pending[0].done()
                and len(self._queue) == 1 and not self._admit_waited):
            self._admit_waited = True
            self.admit_waits += 1
            return
        self._admit_waited = False
        kf_idx = self._queue.pop(0)
        with self.timer.stage("map.finish_host"):
            tracker.finish_kf_host(kf_idx)
        with self.timer.stage("map.phase1_dispatch"):
            outs = {}
            ctx_cull = self._cull_dispatch(tracker, outs)
            ctx_tri = ctx_fuse = None
            if self.map.n_keyframes >= 2:
                ctx_tri = self._tri_dispatch(tracker, kf_idx, outs)
                ctx_fuse = self._fuse_dispatch(tracker, kf_idx, outs)
            copy = HostCopy(outs)
        self._phase1 = {"kf": kf_idx, "ctx_cull": ctx_cull,
                        "ctx_tri": ctx_tri, "ctx_fuse": ctx_fuse,
                        "copy": copy}

    def advance(self, tracker, block: bool = False) -> list[int]:
        """Apply the stages whose copies have landed (all of them with
        ``block``); called once per tracked frame. Returns the keyframes
        whose mapping completed (ready for loop closing)."""
        done: list[int] = []
        if self._ba is not None and (block or self._ba["copy"].done()):
            ba = self._ba
            self._ba = None
            with self.timer.stage("map.ba_apply"):
                self._ba_apply(tracker, ba)
            with self.timer.stage("map.cull_kfs"):
                self._cull_keyframes(ba["kf"])
            done.append(ba["kf"])
        if (self._phase1 is not None and self._ba is None
                and (block or self._phase1["copy"].done())):
            p = self._phase1
            self._phase1 = None
            fetched = p["copy"].result()
            kf_idx = p["kf"]
            with self.timer.stage("map.cull_points"):
                self._cull_apply(tracker, kf_idx, p["ctx_cull"], fetched)
            if p["ctx_tri"] is not None:
                with self.timer.stage("map.triangulate"):
                    self._tri_apply(tracker, kf_idx, p["ctx_tri"], fetched)
            if p["ctx_fuse"] is not None:
                with self.timer.stage("map.fuse"):
                    self._fuse_apply(tracker, kf_idx, p["ctx_fuse"], fetched)
            # the local point set changed: refresh the tracker's list
            tracker.refresh_local_map_latest()
            # BA when no newer keyframe waits (LocalMapping.cc:80-88),
            # with the JAX package's floor: never two keyframes in a row
            # without a solve
            self._kfs_since_ba += 1
            if self.map.n_keyframes >= 2 and (
                    not self._queue or self._kfs_since_ba >= 2):
                with self.timer.stage("map.ba_dispatch"):
                    self._ba = self._ba_dispatch(tracker, kf_idx)
                self._kfs_since_ba = 0
            if self._ba is None:
                done.append(kf_idx)
        if self._phase1 is None and self._queue:
            self._admit(tracker)
            if block and self._phase1 is not None:
                done += self.advance(tracker, block=True)
        return done

    def drain(self, tracker) -> list[int]:
        """Run the pipeline to completion (flush / backpressure); returns
        the keyframes whose mapping completed."""
        done: list[int] = []
        while self.busy:
            done += self.advance(tracker, block=True)
        return done

    def _neighbors(self, kf_idx: int, n: int) -> list[int]:
        """The ``n`` most covisible keyframes of ``kf_idx``."""
        covis = self.map.covisibility(kf_idx)
        order = np.argsort(-covis)
        return [int(k) for k in order if covis[k] > 0][:n]

    def _kf_point_ids(self, kf_idx: int) -> np.ndarray:
        out = np.full(self.map.kp_capacity, -1, np.int64)
        mine = self.map.obs_by_kf(kf_idx)
        if len(mine):
            out[mine[:, 2]] = mine[:, 1]
        return out

    # -- fusion ---------------------------------------------------------------

    def _fuse_search(self, tracker, pt_ids, pt_alive, slot: int,
                     pose: np.ndarray) -> torch.Tensor:
        """``fuse_search``, counted in ``fuse_searches``."""
        self.fuse_searches += 1
        return fuse_search(tracker, self.cam, self.cfg, pt_ids, pt_alive,
                           slot, pose)

    def _fuse_dispatch(self, tracker, kf_idx: int, outs: dict):
        """SearchInNeighbors device phase (ref: LocalMapping.cc:547-637
        + ORBmatcher Fuse :787-930), both directions: the new keyframe's
        points into each covisible neighbour, and the neighbours' points
        not yet seen by the new keyframe into it (ref:
        LocalMapping.cc:586-627)."""
        m = self.map
        dev = tracker.device
        neighbors = self._neighbors(kf_idx, FUSE_NEIGHBORS)
        if not neighbors:
            return None
        my_pts = self._kf_point_ids(kf_idx)
        pt_ids = np.unique(my_pts[my_pts >= 0])
        if len(pt_ids) == 0:
            return None
        if len(pt_ids) > P_CAP:
            self._bind("fuse_pts")
        pt_ids = pt_ids[:P_CAP]
        pad = np.zeros(P_CAP, np.int64)
        pad[: len(pt_ids)] = pt_ids
        alive = np.zeros(P_CAP, bool)
        alive[: len(pt_ids)] = m.pt_valid[pt_ids]
        pad_dev, alive_dev = to_device(pad, dev), to_device(alive, dev)
        outs["fuse_src"] = torch.stack([
            self._fuse_search(tracker, pad_dev, alive_dev, nb, m.kf_pose[nb])
            for nb in neighbors])

        # reverse: the neighbours' points the new keyframe does not see,
        # newest first under the cap
        nb_pts = m.points_seen_by(np.asarray(neighbors, np.int64))
        nb_pts = nb_pts[m.pt_valid[nb_pts]]
        mine = np.zeros(m.max_points, bool)
        mine[pt_ids] = True
        nb_pts = nb_pts[~mine[nb_pts]]
        pad_rev = None
        if len(nb_pts) > 0:
            if len(nb_pts) > P_CAP:
                self._bind("fuse_rev_pts")
                nb_pts = nb_pts[-P_CAP:]
            pad_rev = np.zeros(P_CAP, np.int64)
            pad_rev[: len(nb_pts)] = nb_pts
            alive_rev = np.zeros(P_CAP, bool)
            alive_rev[: len(nb_pts)] = True
            outs["fuse_rev_src"] = self._fuse_search(
                tracker, to_device(pad_rev, dev), to_device(alive_rev, dev),
                kf_idx, m.kf_pose[kf_idx])
        return {"neighbors": neighbors, "pad": pad, "pad_rev": pad_rev}

    def _fuse_apply(self, tracker, kf_idx: int, ctx: dict,
                    fetched: dict) -> None:
        """Fusion host phase: add cross observations, merge duplicates
        (ref: MapPoint::Replace)."""
        m = self.map
        dev = tracker.device
        replaced: dict[int, int] = {}
        merge_pairs: list[tuple[int, int]] = []  # (kill, keep)
        obs_counts = m.point_obs_counts()
        max_merges = 50  # bound on the Replace rewrites per target

        def fuse_into(target_kf: int, src: np.ndarray, pad_ids):
            tgt_pts = self._kf_point_ids(target_kf)
            hit_kp = np.where(src >= 0)[0]
            if len(hit_kp) == 0:
                return
            pid = pad_ids[src[hit_kp]].astype(np.int64)
            ok = m.pt_valid[pid]
            hit_kp, pid = hit_kp[ok], pid[ok]
            existing = tgt_pts[hit_kp]
            # free keypoints -> new cross observations
            free = existing < 0
            if free.any():
                m.add_observations(target_kf, pid[free], hit_kp[free])
                ids = pid[free][:ID_UPLOAD_CAP].astype(np.int32)
                tracker.dmap = device_map.add_obs_counts(
                    tracker.dmap, to_device(ids, dev))
            # conflicts -> merge, keeping the more-observed point
            # (ref: MapPoint.cc:225-261); the table rewrite is one
            # batched replace_points_batch at the end
            conf = ((~free) & (existing != pid)
                    & m.pt_valid[np.maximum(existing, 0)])
            if int(conf.sum()) > max_merges:
                self._bind("fuse_merges")
            for p_i, e_i in zip(pid[conf][:max_merges],
                                existing[conf][:max_merges]):
                p_i = replaced.get(int(p_i), int(p_i))
                e_i = replaced.get(int(e_i), int(e_i))
                if p_i == e_i or not (m.pt_valid[p_i] and m.pt_valid[e_i]):
                    continue
                keep, kill = ((e_i, p_i) if obs_counts[e_i] >= obs_counts[p_i]
                              else (p_i, e_i))
                merge_pairs.append((kill, keep))
                m.pt_valid[kill] = False  # visible to later pairs
                m._valid_epoch += 1
                replaced[kill] = keep

        for nb, src_for_dst in zip(ctx["neighbors"], fetched["fuse_src"]):
            fuse_into(nb, src_for_dst, ctx["pad"])
        if ctx["pad_rev"] is not None:
            fuse_into(kf_idx, fetched["fuse_rev_src"], ctx["pad_rev"])
        if merge_pairs:
            m.replace_points_batch(
                np.array([p[0] for p in merge_pairs], np.int64),
                np.array([p[1] for p in merge_pairs], np.int64))
        if replaced:
            kill_ids = np.array(list(replaced)[:ID_UPLOAD_CAP], np.int32)
            tracker.dmap = device_map.invalidate_points(
                tracker.dmap, to_device(kill_ids, dev))

    # -- triangulation --------------------------------------------------------

    def _tri_dispatch(self, tracker, kf_idx: int, outs: dict):
        """CreateNewMapPoints device phase (ref: LocalMapping.cc:198-472):
        the new keyframe against its top covisible neighbours farther
        than one baseline (ref: LocalMapping.cc:236-244), in one batched
        call; keyframe arrays come from the device store, and only the
        host's "keypoint has no map point yet" masks and the poses are
        uploaded."""
        m = self.map
        dev = tracker.device
        B = self.cfg.mapping.n_triangulate_neighbors
        neighbors = self._neighbors(kf_idx, B)
        if not neighbors:
            return None
        d1 = m.kf_data[kf_idx]
        pts1 = self._kf_point_ids(kf_idx)
        c1 = m.kf_camera_center(kf_idx)
        baseline = self.cam.bf / self.cam.fx
        neighbors = [nb for nb in neighbors
                     if np.linalg.norm(m.kf_camera_center(nb) - c1)
                     >= baseline]
        if not neighbors:
            return None
        N = m.kp_capacity
        t2 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        free2 = np.zeros((B, N), bool)  # keypoint has no map point yet
        nb_pad = np.zeros(B, np.int64)
        nb_valid = np.zeros(B, bool)
        for i, nb in enumerate(neighbors):
            t2[i] = m.kf_pose[nb]
            free2[i] = self._kf_point_ids(nb) < 0
            nb_pad[i] = nb
            nb_valid[i] = True
        store = tracker.kf_store
        g2 = kfs_mod.gather(store, to_device(nb_pad, dev))
        res = tri.triangulate_neighbors(
            to_device(m.kf_pose[kf_idx], dev), store.xy[kf_idx],
            store.level[kf_idx], store.desc_u8[kf_idx],
            to_device(pts1 < 0, dev) & store.semantic[kf_idx],
            store.u_right[kf_idx], store.sem_class[kf_idx],
            store.sem_confidence[kf_idx], store.sem_entropy[kf_idx],
            to_device(m.kf_cov[kf_idx], dev),
            to_device(t2, dev), g2.xy, g2.level, g2.desc_u8,
            to_device(free2, dev) & g2.semantic, g2.sem_class,
            to_device(nb_valid, dev),
            float(self.cfg.semantic.th_confidence),
            float(self.cfg.semantic.th_entropy_reduction), self.cam,
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
        outs["tri_xw"] = res.xw
        outs["tri_kp2"] = res.kp2
        outs["tri_acc"] = res.accepted
        return {"d1": d1, "c1": c1, "neighbors": neighbors}

    def _tri_apply(self, tracker, kf_idx: int, ctx: dict,
                   fetched: dict) -> None:
        """Triangulation host phase: mint the accepted points on the
        host and the device, in the same order."""
        m = self.map
        dev = tracker.device
        d1, neighbors = ctx["d1"], ctx["neighbors"]
        acc = fetched["tri_acc"]  # (B, N)
        first_nb = np.argmax(acc, axis=0)  # first accepting neighbour
        kp1_idx = np.where(acc.any(axis=0))[0]
        if len(kp1_idx) == 0:
            return
        # capacity cut on the candidate list BEFORE minting, so host and
        # device mint the same ids (the id-lockstep contract)
        avail = m.max_points - m.n_points
        if len(kp1_idx) > avail:
            self._bind("tri_capacity", len(kp1_idx) - avail)
            kp1_idx = kp1_idx[:avail]
            if len(kp1_idx) == 0:
                return
        nb_of = first_nb[kp1_idx]
        xw = fetched["tri_xw"][nb_of, kp1_idx]
        kp2_idx = fetched["tri_kp2"][nb_of, kp1_idx]
        ids = m.add_points(xw.astype(np.float32), d1.desc_u8[kp1_idx],
                           d1.sem_class[kp1_idx], kf_idx, kp1_idx,
                           d1.level[kp1_idx])
        self.points_triangulated += len(ids)
        for i, nb in enumerate(neighbors):
            sel = nb_of == i
            if sel.any():
                m.add_observations(nb, ids[sel], kp2_idx[sel])
        # the cross observations' counts, for the keyframe policy's n_ref
        tracker.dmap = device_map.add_obs_counts(
            tracker.dmap, to_device(ids[:ID_UPLOAD_CAP].astype(np.int32),
                                    dev))
        N = m.kp_capacity
        sel_full = np.zeros(N, bool)
        sel_full[kp1_idx] = True
        xw_full = np.zeros((N, 3), np.float32)
        xw_full[kp1_idx] = xw
        store = tracker.kf_store
        tracker.dmap, _ = device_map.add_points(
            tracker.dmap, to_device(sel_full, dev), to_device(xw_full, dev),
            store.desc_u8[kf_idx], store.sem_class[kf_idx],
            store.level[kf_idx], to_device(ctx["c1"].astype(np.float32), dev),
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels)

    # -- keyframe culling -----------------------------------------------------

    def _cull_keyframes(self, kf_idx: int) -> None:
        """KeyFrameCulling (ref: LocalMapping.cc:727-792): a covisible
        keyframe is redundant when over 90% of its tracked points are
        observed by >= 3 other keyframes at the same or a finer scale
        (level <= level + 1). Culled keyframes stay in the pose chain
        for the trajectory (kf_valid=False removes them from use)."""
        m = self.map
        covis = m.covisibility(kf_idx)
        obs = m.observations()
        if len(obs) == 0:
            return
        level_stack = np.stack([
            m.kf_data[k].level if m.kf_data[k] is not None
            else np.zeros(m.kp_capacity, np.int32)
            for k in range(m.n_keyframes)])
        obs_level = level_stack[obs[:, 0], obs[:, 2]]
        # key pt * 16 + level (levels < 16): count every observation at
        # the same or a finer scale, then subtract the keyframe's own
        key_all_sorted = np.sort(obs[:, 1] * 16 + np.minimum(obs_level, 15))
        protected = self.kf_protected()
        for k in np.where(covis > 0)[0]:
            if k == 0 or not m.kf_valid[k] or int(k) in protected:
                continue
            mine = m.obs_by_kf(int(k))
            if len(mine) < 10:
                continue
            my_level = level_stack[mine[:, 0], mine[:, 2]]
            hi = np.searchsorted(
                key_all_sorted,
                mine[:, 1] * 16 + np.minimum(my_level + 1, 15), side="right")
            lo = np.searchsorted(key_all_sorted, mine[:, 1] * 16,
                                 side="left")
            n_redundant = int((hi - lo - 1 >= 3).sum())
            if n_redundant > self.cfg.mapping.kf_cull_redundancy * len(mine):
                m.kf_valid[k] = False
                m._obs_dirty = True
                self.on_kf_culled(int(k))

    # -- point culling ------------------------------------------------------

    def _cull_dispatch(self, tracker, outs: dict) -> dict:
        """MapPointCulling device phase: the counters of the recent-point
        id window (culling only examines points at most 3 keyframes old,
        and ids are minted in creation order)."""
        lo = max(0, self.map.n_points - CULL_WINDOW)
        dm = tracker.dmap
        outs["cull_found"] = dm.pt_found[lo:lo + CULL_WINDOW]
        outs["cull_visible"] = dm.pt_visible[lo:lo + CULL_WINDOW]
        outs["cull_valid"] = dm.pt_valid[lo:lo + CULL_WINDOW]
        return {"lo": lo}

    def _cull_apply(self, tracker, kf_idx: int, ctx: dict,
                    fetched: dict) -> None:
        """MapPointCulling (ref: LocalMapping.cc:165-196) over the
        reference's recent-point list: the found/visible ratio and
        observation tests apply while a point is at most 3 keyframes
        old. Observation counts come from the host table (it includes
        the cross observations of triangulation and fusion), weighted
        as the reference's (a stereo observation counts 2)."""
        m = self.map
        lo = ctx["lo"]
        n = min(m.n_points, lo + CULL_WINDOW)
        w = n - lo
        if w <= 0:
            return
        found = fetched["cull_found"][:w].astype(np.float32)
        visible = np.maximum(fetched["cull_visible"][:w].astype(np.float32),
                             1.0)
        obs = m.point_obs_counts_weighted()[lo:n]
        valid = fetched["cull_valid"][:w]
        first = m.pt_first_kf[lo:n]
        age = kf_idx - first  # in keyframes
        in_list = (first < kf_idx) & (age <= 3)
        ratio_bad = (found / visible) < self.cfg.mapping.found_ratio_min
        # ref: LocalMapping.cc:186-187, cnThObs = 3 for stereo
        obs_bad = (age >= 2) & (obs <= self.cfg.mapping.min_obs_stereo)
        kill_ids = np.where(valid & in_list & (ratio_bad | obs_bad))[0] + lo
        if len(kill_ids) == 0:
            return
        m.mark_points_invalid(kill_ids)
        tracker.dmap = device_map.invalidate_points(
            tracker.dmap,
            to_device(kill_ids[:ID_UPLOAD_CAP].astype(np.int32),
                      tracker.device))

    # -- local bundle adjustment ---------------------------------------------

    def _ba_dispatch(self, tracker, kf_idx: int) -> dict | None:
        """Build the covisible-window problem and enqueue the device
        solve (ref: Optimizer.cc:493-926 via LocalMapping.cc:80-88); the
        write-back happens in ``_ba_apply`` once its copy has landed."""
        m = self.map
        dev = tracker.device
        local = [kf_idx] + self._neighbors(kf_idx, MAX_BA_KF - 1)
        local_set = set(local)
        pt_ids = m.points_seen_by(np.asarray(local, np.int64))
        if len(pt_ids) == 0:
            return None
        if len(pt_ids) > MAX_BA_PT:
            self._bind("ba_pts")
            pt_ids = pt_ids[-MAX_BA_PT:]  # prefer recent points

        # fixed frontier: keyframes outside the window observing these
        # points; always fix at least one camera for the gauge
        # (ref: Optimizer.cc:567-575)
        obs = m.observations()
        obs = obs[np.isin(obs[:, 1], pt_ids)]
        frontier = [int(k) for k in np.unique(obs[:, 0])
                    if k not in local_set]
        if not frontier:
            frontier = [local.pop()] if len(local) > 1 else []
        kfs = local + frontier
        if len(kfs) > MAX_BA_KF:
            self._bind("ba_kfs")
        kfs = kfs[:MAX_BA_KF]
        kf_slot = {k: i for i, k in enumerate(kfs)}
        fixed = np.zeros(MAX_BA_KF, bool)
        fixed[len(local):len(kfs)] = True
        if not fixed.any():
            fixed[min(len(kfs) - 1, MAX_BA_KF - 1)] = True
        if len(kfs) == 1:
            return None  # nothing to adjust against

        valid_kf = np.zeros(MAX_BA_KF, bool)
        valid_kf[: len(kfs)] = True
        poses = np.tile(np.eye(4, dtype=np.float32), (MAX_BA_KF, 1, 1))
        poses[: len(kfs)] = m.kf_pose[kfs]
        pts = np.zeros((MAX_BA_PT, 3), np.float32)
        pts[: len(pt_ids)] = m.pt_pos[pt_ids]
        valid_pt = np.zeros(MAX_BA_PT, bool)
        valid_pt[: len(pt_ids)] = m.pt_valid[pt_ids]

        # observations from keyframes in the window
        rows = obs[np.isin(obs[:, 0], kfs)]
        if len(rows) > MAX_BA_OBS:
            self._bind("ba_obs")
            rows = rows[-MAX_BA_OBS:]
        o = len(rows)
        obs_kf = np.zeros(MAX_BA_OBS, np.int64)
        obs_pt = np.zeros(MAX_BA_OBS, np.int64)
        obs_uvr = np.zeros((MAX_BA_OBS, 3), np.float32)
        obs_sigma2 = np.ones(MAX_BA_OBS, np.float32)
        obs_stereo = np.zeros(MAX_BA_OBS, bool)
        obs_valid = np.zeros(MAX_BA_OBS, bool)
        kf_slot_arr = np.zeros(m.max_keyframes, np.int64)
        for k, i in kf_slot.items():
            kf_slot_arr[k] = i
        pt_slot_arr = np.zeros(m.max_points, np.int64)
        pt_slot_arr[pt_ids] = np.arange(len(pt_ids))
        obs_kf[:o] = kf_slot_arr[rows[:, 0]]
        obs_pt[:o] = pt_slot_arr[rows[:, 1]]
        sf = self.cfg.orb.scale_factor
        for k in kfs:
            sel = rows[:, 0] == k
            if not sel.any():
                continue
            kp = rows[sel, 2]
            data = m.kf_data[k]
            ur = data.u_right[kp]
            obs_uvr[:o][sel] = np.stack(
                [data.xy[kp, 0], data.xy[kp, 1], np.maximum(ur, 0.0)], -1)
            obs_sigma2[:o][sel] = sf ** (2.0 * data.level[kp].astype(
                np.float32))
            obs_stereo[:o][sel] = ur > 0
        obs_valid[:o] = True

        with self.timer.stage("map.ba_upload"):
            prob = local_ba.BAProblem(*(to_device(a, dev) for a in (
                poses, fixed, valid_kf, pts, valid_pt, obs_kf, obs_pt,
                obs_uvr, obs_sigma2, obs_stereo, obs_valid)))
        with self.timer.stage("map.ba_solve_call"):
            res = local_ba.local_bundle_adjustment(prob, 0, self.cam)
        with self.timer.stage("map.ba_fetch_start"):
            copy = HostCopy({"kf_pose": res.kf_pose, "pt_pos": res.pt_pos,
                             "inlier": res.obs_inlier,
                             "cov": res.newest_cov})
        return {"kf": kf_idx, "kfs": kfs, "fixed": fixed, "pt_ids": pt_ids,
                "rows": rows, "o": o, "copy": copy,
                "pt_pos_dev": res.pt_pos,
                # pre-BA pose of the newest window keyframe (slot 0), to
                # re-anchor the tracker in _ba_apply
                "newest_pose_before": poses[0].copy()}

    def _ba_apply(self, tracker, ba: dict) -> None:
        """Write back the BA solution (host map + device mirror) and
        erase outlier observations (ref: Optimizer.cc:822-912)."""
        m = self.map
        out = ba["copy"].result()
        kfs, fixed, pt_ids = ba["kfs"], ba["fixed"], ba["pt_ids"]
        new_poses = out["kf_pose"]
        for i, k in enumerate(kfs):
            if not fixed[i]:
                m.kf_pose[k] = new_poses[i]
        m.kf_cov[ba["kf"]] = out["cov"]
        # re-anchor the tracker on the corrected newest keyframe
        # (ref: Tracking.cc:641-646 UpdateLastFrame)
        if not fixed[0]:
            tracker.apply_world_correction(ba["newest_pose_before"],
                                           new_poses[0])
        m.pt_pos[pt_ids] = out["pt_pos"][: len(pt_ids)]
        ids_pad = np.full(MAX_BA_PT, -1, np.int32)
        ids_pad[: len(pt_ids)] = pt_ids
        tracker.dmap = device_map.set_positions(
            tracker.dmap, to_device(ids_pad, tracker.device),
            ba["pt_pos_dev"])
        # erase outlier observations (ref: Optimizer.cc:822-870)
        bad = ba["rows"][~out["inlier"][: ba["o"]]]
        if len(bad):
            m.erase_observations(bad)
        self.ba_solves += 1
