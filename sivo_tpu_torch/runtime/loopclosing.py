"""Loop closing: detection, Sim3 computation and loop correction (port of
``sivo_tpu/runtime/loopclosing.py``; ref: LoopClosing.cc).

Runs at keyframe rate after local mapping, with the reference's policy
constants: >= 10 keyframes between loops, covisibility-consistency run
length 3, >= 20 brute-force matches per candidate, Sim3 RANSAC with >=
20 inliers, accept at >= 40 total matches. The correction seeds the
loop keyframe's covisible window with the Sim3, optimizes the essential
graph, fuses the duplicated geometry and starts a full-map BA.

Each stage enqueues its device work and starts a copy of its small
result into pinned host memory behind a CUDA event
(``utils/transfer.HostCopy``); ``poll`` applies a stage once its event
has completed, so ``poll(block=False)`` never waits on the device and
the attempt overlaps the next frames' tracking, the equivalent of the
reference's LoopClosing thread. The graph bookkeeping stays on the host.

Every descriptor search is kernel K2 (``ops/matching``): the brute
force (one search), the guided ``search_by_sim3`` (two) and the loop
fuse (one per target keyframe). ``k2_searches`` counts them and
``k2_launches`` counts the K2 launches the wrapper made meanwhile; on a
card the two are equal.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.geometry.projection import CameraParams
from sivo_tpu_torch.ops import kernel_match, matching
from sivo_tpu_torch.optim import ba_build, gba_cg, local_ba, pose_graph
from sivo_tpu_torch.optim import sim3_opt
from sivo_tpu_torch.place import database as db_mod
from sivo_tpu_torch.place import vocabulary as voc_mod
from sivo_tpu_torch.runtime import device_map
from sivo_tpu_torch.runtime.map_state import MapState
from sivo_tpu_torch.runtime.mapping import fuse_search
from sivo_tpu_torch.utils.transfer import HostCopy, to_device


def _h_compose(a, b):
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta)


def _h_inverse(g):
    s, R, t = g
    return (1.0 / s, R.T, -(R.T @ t) / s)


def _h_to_se3(g):
    s, R, t = g
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t / s
    return T


def _h_from_se3(T):
    T = T.astype(np.float64)
    return (1.0, T[:3, :3].copy(), T[:3, 3].copy())


def _center(T):
    T = T.astype(np.float64)
    return -T[:3, :3].T @ T[:3, 3]


@dataclass
class LoopCloser:
    cfg: SystemConfig
    map: MapState
    cam: CameraParams
    voc: voc_mod.Vocabulary
    db: db_mod.KeyFrameDatabase = None
    last_loop_kf: int = -10**9
    # covisibility-consistency state (ref: LoopClosing.cc:111-240)
    consistent_groups: list = field(default_factory=list)
    loops_closed: int = 0
    # persisted loop edges (i, j, Tij 4x4): every later essential-graph
    # solve keeps them (ref: KeyFrame.cc:448-457 AddLoopEdge +
    # Optimizer.cc:1040-1056)
    loop_edges: list = field(default_factory=list)
    # per-closure diagnostics (kf, cand, correction_m, ...)
    loop_events: list = field(default_factory=list)
    # times a fixed capacity truncated real work, by cap
    cap_binds: dict = field(default_factory=dict)
    # optional StageTimer (wired by System) for the lc.* stages
    timer: object = None

    def __post_init__(self):
        if self.db is None:
            self.db = db_mod.KeyFrameDatabase(n_words=self.voc.n_words)
        # keyframes whose word copy is in flight: (kf_idx, HostCopy)
        self._pending: list[tuple] = []
        # in-flight Sim3 attempts (the state machine of _advance_sim3)
        self._sim3q: list[dict] = []
        # bumped whenever a correction or GBA rewrites map geometry; an
        # attempt whose stages straddle a bump holds stale poses/points
        self._map_epoch = 0
        # the post-loop global BA in flight (the reference's GBA thread)
        self._gba = None
        self._scales = {}
        self.k2_searches = 0
        self.k2_launches = 0
        self.gba_dispatched = {"dense": 0, "pcg": 0}
        self.gba_applied = 0

    def _stage(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.stage(name)

    def _bind(self, cap: str, n: int = 1) -> None:
        self.cap_binds[cap] = self.cap_binds.get(cap, 0) + n

    @contextlib.contextmanager
    def _k2(self, n_searches: int):
        """Count ``n_searches`` K2 searches and the launches they made."""
        before = kernel_match.LAUNCHES
        yield
        self.k2_searches += n_searches
        self.k2_launches += kernel_match.LAUNCHES - before

    # -- helpers -------------------------------------------------------------

    def _bow(self, kf_idx: int, tracker=None) -> dict[int, float]:
        """A keyframe's BoW vector, from the device keyframe store, or
        from the host keyframe data without a tracker."""
        if tracker is not None:
            desc = tracker.kf_store.desc_u8[kf_idx]
            sem = tracker.kf_store.semantic[kf_idx]
        else:
            d = self.map.kf_data[kf_idx]
            desc = torch.from_numpy(np.array(d.desc_u8, np.uint8))
            sem = torch.from_numpy(np.array(d.semantic, bool))
        words, _ = voc_mod.transform(self.voc, desc, sem)
        return voc_mod.bow_vector(self.voc, words.cpu().numpy())

    def _covis_groups(self) -> dict[int, list[int]]:
        return self.map.covis_top10()

    def _kf_point_ids(self, kf_idx: int) -> np.ndarray:
        out = np.full(self.map.kp_capacity, -1, np.int64)
        mine = self.map.obs_by_kf(kf_idx)
        if len(mine):
            out[mine[:, 2]] = mine[:, 1]
        return out

    def _scales_on(self, device: torch.device) -> torch.Tensor:
        if device not in self._scales:
            self._scales[device] = to_device(
                self.cfg.orb.scale_factor
                ** np.arange(self.cfg.orb.n_levels, dtype=np.float32),
                device)
        return self._scales[device]

    # -- pipeline ------------------------------------------------------------

    def process_keyframe(self, tracker, kf_idx: int) -> bool:
        """Synchronous detection and correction (tests, flush). True if
        a loop was closed at this keyframe."""
        self.begin_keyframe(tracker, kf_idx)
        return bool(self.poll(tracker, block=True))

    def begin_keyframe(self, tracker, kf_idx: int) -> None:
        """Enqueue the BoW quantization of a mapped keyframe and start
        the copy of its words; detection runs in ``poll`` once the copy
        has landed (the reference's LoopClosing thread consumes its
        queue with the same lag, LoopClosing.cc:72-98)."""
        with self._stage("lc.begin"):
            store = tracker.kf_store
            words, _ = voc_mod.transform(self.voc, store.desc_u8[kf_idx],
                                         store.semantic[kf_idx])
            self._pending.append((kf_idx, HostCopy({"words": words})))

    def poll(self, tracker, block: bool = False) -> list[int]:
        """Advance the global BA, the Sim3 attempts and the keyframes
        whose word copies have landed (everything with ``block``).
        Returns the keyframes at which a loop was closed."""
        closed: list[int] = []
        if self._gba is not None:
            with self._stage("lc.gba_step"):
                self._gba_advance(block)
            if (self._gba is not None and self._gba["copy"] is not None
                    and (block or self._gba["copy"].done())):
                with self._stage("lc.gba_apply"):
                    self._gba_apply(tracker)
        self._advance_sim3(tracker, closed, block)
        while self._pending and (block or self._pending[0][1].done()):
            kf_idx, copy = self._pending.pop(0)
            if not self.map.kf_valid[kf_idx]:
                # culled while its words were in flight: adding it to the
                # inverted file would undo on_keyframe_culled's erase
                continue
            with self._stage("lc.bowvec"):
                bow = voc_mod.bow_vector(self.voc, copy.result()["words"])
            # Sim3 over the consistency-passing candidates, first that
            # converges wins (ref: LoopClosing.cc:242-340), as an async
            # attempt; at most 2 attempts in flight, 3 candidates each
            with self._stage("lc.detect"):
                cands = self._detect_loop(kf_idx, bow)
            if cands:
                if len(self._sim3q) < 2:
                    self._sim3q.append({"kf": kf_idx, "cands": cands[:3],
                                        "stage": "new"})
                else:
                    self._bind("sim3_attempts_dropped")
            self.db.add(kf_idx, bow)
        if self._sim3q:
            self._advance_sim3(tracker, closed, block)
        return closed

    def _advance_sim3(self, tracker, closed: list[int], block: bool) -> None:
        """Advance the Sim3 attempt queue: without ``block`` at most one
        stage is enqueued and no copy is waited for; with ``block`` the
        queue drains."""
        m = self.map
        while self._sim3q:
            a = self._sim3q[0]
            st = a["stage"]
            if a.get("epoch", self._map_epoch) != self._map_epoch:
                # a correction or GBA rewrote the geometry this attempt's
                # stages were computed from
                self._sim3q.pop(0)
                continue
            if st == "new":
                if not a["cands"]:
                    self._sim3q.pop(0)
                    continue
                cand = a["cands"].pop(0)
                if not (m.kf_valid[a["kf"]] and m.kf_valid[cand]):
                    continue
                a["cand"] = cand
                a["epoch"] = self._map_epoch
                with self._stage("lc.sim3"):
                    self._sim3_dispatch_bf(tracker, a)
                a["stage"] = "bf_wait"
                if not block:
                    return
            elif st in ("bf_wait", "ransac_wait"):
                if not (block or a["copy"].done()):
                    return
                with self._stage("lc.sim3"):
                    ok = (self._sim3_after_bf(tracker, a) if st == "bf_wait"
                          else self._sim3_after_ransac(tracker, a))
                if not ok:
                    a["stage"] = "new"
                    continue
                a["stage"] = ("ransac_wait" if st == "bf_wait"
                              else "guided_wait")
                if not block:
                    return
            elif st == "guided_wait":
                if not (block or a["copy"].done()):
                    return
                with self._stage("lc.sim3"):
                    g12_host = self._sim3_after_guided(a)
                if g12_host is None:
                    a["stage"] = "new"
                    continue
                kf_idx, cand = a["kf"], a["cand"]
                self._sim3q.pop(0)
                if not (m.kf_valid[kf_idx] and m.kf_valid[cand]):
                    continue
                # the min-gap gate ran at detection; a second attempt can
                # pass it before the first correction lands
                if kf_idx < (self.last_loop_kf
                             + self.cfg.loop.min_kfs_since_last_loop):
                    continue
                with self._stage("lc.correct"):
                    self._correct_loop(tracker, kf_idx, cand, g12_host)
                closed.append(kf_idx)
                self.loops_closed += 1
                self.last_loop_kf = kf_idx
                if not block:
                    # the correction enqueued a burst of device work; the
                    # next attempt starts on a later poll
                    return

    def on_keyframe_culled(self, kf_idx: int) -> None:
        """Keep the inverted file coherent with keyframe culling
        (ref: KeyFrameDatabase.cc:49-65 erase via SetBadFlag)."""
        self.db.erase(kf_idx)

    def _detect_loop(self, kf_idx: int, bow) -> list[int]:
        """ref: LoopClosing.cc:111-240. Every candidate that passes the
        3-run covisibility-consistency test and the score pre-gate, best
        score first."""
        if kf_idx < self.last_loop_kf + self.cfg.loop.min_kfs_since_last_loop:
            return []
        if self.map.n_keyframes < 10:  # ref: :123
            return []
        covis = self.map.covisibility(kf_idx)
        connected = set(np.where(covis > 0)[0].tolist())
        # minScore: the lowest BoW score among all covisible keyframes
        # (ref: :136-150)
        bow_arr = voc_mod.bow_arrays(bow)
        min_score = 1.0
        for k in np.where(covis > 0)[0]:
            k = int(k)
            if k in self.db.bow:
                min_score = min(min_score, self.db.score(bow_arr, k))
        cand_scores: dict[int, float] = {}
        cands = self.db.detect_loop_candidates(
            kf_idx, bow, min_score, connected, self._covis_groups(),
            scores_out=cand_scores)
        if not cands:
            self.consistent_groups = []
            return []
        # covisibility consistency over 3 detections (ref: :165-237)
        new_groups = []
        enough: list[int] = []
        for c in cands:
            w = self.map.covisibility(c)
            group = set(np.where(w > 0)[0].tolist()) | {c}
            best_count = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count))
            if best_count >= self.cfg.loop.covisibility_consistency_th:
                enough.append(c)
        self.consistent_groups = new_groups
        # Sim3 pre-gate (LoopConfig.sim3_score_margin, beyond the
        # reference): a clear score margin over min_score
        if enough:
            bar = self.cfg.loop.sim3_score_margin * min_score
            gated = [c for c in enough if cand_scores.get(c, 0.0) >= bar]
            if len(enough) > len(gated):
                self._bind("sim3_pregate_dropped", len(enough) - len(gated))
            enough = sorted(gated, key=lambda c: -cand_scores.get(c, 0.0))
        return enough

    # -- Sim3 attempt stages (ref: LoopClosing.cc:242-404 ComputeSim3; the
    # BoW-guided matching is a K2 brute force with the same accept tests)

    def _sim3_dispatch_bf(self, tracker, a: dict) -> None:
        """Stage 1: brute-force matching between the two keyframes
        (ref: LoopClosing.cc:249 SearchByBoW)."""
        kf_idx, cand = a["kf"], a["cand"]
        a["pts1"] = self._kf_point_ids(kf_idx)
        a["pts2"] = self._kf_point_ids(cand)
        store = tracker.kf_store
        has = to_device(np.stack([a["pts1"] >= 0, a["pts2"] >= 0]),
                        tracker.device)
        with self._k2(1):
            res = matching.search_brute_force(
                store.desc_u8[kf_idx], has[0], store.angle[kf_idx],
                store.desc_u8[cand], has[1], store.angle[cand],
                nn_ratio=0.75)  # ref: LoopClosing.cc:249
        a["copy"] = HostCopy({"dst": res.dst_for_src})

    def _sim3_after_bf(self, tracker, a: dict) -> bool:
        """Stage 2: gate on the match count, enqueue the Sim3 RANSAC
        (ref: LoopClosing.cc:262-340)."""
        kf_idx, cand = a["kf"], a["cand"]
        pts1, pts2 = a["pts1"], a["pts2"]
        d1, d2 = self.map.kf_data[kf_idx], self.map.kf_data[cand]
        dst = a["copy"].result()["dst"].astype(np.int64)
        i1 = np.where((dst >= 0) & (pts1 >= 0))[0]
        i1 = i1[pts2[dst[i1]] >= 0]
        if len(i1) < self.cfg.loop.min_bow_matches:  # ref: :277
            return False
        n_cap = 256
        if len(i1) > n_cap:
            self._bind("sim3_pairs")
        idx1 = i1[:n_cap]
        idx2 = dst[idx1]
        n = len(idx1)
        T1 = self.map.kf_pose[kf_idx].astype(np.float64)
        T2 = self.map.kf_pose[cand].astype(np.float64)
        pc1 = self.map.pt_pos[pts1[idx1]] @ T1[:3, :3].T + T1[:3, 3]
        pc2 = self.map.pt_pos[pts2[idx2]] @ T2[:3, :3].T + T2[:3, 3]
        # one packed upload: [pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, valid]
        valid = np.zeros(n_cap, bool)
        valid[:n] = True
        sf = self.cfg.orb.scale_factor
        packed = np.zeros((n_cap, 13), np.float32)
        packed[:n, 0:3] = pc1
        packed[:n, 3:6] = pc2
        packed[:n, 6:8] = d1.xy[idx1]
        packed[:n, 8:10] = d2.xy[idx2]
        packed[:, 10] = 1.0 - valid
        packed[:n, 10] += sf ** (2.0 * d1.level[idx1])
        packed[:, 11] = 1.0 - valid
        packed[:n, 11] += sf ** (2.0 * d2.level[idx2])
        packed[:, 12] = valid
        dev = tracker.device
        pk = to_device(packed, dev)
        # minimal sets from a generator seeded with the keyframe index
        # (the JAX package keys jax.random with it)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(kf_idx))
        res = sim3_opt.ransac_sim3(
            pk[:, 0:3], pk[:, 3:6], pk[:, 6:8], pk[:, 8:10], pk[:, 10],
            pk[:, 11], pk[:, 12] > 0.5, gen, self.cam,
            fix_scale=True)  # stereo (ref: Sim3Solver mbFixScale)
        g = res.g12
        flat = torch.cat([res.n_inliers.reshape(1).to(torch.float32),
                          g.s.reshape(1), g.t.reshape(3), g.R.reshape(9)])
        a["g12"] = g
        a["copy"] = HostCopy({"flat": flat})
        return True

    def _sim3_after_ransac(self, tracker, a: dict) -> bool:
        """Stage 3: gate on the RANSAC inliers, enqueue the guided
        SearchBySim3 (ref: LoopClosing.cc:340-366)."""
        kf_idx, cand = a["kf"], a["cand"]
        out = a["copy"].result()["flat"]  # [n, s, t(3), R(9)]
        n_inl = int(out[0])
        if n_inl < self.cfg.loop.sim3_ransac_min_inliers:
            return False
        a["n_inl"] = n_inl
        a["g12_host"] = (float(out[1]),
                         out[5:14].reshape(3, 3).astype(np.float64),
                         out[2:5].astype(np.float64))
        pts1, pts2 = a["pts1"], a["pts2"]

        def cam_points(pts, k):
            T = self.map.kf_pose[k].astype(np.float64)
            has = pts >= 0
            pw = np.zeros((len(pts), 3), np.float32)
            pw[has] = self.map.pt_pos[pts[has]]
            return (pw @ T[:3, :3].T + T[:3, 3]).astype(np.float32), has

        pk = np.zeros((2, len(pts1), 4), np.float32)
        pk[0, :, :3], pk[0, :, 3] = cam_points(pts1, kf_idx)
        pk[1, :, :3], pk[1, :, 3] = cam_points(pts2, cand)
        dev = tracker.device
        pkd = to_device(pk, dev)
        store, g, cam = tracker.kf_store, a["g12"], self.cam
        with self._k2(2):
            m12 = matching.search_by_sim3(
                g.s, g.R, g.t,
                pkd[0, :, :3], pkd[0, :, 3] > 0.5, store.xy[kf_idx],
                store.level[kf_idx], store.desc_u8[kf_idx],
                pkd[1, :, :3], pkd[1, :, 3] > 0.5, store.xy[cand],
                store.level[cand], store.desc_u8[cand],
                self._scales_on(dev), cam.fx, cam.fy, cam.cx, cam.cy)
        a["copy"] = HostCopy({"m12": m12})
        return True

    def _sim3_after_guided(self, a: dict):
        """Stage 4: the >= 40 total-match accept (ref: LoopClosing.cc:393).
        Returns the host (s, R, t) or None."""
        m12 = a["copy"].result()["m12"]
        n_total = int((m12 >= 0).sum())
        if max(n_total, a["n_inl"]) < self.cfg.loop.min_total_matches:
            return None
        return a["g12_host"]

    # -- correction ----------------------------------------------------------

    def _correct_loop(self, tracker, kf_idx: int, cand: int,
                      g12_np: tuple) -> None:
        """ref: LoopClosing.cc:406-607 CorrectLoop + :663-765 GBA.
        ``g12_np``: host (s, R (3, 3), t (3,)) in float64; the window
        seeding algebra is host float64."""
        m = self.map
        dev = tracker.device
        K = m.n_keyframes
        old_poses = m.kf_pose[:K].copy()  # before any edit
        T1 = old_poses[kf_idx].astype(np.float64)
        T2 = old_poses[cand].astype(np.float64)
        # corrected current pose Scw = g12 * S2w (ref: LoopClosing.cc:443)
        g_corr_cw = _h_compose(g12_np, _h_from_se3(T2))
        # the covisible window of kf_idx, minus the candidate's group
        # (revisit tracking may have made old keyframes covisible with
        # the current one; moving them would drag the side the loop
        # closes against), seeds the pose graph (ref: CorrectedSim3,
        # LoopClosing.cc:445-543); measurements use the old poses
        window = set(np.where(m.covisibility(kf_idx) > 0)[0].tolist())
        cand_group = set(np.where(m.covisibility(cand) > 0)[0].tolist())
        cand_group |= {cand}
        window = (window - cand_group) | {kf_idx}
        delta_inv = _h_inverse(_h_compose(_h_inverse(g_corr_cw),
                                          _h_from_se3(T1)))
        seed_poses = old_poses.copy()
        for k in window:
            seed_poses[k] = _h_to_se3(
                _h_compose(_h_from_se3(old_poses[k]), delta_inv)
            ).astype(np.float32)

        # essential graph (ref: Optimizer.cc:928): spanning tree, strong
        # covisibility, earlier loop edges and the new one. Edges whose
        # old-pose measurement spans the seam would contradict the loop
        # edge; the reference has none at closure time (fusion, which
        # makes them, runs after the edge collection, :548, :575-607).
        def crosses_seam(i: int, j: int) -> bool:
            return ((i in window and j in cand_group)
                    or (j in window and i in cand_group))

        edges_i, edges_j, meas = [], [], []
        for k in range(1, K):  # spanning tree
            p = int(m.kf_parent[k])
            if p < 0 or crosses_seam(k, p):
                p = k - 1
            edges_i.append(k)
            edges_j.append(p)
        cm = m.covisibility_matrix()
        for k in range(K):  # strong covisibility
            for j in np.where(
                    cm[k][:K] >= self.cfg.loop.essential_edge_min_weight)[0]:
                if j > k + 1 and not crosses_seam(int(j), k):
                    edges_i.append(int(j))
                    edges_j.append(k)
        for i, j in zip(edges_i, edges_j):
            meas.append((old_poses[i].astype(np.float64) @ np.linalg.inv(
                old_poses[j].astype(np.float64))).astype(np.float32))
        for li, lj, lT in self.loop_edges:
            edges_i.append(li)
            edges_j.append(lj)
            meas.append(lT)
        new_loop_T = _h_to_se3(g12_np).astype(np.float32)
        edges_i.append(kf_idx)
        edges_j.append(cand)
        meas.append(new_loop_T)
        self.loop_edges.append((kf_idx, cand, new_loop_T))
        E_cap = 4096
        if len(edges_i) > E_cap:
            self._bind("essential_edges")
            edges_i, edges_j = edges_i[-E_cap:], edges_j[-E_cap:]
            meas = meas[-E_cap:]
        E = len(edges_i)
        # power-of-two paddings, as in the JAX package
        K_cap = max(64, 1 << (K - 1).bit_length())
        E_pad = max(256, 1 << (E - 1).bit_length())
        fixed = np.zeros(K_cap, bool)
        fixed[cand] = True  # ref: :1010 fixes the loop keyframe
        valid_kf = np.zeros(K_cap, bool)
        valid_kf[:K] = True
        poses = np.tile(np.eye(4, dtype=np.float32), (K_cap, 1, 1))
        poses[:K] = seed_poses
        mR = np.tile(np.eye(3, dtype=np.float32), (E_pad, 1, 1))
        mR[:E] = np.stack([x[:3, :3] for x in meas])
        mt = np.zeros((E_pad, 3), np.float32)
        mt[:E] = np.stack([x[:3, 3] for x in meas])
        ei = np.zeros(E_pad, np.int64)
        ei[:E] = edges_i
        ej = np.zeros(E_pad, np.int64)
        ej[:E] = edges_j
        ev = np.zeros(E_pad, bool)
        ev[:E] = True
        prob = pose_graph.PoseGraphProblem(*(to_device(x, dev) for x in (
            np.ones(K_cap, np.float32), poses[:, :3, :3], poses[:, :3, 3],
            fixed, valid_kf, ei, ej, np.ones(E_pad, np.float32), mR, mt,
            ev)))
        with self._stage("lc.correct.graph"):
            s, R, t = pose_graph.optimize_essential_graph(prob)
            out = HostCopy({"s": s, "R": R, "t": t}).result()
        # SE3 recovery, and each point moves with its reference
        # keyframe's correction (ref: Optimizer.cc:1188-1233)
        for k in range(K):
            Tk = np.eye(4, dtype=np.float32)
            Tk[:3, :3] = out["R"][k]
            Tk[:3, 3] = out["t"][k] / max(float(out["s"][k]), 1e-9)
            m.kf_pose[k] = Tk
        self._move_points(np.stack([
            np.linalg.inv(m.kf_pose[k].astype(np.float64))
            @ old_poses[k].astype(np.float64) for k in range(K)]),
            np.ones(K, bool), np.zeros(m.max_points, bool))
        self._push_positions(tracker)
        # fuse the duplicated geometry a loop creates
        # (ref: LoopClosing.cc:548, 609-635 SearchAndFuse)
        with self._stage("lc.correct.fuse"):
            merges, new_obs = self._search_and_fuse(tracker, kf_idx, cand,
                                                    window)
        # the full-map BA, asynchronous like the reference's GBA thread
        # (ref: LoopClosing.cc:600-601 RunGlobalBundleAdjustment); a
        # newer closure supersedes an unapplied solve (mnFullBAIdx)
        with self._stage("lc.correct.gba_dispatch"):
            self._gba_dispatch(tracker, kf_idx, cand)
        c_old, c_new = _center(old_poses[kf_idx]), _center(m.kf_pose[kf_idx])
        self.loop_events.append({
            "kf": int(kf_idx), "cand": int(cand),
            "correction_m": round(float(np.linalg.norm(c_new - c_old)), 3),
            "center_old": [round(float(v), 3) for v in c_old],
            "center_new": [round(float(v), 3) for v in c_new],
            "center_cand": [round(float(v), 3)
                            for v in _center(m.kf_pose[cand])],
            "fuse_merges": merges, "fuse_new_obs": new_obs,
        })
        # re-anchor the tracker on the corrected keyframe
        # (ref: Tracking.cc:641-646 UpdateLastFrame semantics)
        tracker.apply_world_correction(old_poses[kf_idx], m.kf_pose[kf_idx])
        self._map_epoch += 1

    def _move_points(self, M: np.ndarray, moved: np.ndarray,
                     skip: np.ndarray) -> None:
        """Move every live point not in ``skip`` whose reference
        keyframe k has ``moved[k]`` by that keyframe's correction
        M[k] = T_new^-1 T_old (one vectorized pass)."""
        m = self.map
        K = len(M)
        n = m.n_points
        ref_kf = m.pt_ref_kf[:n]
        sel = np.where(m.pt_valid[:n] & ~skip[:n] & (ref_kf >= 0)
                       & (ref_kf < K))[0]
        sel = sel[moved[ref_kf[sel]]]
        if len(sel):
            Mp = M[ref_kf[sel]]
            X = m.pt_pos[sel].astype(np.float64)
            m.pt_pos[sel] = (np.einsum("pij,pj->pi", Mp[:, :3, :3], X)
                             + Mp[:, :3, 3]).astype(np.float32)

    def _push_positions(self, tracker) -> None:
        """Write every point position to the device map."""
        n = self.map.n_points
        ids = np.full(tracker.dmap.capacity, -1, np.int32)
        ids[:n] = np.arange(n, dtype=np.int32)
        pos = np.zeros((tracker.dmap.capacity, 3), np.float32)
        pos[:n] = self.map.pt_pos[:n]
        tracker.dmap = device_map.set_positions(
            tracker.dmap, to_device(ids, tracker.device),
            to_device(pos, tracker.device))

    def _search_and_fuse(self, tracker, kf_idx: int, cand: int,
                         window: set) -> tuple[int, int]:
        """Project the loop neighbourhood's map points into the corrected
        window keyframes and merge duplicates, loop points winning
        (ref: LoopClosing.cc:609-635, pRep->Replace(mvpLoopMapPoints));
        free keypoints gain observations of loop points. One K2 search
        per target keyframe. Returns (merges, new observations)."""
        m = self.map
        dev = tracker.device
        covis = m.covisibility(cand)
        cand_group = [cand] + [int(k) for k in np.argsort(-covis)[:10]
                               if covis[k] > 0]
        loop_pts = m.points_seen_by(np.asarray(cand_group, np.int64))
        loop_pts = loop_pts[m.pt_valid[loop_pts]]
        if len(loop_pts) == 0:
            return 0, 0
        P_CAP = 2048
        if len(loop_pts) > P_CAP:
            self._bind("fuse_loop_pts")
        loop_pts = loop_pts[:P_CAP]
        pad = np.zeros(P_CAP, np.int64)
        pad[: len(loop_pts)] = loop_pts
        alive = np.zeros(P_CAP, bool)
        alive[: len(loop_pts)] = True
        targets = sorted(window)[:10]
        pad_dev, alive_dev = to_device(pad, dev), to_device(alive, dev)
        with self._k2(len(targets)):
            src = torch.stack([
                fuse_search(tracker, self.cam, self.cfg, pad_dev, alive_dev,
                            k, m.kf_pose[k]) for k in targets])
        src_all = HostCopy({"src": src}).result()["src"]
        replaced: dict[int, int] = {}
        merge_pairs: list[tuple[int, int]] = []
        n_new_obs = 0
        for i, k in enumerate(targets):
            kf_pts = self._kf_point_ids(k)
            hit_kp = np.where(src_all[i] >= 0)[0]
            if len(hit_kp) == 0:
                continue
            pid = pad[src_all[i][hit_kp]].astype(np.int64)
            ok = m.pt_valid[pid]
            hit_kp, pid = hit_kp[ok], pid[ok]
            existing = kf_pts[hit_kp]
            free = existing < 0
            if free.any():
                m.add_observations(k, pid[free], hit_kp[free])
                n_new_obs += int(free.sum())
            conf = (~free) & (existing != pid)
            for p_i, e_i in zip(pid[conf], existing[conf]):
                p_i = replaced.get(int(p_i), int(p_i))
                e_i = replaced.get(int(e_i), int(e_i))
                if p_i == e_i or not (m.pt_valid[p_i] and m.pt_valid[e_i]):
                    continue
                # the loop point replaces the window point; the table
                # rewrite is one replace_points_batch below
                merge_pairs.append((e_i, p_i))
                m.pt_valid[e_i] = False
                m._valid_epoch += 1
                replaced[e_i] = p_i
        if merge_pairs:
            m.replace_points_batch(
                np.array([p[0] for p in merge_pairs], np.int64),
                np.array([p[1] for p in merge_pairs], np.int64))
        if replaced:
            kill_ids = np.array(list(replaced)[:4096], np.int32)
            tracker.dmap = device_map.invalidate_points(
                tracker.dmap, to_device(kill_ids, dev))
        return len(replaced), n_new_obs

    # -- global BA -----------------------------------------------------------

    # Maps up to GBA_KF keyframes, GBA_PT points and GBA_OBS observations
    # solve by the dense Schur LM (one (P, K, 6, 3) cross buffer); larger
    # ones by the matrix-free PCG (optim/gba_cg.py) at the smallest
    # fitting bucket of (keyframes, points, observations) caps.
    GBA_KF = 64
    GBA_PT = 8192
    GBA_OBS = 24576
    GBA_BUCKETS = (
        (64, 16384, 49152),
        (256, 32768, 98304),
        (512, 49152, 196608),
        (2048, 131072, 393216),
    )

    def _gba_dispatch(self, tracker, kf_idx: int, cand: int) -> None:
        """Enqueue the post-loop full-map BA (ref: Optimizer.cc:39-271 via
        LoopClosing.cc:663-765; 10 iterations, robust kernel off). Dense
        only when the whole problem fits its caps (a truncated problem
        leaves keyframes unconstrained); the PCG solve is paced one LM
        iteration per poll. The solution applies in ``poll``."""
        m = self.map
        K = m.n_keyframes
        n_obs_all = len(m.observations())
        n_pts_all = int(m.pt_valid[: m.n_points].sum())
        pcg = (K > self.GBA_KF or n_obs_all > self.GBA_OBS
               or n_pts_all > self.GBA_PT)
        bucket = self.GBA_BUCKETS[-1]
        for b in self.GBA_BUCKETS:  # smallest fitting bucket
            if K <= b[0] and n_pts_all <= b[1] and n_obs_all <= b[2]:
                bucket = b
                break
        if not pcg:
            bucket = (self.GBA_KF, self.GBA_PT, self.GBA_OBS)
        kf_cap = bucket[0]
        if K <= kf_cap:
            kfs = list(range(K))
        else:
            # window: the loop neighbourhoods, then the most recent
            self._bind("gba_window")
            near = {kf_idx, cand}
            for c in (kf_idx, cand):
                w = m.covisibility(c)
                near |= {int(j) for j in np.argsort(-w)[:15] if w[j] > 0}
            rest = [k for k in range(K - 1, -1, -1) if k not in near]
            kfs = sorted(near) + rest[: kf_cap - len(near)]
        kfs = [k for k in kfs if m.kf_valid[k]][:kf_cap]
        if 0 not in kfs:
            kfs = [0] + kfs[: kf_cap - 1]
        fixed = np.array([k == 0 for k in kfs], bool)  # ref: :114
        built = ba_build.build_problem(m, kfs, fixed, *bucket,
                                       self.cfg.orb.scale_factor,
                                       tracker.device)
        if built is None:
            return
        prob, ctx = built
        ctx["loop_kf"] = kf_idx
        if ctx["truncated_obs"] or ctx["truncated_pts"]:
            self._bind("gba_truncated")
        self._gba = {"ctx": ctx, "copy": None, "n_kf": K,
                     "poses_before": m.kf_pose[:K].copy()}
        if pcg:
            self.gba_dispatched["pcg"] += 1
            carry = gba_cg.gba_cg_begin(prob, self.cam)
            self._gba["stepped"] = {"carry": carry, "prob": prob,
                                    "iters_left": 10,
                                    "probe": HostCopy({"chi2": carry[3]})}
            return
        self.gba_dispatched["dense"] += 1
        res = local_ba.global_bundle_adjustment(prob, self.cam,
                                                iterations=10)
        self._gba_result(res)

    def _gba_result(self, res) -> None:
        self._gba["copy"] = HostCopy({"kf_pose": res.kf_pose,
                                      "pt_pos": res.pt_pos,
                                      "inlier": res.obs_inlier})
        self._gba["pt_pos_dev"] = res.pt_pos

    def _gba_advance(self, block: bool = False) -> None:
        """Pace a PCG solve: enqueue the next LM iteration once the
        previous one's probe has landed, then the inlier finish and the
        result copy. With ``block`` the remaining iterations go back to
        back."""
        g = self._gba
        st = g.get("stepped") if g else None
        if st is None:
            return
        while block or st["probe"].done():
            if st["iters_left"] > 0:
                st["carry"] = gba_cg.gba_cg_step(st["carry"], st["prob"],
                                                 self.cam)
                st["iters_left"] -= 1
                st["probe"] = HostCopy({"chi2": st["carry"][3]})
            else:
                self._gba_result(gba_cg.gba_cg_finish(st["carry"],
                                                      st["prob"], self.cam))
                g.pop("stepped")
                return
            if not block:
                return  # one iteration per poll

    def finish_gba(self, tracker) -> None:
        """Drive an in-flight GBA to its end and apply it (flush,
        compaction)."""
        if self._gba is None:
            return
        self._gba_advance(block=True)
        self._gba_apply(tracker)

    def _gba_apply(self, tracker) -> None:
        """Apply a landed GBA solution, and carry its correction to the
        keyframes and points made (or windowed out) during the solve
        through the spanning tree (ref: LoopClosing.cc:683-765)."""
        g = self._gba
        self._gba = None
        m = self.map
        with self._stage("lc.gba_apply.fetch"):
            out = g["copy"].result()
        ctx = g["ctx"]
        in_problem = np.zeros(m.max_keyframes, bool)
        in_problem[ctx["kfs"]] = True
        poses_old = g["poses_before"]
        with self._stage("lc.gba_apply.sol"):
            ba_build.apply_solution(m, tracker, ctx, out, g["pt_pos_dev"])
        # keyframes outside the problem chain through their nearest
        # corrected ancestor, keeping the relative pose measured before
        # the correction (ref: :700-733)
        K_now = m.n_keyframes
        corrected = {k: poses_old[k] for k in ctx["kfs"]}
        pre = {k: m.kf_pose[k].copy() if k >= g["n_kf"] else poses_old[k]
               for k in range(K_now)}
        for k in range(K_now):
            if in_problem[k]:
                continue
            p = int(m.kf_parent[k]) if m.kf_parent[k] >= 0 else k - 1
            seen = set()
            while p > 0 and not in_problem[p] and p not in seen:
                seen.add(p)
                p = int(m.kf_parent[p]) if m.kf_parent[p] >= 0 else p - 1
            if not in_problem[p]:
                continue
            T_rel = pre[k].astype(np.float64) @ np.linalg.inv(
                pre[p].astype(np.float64))
            m.kf_pose[k] = (T_rel @ m.kf_pose[p].astype(np.float64)
                            ).astype(np.float32)
            in_problem[k] = True  # children of k may chain through it
            corrected[k] = pre[k]
        # points outside the problem move with their reference keyframe
        # (ref: :737-761)
        M = np.tile(np.eye(4), (K_now, 1, 1))
        moved = np.zeros(K_now, bool)
        for k, T_old in corrected.items():
            if k >= K_now:
                continue
            T_new = m.kf_pose[k].astype(np.float64)
            if np.allclose(T_old, T_new, atol=1e-9):
                continue
            M[k] = np.linalg.inv(T_new) @ T_old.astype(np.float64)
            moved[k] = True
        pt_in = np.zeros(m.max_points, bool)
        pt_in[ctx["pt_ids"]] = True
        self._move_points(M, moved, pt_in)
        with self._stage("lc.gba_apply.dev"):
            self._push_positions(tracker)
        # re-anchor the tracker on its reference keyframe's correction
        ref = tracker.last_kf_id
        if 0 <= ref < K_now:
            tracker.apply_world_correction(pre[ref], m.kf_pose[ref])
        self.gba_applied += 1
        self._map_epoch += 1
