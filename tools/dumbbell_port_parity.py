"""The port's SLAM session against the JAX package's on the dumbbell434
cell, like for like, on the CPU: both packages in lockstep on the same
frames, frame by frame, to find where their decisions first part.

The cell is ``tools/dumbbell_jax_reference.py``'s (and ``chip_smoke.py``
phase 11's): the lap renders ``WORK_DIR/dumbbell404.npz`` (written by
that tool's ``render_lap`` if missing), frame ``i`` showing render
``i % 404``, the renderer's semantics (``structured_semantics(seed=7)``)
through each package's ``build_frame_nosegnet``, ``System(
max_keyframes=448, max_points=49152, pipeline_depth=3)`` with the
offline vocabulary, ``track_frame(pipeline=True)`` and ``flush``.

Like for like means:

* **Descriptor semantics.** Side ``jax`` runs K1, the JAX package's
  Pallas kernel (interpreted on the CPU):
  ``sivo_tpu.ops.pallas_orb.use_pallas`` is patched to return True
  before the first trace, so descriptors come from u8 canvases as in the
  port's kernel. Left alone (side ``jax_xla``), the JAX package takes
  its XLA descriptor path on the CPU, whose float canvases give other
  bits. K2 stays on its XLA path, which is integer-exact.
* **Regime.** The JAX sides' host fetches have landed when they return
  (``tools/jax_regime.land_fetches``), as on
  the card; the port's copies of CPU tensors land at once, and the
  mapper's deferred admissions (``admit_waits``) are printed to show it.
* **Random draws.** The RANSACs draw their minimal sets from
  ``jax.random`` in the JAX package and from ``torch.Generator`` in the
  port. Side ``port`` is handed the JAX package's draws (the tracking
  anchor's EPnP keyed by the frame's keypoint sum, relocalization's by
  the frame count, the loop closer's Sim3 by the keyframe), so the
  lockstep meets only differences of code and rounding; side
  ``port_own`` runs with its own draws, as on the card.

``--cell loop190`` or ``--cell loop40`` runs the same lockstep on
``chip_smoke.py``'s loop world cells instead (phases 7 and 6): the
bench loop world's 190 frames (``make_loop_world(seed=0, outer=16,
inner=6)``, ``square_loop_trajectory(190, half=9.5, corner_r=3.5,
jitter=0.03)``, ``ss=2``, rendered once into ``WORK_DIR/loop190.npz``),
``System(max_keyframes=256, max_points=32768)``, ``track_frame``
unpipelined as ``track_stereo`` runs it, with the offline vocabulary on
loop190 and without it on loop40 (its first 40 frames).

``--stable-walk`` replaces the sequential selection walk of
``select/info.py`` in every side by one float64 numpy walk
(``stable_walk``): in float32 its covariance update loses positive
definiteness within a few accepts, so which keypoints a keyframe mints
follows each BLAS's rounding.

Each side runs in its own process; the parent steps them one frame at a
time and compares their records. Per frame: the frontend (valid,
semantic and stereo keypoints; slots whose position or level differ
between the packages, and keypoints whose descriptor does); each frame
retired (lost, tracking OK, reference keyframe, keyframe made and the
keypoints it mints from, the tracking step's matched, inlier, tracked,
reference and selection counts, the keyframe rule's inputs) and its
pose; relocalizations and their candidate; after the call the
keyframes, map points, loops, GBA dispatches and applications, crisis
frames and compactions.

It prints the first frame at which each integer field differs between
the first side and each other, with both values and the largest gap
between their camera centres up to that frame. At the first frame where
a count differs (tracking's matches, inliers, keypoints, map points),
and again at the first where a decision does (a frame lost,
relocalized or made a keyframe, its minted keypoints, its reference
keyframe, a crisis, a loop, a GBA), it prints the inputs of the
decisions there on every side with their margins to the thresholds,
and each side saves its state
(``WORK_DIR/divergence_<count|decision>_<side>.npz``). Then for each
side: loops and their events, each GBA's path, bucket and dispatch and
application frames, keyframes, lost frames, relocalizations, crisis
frames, ATE over ``frame_poses()`` (all frames and the tracked ones) and
the largest aligned centre error with its frame. For the JAX sides also
the ATE with each relocalized frame's record pointed at its
relocalization keyframe, as the port keeps it (``System._relocalize``
leaves it on the keyframe it was lost from, with a relative pose taken
against the new one). The last lines are ``REF_DUMBBELL`` entries, one
per side, for ``chip_smoke.py``. Records go to ``WORK_DIR/parity.json``.

Run from the repository root (CPU, 8 cores: 62-66 minutes for 434
frames with two or three sides, 91 with ``--stable-walk``, the JAX
side's pace; the renders ~3 minutes more if missing):
``JAX_PLATFORMS=cpu python tools/dumbbell_port_parity.py WORK_DIR
[--frames N] [--sides jax,jax_xla,port,port_own] [--stable-walk]
[--cell dumbbell434|loop190|loop40]`` (loop190: ~30 minutes);
the first side named is the one the others are compared with.
"""

from __future__ import annotations

import copy
import json
import multiprocessing
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

# the cell's renders, frame count, vocabulary, ATE alignment and landed
# fetches; importing it puts JAX on the CPU at HIGHEST matmul precision
import dumbbell_jax_reference as ref

PORT_THREADS = 2
# the tracking step's counts recorded for each retired frame
SUMMARY_FIELDS = ("OK", "N_TRACKED", "N_REF", "N_CLOSE_TRACKED",
                  "N_CLOSE_FREE", "N_MATCHES_MOTION", "N_INLIERS1",
                  "N_INLIERS2", "N_SELECTED", "N_SEMANTIC", "USED_FALLBACK",
                  "MOT_N", "MOT_INL", "SEL_LAST_ACCEPT", "N_CANDIDATES")
# each retired frame's record: these and SUMMARY_FIELDS lowercased
# (chip_smoke.py's phase 11 record keeps the same names for the same
# fields, but for the minted keypoints "sel")
RETIRED_FIELDS = ("fid", "lost", "ref_kf", "kf", "since_kf", "queue",
                  "busy", "n_kf_before", "rot_rate", "pose", "rot_dev",
                  "sel")
# the fields that are decisions: a frame lost, tracked, relocalized or
# made a keyframe, its reference keyframe, retired early (crisis), a
# loop closed, a GBA dispatched or applied; the others are counts
DECISIONS = {"retired.fids", "retired.lost", "retired.ok", "retired.kf",
             "retired.sel",
             "retired.ref_kf", "reloc", "counter.keyframes", "counter.loops",
             "counter.gba_dispatched", "counter.gba_applied",
             "counter.crisis", "counter.reloc_attempts",
             "counter.reloc_successes", "counter.inflight",
             "counter.compactions", "counter.ba_solves"}
COUNTS = ({f"retired.{f.lower()}" for f in SUMMARY_FIELDS}
          | {"counter.points", "front.n_valid", "front.n_semantic",
             "front.n_stereo", "front.slots_equal"}) - DECISIONS
COUNTERS = ("keyframes", "points", "loops", "gba_dispatched", "gba_applied",
            "crisis", "reloc_attempts", "reloc_successes", "inflight",
            "compactions", "ba_solves")


# the cells: their renders, frames, System, vocabulary and whether
# track_frame is pipelined (chip_smoke.py's phases 11, 7 and 6)
CELLS = {
    "dumbbell434": {"renders": "dumbbell404.npz", "frames": ref.N_FRAMES,
                    "system": {"max_keyframes": 448, "max_points": 49152,
                               "pipeline_depth": 3},
                    "vocabulary": True, "pipeline": True},
    "loop190": {"renders": "loop190.npz", "frames": 190,
                "system": {"max_keyframes": 256, "max_points": 32768},
                "vocabulary": True, "pipeline": False},
    "loop40": {"renders": "loop190.npz", "frames": 40,
               "system": {"max_keyframes": 256, "max_points": 32768},
               "vocabulary": False, "pipeline": False},
}


def render_loop(work: Path) -> None:
    """The loop world's 190 frames, made once per WORK_DIR."""
    from sivo_tpu.config import SystemConfig
    from sivo_tpu.io import synthetic

    if (work / "loop190.npz").exists():
        return
    world = synthetic.make_loop_world(SystemConfig().camera, seed=0,
                                      outer=16.0, inner=6.0)
    left, right, cls = synthetic.render_sequence(world, loop_truth(190),
                                                 ss=2)
    np.savez(work / "loop190.npz", left=left, right=right, cls=cls)


def loop_truth(n: int) -> np.ndarray:
    from sivo_tpu.io import synthetic

    return synthetic.square_loop_trajectory(n_frames=190, half=9.5,
                                            corner_r=3.5, jitter=0.03)[:n]


def _loops(system) -> int:
    lc = system.loop_closer
    return 0 if lc is None else int(lc.loops_closed)


# -- the two packages, behind one interface ------------------------------


class _Side:
    """One package's session on the lap, instrumented for the records."""

    def __init__(self, name: str, work: Path, n_frames: int,
                 stable_walk: bool, cell: str = "dumbbell434"):
        self.name = name
        self.stable_walk = stable_walk
        self.n_frames = n_frames
        self.frame = [0]
        self.retired: list[dict] = []
        self.relocs: list[dict] = []
        self.gbas: list[dict] = []
        self.closed_at: list[int] = []
        self.anchor_seed = [0]
        # the JAX package's relocalized records as the port keeps them:
        # on the relocalization keyframe (index in the trajectory, record)
        self.repointed: list = []
        self.t0 = time.perf_counter()
        self.cell = CELLS[cell]
        z = np.load(work / self.cell["renders"])
        self.left, self.right, self.cls = z["left"], z["right"], z["cls"]
        self.lap = self.left.shape[0]
        self.setup()
        self.instrument()
        if self.cell["vocabulary"]:
            self.system.attach_vocabulary(
                self.voc_mod.load_npz(str(ref.VOCABULARY)))

    # the package's own calls

    def setup(self) -> None:
        raise NotImplementedError

    def build(self, s: int):
        raise NotImplementedError

    def to_np(self, x) -> np.ndarray:
        raise NotImplementedError

    # instrumentation (the port keeps the JAX package's names)

    def instrument(self) -> None:
        side, m = self, self.mods
        retire = m.Tracker.retire
        reloc = m.System._relocalize
        culled = m.System._on_kf_culled
        build, dense = m.ba_build.build_problem, m.local_ba.global_bundle_adjustment
        begin, apply = m.gba_cg.gba_cg_begin, m.LoopCloser._gba_apply
        ts = m.ts

        def recorded_retire(self, ticket):
            since = ticket.frame_id - self.last_kf_frame_id
            mapper = self.mapper
            queue = 0 if mapper is None else mapper.queue_len
            busy = mapper is not None and bool(mapper.busy)
            n_kf = self.map.n_keyframes
            out = retire(self, ticket)
            s = self.last_summary
            r = self.trajectory[-1]
            rec = {"fid": int(ticket.frame_id), "lost": bool(r.lost),
                   "ref_kf": int(r.ref_kf),
                   "kf": -1 if self.kf_created is None
                   else int(self.kf_created),
                   "since_kf": int(since), "queue": int(queue),
                   "busy": busy, "n_kf_before": int(n_kf),
                   "rot_rate": float(getattr(self, "_rot_rate", 0.0)),
                   "pose": np.asarray(r.pose, np.float64).tolist()}
            for f in SUMMARY_FIELDS:
                rec[f.lower()] = int(round(float(s[getattr(ts, "S_" + f)])))
            rec["rot_dev"] = float(s[ts.S_ROT_DEV])
            # the keypoints a keyframe mints points from
            rec["sel"] = () if self.kf_created is None else tuple(
                int(k) for k in np.flatnonzero(
                    side.to_np(ticket.result.sel_mask)))
            assert set(rec) == set(RETIRED_FIELDS) | {
                f.lower() for f in SUMMARY_FIELDS}, sorted(rec)
            side.retired.append(rec)
            return out

        def recorded_reloc(self, f, timestamp):
            attempts = getattr(self, "reloc_attempts", 0)
            out = reloc(self, f, timestamp)
            tr = self.tracker
            side.relocs.append({
                "frame": side.frame[0],
                "fid": int(tr.trajectory[-1].frame_id) if tr.trajectory
                else -1,
                "record": len(tr.trajectory) - 1, "ok": out is not None,
                "cand": int(tr.last_kf_id) if out is not None else -1,
                "attempted": getattr(self, "reloc_attempts", 0) - attempts})
            if out is not None and side.name.startswith("jax"):
                # its relative pose is taken against the candidate
                side.repointed.append((len(tr.trajectory) - 1, copy.copy(
                    tr.trajectory[-1])))
                side.repointed[-1][1].ref_kf = int(tr.last_kf_id)
            return out

        def recorded_cull(self, k):
            culled(self, k)
            if side.repointed:
                # re-express the re-pointed records too, as the
                # package re-expresses its own
                traj, lc = self.tracker.trajectory, self.loop_closer
                self.tracker.trajectory = [r for _, r in side.repointed]
                self.loop_closer = None
                try:
                    culled(self, k)
                finally:
                    self.tracker.trajectory, self.loop_closer = traj, lc

        def counted_build(mp, kfs, fixed, kf_cap, pt_cap, obs_cap, *a, **k):
            side.gbas.append({"frame": side.frame[0],
                              "bucket": [kf_cap, pt_cap, obs_cap],
                              "n_kfs": len(kfs),
                              "n_keyframes": mp.n_keyframes, "path": None,
                              "applied_frame": None})
            built = build(mp, kfs, fixed, kf_cap, pt_cap, obs_cap, *a, **k)
            if built is not None:
                built[1]["parity_gba"] = len(side.gbas) - 1
            return built

        def counted_dense(*a, **k):
            side.gbas[-1]["path"] = "dense"
            return dense(*a, **k)

        def counted_begin(*a, **k):
            side.gbas[-1]["path"] = "pcg"
            return begin(*a, **k)

        def counted_apply(self, tracker):
            side.gbas[self._gba["ctx"]["parity_gba"]]["applied_frame"] = (
                side.frame[0])
            return apply(self, tracker)

        m.Tracker.retire = recorded_retire
        m.System._relocalize = recorded_reloc
        m.System._on_kf_culled = recorded_cull
        # the mapper holds the hook it was built with
        self.system.mapper.on_kf_culled = self.system._on_kf_culled
        m.ba_build.build_problem = counted_build
        m.local_ba.global_bundle_adjustment = counted_dense
        m.gba_cg.gba_cg_begin = counted_begin
        m.LoopCloser._gba_apply = counted_apply

    # the run

    def counters(self) -> dict:
        sy = self.system
        mp = sy.map
        return {
            "keyframes": int(mp.n_keyframes), "points": int(mp.n_points),
            "loops": _loops(sy), "gba_dispatched": len(self.gbas),
            "gba_applied": sum(g["applied_frame"] is not None
                               for g in self.gbas),
            "crisis": int(getattr(sy, "crisis_frames", 0)),
            "reloc_attempts": int(getattr(sy, "reloc_attempts", 0)),
            "reloc_successes": int(getattr(sy, "reloc_successes", 0)),
            "inflight": int(sy.tracker.inflight_count),
            "compactions": int(getattr(sy, "compactions", 0)),
            "ba_solves": int(sy.timer.counts.get("map.ba_apply", 0)),
        }

    def step(self, i: int) -> dict:
        self.frame[0] = i
        s = i % self.lap
        f = self.build(s)
        n_ret, n_rel = len(self.retired), len(self.relocs)
        before = _loops(self.system)
        t0 = time.perf_counter()
        self.system.track_frame(f, i * 0.1, pipeline=self.cell["pipeline"])
        self.closed_at += [i] * (_loops(self.system) - before)
        front = {k: self.to_np(getattr(f, k)) for k in
                 ("xy", "level", "desc_u8", "valid", "semantic", "depth")}
        return {"frame": i, "ms": 1e3 * (time.perf_counter() - t0),
                "retired": self.retired[n_ret:],
                "relocs": self.relocs[n_rel:], "counters": self.counters(),
                "front": {"xy": front["xy"], "level": front["level"],
                          "desc_u8": front["desc_u8"],
                          "valid": front["valid"],
                          "n_valid": int(front["valid"].sum()),
                          "n_semantic": int(front["semantic"].sum()),
                          "n_stereo": int(((front["depth"] > 0)
                                           & front["semantic"]).sum())}}

    def dump(self, path: Path, retired: list[dict]) -> None:
        tr, mp = self.system.tracker, self.system.map
        np.savez(path,
                 summary=np.asarray(getattr(tr, "last_summary", None)
                                    if getattr(tr, "last_summary", None)
                                    is not None else []),
                 retired=json.dumps(retired),
                 traj_pose=np.array([r.pose for r in tr.trajectory]),
                 traj_ref=np.array([r.ref_kf for r in tr.trajectory]),
                 traj_lost=np.array([r.lost for r in tr.trajectory]),
                 kf_pose=np.asarray(mp.kf_pose[: mp.n_keyframes]),
                 kf_valid=np.asarray(mp.kf_valid[: mp.n_keyframes]))

    def finish(self) -> dict:
        self.frame[0] = self.n_frames
        n_ret = len(self.retired)
        before = _loops(self.system)
        self.system.flush()
        self.closed_at += [self.n_frames] * (_loops(self.system) - before)
        sy = self.system
        poses = sy.frame_poses()
        tr = sy.tracker
        out = {
            "retired": self.retired[n_ret:], "counters": self.counters(),
            "poses": np.asarray(poses, np.float64),
            "lost_frames": [i for i, r in enumerate(tr.trajectory)
                            if r.lost],
            "events": [{"frame": fr, **{k: e[k] for k in
                                        ("kf", "cand", "correction_m")}}
                       for fr, e in zip(self.closed_at,
                                        getattr(sy.loop_closer,
                                                "loop_events", []))],
            "gbas": self.gbas, "relocs": self.relocs,
            "admit_waits": getattr(sy.mapper, "admit_waits", None),
            "points_live": int(sy.map.pt_valid[: sy.map.n_points].sum()),
            "keyframes_live": int(sy.map.kf_valid[: sy.map.n_keyframes]
                                  .sum()),
            "local_cap_binds": int(tr.local_cap_binds),
            "seconds": time.perf_counter() - self.t0,
        }
        if self.repointed and out["counters"]["compactions"] == 0:
            recs = list(tr.trajectory)
            for i, r in self.repointed:
                recs[i] = r
            out["poses_repointed"] = np.asarray(
                self.traj_io.chained_frame_poses(
                    [r.rel_pose for r in recs],
                    [max(r.ref_kf, 0) for r in recs],
                    sy.map.kf_pose[: sy.map.n_keyframes]), np.float64)
        return out


class _Jax(_Side):
    """The JAX package with its fetches landed: ``jax`` with K1's
    kernel semantics, ``jax_xla`` on its CPU XLA descriptor path."""

    def setup(self) -> None:
        import jax.numpy as jnp

        from sivo_tpu.config import SystemConfig
        from sivo_tpu.io import synthetic
        from sivo_tpu.io import trajectory as traj_io
        from sivo_tpu.optim import ba_build, gba_cg, local_ba
        from sivo_tpu.place import vocabulary as voc_mod
        from sivo_tpu.runtime import frame as frame_mod
        from sivo_tpu.runtime import track_step as ts
        from sivo_tpu.runtime.loopclosing import LoopCloser
        from sivo_tpu.runtime.system import System
        from sivo_tpu.runtime.tracking import Tracker
        from tools import jax_regime

        if self.name == "jax":  # K1 interpreted, u8 canvases
            jax_regime.use_k1()
        if self.stable_walk:
            import jax

            from sivo_tpu.select import info

            def walk(cov, pts, s2, ent, cand, th, fx, fy, baseline,
                     min_select=32, order_by_depth=False):
                n = pts.shape[0]
                shapes = (jax.ShapeDtypeStruct((n,), jnp.bool_),
                          jax.ShapeDtypeStruct((6, 6), jnp.float32),
                          jax.ShapeDtypeStruct((), jnp.float32))
                return jax.pure_callback(
                    lambda *a: stable_walk(*a, fx, fy, baseline,
                                           min_select),
                    shapes, cov, pts, s2, ent, cand, th)

            info.sequential_selection_stereo = walk
        jax_regime.land_fetches()
        self.jnp, self.synthetic, self.frame_mod = jnp, synthetic, frame_mod
        self.voc_mod, self.traj_io = voc_mod, traj_io
        self.mods = SimpleNamespace(System=System, Tracker=Tracker, ts=ts,
                          ba_build=ba_build, local_ba=local_ba,
                          gba_cg=gba_cg, LoopCloser=LoopCloser)
        cfg = SystemConfig()
        self.statics = frame_mod.make_statics(cfg)
        self.system = System(cfg=cfg, **self.cell["system"])

    def build(self, s: int):
        jnp = self.jnp
        cls, conf, ent = self.synthetic.structured_semantics(self.cls[s],
                                                             seed=7)
        return self.frame_mod.build_frame_nosegnet(
            self.statics, jnp.asarray(self.left[s]),
            jnp.asarray(self.right[s]), jnp.asarray(cls), jnp.asarray(conf),
            jnp.asarray(ent))

    def to_np(self, x) -> np.ndarray:
        return np.asarray(x)


class _Port(_Side):
    """The port on the CPU; ``port`` with the JAX package's RANSAC
    draws, ``port_own`` with its own."""

    def setup(self) -> None:
        import torch

        from sivo_tpu_torch.config import SystemConfig
        from sivo_tpu_torch.io import synthetic
        from sivo_tpu_torch.io import trajectory as traj_io
        from sivo_tpu_torch.optim import ba_build, gba_cg, local_ba
        from sivo_tpu_torch.place import vocabulary as voc_mod
        from sivo_tpu_torch.runtime import frame as frame_mod
        from sivo_tpu_torch.runtime import track_step as ts
        from sivo_tpu_torch.runtime.loopclosing import LoopCloser
        from sivo_tpu_torch.runtime.system import System
        from sivo_tpu_torch.runtime.tracking import Tracker

        torch.set_num_threads(PORT_THREADS)
        self.torch, self.synthetic, self.frame_mod = torch, synthetic, frame_mod
        self.voc_mod, self.traj_io = voc_mod, traj_io
        self.dev = torch.device("cpu")
        self.mods = SimpleNamespace(System=System, Tracker=Tracker, ts=ts,
                          ba_build=ba_build, local_ba=local_ba,
                          gba_cg=gba_cg, LoopCloser=LoopCloser)
        cfg = SystemConfig()
        self.statics = frame_mod.make_statics(cfg)
        self.system = System(cfg=cfg, device=self.dev, **self.cell["system"])
        if self.name == "port":
            self.jax_draws()
        if self.stable_walk:
            from sivo_tpu_torch.select import info

            def walk(cov, pts, s2, ent, cand, th, fx, fy, baseline,
                     min_select=32):
                out = stable_walk(*(x.numpy() for x in (cov, pts, s2, ent,
                                                        cand)),
                                  th, fx, fy, baseline, min_select)
                return tuple(torch.from_numpy(np.asarray(x)) for x in out)

            info.sequential_selection_stereo = walk

    def jax_draws(self) -> None:
        """Hand the port the JAX package's minimal sets: the anchor's
        key folds the frame's keypoint sum into key 17
        (``sivo_tpu/runtime/track_step.py``), relocalization keys by the
        frame count and the Sim3 RANSAC by the keyframe, which the
        port's generators are seeded with."""
        import jax
        import jax.numpy as jnp

        from sivo_tpu_torch.optim import sim3_opt
        from sivo_tpu_torch.place import pnp

        torch, side = self.torch, self
        seed_of = jax.jit(lambda xy: (jnp.sum(xy, dtype=jnp.float32)
                                      * 7.0).astype(jnp.int32))

        def sets(key, valid, n_hyp, k):
            g = jax.random.gumbel(key, (n_hyp, valid.shape[0]))
            g = jnp.where(jnp.asarray(valid.numpy())[None, :], g, -jnp.inf)
            return torch.from_numpy(
                np.asarray(jax.lax.top_k(g, k)[1]).astype(np.int64))

        def pnp_sets(valid, generator, n_hypotheses=256):
            if generator is side.system.tracker.generator:
                key = jax.random.fold_in(jax.random.key(17),
                                         side.anchor_seed[0])
            else:
                key = jax.random.key(generator.initial_seed())
            return sets(key, valid, n_hypotheses, pnp.MIN_SET)

        def sim3_sets(valid, generator, n_hypotheses=128):
            return sets(jax.random.key(generator.initial_seed()), valid,
                        n_hypotheses, 3)

        dispatch = self.mods.Tracker.dispatch

        def seeded_dispatch(self, frame, timestamp):
            side.anchor_seed[0] = int(seed_of(jnp.asarray(frame.xy.numpy())))
            return dispatch(self, frame, timestamp)

        pnp.draw_sets = pnp_sets
        sim3_opt.draw_sets = sim3_sets
        self.mods.Tracker.dispatch = seeded_dispatch

    def build(self, s: int):
        cls, conf, ent = self.synthetic.structured_semantics(self.cls[s],
                                                             seed=7)
        return self.frame_mod.build_frame_nosegnet(
            self.statics, self.left[s], self.right[s], cls, conf, ent,
            device=self.dev)

    def to_np(self, x) -> np.ndarray:
        return x.numpy()


SIDES = {"jax": _Jax, "jax_xla": _Jax, "port": _Port, "port_own": _Port}


def stable_walk(cov, pts, sigma2, ent, cand, th, fx, fy, baseline,
                min_select):
    """The sequential selection walk of ``select/info.py`` (both
    packages) in float64 numpy: the same candidates, order, scores,
    accept rule and covariance-only Kalman update. In float32 that update
    loses the covariance's positive definiteness within a few accepts,
    and then which keypoints are accepted rests on each BLAS's rounding.
    Returns (selected (N,) bool, final (6, 6) covariance as float32, the
    walk index of the last accept as float32, -1 when none)."""
    n = pts.shape[0]
    comp = np.sort(np.where(cand, np.arange(n), n))[: min(512, n)]
    comp = comp[comp < n]
    X, Y, Z = np.asarray(pts, np.float64)[comp].T
    Z = np.where(np.abs(Z) > 1e-12, Z, 1e-12)
    iz, zero = 1.0 / Z, np.zeros_like(X)
    iz2 = iz * iz
    Xb = X - baseline
    J = np.stack([
        np.stack([fx * iz, zero, -fx * X * iz2, -fx * X * Y * iz2,
                  fx * (1.0 + X * X * iz2), -fx * Y * iz], -1),
        np.stack([zero, fy * iz, -fy * Y * iz2, -fy * (1.0 + Y * Y * iz2),
                  fy * X * Y * iz2, fy * X * iz], -1),
        np.stack([fx * iz, zero, -fx * Xb * iz2, -fx * Xb * Y * iz2,
                  fx * (1.0 + X * Xb * iz2), -fx * Y * iz], -1),
    ], -2)
    P = np.asarray(cov, np.float64)
    sel, count, last = np.zeros(n, bool), 0, -1.0
    for k, kp in enumerate(comp):
        s2 = float(sigma2[kp])
        S = J[k] @ P @ J[k].T + s2 * np.eye(3)
        mi = 0.5 * (np.log(max(np.linalg.det(S), 1e-30))
                    - 3.0 * np.log(s2)) * 1.4426950408889634
        score = mi - float(ent[kp])
        if score > float(th) or (count < min_select and score > 0.0):
            K = P @ J[k].T @ np.linalg.inv(S)
            P = (np.eye(6) - K @ J[k]) @ P
            P = 0.5 * (P + P.T)
            sel[kp], count, last = True, count + 1, float(k)
    return sel, P.astype(np.float32), np.float32(last)


def _worker(name: str, work: str, n_frames: int, stable: bool, cell: str,
            conn) -> None:
    """One side in its own process, stepped by the parent's messages."""
    try:
        side = SIDES[name](name, Path(work), n_frames, stable, cell)
        conn.send(("ready", None))
        last = []
        while True:
            msg, arg = conn.recv()
            if msg == "step":
                rec = side.step(arg)
                last = rec["retired"]
                conn.send(("rec", rec))
            elif msg == "dump":
                side.dump(Path(work) / f"divergence_{arg}_{name}.npz", last)
                conn.send(("dumped", None))
            elif msg == "finish":
                conn.send(("final", side.finish()))
                return
    except Exception:  # noqa: BLE001 (reported to the parent)
        conn.send(("error", traceback.format_exc()))


# -- comparison ------------------------------------------------------------


def _centre(pose) -> np.ndarray:
    p = np.asarray(pose, np.float64)
    return -p[:3, :3].T @ p[:3, 3]


def integer_fields(rec: dict) -> dict:
    """The call's integer fields, by name."""
    out = {f"counter.{k}": v for k, v in rec["counters"].items()}
    fr = rec["front"]
    for k in ("n_valid", "n_semantic", "n_stereo"):
        out[f"front.{k}"] = fr[k]
    out["retired.fids"] = tuple(r["fid"] for r in rec["retired"])
    for r in rec["retired"]:
        for k in ("lost", "ref_kf", "kf", "sel", *(f.lower() for f in
                                                    SUMMARY_FIELDS)):
            out[f"retired.{k}"] = out.get(f"retired.{k}", ()) + (r[k],)
    out["reloc"] = tuple((r["fid"], r["ok"], r["cand"])
                         for r in rec["relocs"])
    return out


def front_diff(a: dict, b: dict) -> dict:
    """Slots whose position or level differ, and keypoints (in equal
    slots) whose descriptor does."""
    va, vb = a["valid"], b["valid"]
    same = ((a["xy"] == b["xy"]).all(1) & (a["level"] == b["level"])
            & (va == vb))
    both = same & va
    bits = np.unpackbits(a["desc_u8"] ^ b["desc_u8"], axis=1).sum(1)
    return {"slots_diff": int((~same & (va | vb)).sum()),
            "desc_diff": int((bits[both] > 0).sum()),
            "desc_bits_max": int(bits[both].max()) if both.any() else 0}


def margins(r: dict, cfg: dict) -> str:
    """The keyframe rule's inputs (tracking.py ``_need_new_keyframe``)
    and their distance to each threshold."""
    th_ref = cfg["th_ref_ratio"] if r["n_kf_before"] >= 2 else 0.25
    return (f"tracked {r['n_tracked']} vs ref {r['n_ref']} x {th_ref} = "
            f"{r['n_ref'] * th_ref:.2f} (margin "
            f"{r['n_tracked'] - r['n_ref'] * th_ref:+.2f}); close tracked "
            f"{r['n_close_tracked']} vs < {cfg['close_tracked_max']}, close "
            f"free {r['n_close_free']} vs > {cfg['close_nontracked_min']}; "
            f"rotation {r['rot_rate']:.5f} vs 0.03 rad/frame; "
            f"{r['since_kf']} frames since the keyframe; mapper queue "
            f"{r['queue']}, busy {r['busy']}; ok {r['ok']}, inliers "
            f"{r['n_inliers1']}/{r['n_inliers2']}, motion matches "
            f"{r['n_matches_motion']} (motion stage {r['mot_n']}/"
            f"{r['mot_inl']}), fallback {r['used_fallback']}, rotation "
            f"deviation {r['rot_dev']:.5f}")


def ate(poses: np.ndarray, gt: np.ndarray, keep=None) -> float:
    err = ref.frame_errors(poses if keep is None else poses[keep],
                       gt if keep is None else gt[keep])
    return float(np.sqrt(np.mean(err ** 2)))


def summarize(name: str, final: dict, gt: np.ndarray, n: int) -> dict:
    poses = final["poses"]
    err = ref.frame_errors(poses, gt)
    kept = np.setdiff1d(np.arange(n), final["lost_frames"])
    c = final["counters"]
    ok_relocs = [r for r in final["relocs"] if r["ok"]]
    entry = {
        "side": name,
        "descriptors": {"jax": "K1 semantics (Pallas kernel, interpreted)",
                        "jax_xla": "the XLA path (float canvases)",
                        "port": "K1 semantics (the port's plain version)",
                        "port_own": "K1 semantics (the port's plain version)"
                        }[name],
        "draws": {"jax": "jax.random", "jax_xla": "jax.random",
                  "port": "jax.random (handed in)",
                  "port_own": "torch.Generator"}[name],
        "loops": c["loops"], "events": final["events"],
        "gba": final["gbas"], "gba_applied": c["gba_applied"],
        "compactions": c["compactions"],
        "relocalizations": c["reloc_successes"],
        "reloc_attempts": c["reloc_attempts"],
        "reloc_frames": [r["fid"] for r in ok_relocs],
        "crisis_frames": c["crisis"], "lost": len(final["lost_frames"]),
        "lost_frames": final["lost_frames"], "keyframes": c["keyframes"],
        "keyframes_live": final["keyframes_live"], "points": c["points"],
        "points_live": final["points_live"],
        "ate": round(ate(poses, gt), 4),
        "ate_tracked": round(ate(poses, gt, kept), 4),
        "err_max": round(float(err.max()), 4),
        "err_max_frame": int(err.argmax()),
        "local_cap_binds": final["local_cap_binds"],
        "admit_waits": final["admit_waits"],
        "seconds": round(final["seconds"]),
    }
    if "poses_repointed" in final and ok_relocs:
        rp = final["poses_repointed"]
        entry["ate_repointed"] = round(ate(rp, gt), 4)
        entry["ate_tracked_repointed"] = round(ate(rp, gt, kept), 4)
    return entry


def main() -> None:
    args = sys.argv[1:]
    sides, cell = ["jax", "port", "port_own"], "dumbbell434"
    if "--cell" in args:
        k = args.index("--cell")
        cell = args[k + 1]
        del args[k: k + 2]
    n_frames = CELLS[cell]["frames"]
    if "--frames" in args:
        k = args.index("--frames")
        n_frames = int(args[k + 1])
        del args[k: k + 2]
    stable = "--stable-walk" in args
    args = [a for a in args if a != "--stable-walk"]
    if "--sides" in args:
        k = args.index("--sides")
        sides = args[k + 1].split(",")
        del args[k: k + 2]
    if not set(sides) <= set(SIDES) or len(set(sides)) != len(sides):
        raise SystemExit(f"--sides: distinct names of {sorted(SIDES)}")
    work = Path(args[0])
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    from sivo_tpu.config import SystemConfig
    from sivo_tpu.io import synthetic

    if cell == "dumbbell434":
        ref.render_lap(work)
    else:
        render_loop(work)
    tcfg = SystemConfig().tracking
    cfg = {k: getattr(tcfg, k) for k in ("th_ref_ratio", "close_tracked_max",
                                         "close_nontracked_min")}
    gt = (synthetic.figure8_trajectory(n_frames) if cell == "dumbbell434"
          else loop_truth(n_frames))
    print(f"renders ready in {time.perf_counter() - t0:.0f} s; sides "
          f"{sides}, {n_frames} frames"
          + ", the selection walk in float64" * stable, flush=True)

    ctx = multiprocessing.get_context("spawn")
    procs, conns = {}, {}
    for name in sides:
        parent, child = ctx.Pipe()
        procs[name] = ctx.Process(target=_worker, daemon=True,
                                  args=(name, str(work), n_frames, stable,
                                        cell, child))
        procs[name].start()
        conns[name] = parent

    def recv(name):
        msg, arg = conns[name].recv()
        if msg == "error":
            for p in procs.values():
                p.kill()
            raise RuntimeError(f"side {name} failed:\n{arg}")
        return arg

    for name in sides:
        recv(name)
    b, others = sides[0], sides[1:]
    first: dict = {o: {} for o in others}
    gap_max = {o: 0.0 for o in others}
    gap_at = {o: -1 for o in others}
    fronts = {o: {"slots_frames": [], "desc_frames": [],
                  "desc_bits_max": 0} for o in others}
    records: dict = {s: [] for s in sides}
    dumped: set = set()
    poses_by_fid: dict = {s: {} for s in sides}
    for i in range(n_frames):
        for name in sides:
            conns[name].send(("step", i))
        recs = {name: recv(name) for name in sides}
        for name, rec in recs.items():
            for r in rec["retired"]:
                poses_by_fid[name][r["fid"]] = _centre(r["pose"])
        base = integer_fields(recs[b])
        new_div = []
        for o in others:
            for fid, c in poses_by_fid[o].items():
                if fid in poses_by_fid[b]:
                    g = float(np.linalg.norm(c - poses_by_fid[b][fid]))
                    if g > gap_max[o]:
                        gap_max[o], gap_at[o] = g, fid
            fd = front_diff(recs[b]["front"], recs[o]["front"])
            if fd["slots_diff"]:
                fronts[o]["slots_frames"].append((i, fd["slots_diff"]))
            if fd["desc_diff"]:
                fronts[o]["desc_frames"].append((i, fd["desc_diff"]))
            fronts[o]["desc_bits_max"] = max(fronts[o]["desc_bits_max"],
                                             fd["desc_bits_max"])
            for k, v in {**integer_fields(recs[o]),
                         "front.slots_equal": fd["slots_diff"] == 0,
                         "front.desc_equal": fd["desc_diff"] == 0}.items():
                bv = base.get(k, True)
                if v != bv and k not in first[o]:
                    first[o][k] = {"frame": i, "base": bv, "other": v,
                                   "gap_max": gap_max[o],
                                   "gap_frame": gap_at[o]}
                    new_div.append((o, k))
        for name, rec in recs.items():
            records[name].append({k: v for k, v in rec.items()
                                  if k != "front"})
        kinds = {kind for _, k in new_div for kind, names in
                 (("count", COUNTS), ("decision", DECISIONS))
                 if k in names and kind not in dumped}
        if kinds:
            dumped |= kinds
            print(f"\n== first {' and '.join(sorted(kinds))} apart: frame "
                  f"{i} ==")
            for o, k in new_div:
                print(f"  {k}: {b} {first[o][k]['base']}, {o} "
                      f"{first[o][k]['other']}")
            for name, rec in recs.items():
                for r in rec["retired"]:
                    print(f"  {name} frame {r['fid']}: lost {r['lost']}, "
                          f"ref_kf {r['ref_kf']}, kf {r['kf']}; "
                          + margins(r, cfg))
                for r in rec["relocs"]:
                    print(f"  {name} relocalization: {r}")
                print(f"  {name} counters {rec['counters']}")
            for name in sides:
                conns[name].send(("dump", "_".join(sorted(kinds))))
                recv(name)
            print(flush=True)
        if i % 20 == 19:
            c = recs[b]["counters"]
            print(f"frame {i + 1}: {b} keyframes {c['keyframes']}, loops "
                  f"{c['loops']}; "
                  + "; ".join(f"{o} keyframes "
                              f"{recs[o]['counters']['keyframes']}, "
                              f"fields apart {len(first[o])}, centre gap "
                              f"max {gap_max[o]:.4f} m" for o in others)
                  + f"; {time.perf_counter() - t0:.0f} s", flush=True)
    for name in sides:
        conns[name].send(("finish", None))
    finals = {name: recv(name) for name in sides}
    for p in procs.values():
        p.join(timeout=60)

    print("\n== lockstep ==")
    for o in others:
        print(f"{b} against {o}: the first frame at which each integer "
              f"field differs (value on each side; the largest camera-centre"
              f" gap between the two up to then, and its frame)")
        for k, d in sorted(first[o].items(), key=lambda kv: kv[1]["frame"]):
            print(f"  frame {d['frame']:3d} {k}: {b} {d['base']}, {o} "
                  f"{d['other']}; gap {d['gap_max']:.5f} m (frame "
                  f"{d['gap_frame']})")
        fr = fronts[o]
        print(f"  frontend: frames with slots apart {fr['slots_frames']}; "
              f"frames with descriptors apart {len(fr['desc_frames'])} "
              f"(first {fr['desc_frames'][:5]}), most bits apart "
              f"{fr['desc_bits_max']}; largest centre gap "
              f"{gap_max[o]:.5f} m at frame {gap_at[o]}")
    refs = {name: summarize(name, finals[name], gt, n_frames)
            for name in sides}
    for name, r in refs.items():
        print(f"\n{name} ({r['descriptors']}, draws {r['draws']}): loops "
              f"{r['loops']}, events {json.dumps(r['events'])}")
        for g in r["gba"]:
            print(f"  GBA at frame {g['frame']}: {g['path']}, bucket "
                  f"{g['bucket']}, {g['n_kfs']} of {g['n_keyframes']} "
                  f"keyframes, applied at frame {g['applied_frame']}")
        extra = ""
        if "ate_repointed" in r:
            extra = (f"; relocalized records re-pointed: ATE "
                     f"{r['ate_repointed']:.4f} m "
                     f"({r['ate_tracked_repointed']:.4f} m tracked)")
        print(f"  keyframes {r['keyframes']} ({r['keyframes_live']} live), "
              f"points {r['points']} ({r['points_live']} live), lost "
              f"{r['lost']} {r['lost_frames']}, relocalizations "
              f"{r['relocalizations']} of {r['reloc_attempts']} at "
              f"{r['reloc_frames']}, crisis frames {r['crisis_frames']}, "
              f"compactions {r['compactions']}, admissions deferred "
              f"{r['admit_waits']}, ATE {r['ate']:.4f} m "
              f"({r['ate_tracked']:.4f} m tracked), largest aligned centre "
              f"error {r['err_max']:.3f} m at frame {r['err_max_frame']}"
              f"{extra}; {r['seconds']} s")
    (work / "parity.json").write_text(json.dumps(
        {"records": records, "first": first, "refs": refs,
         "fronts": fronts}, default=str))
    for name, r in refs.items():
        print(f"REF_{cell.upper()} {name} " + json.dumps(
            {k: v for k, v in r.items() if k != "gba"}))
    print(f"{time.perf_counter() - t0:.0f} s")


if __name__ == "__main__":
    main()
