"""Copies that land late: the port's session on the CPU under the card's
copy timing, and dumbbell434's first frames or loop190 run so.

On the CPU every ``HostCopy`` has landed when it is made (``done()`` is
always true), so the mapper's admissions and BA, and the loop closer's
Sim3 attempts, global BA steps and application, always meet the frames
in flight at the same point. On the card they land whenever their copy
completes, which varies from run to run. ``delayed_landing(seed)``
makes each ``HostCopy`` answer "not landed" to its first k polls of
``done()``, k drawn per copy from ``numpy.random.default_rng(seed)`` in
0..``max_polls`` (the session's ``pipeline_depth`` + 2 by default);
``result()`` is unchanged, as on the card, where it waits for the copy.
That moves the mapper's deferred admission (``LocalMapper._admit``),
the world corrections re-chained onto tickets in flight
(``Tracker.apply_world_correction``), the loop closer's GBA steps and
application, and so the crisis rule's inputs.

As a script, it runs the port on the CPU on dumbbell434's first frames
(``chip_smoke.py`` phase 11's session: ``System(max_keyframes=448,
max_points=49152, pipeline_depth=3)`` with the offline vocabulary,
``track_frame(pipeline=True)``, the renderer's semantics through
``build_frame_nosegnet``) under the harness, once per seed, with
phase 11's per-frame record (``chip_smoke.FrameLog``), saved as
``WORK_DIR/late_<seed>.npz``. The lap renders are
``tools/dumbbell_jax_reference.py``'s ``WORK_DIR/dumbbell404.npz``. It
prints each run's lost frames, loops with their frames, keyframes, the
polls refused, the first non-zero map-health count and the ATE over
``frame_poses()``, and on a lost frame the record around it.
``--cell loop190`` runs ``chip_smoke.py`` phase 7's session instead,
built as ``tools/loop190_jax_reference.py`` builds the JAX package's
(``chip_smoke.loop_system``: ``System(max_keyframes=256,
max_points=32768)`` with the offline vocabulary, ``track_frame``
unpipelined, the renderer's semantics) on the loop world's 190 frames,
rendered once into ``WORK_DIR/loop190.npz``; its records are
``WORK_DIR/loop190_<draw>_<seed>.npz``. A seed named "plain" runs
without late copies (on the CPU every copy has then landed when it is
made, and plain draws differ only by the float sums the CPU's threads
reorder). ``--lose FRAME`` strips that frame of its semantic
keypoints, so that it is lost (as ``tests/test_torch_session.py``'s
crisis test does): the session's course after one lost frame there.
``--package jax`` runs the JAX package's ``System`` instead (no
record), with K1's descriptor semantics and its host fetches landed on
return (``tools/jax_regime.py``), each fetch then answering "not
landed" to its first k polls as above (``jax_delayed_landing``).

Run from the repository root (CPU, ~2 threads and ~3 GB a run; ~5 s a
frame): ``python tools/late_copies.py WORK_DIR [--cell
dumbbell434|loop190] [--frames N] [--seeds 0,1,2,3] [--parallel N]
[--lose FRAME] [--package port|jax]`` (seeds run as parallel
processes, ``--parallel`` at a time, by default all; the JAX package
~10 s a frame with K1 interpreted, dumbbell434 only). Phase 7's draws:
``--cell loop190 --seeds plain,plain,0,1,2,3,4,5 --parallel 3`` (~1.3
GB and 45-55 minutes a draw three at a time beside two JAX runs on 8
cores); each draw's last line is ``LATE {...}``.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 260  # past the first loop closure (frames 244-250)
THREADS = 2


@contextlib.contextmanager
def delayed_landing(seed: int, max_polls: int):
    """Every ``HostCopy`` made inside answers ``done()`` False for its
    first k polls, k uniform in 0..``max_polls``. Yields counts of the
    copies made and the polls refused."""
    from sivo_tpu_torch.utils.transfer import HostCopy

    rng = np.random.default_rng(seed)
    init, done = HostCopy.__init__, HostCopy.done
    counts = {"copies": 0, "late": 0, "refused": 0}

    def late_init(self, tensors):
        init(self, tensors)
        self._late_polls = int(rng.integers(0, max_polls + 1))
        counts["copies"] += 1
        counts["late"] += self._late_polls > 0

    def late_done(self):
        if getattr(self, "_late_polls", 0) > 0:
            self._late_polls -= 1
            counts["refused"] += 1
            return False
        return done(self)

    HostCopy.__init__, HostCopy.done = late_init, late_done
    try:
        yield counts
    finally:
        HostCopy.__init__, HostCopy.done = init, done


class _Late:
    """A landed future that answers ``done()`` False for ``k`` polls."""

    def __init__(self, fut, k: int, counts: dict):
        self._fut, self._k, self._counts = fut, k, counts

    def done(self) -> bool:
        if self._k > 0:
            self._k -= 1
            self._counts["refused"] += 1
            return False
        return self._fut.done()

    def result(self, *args):
        return self._fut.result(*args)


@contextlib.contextmanager
def jax_delayed_landing(seed: int, max_polls: int):
    """``delayed_landing`` for the JAX package: its fetches land when
    they return, then answer ``done()`` False for their first k polls."""
    from sivo_tpu.utils import fetch

    from tools import jax_regime

    rng = np.random.default_rng(seed)
    packed, get = fetch.fetch_packed_async, fetch.device_get_async
    counts = {"copies": 0, "late": 0, "refused": 0}

    def late(fut):
        k = int(rng.integers(0, max_polls + 1))
        counts["copies"] += 1
        counts["late"] += k > 0
        return _Late(fut, k, counts)

    def late_packed(tree):
        out = jax_regime.landed_packed(tree)
        out._fut = late(out._fut)
        return out

    fetch.fetch_packed_async = late_packed
    fetch.device_get_async = lambda x: late(jax_regime.landed_get(x))
    try:
        yield counts
    finally:
        fetch.fetch_packed_async, fetch.device_get_async = packed, get


def run_jax(work: Path, seed: int, n_frames: int) -> dict:
    """The JAX package's session on the lap's first ``n_frames`` under
    ``jax_delayed_landing(seed)``, with K1's descriptor semantics; its
    summary."""
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from sivo_tpu.config import SystemConfig
    from sivo_tpu.io import synthetic
    from sivo_tpu.place import vocabulary as voc_mod
    from sivo_tpu.runtime import frame as frame_mod
    from sivo_tpu.runtime.system import System
    from tools import jax_regime

    jax_regime.use_k1()
    z = np.load(work / "dumbbell404.npz")
    left, right, cls_maps = z["left"], z["right"], z["cls"]
    lap = left.shape[0]
    cfg = SystemConfig()
    statics = frame_mod.make_statics(cfg)
    system = System(cfg=cfg, max_keyframes=448, max_points=49152,
                    pipeline_depth=3)
    system.attach_vocabulary(voc_mod.load_npz(
        str(ROOT / "sivo_tpu" / "place" / "data" / "orbvoc_synth.npz")))
    lc = system.loop_closer
    closed_at = []
    with jax_delayed_landing(seed, system.pipeline_depth + 2) as counts:
        for i in range(n_frames):
            s = i % lap
            cls, conf, ent = synthetic.structured_semantics(cls_maps[s],
                                                            seed=7)
            f = frame_mod.build_frame_nosegnet(
                statics, jnp.asarray(left[s]), jnp.asarray(right[s]),
                jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent))
            before = lc.loops_closed
            system.track_frame(f, i * 0.1, pipeline=True)
            closed_at += [i] * (lc.loops_closed - before)
        system.flush()
    gt = synthetic.figure8_trajectory(n_frames)
    poses = system.frame_poses()
    lost = [i for i, r in enumerate(system.tracker.trajectory) if r.lost]
    return {"package": "jax", "seed": seed, "frames": n_frames,
            "lost": len(lost), "lost_frames": lost,
            "loops": lc.loops_closed, "closed_at": closed_at,
            "keyframes": system.map.n_keyframes,
            "relocalizations": getattr(system, "reloc_successes", 0),
            "reloc_attempts": getattr(system, "reloc_attempts", 0),
            "crisis_frames": getattr(system, "crisis_frames", 0), **counts,
            "ate": float(synthetic.ate_rmse(poses, gt)),
            "finite": bool(np.isfinite(poses).all())}


def _frames(work: Path, cell: str):
    """The cell's rendered frames (left, right, classes) and its ground
    truth of ``n`` frames: dumbbell434's lap from
    ``tools/dumbbell_jax_reference.py``'s ``WORK_DIR/dumbbell404.npz``,
    loop190's 190 frames from ``WORK_DIR/loop190.npz`` (rendered here
    by ``chip_smoke.make_scene`` if missing)."""
    import chip_smoke as cs
    from sivo_tpu_torch.io import synthetic

    if cell == "dumbbell434":
        if not (work / "dumbbell404.npz").exists():
            sys.path.insert(0, str(ROOT / "tools"))
            import dumbbell_jax_reference as ref

            ref.render_lap(work)
        z = np.load(work / "dumbbell404.npz")
        return z["left"], z["right"], z["cls"], synthetic.figure8_trajectory
    path = work / "loop190.npz"
    if not path.exists():
        _, left, right, _, cls = cs.make_scene(cs.SystemConfig(),
                                               cs.N_LOOP_FRAMES)
        work.mkdir(parents=True, exist_ok=True)
        np.savez(path, left=left, right=right, cls=cls)
    z = np.load(path)
    return z["left"], z["right"], z["cls"], lambda n: (
        synthetic.square_loop_trajectory(n_frames=cs.N_LOOP_FRAMES,
                                         half=9.5, corner_r=3.5,
                                         jitter=0.03)[:n])


def run(work: Path, seed, n_frames: int, lose: int = -1,
        cell: str = "dumbbell434", index: int = 0) -> dict:
    """The cell's session on its first ``n_frames`` under
    ``delayed_landing(seed)`` (``seed`` "plain": no copy lands late),
    frame ``lose`` without semantic keypoints; its summary."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sivo_tpu_torch.config import SystemConfig
    from sivo_tpu_torch.io import synthetic
    from sivo_tpu_torch.place import vocabulary as voc_mod
    from sivo_tpu_torch.runtime import frame as frame_mod
    from sivo_tpu_torch.runtime.system import System

    torch.set_num_threads(THREADS)
    left, right, cls_maps, trajectory = _frames(work, cell)
    lap = left.shape[0]
    n_frames = min(n_frames, lap) if cell == "loop190" else n_frames
    cfg = SystemConfig()
    dev = torch.device("cpu")
    statics = frame_mod.make_statics(cfg)
    voc = voc_mod.load_npz(cs.VOCABULARY)
    if cell == "loop190":
        system = cs.loop_system(cfg, dev, voc)
    else:
        system = System(cfg=cfg, device=dev, max_keyframes=448,
                        max_points=49152, pipeline_depth=3)
        system.attach_vocabulary(voc)
    lc = system.loop_closer
    closed_at = []
    late = (contextlib.nullcontext({}) if seed == "plain" else
            delayed_landing(int(seed), system.pipeline_depth + 2))
    with late as counts, cs.FrameLog(system) as log:
        for i in range(n_frames):
            s = i % lap
            cls, conf, ent = synthetic.structured_semantics(cls_maps[s],
                                                            seed=7)
            f = frame_mod.build_frame_nosegnet(statics, left[s], right[s],
                                               cls, conf, ent, device=dev)
            if i == lose:
                f = f._replace(semantic=torch.zeros_like(f.semantic))
            before = lc.loops_closed
            system.track_frame(f, i * 0.1, pipeline=cell != "loop190")
            closed_at += [i] * (lc.loops_closed - before)
            if i % 20 == 19:
                print(f"{cell} draw {index} ({seed}): frame {i + 1}, "
                      f"keyframes {system.map.n_keyframes}, loops "
                      f"{lc.loops_closed}, lost {system.n_lost()}",
                      flush=True)
        system.flush()
    name = (f"late_{seed}" if cell == "dumbbell434"
            else f"{cell}_{index}_{seed}")
    name += f"_lose{lose}" if lose >= 0 else ""
    nbytes = log.save(str(work / f"{name}.npz"))
    gt = trajectory(n_frames)
    poses = system.frame_poses()
    lost = [i for i, r in enumerate(system.tracker.trajectory) if r.lost]
    out = {"cell": cell, "seed": seed, "index": index, "frames": n_frames,
           "lose": lose, "lost": len(lost),
           "lost_frames": lost, "loops": lc.loops_closed,
           "closed_at": closed_at, "corrected_at": cs.loop_closed_at(log),
           "events": [[e["kf"], e["cand"]] for e in lc.loop_events],
           "gba_applied": lc.gba_applied,
           "keyframes": system.map.n_keyframes,
           "relocalizations": system.reloc_successes,
           "reloc_attempts": system.reloc_attempts,
           "crisis_frames": system.crisis_frames,
           "admit_waits": system.mapper.admit_waits, **counts,
           "first_unhealthy": log.first_unhealthy(),
           "ate": float(synthetic.ate_rmse(poses, gt)),
           "finite": bool(np.isfinite(poses).all()),
           "record_bytes": nbytes, "record_s": log.seconds}
    if lost or out["first_unhealthy"] is not None:
        log.print_window(f"[{cell} draw {index}]")
    return out


def main() -> None:
    import json
    import subprocess

    args = sys.argv[1:]
    work = Path(args[0])

    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    cell = opt("--cell", "dumbbell434")
    n_frames = int(opt("--frames", FRAMES if cell == "dumbbell434"
                       else 190))
    lose = int(opt("--lose", -1))
    package = opt("--package", "port")
    if "--one" in args:
        index, seed = opt("--one", "0:0").split(":")
        out = (run_jax(work, int(seed), n_frames) if package == "jax"
               else run(work, seed, n_frames, lose, cell, int(index)))
        print("LATE " + json.dumps(out), flush=True)
        return
    seeds = opt("--seeds", "0,1,2,3").split(",")
    parallel = int(opt("--parallel", len(seeds)))
    sys.path.insert(0, str(ROOT))
    _frames(work, cell)  # rendered once, before the draws
    draws = list(enumerate(seeds))
    for at in range(0, len(draws), parallel):
        procs = [(i, s, subprocess.Popen(
            [sys.executable, __file__, str(work), "--cell", cell,
             "--frames", str(n_frames), "--lose", str(lose), "--package",
             package, "--one", f"{i}:{s}"], stdout=subprocess.PIPE,
            text=True)) for i, s in draws[at:at + parallel]]
        for i, s, p in procs:
            out = p.communicate()[0]
            print(f"--- draw {i} (seed {s})\n{out}", end="", flush=True)


if __name__ == "__main__":
    main()
