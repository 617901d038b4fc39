"""The JAX package's SLAM session on the dumbbell434 cell, on the CPU: the
reference numbers that ``chip_smoke.py``'s phase 11 holds the port to
(``REF_DUMBBELL``).

The cell is one super-lap of ``bench.py``'s endurance mode: the dumbbell
world (``make_dumbbell_world(seed=0)``) driven along
``figure8_trajectory(434)``, where 434 is ``figure8_lap_frames()`` (404)
plus the 30 frames that re-drive the start. The trajectory is exactly
periodic, so one lap's 404 renders serve all 434 frames (frame ``i``
shows render ``i % 404``). Renders at ``ss=2`` and the default
``SystemConfig`` (352x1024), the renderer's semantics
(``structured_semantics(seed=7)``) through ``build_frame_nosegnet``,
then ``System(max_keyframes=448, max_points=49152, pipeline_depth=3)``
with the offline vocabulary ``sivo_tpu/place/data/orbvoc_synth.npz``
attached, ``track_frame(pipeline=True)`` on each frame and ``flush``.
Matmuls run at HIGHEST precision, as in the tests.

Prints loops closed and each loop event with the frame it closed at;
each global BA's path (dense or PCG), its bucket (keyframe, point and
observation caps), the keyframes in its problem and the frames at which
it was dispatched and applied; compactions, relocalizations, crisis
frames, lost frames, keyframes and the ATE over ``frame_poses()`` (also
over the frames not lost, and the largest aligned centre error); the
last line is a ``REF_DUMBBELL`` entry. The poses are saved to
``WORK_DIR/poses[_landed].npy``.

The JAX mapper and loop closer apply a stage when its fetch thread's
future is done, so the numbers follow the host/device timing. On the
CPU the device work is slow and fetches land frames late. ``--landed``
runs in the card's regime instead: every host fetch has landed when it
returns (``sivo_tpu.utils.fetch.fetch_packed_async`` and
``device_get_async`` wrapped here; the paced PCG solve polls the
latter; the package itself is unchanged).

The 404 renders are made by a pool of worker processes, one frame per
task, and kept in ``WORK_DIR/dumbbell404.npz`` for the next run.

Run from the repository root (CPU; about an hour per run):
``JAX_PLATFORMS=cpu python tools/dumbbell_jax_reference.py [--landed]
[WORK_DIR]``
"""

from __future__ import annotations

import json
import multiprocessing
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sivo_tpu.config import SystemConfig  # noqa: E402
from sivo_tpu.io import synthetic  # noqa: E402
from tools.jax_regime import land_fetches  # noqa: E402

N_FRAMES = 434  # one super-lap (404) + the 30 frames re-driving the start
VOCABULARY = ROOT / "sivo_tpu" / "place" / "data" / "orbvoc_synth.npz"
RENDER_WORKERS = 6

_WORLD = None


def _render_init() -> None:
    global _WORLD
    import cv2

    cv2.setNumThreads(1)
    _WORLD = synthetic.make_dumbbell_world(SystemConfig().camera, seed=0)


def _render_one(pose: np.ndarray):
    left, right, cls = synthetic.render_sequence(_WORLD, pose[None], ss=2)
    return left[0], right[0], cls[0]


def render_lap(work: Path):
    """The lap's renders (left, right, classes), made once per WORK_DIR."""
    cache = work / "dumbbell404.npz"
    lap = synthetic.figure8_lap_frames()
    if cache.exists():
        z = np.load(cache)
        return z["left"], z["right"], z["cls"]
    gt = synthetic.figure8_trajectory(lap)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=ctx,
                             initializer=_render_init) as pool:
        out = list(pool.map(_render_one, gt))
    left, right, cls = (np.stack(a) for a in zip(*out))
    np.savez(cache, left=left, right=right, cls=cls)
    return left, right, cls


def frame_errors(est_cw: np.ndarray, gt_cw: np.ndarray) -> np.ndarray:
    """Each frame's camera-centre distance (m) after the alignment
    ``ate_rmse`` makes (Umeyama, no scale)."""

    def centers(T):
        return np.stack([-(P[:3, :3].T.astype(np.float64)
                           @ P[:3, 3].astype(np.float64)) for P in T])

    ce, cg = centers(est_cw), centers(gt_cw)
    mu_e, mu_g = ce.mean(0), cg.mean(0)
    U, _, Vt = np.linalg.svd((ce - mu_e).T @ (cg - mu_g))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    return np.linalg.norm(ce @ R.T + (mu_g - R @ mu_e) - cg, axis=-1)


def main() -> None:
    args = sys.argv[1:]
    landed = "--landed" in args
    n_frames = N_FRAMES
    args = [a for a in args if a != "--landed"]
    work = Path(args[0]) if args else Path(
        tempfile.mkdtemp(prefix="dumbbell_"))
    work.mkdir(parents=True, exist_ok=True)

    from sivo_tpu.optim import ba_build, gba_cg, local_ba
    from sivo_tpu.place import vocabulary as voc_mod
    from sivo_tpu.runtime import frame as frame_mod
    from sivo_tpu.runtime.loopclosing import LoopCloser
    from sivo_tpu.runtime.system import System

    if landed:
        land_fetches()
    t0 = time.perf_counter()
    cfg = SystemConfig()
    lap = synthetic.figure8_lap_frames()
    left, right, cls_maps = render_lap(work)
    gt = synthetic.figure8_trajectory(n_frames)
    print(f"{lap} lap frames rendered (or read) in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    statics = frame_mod.make_statics(cfg)
    system = System(cfg=cfg, max_keyframes=448, max_points=49152,
                    pipeline_depth=3)
    system.attach_vocabulary(voc_mod.load_npz(str(VOCABULARY)))

    frame = [0]
    gbas: list[dict] = []
    build, dense = ba_build.build_problem, local_ba.global_bundle_adjustment
    begin, apply = gba_cg.gba_cg_begin, LoopCloser._gba_apply

    def counted_build(m, kfs, fixed, kf_cap, pt_cap, obs_cap, *a, **k):
        gbas.append({"frame": frame[0], "bucket": [kf_cap, pt_cap, obs_cap],
                     "n_kfs": len(kfs), "n_keyframes": m.n_keyframes,
                     "path": None, "applied_frame": None})
        built = build(m, kfs, fixed, kf_cap, pt_cap, obs_cap, *a, **k)
        if built is not None:
            built[1]["ref_gba"] = len(gbas) - 1
        return built

    def counted_dense(*a, **k):
        gbas[-1]["path"] = "dense"
        return dense(*a, **k)

    def counted_begin(*a, **k):
        gbas[-1]["path"] = "pcg"
        return begin(*a, **k)

    def counted_apply(self, tracker):
        gbas[self._gba["ctx"]["ref_gba"]]["applied_frame"] = frame[0]
        return apply(self, tracker)

    ba_build.build_problem = counted_build
    local_ba.global_bundle_adjustment = counted_dense
    gba_cg.gba_cg_begin = counted_begin
    LoopCloser._gba_apply = counted_apply
    lc = system.loop_closer
    closed_at = []
    for i in range(n_frames):
        frame[0] = i
        s = i % lap
        cls, conf, ent = synthetic.structured_semantics(cls_maps[s], seed=7)
        f = frame_mod.build_frame_nosegnet(
            statics, jnp.asarray(left[s]), jnp.asarray(right[s]),
            jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent))
        before = lc.loops_closed
        system.track_frame(f, i * 0.1, pipeline=True)
        closed_at += [i] * (lc.loops_closed - before)
        if i % 20 == 19:
            print(f"frame {i + 1}: keyframes {system.map.n_keyframes}, "
                  f"loops {lc.loops_closed}, compactions "
                  f"{getattr(system, 'compactions', 0)}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    frame[0] = n_frames
    before = lc.loops_closed
    system.flush()
    closed_at += [n_frames] * (lc.loops_closed - before)
    poses = system.frame_poses()
    ate = synthetic.ate_rmse(poses, gt)
    lost_at = [i for i, r in enumerate(system.tracker.trajectory) if r.lost]
    kept = np.setdiff1d(np.arange(n_frames), lost_at)
    err = frame_errors(poses, gt)
    np.save(work / f"poses{'_landed' * landed}.npy", poses)
    m = system.map
    events = [{"frame": fr, **{k: e[k] for k in ("kf", "cand",
                                                 "correction_m")}}
              for fr, e in zip(closed_at, lc.loop_events)]
    ref = {
        "loops": lc.loops_closed,
        "events": events,
        "gba": gbas,
        "gba_applied": sum(g["applied_frame"] is not None for g in gbas),
        "compactions": getattr(system, "compactions", 0),
        "relocalizations": getattr(system, "reloc_successes", 0),
        "reloc_attempts": getattr(system, "reloc_attempts", 0),
        "crisis_frames": getattr(system, "crisis_frames", 0),
        "lost": system.n_lost(),
        "keyframes": m.n_keyframes,
        "keyframes_live": int(m.kf_valid[: m.n_keyframes].sum()),
        "points": m.n_points,
        "points_live": int(m.pt_valid[: m.n_points].sum()),
        "ate": round(float(ate), 4),
        "lost_frames": lost_at,
        "ate_tracked": round(float(synthetic.ate_rmse(poses[kept],
                                                      gt[kept])), 4),
        "err_max": round(float(err.max()), 4),
        "err_max_frame": int(err.argmax()),
        "local_cap_binds": system.tracker.local_cap_binds,
        "cap_binds": lc.cap_binds,
        "seconds": round(time.perf_counter() - t0),
    }
    mode = "fetches landed" if landed else "as the CPU times it"
    print(f"dumbbell{n_frames} JAX System (CPU, {mode}): loops closed "
          f"{ref['loops']}, events {json.dumps(events)}")
    for g in gbas:
        print(f"  GBA at frame {g['frame']}: {g['path']}, bucket "
              f"{g['bucket']}, {g['n_kfs']} of {g['n_keyframes']} "
              f"keyframes, applied at frame {g['applied_frame']}")
    print(f"  applied {ref['gba_applied']}, compactions "
          f"{ref['compactions']}, relocalizations {ref['relocalizations']}"
          f" of {ref['reloc_attempts']}, crisis frames "
          f"{ref['crisis_frames']}, lost {ref['lost']}, keyframes "
          f"{ref['keyframes']} ({ref['keyframes_live']} live), map points "
          f"{ref['points']} ({ref['points_live']} live), ATE "
          f"{ref['ate']:.4f} m ({ref['ate_tracked']:.4f} m over the frames "
          f"not lost; lost frames {lost_at}; the largest aligned centre "
          f"error {ref['err_max']:.3f} m at frame {ref['err_max_frame']}), "
          f"local cap binds {ref['local_cap_binds']}, {ref['seconds']} s")
    print("REF_DUMBBELL" + ("_landed" if landed else "") + " "
          + json.dumps(ref))
    assert np.isfinite(poses).all()


if __name__ == "__main__":
    main()
