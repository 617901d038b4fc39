"""The JAX package's SLAM session with loop closing on the loop190 cell,
on the CPU: the reference numbers that ``chip_smoke.py``'s phase 7
holds the port to.

The bench loop world (``make_loop_world(seed=0, outer=16, inner=6)``),
all 190 frames of ``square_loop_trajectory(190, half=9.5, corner_r=3.5,
jitter=0.03)`` at the default ``SystemConfig`` (352x1024), the
renderer's semantics (``structured_semantics(seed=7)``) through
``build_frame_nosegnet``, then ``System(max_keyframes=256,
max_points=32768)`` with the offline vocabulary
``sivo_tpu/place/data/orbvoc_synth.npz`` attached, ``track_frame`` on
each frame and ``flush``. Prints loops closed and each loop event,
which global BA path ran (dense Schur or PCG) and how many solutions
were applied, lost frames, keyframes, ATE over ``frame_poses()`` and
relocalizations, and on its last line the lost frames and the frames
whose call closed a loop. Matmuls run at HIGHEST precision, as in the
tests. The JAX mapper and loop closer apply a stage when its fetch
thread's future is done, so the numbers can differ between runs.

``--k1`` describes keypoints with K1's semantics, as the port's kernel
does (``tools/jax_regime.use_k1``); without it the JAX package takes its
CPU XLA descriptor path. ``--landed`` runs in the card's regime, every
host fetch landed when it returns (``tools/jax_regime.land_fetches``).
The last line is a ``REF_LOOP`` entry naming both.

Run from the repository root (CPU; ~26 minutes, ~30 with ``--k1``; two
runs can go side by side; ~55 minutes each two at a time beside other
jobs):
``JAX_PLATFORMS=cpu python tools/loop190_jax_reference.py [--k1]
[--landed]``
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sivo_tpu.config import SystemConfig  # noqa: E402
from sivo_tpu.io import synthetic  # noqa: E402
from sivo_tpu.optim import gba_cg, local_ba  # noqa: E402
from sivo_tpu.place import vocabulary as voc_mod  # noqa: E402
from sivo_tpu.runtime import frame as frame_mod  # noqa: E402
from sivo_tpu.runtime.loopclosing import LoopCloser  # noqa: E402
from sivo_tpu.runtime.system import System  # noqa: E402
from tools.jax_regime import land_fetches, take_flags, use_k1  # noqa: E402

N_FRAMES = 190
VOCABULARY = (Path(__file__).resolve().parents[1] / "sivo_tpu" / "place"
              / "data" / "orbvoc_synth.npz")


def main() -> None:
    _, flags = take_flags(sys.argv[1:], "--k1", "--landed")
    if flags["k1"]:
        use_k1()
    if flags["landed"]:
        land_fetches()
    t0 = time.perf_counter()
    cfg = SystemConfig()
    world = synthetic.make_loop_world(cfg.camera, seed=0, outer=16.0,
                                      inner=6.0)
    gt = synthetic.square_loop_trajectory(n_frames=N_FRAMES, half=9.5,
                                          corner_r=3.5, jitter=0.03)
    left, right, cls_maps = synthetic.render_sequence(world, gt, ss=2)
    print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.0f} s",
          flush=True)
    statics = frame_mod.make_statics(cfg)
    system = System(cfg=cfg, max_keyframes=256, max_points=32768)
    system.attach_vocabulary(voc_mod.load_npz(str(VOCABULARY)))

    gba = {"dense": 0, "pcg": 0, "applied": 0}
    dense, begin = local_ba.global_bundle_adjustment, gba_cg.gba_cg_begin
    apply = LoopCloser._gba_apply

    def counted_dense(*args, **kwargs):
        gba["dense"] += 1
        return dense(*args, **kwargs)

    def counted_begin(*args, **kwargs):
        gba["pcg"] += 1
        return begin(*args, **kwargs)

    def counted_apply(self, tracker):
        gba["applied"] += 1
        return apply(self, tracker)

    local_ba.global_bundle_adjustment = counted_dense
    gba_cg.gba_cg_begin = counted_begin
    LoopCloser._gba_apply = counted_apply
    closed_at = []
    for i in range(N_FRAMES):
        cls, conf, ent = synthetic.structured_semantics(cls_maps[i], seed=7)
        f = frame_mod.build_frame_nosegnet(
            statics, jnp.asarray(left[i]), jnp.asarray(right[i]),
            jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent))
        before = system.loop_closer.loops_closed
        system.track_frame(f, i * 0.1)
        closed_at += [i] * (system.loop_closer.loops_closed - before)
        if i % 20 == 19:
            print(f"frame {i + 1}: keyframes {system.map.n_keyframes}, "
                  f"loops {system.loop_closer.loops_closed}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    before = system.loop_closer.loops_closed
    system.flush()
    closed_at += [N_FRAMES] * (system.loop_closer.loops_closed - before)
    lost_at = [i for i, r in enumerate(system.tracker.trajectory) if r.lost]
    poses = system.frame_poses()
    ate = synthetic.ate_rmse(poses, gt)
    m, lc = system.map, system.loop_closer
    events = [{k: e[k] for k in ("kf", "cand", "correction_m")}
              for e in lc.loop_events]
    print(f"loop190 JAX System (CPU): loops closed {lc.loops_closed}, "
          f"events {json.dumps(events)}, GBA dense {gba['dense']} / PCG "
          f"{gba['pcg']}, applied {gba['applied']}, lost {system.n_lost()}, "
          f"ATE {ate:.4f} m, keyframes {m.n_keyframes} "
          f"({int(m.kf_valid[: m.n_keyframes].sum())} live), map points "
          f"{m.n_points} ({int(m.pt_valid[: m.n_points].sum())} live), "
          f"relocalizations {getattr(system, 'reloc_successes', 0)} of "
          f"{getattr(system, 'reloc_attempts', 0)} attempts, cap binds "
          f"{lc.cap_binds}, {time.perf_counter() - t0:.0f} s")
    assert np.isfinite(poses).all()
    print("REF_LOOP " + json.dumps({
        "descriptors": "k1" if flags["k1"] else "xla",
        "landed": flags["landed"], "loops": lc.loops_closed,
        "lost": system.n_lost(), "ate": round(float(ate), 4),
        "keyframes": m.n_keyframes,
        "events": [[e["kf"], e["cand"]] for e in events],
        "gba": [gba["dense"], gba["pcg"], gba["applied"]],
        "lost_frames": lost_at, "closed_at": closed_at}))


if __name__ == "__main__":
    main()
