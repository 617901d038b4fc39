"""The JAX package's SLAM session on the loop40 cell, on the CPU: the
reference numbers that ``chip_smoke.py``'s phase 6 holds the port to.

The bench loop world (``make_loop_world(seed=0, outer=16, inner=6)``,
``square_loop_trajectory(190, half=9.5, corner_r=3.5, jitter=0.03)``),
its first 40 frames at the default ``SystemConfig`` (352x1024), the
renderer's semantics (``structured_semantics(seed=7)``) through
``build_frame_nosegnet``, then ``System(max_keyframes=256,
max_points=32768).track_frame`` on each frame and ``flush``. Prints lost
frames, ATE over ``frame_poses()``, keyframes, BA solves applied, map
points and the points triangulation minted (``MapState.add_points`` is
called by the mapper's triangulation only). Matmuls run at HIGHEST
precision, as in the tests. The JAX mapper applies a stage when its
fetch thread's future is done, so the numbers can differ between runs.

``--k1`` describes keypoints with K1's semantics, as the port's kernel
does (``tools/jax_regime.use_k1``); without it the JAX package takes its
CPU XLA descriptor path. ``--landed`` runs in the card's regime, every
host fetch landed when it returns (``tools/jax_regime.land_fetches``).
The last line is a ``REF_SYSTEM`` entry naming both.

Run from the repository root (CPU; ~4 minutes, ~5 with ``--k1``):
``JAX_PLATFORMS=cpu python tools/loop40_jax_reference.py [--k1]
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
from sivo_tpu.runtime import frame as frame_mod  # noqa: E402
from sivo_tpu.runtime.system import System  # noqa: E402
from tools.jax_regime import land_fetches, take_flags, use_k1  # noqa: E402

N_FRAMES = 40


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
    gt = synthetic.square_loop_trajectory(n_frames=190, half=9.5,
                                          corner_r=3.5,
                                          jitter=0.03)[:N_FRAMES]
    left, right, cls_maps = synthetic.render_sequence(world, gt, ss=2)
    statics = frame_mod.make_statics(cfg)
    system = System(cfg=cfg, max_keyframes=256, max_points=32768)
    minted = [0]
    add_points = system.map.add_points

    def counted_add_points(positions, *args, **kwargs):
        minted[0] += len(positions)
        return add_points(positions, *args, **kwargs)

    system.map.add_points = counted_add_points
    for i in range(N_FRAMES):
        cls, conf, ent = synthetic.structured_semantics(cls_maps[i], seed=7)
        f = frame_mod.build_frame_nosegnet(
            statics, jnp.asarray(left[i]), jnp.asarray(right[i]),
            jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent))
        system.track_frame(f, i * 0.1)
    system.flush()
    poses = system.frame_poses()
    ate = synthetic.ate_rmse(poses, gt)
    m = system.map
    print(f"loop40 JAX System (CPU): lost {system.n_lost()}, ATE {ate:.4f} m, "
          f"keyframes {m.n_keyframes}, BA solves "
          f"{system.timer.counts.get('map.ba_apply', 0)}, map points "
          f"{m.n_points} ({int(m.pt_valid[: m.n_points].sum())} live), "
          f"triangulated {minted[0]}, {time.perf_counter() - t0:.0f} s")
    assert np.isfinite(poses).all()
    print("REF_SYSTEM " + json.dumps({
        "descriptors": "k1" if flags["k1"] else "xla",
        "landed": flags["landed"], "lost": system.n_lost(),
        "ate": round(float(ate), 4), "keyframes": m.n_keyframes,
        "ba_solves": system.timer.counts.get("map.ba_apply", 0),
        "triangulated": minted[0]}))


if __name__ == "__main__":
    main()
