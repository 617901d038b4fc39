"""The JAX package's command line on the cli40 scene, on the CPU: the
reference numbers that ``chip_smoke.py``'s phase 8 holds the port's
command line to (``REF_CLI``).

The scene is the first 40 frames of the bench loop world's lap
(``make_loop_world(seed=0, outer=16, inner=6)``,
``square_loop_trajectory(190, half=9.5, corner_r=3.5, jitter=0.03)``,
``ss=2``) at the default ``SystemConfig`` (352x1024), written as a KITTI
directory (``image_2/``, ``image_3/`` PNGs, ``times.txt`` at the
camera's fps, ``settings.yaml`` by ``tools/make_kitti_fixture.
write_settings``), as ``chip_smoke.py`` writes it. A 40-frame
``make_fixture`` would render a different, faster lap. The offline
vocabulary ``sivo_tpu/place/data/orbvoc_synth.npz`` is written as DBoW
text by the JAX package's ``save_text``.

Then ``sivo_tpu.cli.main([voc.txt, settings.yaml, "basic_prototxt", "-",
DIR, "--no-semantics"])`` runs twice, each in its own working directory,
and each run's ATE (Umeyama-aligned, over ``CameraTrajectory.txt``
against the rendered ground truth) and keyframes (``keyframes_points.
txt``) are printed. ``--no-semantics`` (every pixel static and certain)
is the JAX counterpart of phase 8's certain-static standard network.
Matmuls run at HIGHEST precision, as in the tests.

The JAX mapper applies a stage when its fetch thread's future is done,
so the keyframes follow the host/device timing. On the CPU the device
work is slow: a new keyframe's host fetch queues behind the next frames'
tracking programs and the mapper admits it a frame or two late, which
keeps its admission queue non-empty and the keyframe decision's
queue-empty clause off. Where the device outruns the host, as on the
card, every fetch has landed by the next frame. ``--landed`` runs the
JAX command line in that regime: its packed fetches complete before
they return (``sivo_tpu.utils.fetch.fetch_packed_async`` wrapped by
``tools/jax_regime.landed_packed``;
the package itself is unchanged). Phase 8 holds the port's keyframes to
the ``--landed`` runs and its ATE to all four.

``--k1`` describes keypoints with K1's semantics, as the port's kernel
does (``tools/jax_regime.use_k1``); without it the JAX package takes its
CPU XLA descriptor path. The last line is a ``REF_CLI`` entry per run,
naming both.

Run from the repository root (CPU; ~10 minutes each, ~11 with ``--k1``):
``JAX_PLATFORMS=cpu python tools/cli40_jax_reference.py [--landed] [--k1]
[WORK_DIR]``
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import cv2  # noqa: E402
import numpy as np  # noqa: E402

from sivo_tpu import cli  # noqa: E402
from sivo_tpu.config import SystemConfig  # noqa: E402
from sivo_tpu.io import synthetic  # noqa: E402
from sivo_tpu.place import vocabulary as voc_mod  # noqa: E402
from sivo_tpu.utils import fetch  # noqa: E402
from tools.jax_regime import landed_packed, take_flags, use_k1  # noqa: E402
from tools.make_kitti_fixture import write_settings  # noqa: E402

N_FRAMES = 40
VOCABULARY = ROOT / "sivo_tpu" / "place" / "data" / "orbvoc_synth.npz"


def write_scene(out_dir: Path) -> np.ndarray:
    """The cli40 KITTI directory; returns the ground-truth poses."""
    cfg = SystemConfig()
    world = synthetic.make_loop_world(cfg.camera, seed=0, outer=16.0,
                                      inner=6.0)
    gt = synthetic.square_loop_trajectory(n_frames=190, half=9.5,
                                          corner_r=3.5,
                                          jitter=0.03)[:N_FRAMES]
    left, right, _ = synthetic.render_sequence(world, gt, ss=2)
    for side, images in (("image_2", left), ("image_3", right)):
        (out_dir / side).mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(images):
            cv2.imwrite(str(out_dir / side / f"{i:06d}.png"),
                        img.astype(np.uint8))
    with open(out_dir / "times.txt", "w") as f:
        for i in range(N_FRAMES):
            f.write(f"{i / cfg.camera.fps:.6e}\n")
    write_settings(str(out_dir / "settings.yaml"), cfg.camera, cfg.orb,
                   cfg.semantic, cfg.tracking)
    return gt


def read_trajectory(path: Path) -> np.ndarray:
    """A KITTI trajectory file's rows (camera-to-world, Rwc | twc) as
    world-to-camera poses, the convention of ``ate_rmse``."""
    rows = np.loadtxt(path, ndmin=2).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :] = rows
    return np.linalg.inv(poses)


def main() -> None:
    args, flags = take_flags(sys.argv[1:], "--landed", "--k1")
    landed = flags["landed"]
    if landed:
        fetch.fetch_packed_async = landed_packed
    if flags["k1"]:
        use_k1()
    work = Path(args[0]) if args else Path(tempfile.mkdtemp(prefix="cli40_"))
    seq = work / "seq"
    t0 = time.perf_counter()
    gt = write_scene(seq)
    voc_txt = work / "voc.txt"
    voc = voc_mod.load_npz(str(VOCABULARY))
    voc_mod.save_text(voc, str(voc_txt))
    print(f"scene and vocabulary ({voc.n_words} words) written to {work} "
          f"in {time.perf_counter() - t0:.0f} s")
    results = []
    for run in range(2):
        run_dir = work / f"run{run}"
        run_dir.mkdir(exist_ok=True)
        t1 = time.perf_counter()
        with contextlib.chdir(run_dir):
            rc = cli.main([str(voc_txt), str(seq / "settings.yaml"),
                           "basic_prototxt", "-", str(seq),
                           "--no-semantics"])
        assert rc == 0, rc
        poses = read_trajectory(run_dir / "CameraTrajectory.txt")
        counts = (run_dir / "keyframes_points.txt").read_text()
        n_kf = int(counts.split("Final number of keyframes:")[1].split()[0])
        ate = synthetic.ate_rmse(poses, gt)
        results.append((ate, n_kf))
        print(f"cli40 JAX CLI run {run} (CPU{', fetches landed' * landed}): "
              f"{len(poses)} poses, ATE "
              f"{ate:.4f} m, keyframes {n_kf}, "
              f"{time.perf_counter() - t1:.0f} s; counts file {counts!r}")
    for ate, n_kf in results:
        print("REF_CLI " + json.dumps({
            "descriptors": "k1" if flags["k1"] else "xla", "landed": landed,
            "ate": round(float(ate), 4), "keyframes": n_kf}))


if __name__ == "__main__":
    main()
