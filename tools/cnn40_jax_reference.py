"""The JAX package's SegNet training recipe and command line on the
cli40 scene, on the CPU: the reference numbers that ``chip_smoke.py``'s
phase 3c and phase 8 run C hold the port to (``REF_CNN``).

1. The bench loop world's lap (``make_loop_world(seed=0, outer=16,
   inner=6)``, ``square_loop_trajectory(190, half=9.5, corner_r=3.5,
   jitter=0.03)``, ``ss=2``) is rendered with ``sivo_tpu.io.synthetic``
   and written in the JAX training tool's cache format (``left`` as
   uint8, ``cls``), as ``bench.py`` writes it. The frames the recipe
   reads (every 8th, and holdout frame 4) are also written to
   ``tools/data/cnn40_training_frames.npz`` (``index``, ``left``,
   ``cls``), which ``chip_smoke.py``'s phase 3c trains on: a machine
   with other versions of OpenCV and numpy renders other pixels.
2. SegNet basic is trained on it eight times, four processes at a
   time: by the unchanged ``tools/train_bench_segnet.py CACHE OUT 150``
   (seed 0: ``jax.random.key(0)`` and ``train_segnet(seed=0)``), and by
   the same recipe in this script with seeds 1-7 (every 8th frame at
   176x512, batch 2, lr 1e-3, 150 steps). Each prints its pixel accuracy on
   holdout frame 4 at full resolution with MC = 3 (``jax.random.key(1)``
   as the tool). One seed is one draw: on this scene the holdout accuracy
   of the recipe spreads over several hundredths from seed to seed.
   Each network is then loaded back from its ``.caffemodel`` and run
   again on the holdout frame the same way, for the accuracy and the
   mean entropy (bits) of its posterior.
3. The cli40 directory (``cli40_jax_reference.write_scene``) and the
   offline vocabulary as DBoW text are written, and
   ``sivo_tpu.cli.main([voc.txt, settings.yaml,
   "bayesian_segnet_basic_kitti.prototxt", OUT, DIR])`` runs once on each
   trained network, in parallel processes, with semantics on and its
   host fetches landed when they return (the card's timing regime,
   ``cli40_jax_reference.fetch_landed``; in that regime a run is
   deterministic: two runs on the seed-0 network gave the same numbers).

For each run it prints the ATE (Umeyama-aligned, over
``CameraTrajectory.txt`` against the rendered ground truth), the
keyframes, the lost frames, the mean pixel accuracy of the posterior's
classes against the renderer's class maps, the mean entropy (bits, over
all pixels of all frames), and the share of extracted keypoints whose
semantic flag is set (the static-class gate, over all frames), read
from each frame that ``build_frame`` returns. The last line is the
``REF_CNN`` dictionary, one entry per seed.

Run from the repository root (CPU; ~45 minutes on 8 cores; the CLI runs
go two at a time, a few GB each):
``JAX_PLATFORMS=cpu python tools/cnn40_jax_reference.py [WORK_DIR]``
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402

from sivo_tpu.config import SystemConfig  # noqa: E402
from sivo_tpu.io import synthetic  # noqa: E402
from sivo_tpu.place import vocabulary as voc_mod  # noqa: E402
from tools.cli40_jax_reference import (  # noqa: E402
    N_FRAMES, VOCABULARY, fetch_landed, read_trajectory, write_scene)

N_LAP = 190
SEEDS = tuple(range(8))
HOLDOUT, EVERY = 4, 8
FRAMES = ROOT / "tools" / "data" / "cnn40_training_frames.npz"
TRAIN_STEPS = 150
PROTOTXT = "bayesian_segnet_basic_kitti.prototxt"
ENV = dict(os.environ, JAX_PLATFORMS="cpu", SIVO_TRAIN_CPU="1")


def render_lap(cache: Path) -> None:
    """The lap's left frames and class maps in the training tool's cache
    format."""
    cfg = SystemConfig()
    world = synthetic.make_loop_world(cfg.camera, seed=0, outer=16.0,
                                      inner=6.0)
    gt = synthetic.square_loop_trajectory(n_frames=N_LAP, half=9.5,
                                          corner_r=3.5, jitter=0.03)
    left, cls = [], []
    for T in gt:
        img, c = synthetic._render_view(world, T, False, ss=2)
        left.append(img)
        cls.append(c)
    left, cls = np.stack(left).astype(np.uint8), np.stack(cls)
    np.savez(cache, left=left, cls=cls)
    index = np.array(sorted({*range(0, N_LAP, EVERY), HOLDOUT}))
    FRAMES.parent.mkdir(exist_ok=True)
    np.savez_compressed(FRAMES, index=index, left=left[index],
                        cls=cls[index])
    share = np.bincount(cls[HOLDOUT].ravel()).max() / cls[HOLDOUT].size
    print(f"holdout frame {HOLDOUT}: its majority class covers {share:.4f} "
          "of its pixels", flush=True)


def holdout_stats(cache: Path, model: str) -> tuple[float, float]:
    """Pixel accuracy and mean entropy (bits) of ``segment_image`` (MC =
    3, ``jax.random.key(1)``, float32, as the training tool) with the
    network in ``model`` on holdout frame 4 at full resolution."""
    from sivo_tpu.models import caffe_io, segnet

    z = np.load(cache)
    img = np.repeat(z["left"][HOLDOUT].astype(np.float32)[..., None], 3,
                    axis=-1)
    net = segnet.SegNet(variant="basic", num_classes=15)
    params = caffe_io.merge_params(
        segnet.init_params(net, jax.random.key(0), *img.shape[:2]),
        caffe_io.load_segnet_params(model, "basic"))
    classes, _, entropy = segnet.segment_image(
        net, params, img, jax.random.key(1), mc_samples=3)
    return (float(np.mean(np.asarray(classes) == z["cls"][HOLDOUT])),
            float(np.asarray(entropy).mean()))


def train_worker(cache: str, out: str, seed: int) -> None:
    """``tools/train_bench_segnet.py``'s recipe with ``seed`` in place of
    its 0; prints the tool's holdout line."""
    from sivo_tpu.models import caffe_io, segnet, train

    z = np.load(cache)
    left, cls = z["left"], z["cls"]
    sel = np.arange(0, left.shape[0], 8)
    imgs = np.repeat(left[sel, ::2, ::2].astype(np.float32)[..., None], 3,
                     axis=-1)
    labels = cls[sel, ::2, ::2].astype(np.int32)
    model = segnet.SegNet(variant="basic", num_classes=15)
    params = segnet.init_params(model, jax.random.key(seed), imgs.shape[1],
                                imgs.shape[2])
    trained = train.train_segnet(model, params, imgs, labels,
                                 steps=TRAIN_STEPS, batch=2, lr=1e-3,
                                 seed=seed, log_every=10)
    caffe_io.save_segnet_params(out, jax.tree.map(np.asarray, trained))
    img = np.repeat(left[HOLDOUT].astype(np.float32)[..., None], 3, axis=-1)
    classes, _, _ = segnet.segment_image(model, trained, img,
                                         jax.random.key(1), mc_samples=3)
    acc = float(np.mean(np.asarray(classes) == cls[HOLDOUT]))
    print(f"holdout frame 4 full-res pixel acc: {acc:.3f}", flush=True)


class Recorder:
    """Keeps each built frame's classes, entropy, semantic flags and
    extraction flags (``build_frame`` wrapped), and the ``System`` that
    shut down."""

    def __init__(self):
        from sivo_tpu.runtime import frame as frame_mod
        from sivo_tpu.runtime.system import System

        self.frame_mod, self.System = frame_mod, System
        self.frames, self.system = [], None
        self._build = frame_mod.build_frame
        self._shutdown = System.shutdown

    def __enter__(self):
        def build(*args, **kwargs):
            f = self._build(*args, **kwargs)
            self.frames.append((f.classes_raster, f.entropy_raster,
                                f.semantic, f.valid))
            return f

        def shutdown(system, *args, **kwargs):
            self.system = system
            return self._shutdown(system, *args, **kwargs)

        self.frame_mod.build_frame = build
        self.System.shutdown = shutdown
        return self

    def __exit__(self, *exc):
        self.frame_mod.build_frame = self._build
        self.System.shutdown = self._shutdown

    def posterior_stats(self, cls_maps: np.ndarray) -> dict:
        n = len(cls_maps)
        frames = [[np.asarray(x) for x in f] for f in self.frames[:n]]
        assert len(frames) == n, len(frames)
        acc = np.mean([np.mean(c == g) for (c, _, _, _), g
                       in zip(frames, cls_maps)])
        ent = np.mean([e.mean() for _, e, _, _ in frames])
        sem = sum(int(s.sum()) for _, _, s, _ in frames)
        valid = sum(int(v.sum()) for _, _, _, v in frames)
        return {"pixel_acc": float(acc), "entropy": float(ent),
                "gate_share": sem / max(valid, 1)}


def cli_worker(work: str, model: str, run_dir: str) -> None:
    """One landed run of the JAX command line on ``model``; prints its
    numbers as a JSON line."""
    from sivo_tpu import cli
    from sivo_tpu.utils import fetch

    work = Path(work)
    seq = work / "seq"
    gt = np.load(work / "gt.npy")
    cls_maps = np.load(work / "render_cache.npz")["cls"][:N_FRAMES]
    fetch.fetch_packed_async = fetch_landed
    Path(run_dir).mkdir(exist_ok=True)
    with Recorder() as rec, contextlib.chdir(run_dir):
        rc = cli.main([str(work / "voc.txt"), str(seq / "settings.yaml"),
                       PROTOTXT, model, str(seq)])
    assert rc == 0, rc
    poses = read_trajectory(Path(run_dir) / "CameraTrajectory.txt")
    counts = (Path(run_dir) / "keyframes_points.txt").read_text()
    assert len(poses) == N_FRAMES, len(poses)
    stats = {"ate": synthetic.ate_rmse(poses, gt),
             "keyframes": int(counts.split("Final number of keyframes:")
                              [1].split()[0]),
             "lost": rec.system.n_lost(),
             **rec.posterior_stats(cls_maps)}
    print(json.dumps(stats), flush=True)


def _parallel(commands: list[list[str]], at_once: int) -> list[str]:
    """Run the commands as processes, ``at_once`` at a time; their
    standard output."""
    outs = []
    for i in range(0, len(commands), at_once):
        batch = commands[i:i + at_once]
        procs = [subprocess.Popen(c, env=ENV, stdout=subprocess.PIPE,
                                  text=True) for c in batch]
        outs += [p.communicate()[0] for p in procs]
        for c, p in zip(batch, procs):
            if p.returncode:
                raise RuntimeError(f"{c} returned {p.returncode}")
    return outs


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--train"]:
        return train_worker(args[1], args[2], int(args[3]))
    if args[:1] == ["--cli"]:
        return cli_worker(*args[1:4])
    work = Path(args[0]) if args else Path(tempfile.mkdtemp(prefix="cnn40_"))
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cache = work / "render_cache.npz"
    render_lap(cache)
    np.save(work / "gt.npy", write_scene(work / "seq"))
    voc_mod.save_text(voc_mod.load_npz(str(VOCABULARY)),
                      str(work / "voc.txt"))
    print(f"lap of {N_LAP} frames, the cli40 directory and the vocabulary "
          f"written to {work} in {time.perf_counter() - t0:.0f} s",
          flush=True)

    t0 = time.perf_counter()
    models = [str(work / f"trained_seed{s}.caffemodel") for s in SEEDS]
    me = str(Path(__file__).resolve())
    tool = str(ROOT / "tools" / "train_bench_segnet.py")
    outs = _parallel([[sys.executable, tool, str(cache), models[0],
                       str(TRAIN_STEPS)]]
                     + [[sys.executable, me, "--train", str(cache), m,
                         str(s)] for s, m in zip(SEEDS[1:], models[1:])],
                     at_once=4)
    holdout = []
    for s, out in zip(SEEDS, outs):
        print(f"--- training, seed {s}\n{out}", end="", flush=True)
        holdout.append(float(re.search(r"full-res pixel acc: ([0-9.]+)",
                                       out).group(1)))
    print(f"trained {len(SEEDS)} networks in "
          f"{time.perf_counter() - t0:.0f} s: holdout accuracy {holdout}",
          flush=True)
    entropy = []
    for s, m in zip(SEEDS, models):
        acc, ent = holdout_stats(cache, m)
        entropy.append(round(ent, 4))
        print(f"seed {s} network loaded back: holdout accuracy {acc:.4f}, "
              f"mean entropy {ent:.4f} bits", flush=True)

    t0 = time.perf_counter()
    outs = _parallel([[sys.executable, me, "--cli", str(work), m,
                       str(work / f"run_seed{s}")]
                      for s, m in zip(SEEDS, models)], at_once=2)
    runs = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    for s, r in zip(SEEDS, runs):
        print(f"cnn40 JAX CLI on the seed-{s} network (CPU, fetches "
              "landed): " + ", ".join(
                  f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in r.items()), flush=True)
    print(f"{len(runs)} CLI runs in {time.perf_counter() - t0:.0f} s")
    ref = {"holdout_acc": tuple(holdout),
           "holdout_entropy": tuple(entropy)}
    for key in runs[0]:
        ref[key] = tuple(round(r[key], 4) if isinstance(r[key], float)
                         else r[key] for r in runs)
    print(f"REF_CNN = {ref}")


if __name__ == "__main__":
    main()
