"""How the card's host renders the bench worlds: what OpenCV's thread
count does to a frame's pixels and time, what a pool of render
processes gains, and how much rendering beside a session slows its host
thread. The facts behind ``chip_smoke.PooledRender`` and the order of
its phases.

On the GPU machine, from the repository root (~7 minutes):
``python3 tools/render_pool_study.py``. Prints, for the dumbbell world:
the serial seconds per frame under 1, 2, 4 and the default OpenCV
threads and the share of pixels that differ from the default's; a
pool's seconds per frame at 8 x 1, 4 x 2 and 8 x 2 (processes x
threads); then the tracker slice's ms per frame on 16 loop-world frames
alone, beside 6 x 1, 6 x 2, 4 x 1 and 2 x 2 render workers, and alone
again.
"""

import multiprocessing
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from sivo_tpu_torch.config import SystemConfig  # noqa: E402
from sivo_tpu_torch.io import synthetic  # noqa: E402
from sivo_tpu_torch.runtime import frame as frame_mod  # noqa: E402

_WORLD = None


def _init(threads):
    global _WORLD
    cv2.setNumThreads(threads)
    _WORLD = cs.bench_world("dumbbell", SystemConfig().camera)


def _one(pose):
    return synthetic.render_sequence(_WORLD, pose[None], ss=2)


def _pool(workers, threads, poses):
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_init, initargs=(threads,))
    return pool, [pool.submit(_one, p) for p in poses], time.perf_counter()


def main():
    dev = torch.device("cuda", 0)
    cs.phase_card()
    cs.phase_build()
    cfg = SystemConfig()
    world = cs.bench_world("dumbbell", cfg.camera)
    poses = synthetic.figure8_trajectory(404)
    default = cv2.getNumThreads()
    print(f"[render] OpenCV {cv2.__version__}, default threads {default}, "
          f"{multiprocessing.cpu_count()} cores")
    ref = synthetic.render_sequence(world, poses[[0, 200]], ss=2)
    for threads in (1, 2, 4, default):
        cv2.setNumThreads(threads)
        t0 = time.perf_counter()
        got = synthetic.render_sequence(world, poses[[0, 200]], ss=2)
        dt = (time.perf_counter() - t0) / 2
        differ = [float(np.mean(a != b)) for a, b in zip(got, ref)]
        print(f"[render] serial, {threads} threads: {dt:.3f} s per frame; "
              f"pixels differing from the default's (left, right, "
              f"classes) {differ}", flush=True)
    cv2.setNumThreads(default)
    for workers, threads in ((8, 1), (4, 2), (8, 2)):
        pool, futures, t0 = _pool(workers, threads, poses[:48])
        [f.result() for f in futures]
        dt = time.perf_counter() - t0
        pool.shutdown()
        print(f"[render] pool {workers} x {threads} threads: "
              f"{dt / 48:.3f} s per frame", flush=True)
    gt, left, right, sems, _ = cs.make_scene(cfg, 16)
    statics = frame_mod.make_statics(cfg)
    model = cs.phase_segnet(cfg, left[0], dev)
    cs.run_slice(cfg, statics, model, left[:4], right[:4], sems[:4], dev)

    def slice_ms():
        _, _, front, track, _ = cs.run_slice(cfg, statics, model, left,
                                             right, sems, dev)
        return statistics.median([a + b for a, b in zip(front, track)])

    print(f"[slice] alone: {slice_ms():.1f} ms per frame", flush=True)
    for workers, threads in ((6, 1), (6, 2), (4, 1), (2, 2)):
        pool, futures, t0 = _pool(workers, threads, poses[:200])
        time.sleep(8)  # the workers have started
        ms = slice_ms()
        done = sum(f.done() for f in futures)
        pool.shutdown(cancel_futures=True)
        print(f"[slice] beside {workers} x {threads} render workers: "
              f"{ms:.1f} ms per frame; {done} frames rendered in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[slice] alone again: {slice_ms():.1f} ms per frame")


if __name__ == "__main__":
    main()
