"""Train an offline ORB vocabulary on imagery disjoint from the bench
(port of ``tools/train_offline_vocab.py``).

The JAX tool's recipe, unchanged: six synthetic worlds whose texture
seeds and geometry differ from the bench world's (three loop worlds and
three corridors, with their trajectories), ORB descriptors extracted
through the frontend (``runtime.frame.build_frame_nosegnet``, with the
renderer's classes and constant confidence 0.9 and entropy 0.5; kernel
K1 runs twice per rendered frame, once per image), the descriptors of
the keypoints whose semantic flag is set kept, and a k=10 / depth=5
hierarchical k-medians tree trained on them (``place.vocabulary.train``,
up to 10^5 words), the DBoW2 recipe at reduced scale.

Extraction runs on the CUDA card unless ``--device cpu`` is given; the
k-medians training is host numpy. No descriptor cache is kept. The
default output is ``build/sivo_tpu_torch/orbvoc_synth.npz``; the
repository's vocabulary, ``sivo_tpu/place/data/orbvoc_synth.npz``, is
the JAX package's and is never written here.

Usage: ``python -m sivo_tpu_torch.tools.train_offline_vocab
[--frames-per-world N] [--k K] [--depth D] [--out PATH] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.io import synthetic
from sivo_tpu_torch.models import train
from sivo_tpu_torch.place import vocabulary as voc_mod
from sivo_tpu_torch.runtime import frame as frame_mod

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "sivo_tpu_torch" / "orbvoc_synth.npz"


def world_specs(cam, frames_per_world: int) -> list:
    """The six (world, trajectory) pairs of the JAX tool."""
    # Worlds deliberately distinct from the bench fixture (seed=0,
    # outer=16/inner=6, half=9.5/corner_r=3.5): different texture
    # seeds, ring geometry, and plain corridors.
    specs = [
        (
            synthetic.make_loop_world(cam, seed=11, outer=14.0, inner=5.0),
            synthetic.square_loop_trajectory(
                frames_per_world, half=8.0, corner_r=3.0, seed=2
            ),
        ),
        (
            synthetic.make_loop_world(cam, seed=23, outer=19.0, inner=9.0),
            synthetic.square_loop_trajectory(
                frames_per_world, half=12.0, corner_r=4.0, seed=3
            ),
        ),
        (
            synthetic.make_loop_world(cam, seed=31, outer=16.5, inner=7.5),
            synthetic.square_loop_trajectory(
                frames_per_world, half=10.5, corner_r=2.5, seed=4
            ),
        ),
        (
            synthetic.make_world(cam, seed=37, length=200.0, half_width=8.0),
            synthetic.forward_trajectory(
                frames_per_world, speed=0.8, yaw_rate=0.004, seed=5
            ),
        ),
        (
            synthetic.make_world(cam, seed=53, length=160.0, half_width=11.0),
            synthetic.forward_trajectory(
                frames_per_world, speed=0.7, yaw_rate=-0.003, seed=6
            ),
        ),
        (
            synthetic.make_world(cam, seed=71, length=180.0, half_width=6.5),
            synthetic.forward_trajectory(
                frames_per_world, speed=0.9, yaw_rate=0.002, seed=7
            ),
        ),
    ]
    return specs


def collect_descriptors(frames_per_world: int,
                        device: torch.device) -> np.ndarray:
    """The semantic keypoints' packed descriptors (M, 32) uint8 over
    every frame of ``world_specs``, each frame rendered on the host and
    extracted on ``device``."""
    cfg = SystemConfig()
    cam = cfg.camera
    statics = frame_mod.make_statics(cfg)
    specs = world_specs(cam, frames_per_world)
    conf = torch.full((cam.height, cam.width), 0.9, device=device)
    ent = torch.full((cam.height, cam.width), 0.5, device=device)
    descs, flags = [], []
    for wi, (world, traj) in enumerate(specs):
        t0 = time.time()
        for fi, T in enumerate(traj):
            left, cls = synthetic._render_view(world, T, False, ss=2)
            right, _ = synthetic._render_view(world, T, True, ss=2)
            f = frame_mod.build_frame_nosegnet(
                statics, left.astype(np.float32), right.astype(np.float32),
                cls.astype(np.uint8), conf, ent, device=device)
            # selected at the end: one fetch, not one a frame
            descs.append(f.desc_u8)
            flags.append(f.semantic)
            if fi % 16 == 0:
                print(f"# world {wi}: frame {fi}/{len(traj)} "
                      f"({time.time() - t0:.0f}s)", flush=True)
    return torch.cat(descs)[torch.cat(flags)].cpu().numpy()


def main(argv: list[str] | None = None) -> voc_mod.Vocabulary:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames-per-world", type=int, default=56)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="'cpu' to extract on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = train.resolve_device(args.device)
    t0 = time.time()
    desc = collect_descriptors(args.frames_per_world, device)
    print(f"# collected {len(desc)} descriptors in {time.time() - t0:.0f}s",
          flush=True)
    t0 = time.time()
    voc = voc_mod.train(desc, k=args.k, depth=args.depth, seed=0)
    print(f"# trained k={args.k} depth={args.depth}: {voc.n_words} words "
          f"in {time.time() - t0:.0f}s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    voc_mod.save_npz(args.out, voc)
    print(f"# wrote {os.path.abspath(args.out)}", flush=True)
    return voc


if __name__ == "__main__":
    main()
