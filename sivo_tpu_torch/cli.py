"""Command-line entry point (port of ``sivo_tpu/cli.py``).

Mirrors the reference binary (ref: src/sivo.cc:41-49):
    SIVO vocab settings prototxt caffemodel sequence_dir
Usage:
    python -m sivo_tpu_torch.cli VOCAB SETTINGS PROTOTXT CAFFEMODEL SEQ_DIR
        [--no-semantics] [--save-frames DIR] [--device cpu]
with '-' accepted for VOCAB (disables loop closing) and CAFFEMODEL
(seeded random network weights). The SegNet variant is "basic" when the
prototxt's name contains "basic", else "standard". The session runs on
the CUDA card unless ``--device cpu`` asks for the CPU.

Outputs match the reference: per-frame pacing to the dataset
timestamps, median/mean track-time stats at exit (sivo.cc:130-137),
CameraTrajectory.txt (System.cc:274-336) and keyframes_points.txt
(System.cc:263-271), written to the working directory. With
``--save-frames DIR``: a tracked-keypoint overlay per frame and a
top-down map render, the session then running unpipelined.

``run`` returns the return code and the finished ``System``, so a caller
in the same process can read the session; ``main`` returns the code.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from sivo_tpu_torch import config as cfg_mod
from sivo_tpu_torch.io import kitti
from sivo_tpu_torch.models import caffe_io, segnet
from sivo_tpu_torch.place import vocabulary as voc_mod
from sivo_tpu_torch.runtime import frame as frame_mod
from sivo_tpu_torch.runtime.system import System
from sivo_tpu_torch.utils.transfer import HostCopy
from sivo_tpu_torch.viz import replay

USAGE = ("usage: python -m sivo_tpu_torch.cli path_to_vocabulary "
         "path_to_settings path_to_prototxt path_to_caffemodel "
         "path_to_sequence [--no-semantics] [--save-frames DIR] "
         "[--device cpu]")


def _usage() -> tuple[int, None]:
    print(USAGE, file=sys.stderr)
    return 1, None


def run(argv: list[str] | None = None):
    """Run the command line; returns (return code, the System or None)."""
    argv = list(argv if argv is not None else sys.argv[1:])
    no_semantics = "--no-semantics" in argv
    options = {}
    for flag in ("--save-frames", "--device"):
        if flag in argv:
            j = argv.index(flag)
            if j + 1 >= len(argv):
                return _usage()
            options[flag] = argv[j + 1]
            argv = argv[:j] + argv[j + 2:]
    argv = [a for a in argv if not a.startswith("--")]
    if len(argv) < 5:
        return _usage()
    vocab_path, settings_path, prototxt, caffemodel, seq_dir = argv[:5]
    save_frames = options.get("--save-frames")
    device = (torch.device(options["--device"]) if "--device" in options
              else None)
    if device is None and not torch.cuda.is_available():
        print("error: no CUDA card is available (pass --device cpu to run "
              "on the CPU)", file=sys.stderr)
        return 1, None

    cfg = cfg_mod.load_settings(settings_path)
    variant = "basic" if "basic" in prototxt else "standard"

    params = None
    if caffemodel != "-":
        try:
            params = caffe_io.state_dict_from_caffemodel(
                caffemodel, variant, segnet.init_params(
                    seed=0, num_classes=cfg.semantic.num_classes,
                    variant=variant))
            print(f"Loaded weights from {caffemodel}")
        except ValueError as e:
            print(f"WARNING: {e}; using random initialization")

    vocabulary = None
    if vocab_path != "-":
        t0 = time.time()
        vocabulary = voc_mod.load_text(vocab_path)
        print(
            f"Vocabulary loaded: {vocabulary.n_words} words "
            f"({time.time() - t0:.1f}s)"
        )

    seq = kitti.load_sequence(seq_dir)
    print(f"Images in the sequence: {len(seq)}")

    system = System(cfg=cfg, device=device, segnet_variant=variant,
                    segnet_params=params, vocabulary=vocabulary)
    dev = system.device

    sem_override = None
    if no_semantics:
        # geometric-only mode: every pixel static and certain, and
        # SegNet is not run (use_cnn_static=False below)
        h, w = cfg.camera.height, cfg.camera.width
        sem_override = (
            torch.zeros((h, w), dtype=torch.uint8, device=dev),
            torch.ones((h, w), dtype=torch.float32, device=dev),
            torch.zeros((h, w), dtype=torch.float32, device=dev),
            False,
        )
        print("Semantics bypassed (--no-semantics): geometric VO mode")

    def read_crop(i):
        left, right = seq.read(i)
        return (
            kitti.center_crop(
                left, cfg.camera.height, cfg.camera.width
            ).astype(np.uint8),
            kitti.center_crop(
                right, cfg.camera.height, cfg.camera.width
            ).astype(np.uint8),
        )

    built = {}

    def build(i):
        if i in built or i >= len(seq):
            return
        left, right = read_crop(i)
        # the dropout masks come from the session's generator
        built[i] = frame_mod.build_frame(
            system.model, system.statics, left, right, system.generator,
            sem_override=sem_override,
            # the posterior source is fixed for the whole run: with
            # --no-semantics SegNet is not run at all
            use_cnn_static=None if sem_override is None else False,
            device=dev,
        )

    if save_frames:
        os.makedirs(save_frames, exist_ok=True)

    track_times = []
    for i in range(len(seq)):
        build(i)
        f = built.pop(i)
        t1 = time.time()
        # the next frame's frontend is enqueued between this frame's
        # dispatch and its retire (System.track_frame's pre_retire)
        system.track_frame(
            f, float(seq.timestamps[i]), pipeline=not save_frames,
            pre_retire=lambda: build(i + 1),
        )
        dt = time.time() - t1
        track_times.append(dt)
        if save_frames:
            _save_frame(system, f, read_crop(i)[0], i, save_frames)
        # pace to the dataset timestamps (ref: sivo.cc:115-123)
        if i + 1 < len(seq):
            wait = float(seq.timestamps[i + 1] - seq.timestamps[i]) - dt
            if wait > 0:
                time.sleep(min(wait, 0.5))

    system.shutdown("keyframes_points.txt")
    system.save_trajectory_kitti("CameraTrajectory.txt")
    if save_frames:
        replay.render_session(system, save_frames)
        print(f"Frame overlays + map render written to {save_frames}/")
    tt = np.sort(track_times)
    print(
        "-------\n"
        f"median tracking time: {tt[len(tt) // 2]:.4f}\n"
        f"mean tracking time: {tt.mean():.4f}"
    )
    return 0, system


def _save_frame(system, f, gray: np.ndarray, i: int, out_dir: str) -> None:
    """Frame ``i``'s overlay: its classes and keypoints, tracked ones in
    green, fetched in one host copy (ref: FrameDrawer.cc)."""
    import cv2

    h = HostCopy({
        "cls": f.classes_raster,
        "xy": f.xy,
        "valid": f.valid,
        "tracked": system.tracker.carry.pt_idx >= 0,
    }).result()
    img = replay.draw_frame(
        gray.astype(np.float32) if gray.ndim == 2 else gray.mean(-1),
        h["cls"], h["xy"], h["tracked"], h["valid"],
        status=(f"frame {i}  KFs {system.map.n_keyframes}  "
                f"state {system.state.name}"),
    )
    cv2.imwrite(os.path.join(out_dir, f"frame_{i:06d}.png"), img)


def main(argv: list[str] | None = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
