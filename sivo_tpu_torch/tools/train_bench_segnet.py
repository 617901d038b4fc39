"""Offline SegNet training for the bench scene (port of
``tools/train_bench_segnet.py``).

Trains SegNet basic (15 classes, dropout 0.5) on the bench loop world's
rendered frames and the renderer's class maps, then writes the weights
as a ``.caffemodel``, so that the command line runs on a trained
network's real MC-dropout posterior (the reference ships pre-trained
weights and only loads them, bayesian_segnet.cpp:46-66). The recipe is
the JAX tool's: every 8th frame of the 190-frame lap at half resolution
(176x512; the convolutions do not depend on the resolution), the gray
image repeated to three channels as the frontend feeds it, 150 Adam
steps of batch 2 at lr 1e-3 in float32; then the pixel accuracy and
the mean entropy on holdout frame 4 (not a multiple of 8) at full
resolution with MC = 3.
Training starts from ``segnet.init_params(seed)``: the LeCun
truncated normal of Flax's default initializer, drawn with numpy.

``train_on_frames`` trains on frames a caller has rendered; ``main``
renders the frames it needs with ``io/synthetic.py`` (the training
frames and the holdout frame, as uint8, the JAX tool's render cache's
type). Training runs on the CUDA card unless ``--device cpu`` is given.

Usage: ``python -m sivo_tpu_torch.tools.train_bench_segnet [--out PATH]
[--steps N] [--device cpu]``; the default output is
``build/sivo_tpu_torch/bench_segnet.caffemodel``.
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
from sivo_tpu_torch.models import caffe_io, segnet, train

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "sivo_tpu_torch" / "bench_segnet.caffemodel"
N_LAP, EVERY, HOLDOUT = 190, 8, 4
STEPS, BATCH, LR, MC_SAMPLES = 150, 2, 1e-3, 3
NUM_CLASSES, DROPOUT = 15, 0.5


def training_set(left: np.ndarray, cls: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Every ``EVERY``-th frame at half resolution, gray repeated to
    three channels: ((F, H/2, W/2, 3) float32, (F, H/2, W/2) int32)."""
    sel = np.arange(0, left.shape[0], EVERY)
    imgs = left[sel, ::2, ::2].astype(np.float32)
    imgs = np.repeat(imgs[..., None], 3, axis=-1)
    return imgs, cls[sel, ::2, ::2].astype(np.int32)


def train_on_frames(left: np.ndarray, cls: np.ndarray, *,
                    steps: int = STEPS, seed: int = 0, log_every: int = 0,
                    device: torch.device | str | None = None
                    ) -> tuple[segnet.SegNet, torch.Tensor]:
    """SegNet basic trained on the lap's frames ``left`` ((N, H, W)
    uint8, frame i of the lap at index i) and class maps ``cls``;
    returns the float32 model on the device and the per-step losses."""
    imgs, labels = training_set(np.asarray(left), np.asarray(cls))
    model = segnet.SegNet("basic", num_classes=NUM_CLASSES,
                          dropout_rate=DROPOUT)
    model.load_state_dict(segnet.init_params(seed=seed,
                                             num_classes=NUM_CLASSES))
    return train.train_segnet(model, imgs, labels, steps=steps,
                              batch=BATCH, lr=LR, seed=seed,
                              log_every=log_every, device=device)


def holdout(model: segnet.SegNet, left: np.ndarray, cls: np.ndarray,
            dtype: torch.dtype = torch.float32, seed: int = 1) -> dict:
    """``segment_image_with_variance`` (MC = 3) with ``model``'s weights
    run in ``dtype`` on one full-size frame (``left`` (H, W) uint8):
    the pixel accuracy against its class map ``cls``, the mean entropy
    (bits), and the range of the MC variance and whether it and its
    ``variance_image`` are finite."""
    dev = next(model.parameters()).device
    net = segnet.SegNet(model.variant, num_classes=model.num_classes,
                        dropout_rate=model.dropout_rate, dtype=dtype)
    net.load_state_dict(model.state_dict())
    net = net.to(dev)
    img = torch.from_numpy(left.astype(np.float32)).to(dev)
    img = img[:, :, None].expand(-1, -1, 3)
    gen = torch.Generator(device=dev).manual_seed(seed)
    want = torch.from_numpy(np.asarray(cls, np.uint8)).to(dev)
    with torch.no_grad():
        classes, _, entropy, var = segnet.segment_image_with_variance(
            net, img, gen, MC_SAMPLES)
        finite = torch.isfinite(var).all() & torch.isfinite(
            segnet.variance_image(var)).all()
        return {"acc": float((classes == want).float().mean()),
                "entropy": float(entropy.mean()),
                "var_min": float(var.min()), "var_max": float(var.max()),
                "var_finite": bool(finite)}


def save(model: segnet.SegNet, path: str) -> None:
    """The model's weights as a ``.caffemodel``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    caffe_io.save_segnet_params(path, segnet.flax_from_params(
        model.state_dict()))


def render_frames(indices) -> tuple[np.ndarray, np.ndarray]:
    """The bench lap's left frames (uint8) and class maps at
    ``indices``; the arrays hold frame i at index i, other rows zero."""
    cfg = SystemConfig()
    world = synthetic.make_loop_world(cfg.camera, seed=0, outer=16.0,
                                      inner=6.0)
    gt = synthetic.square_loop_trajectory(n_frames=N_LAP, half=9.5,
                                          corner_r=3.5, jitter=0.03)
    shape = (N_LAP, cfg.camera.height, cfg.camera.width)
    left, cls = np.zeros(shape, np.uint8), np.zeros(shape, np.uint8)
    for i in indices:
        img, c = synthetic._render_view(world, gt[i], False, ss=2)
        left[i], cls[i] = img.astype(np.uint8), c
    return left, cls


def main(argv: list[str] | None = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = train.resolve_device(args.device)
    t0 = time.perf_counter()
    wanted = sorted({*range(0, N_LAP, EVERY), HOLDOUT})
    left, cls = render_frames(wanted)
    print(f"rendered {len(wanted)} frames in {time.perf_counter() - t0:.0f}"
          " s", flush=True)
    imgs, labels = training_set(left, cls)
    print(f"training on {len(imgs)} frames {imgs.shape[1:]} "
          f"classes={np.unique(labels)} on {device}", flush=True)
    t0 = time.perf_counter()
    model, _ = train_on_frames(left, cls, steps=args.steps, log_every=10,
                               device=device)
    print(f"trained in {time.perf_counter() - t0:.0f} s", flush=True)
    save(model, args.out)
    print("wrote", args.out, flush=True)
    got = holdout(model, left[HOLDOUT], cls[HOLDOUT])
    print(f"holdout frame {HOLDOUT} full-res pixel acc: {got['acc']:.3f}, "
          f"mean entropy {got['entropy']:.4f} bits", flush=True)
    return got["acc"]


if __name__ == "__main__":
    main()
