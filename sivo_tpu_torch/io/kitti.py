"""KITTI odometry sequence loading.

Mirrors the reference CLI's loader (ref: src/sivo.cc:145-177
``loadImages``): reads ``times.txt`` and builds the ``image_2/`` (left
color) and ``image_3/`` (right color) filename lists with 6-digit
zero-padded stems.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class KittiSequence:
    left_paths: list[str]
    right_paths: list[str]
    timestamps: np.ndarray  # (F,) seconds

    def __len__(self) -> int:
        return len(self.left_paths)

    def read(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (left BGR (H, W, 3) float32, right gray (H, W)
        float32), center-cropped is the caller's job (System.cc:154-170
        resizeImages). Decodes via OpenCV when available (reference
        parity: cv::imread, sivo.cc:86-88), else Pillow — converted to
        the same BGR channel order and ITU-R gray the reference sees."""
        try:
            import cv2

            left = cv2.imread(self.left_paths[i], cv2.IMREAD_COLOR)
            right = cv2.imread(self.right_paths[i], cv2.IMREAD_GRAYSCALE)
            if left is None or right is None:
                raise FileNotFoundError(
                    f"frame {i}: {self.left_paths[i]} / "
                    f"{self.right_paths[i]}"
                )
            return left.astype(np.float32), right.astype(np.float32)
        except ImportError:
            from PIL import Image

            left_rgb = np.asarray(
                Image.open(self.left_paths[i]).convert("RGB"),
                np.float32,
            )
            right = np.asarray(
                Image.open(self.right_paths[i]).convert("L"), np.float32
            )
            return left_rgb[:, :, ::-1].copy(), right


def load_sequence(seq_dir: str) -> KittiSequence:
    """ref: src/sivo.cc:145-177."""
    times_path = os.path.join(seq_dir, "times.txt")
    with open(times_path) as f:
        ts = np.array([float(x) for x in f.read().split()], np.float64)
    left_dir = os.path.join(seq_dir, "image_2")
    right_dir = os.path.join(seq_dir, "image_3")
    lefts = [
        os.path.join(left_dir, f"{i:06d}.png") for i in range(len(ts))
    ]
    rights = [
        os.path.join(right_dir, f"{i:06d}.png") for i in range(len(ts))
    ]
    return KittiSequence(
        left_paths=lefts, right_paths=rights, timestamps=ts
    )


def center_crop(
    img: np.ndarray, height: int, width: int
) -> np.ndarray:
    """Center crop to the network geometry (ref: System.cc:154-170 /
    bayesian_segnet.cpp:142-162 resizeImage)."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    if h < height or w < width:
        raise ValueError(
            f"image {h}x{w} smaller than target {height}x{width}"
        )
    y0 = h // 2 - height // 2
    x0 = w // 2 - width // 2
    return img[y0 : y0 + height, x0 : x0 + width]
