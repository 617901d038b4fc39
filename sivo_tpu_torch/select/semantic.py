"""Semantic class gating (port of ``sivo_tpu/select/semantic.py``)."""

from __future__ import annotations

import numpy as np
import torch

NUM_CLASSES = 15
STATIC_CLASS_MAX = 8  # Classes.TERRAIN (ref: Frame.cc:190)

# BGR palette for overlay rendering (ref: bayesian_segnet.cpp:91-117).
CLASS_COLOURS_BGR = np.array(
    [
        [128, 64, 128],  # ROAD
        [232, 35, 244],  # SIDEWALK
        [69, 69, 69],  # BUILDING
        [156, 102, 102],  # WALL
        [153, 153, 153],  # POLE
        [30, 170, 250],  # TRAFFIC_LIGHT
        [0, 220, 220],  # TRAFFIC_SIGN
        [35, 142, 107],  # VEGETATION
        [152, 251, 152],  # TERRAIN
        [180, 130, 70],  # SKY
        [60, 20, 220],  # PERSON
        [142, 0, 0],  # CAR
        [70, 0, 0],  # COMMERCIAL_VEHICLE
        [32, 11, 119],  # BIKE
    ],
    dtype=np.uint8,
)


def static_class_mask(classes: torch.Tensor) -> torch.Tensor:
    """True where the detected class is static (``<= TERRAIN``)."""
    return classes <= STATIC_CLASS_MAX


def sample_rasters(
    classes: torch.Tensor,
    confidence: torch.Tensor,
    entropy: torch.Tensor,
    uv: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Semantics at the integer-truncated keypoint positions
    (ref: Tracking.cc:937-939). uv: (N, 2) (x=col, y=row)."""
    h, w = classes.shape
    col = torch.clamp(uv[..., 0].to(torch.int32), 0, w - 1).long()
    row = torch.clamp(uv[..., 1].to(torch.int32), 0, h - 1).long()
    return classes[row, col], confidence[row, col], entropy[row, col]
