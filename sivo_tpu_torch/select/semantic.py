"""Semantic class gating (port of ``sivo_tpu/select/semantic.py``)."""

from __future__ import annotations

import enum

import numpy as np
import torch


class Classes(enum.IntEnum):
    """ref: include/bayesian_segnet/bayesian_segnet.hpp:67-83."""

    ROAD = 0
    SIDEWALK = 1
    BUILDING = 2
    WALL = 3
    POLE = 4
    TRAFFIC_LIGHT = 5
    TRAFFIC_SIGN = 6
    VEGETATION = 7
    TERRAIN = 8
    SKY = 9
    PERSON = 10
    CAR = 11
    COMMERCIAL_VEHICLE = 12
    BIKE = 13
    VOID = 255


NUM_CLASSES = 15
STATIC_CLASS_MAX = int(Classes.TERRAIN)  # ref: Frame.cc:190

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


def selection_gate(
    classes: torch.Tensor,
    confidence: torch.Tensor,
    depth: torch.Tensor,
    th_confidence: float,
) -> torch.Tensor:
    """The depth/class/confidence pre-gate of CheckSemantics
    (ref: LocalMapping.cc:497-507): depth > 0, static class,
    confidence >= threshold."""
    return (
        (depth > 0.0)
        & static_class_mask(classes)
        & (confidence >= th_confidence)
    )
