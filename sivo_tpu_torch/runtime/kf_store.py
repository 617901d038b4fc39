"""Device-resident keyframe store (port of ``sivo_tpu/runtime/kf_store.py``).

Keeps each keyframe's keypoint arrays on the device, written once at
insertion, for the keyframe-rate consumers (the local mapper's
triangulation and fusion gather their neighbours' arrays by slot).
Updated in place: a slot write touches only that slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DeviceKFStore(NamedTuple):
    xy: torch.Tensor  # (K, N, 2) f32
    level: torch.Tensor  # (K, N) int32
    angle: torch.Tensor  # (K, N) f32
    desc_u8: torch.Tensor  # (K, N, 32) uint8
    u_right: torch.Tensor  # (K, N) f32
    semantic: torch.Tensor  # (K, N) bool
    sem_class: torch.Tensor  # (K, N) uint8
    sem_confidence: torch.Tensor  # (K, N) f32
    sem_entropy: torch.Tensor  # (K, N) f32

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def make_kf_store(max_keyframes: int, kp_capacity: int,
                  device: torch.device) -> DeviceKFStore:
    K, N = max_keyframes, kp_capacity

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return DeviceKFStore(
        xy=full((K, N, 2), 0, torch.float32),
        level=full((K, N), 0, torch.int32),
        angle=full((K, N), 0, torch.float32),
        desc_u8=full((K, N, 32), 0, torch.uint8),
        u_right=full((K, N), -1.0, torch.float32),
        semantic=full((K, N), False, torch.bool),
        sem_class=full((K, N), 255, torch.uint8),
        sem_confidence=full((K, N), 0, torch.float32),
        sem_entropy=full((K, N), 0, torch.float32),
    )


def insert(store: DeviceKFStore, slot: int, **fields: torch.Tensor
           ) -> DeviceKFStore:
    """Write one keyframe's arrays (keyword per field) into ``slot``, in
    place."""
    for name, value in fields.items():
        getattr(store, name)[slot] = value
    return store


def gather(store: DeviceKFStore, idx: torch.Tensor) -> DeviceKFStore:
    """(B,) keyframe slots -> per-field (B, N, ...) copies."""
    idx = idx.long()
    return DeviceKFStore(*(f[idx] for f in store))
