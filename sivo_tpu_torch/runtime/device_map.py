"""Device-resident map mirror (port of ``sivo_tpu/runtime/device_map.py``).

The map's hot data lives on the device as fixed-capacity tensors; the
host MapState keeps the bookkeeping. The JAX scatters use
``mode="drop"``: an id equal to the capacity is silently skipped. Here
every scatter goes into a copy with one extra trailing row that takes
the dropped writes and is then cut off, so no id is ever out of range
and no host sync is needed to filter them. Accumulating scatters use
``index_put_(..., accumulate=True)``, which adds duplicates like
``.at[].add``. The updates are functional (a new DeviceMap), as in JAX;
they run at keyframe rate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sivo_tpu_torch.ops.orb import unpack_bits

DESC_RING = 4  # recent keyframe observations kept per point


class DeviceMap(NamedTuple):
    pt_pos: torch.Tensor  # (P, 3) f32 world positions
    pt_normal: torch.Tensor  # (P, 3) f32 mean viewing direction
    pt_min_dist: torch.Tensor  # (P,) f32
    pt_max_dist: torch.Tensor  # (P,) f32
    pt_desc_u8: torch.Tensor  # (P, 32) uint8 distinctive descriptor
    pt_desc_ring: torch.Tensor  # (P, DESC_RING, 32) recent observations
    pt_class: torch.Tensor  # (P,) uint8 semantic class (255 = unset)
    pt_valid: torch.Tensor  # (P,) bool
    pt_obs_count: torch.Tensor  # (P,) int32
    pt_visible: torch.Tensor  # (P,) int32 found/visible counters
    pt_found: torch.Tensor  # (P,) int32
    n_points: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.pt_pos.shape[0]


def make_device_map(capacity: int, device: torch.device) -> DeviceMap:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DeviceMap(
        pt_pos=z(capacity, 3),
        pt_normal=z(capacity, 3),
        pt_min_dist=z(capacity),
        pt_max_dist=z(capacity),
        pt_desc_u8=z(capacity, 32, dtype=torch.uint8),
        pt_desc_ring=z(capacity, DESC_RING, 32, dtype=torch.uint8),
        pt_class=torch.full((capacity,), 255, dtype=torch.uint8,
                            device=device),
        pt_valid=z(capacity, dtype=torch.bool),
        pt_obs_count=z(capacity, dtype=torch.int32),
        pt_visible=z(capacity, dtype=torch.int32),
        pt_found=z(capacity, dtype=torch.int32),
        n_points=z(dtype=torch.int32),
    )


def scatter(dst: torch.Tensor, idx, values, accumulate: bool = False
            ) -> torch.Tensor:
    """``dst.at[idx].set(values, mode="drop")`` (or ``.add`` with
    ``accumulate``) for ids in [0, capacity]: id == capacity is dropped.
    ``idx`` is one index tensor or a tuple of them (first dim indexed by
    the first)."""
    ext = torch.cat([dst, dst[:1]])  # trailing row takes the dropped ids
    if not isinstance(idx, tuple):
        idx = (idx,)
    ext.index_put_(tuple(i.long() for i in idx), values.to(dst.dtype),
                   accumulate=accumulate)
    return ext[:-1]


def add_points(
    dmap: DeviceMap,
    sel_mask: torch.Tensor,  # (N,) create a point for these keypoints
    xw: torch.Tensor,  # (N, 3) world positions
    desc_u8: torch.Tensor,  # (N, 32)
    classes: torch.Tensor,  # (N,) uint8
    levels: torch.Tensor,  # (N,) int32
    cam_center: torch.Tensor,  # (3,)
    scale_factor: float = 1.2,
    n_levels: int = 8,
) -> tuple[DeviceMap, torch.Tensor]:
    """Create map points for the selected keypoints. Returns (updated
    map, (N,) int32 assigned point ids or -1). Normal / scale-bound init
    follows MapPoint ctor + UpdateNormalAndDepth (ref: MapPoint.cc:32-59,
    368-421)."""
    cap = dmap.capacity
    n = sel_mask.shape[0]
    rank = torch.cumsum(sel_mask.to(torch.int32), 0) - 1
    ids = torch.where(sel_mask, dmap.n_points + rank,
                      torch.full_like(rank, cap))
    ids = torch.clamp(ids, max=cap)
    d = xw - cam_center
    dist = torch.linalg.vector_norm(d, dim=-1) + 1e-9
    level_sf = scale_factor ** levels.float()
    max_dist = dist * level_sf
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    ones = torch.ones(n, dtype=torch.int32, device=xw.device)
    new = dmap._replace(
        pt_pos=scatter(dmap.pt_pos, ids, xw),
        pt_normal=scatter(dmap.pt_normal, ids, d / dist[:, None]),
        pt_min_dist=scatter(dmap.pt_min_dist, ids, 0.8 * min_dist),
        pt_max_dist=scatter(dmap.pt_max_dist, ids, 1.2 * max_dist),
        pt_desc_u8=scatter(dmap.pt_desc_u8, ids, desc_u8),
        pt_desc_ring=scatter(dmap.pt_desc_ring, ids,
                             desc_u8[:, None, :].expand(n, DESC_RING, 32)),
        pt_class=scatter(dmap.pt_class, ids, classes),
        pt_valid=scatter(dmap.pt_valid, ids, torch.ones_like(sel_mask)),
        pt_obs_count=scatter(dmap.pt_obs_count, ids, ones),
        pt_visible=scatter(dmap.pt_visible, ids, ones),
        pt_found=scatter(dmap.pt_found, ids, ones),
        n_points=torch.clamp(dmap.n_points + torch.sum(sel_mask),
                             max=cap).to(torch.int32),
    )
    out_ids = torch.where(sel_mask & (ids < cap), ids,
                          torch.full_like(ids, -1)).to(torch.int32)
    return new, out_ids


def observe_points(
    dmap: DeviceMap,
    pt_idx: torch.Tensor,  # (N,) int32 per-keypoint point id, -1 none
    classes: torch.Tensor,  # (N,) uint8 current detection
    desc_u8: torch.Tensor,  # (N, 32) observing keyframe's descriptors
) -> DeviceMap:
    """Keyframe observation bookkeeping: bump obs counts, set the class
    of fresh points (first observation only), insert the observation in
    the point's descriptor ring and re-pick its distinctive descriptor
    (the ring member with the smallest median Hamming distance to the
    others, ref: MapPoint.cc:284-347)."""
    cap = dmap.capacity
    has = pt_idx >= 0
    idx = torch.where(has, pt_idx, torch.full_like(pt_idx, cap)).long()
    touched = torch.clamp(pt_idx, 0, cap - 1).long()
    obs_before = dmap.pt_obs_count[touched]
    n = pt_idx.shape[0]
    ones = torch.ones(n, dtype=torch.int32, device=pt_idx.device)
    obs = scatter(dmap.pt_obs_count, idx, ones, accumulate=True)
    fresh = has & (dmap.pt_class[touched] == 255)
    cls = scatter(dmap.pt_class,
                  torch.where(fresh, idx, torch.full_like(idx, cap)), classes)
    slot = torch.where(has, obs_before % DESC_RING,
                       torch.zeros_like(obs_before))
    ring = scatter(dmap.pt_desc_ring, (idx, slot), desc_u8)
    r = ring[touched]  # (N, R, 32)
    bits = unpack_bits(r)  # (N, R, 256)
    dist = torch.sum((bits[:, :, None, :] - bits[:, None, :, :]).abs(), -1)
    # jnp.median averages the two middle values of an even count
    srt = torch.sort(dist, dim=-1).values
    mid = DESC_RING // 2
    med = 0.5 * (srt[..., mid - 1] + srt[..., mid])
    best = torch.argmin(med, dim=-1)
    distinctive = r[torch.arange(n, device=r.device), best]
    return dmap._replace(
        pt_obs_count=obs,
        pt_class=cls,
        pt_desc_u8=scatter(dmap.pt_desc_u8, idx, distinctive),
        pt_desc_ring=ring,
    )


def _ids_or_drop(pt_ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Point ids with every -1 entry sent to the dropped row."""
    return torch.where(pt_ids >= 0, pt_ids,
                       torch.full_like(pt_ids, capacity)).long()


def add_obs_counts(dmap: DeviceMap, pt_ids: torch.Tensor) -> DeviceMap:
    """Bump observation counts for cross-observations created by
    triangulation and fusion, so the keyframe policy's
    TrackedMapPoints(minObs) counter (ref: Tracking.cc:845-851) sees
    them; -1 entries ignored, repeated ids counted each time."""
    idx = _ids_or_drop(pt_ids, dmap.capacity)
    ones = torch.ones_like(idx, dtype=torch.int32)
    return dmap._replace(
        pt_obs_count=scatter(dmap.pt_obs_count, idx, ones, accumulate=True))


def invalidate_points(dmap: DeviceMap, pt_ids: torch.Tensor) -> DeviceMap:
    """Kill points by id (culling, fusion); -1 entries ignored."""
    idx = _ids_or_drop(pt_ids, dmap.capacity)
    return dmap._replace(pt_valid=scatter(
        dmap.pt_valid, idx, torch.zeros_like(idx, dtype=torch.bool)))


def set_positions(dmap: DeviceMap, pt_ids: torch.Tensor,
                  positions: torch.Tensor) -> DeviceMap:
    """Write point positions (BA write-back); -1 entries ignored."""
    idx = _ids_or_drop(pt_ids, dmap.capacity)
    return dmap._replace(pt_pos=scatter(dmap.pt_pos, idx, positions))
