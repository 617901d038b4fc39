"""Map compaction: bounded-lifetime capacity for points and keyframes
(port of ``sivo_tpu/runtime/compact.py``).

The reference frees culled map points and keyframes outright
(ref: MapPoint.cc:201-223, KeyFrame.cc:459-573, Map.cc:103-121). Here
slot ids are assigned in creation order (the host/device id lockstep),
so culled slots would leak until the fixed capacities run out. When
occupancy crosses a threshold, live entries slide down to contiguous
slots in their original order and every id-bearing structure
(observation table, spanning tree, point reference keyframes, device
mirrors, tracker carry, trajectory records) is remapped in one pass.
Slot order stays time order, so every "slot index as clock" comparison
(cull age, spanning-tree predecessors, recent-point cull windows)
survives.

Called at a drained-pipeline point (no frame in flight, mapper idle,
no global BA in flight); the loop closer's database, consistency groups,
loop edges and last loop keyframe are remapped too.
"""

from __future__ import annotations

import numpy as np
import torch

from sivo_tpu_torch.runtime.device_map import DeviceMap
from sivo_tpu_torch.runtime.kf_store import DeviceKFStore
from sivo_tpu_torch.utils.transfer import to_device


def compact_device_map(dmap: DeviceMap, perm: torch.Tensor) -> DeviceMap:
    """New slot i takes old slot perm[i] (perm == -1: dead slot)."""
    idx = torch.clamp(perm, 0, dmap.capacity - 1).long()
    live = perm >= 0
    moved = DeviceMap(*(f[idx] if f.dim() else f for f in dmap))
    return moved._replace(pt_valid=moved.pt_valid & live,
                          n_points=torch.sum(live).to(torch.int32))


def compact_kf_store(store: DeviceKFStore, perm: torch.Tensor
                     ) -> DeviceKFStore:
    idx = torch.clamp(perm, 0, store.capacity - 1).long()
    return DeviceKFStore(*(f[idx] for f in store))


def remap_ids(ids: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Map old point ids through the old->new lut; dead or out-of-range
    ids become -1."""
    cap = lut.shape[0]
    ok = (ids >= 0) & (ids < cap)
    new = lut[torch.clamp(ids, 0, cap - 1).long()]
    return torch.where(ok, new, torch.full_like(new, -1)).to(torch.int32)


def _nearest_live_ancestor(m) -> np.ndarray:
    """anc[k] = k if live, else the nearest live ancestor through the
    spanning tree (falling back to k-1 chains), 0 at worst (the
    reference's bad-KF parent walk, System.cc:303-311)."""
    K = m.n_keyframes
    anc = np.arange(K)
    for k in range(K):
        a = k
        hops = 0
        while a > 0 and not m.kf_valid[a] and hops <= K:
            p = int(m.kf_parent[a])
            a = p if 0 <= p < a else a - 1
            hops += 1
        anc[k] = a if m.kf_valid[a] or a == 0 else 0
    return anc


def should_compact(system) -> bool:
    """Trigger when either store is nearly full AND enough is dead to
    make the move worthwhile (0.95 and 1% dead is critical: the
    pipeline keeps minting between the trigger and the drained point)."""
    m = system.map
    pt_occ = m.n_points / max(m.max_points, 1)
    kf_occ = m.n_keyframes / max(m.max_keyframes, 1)
    pt_dead = 1.0 - m.pt_valid[: m.n_points].mean() if m.n_points else 0.0
    kf_dead = (1.0 - m.kf_valid[: m.n_keyframes].mean()
               if m.n_keyframes else 0.0)
    critical = ((pt_occ > 0.95 and pt_dead > 0.01)
                or (kf_occ > 0.95 and kf_dead > 0.01))
    lc = getattr(system, "loop_closer", None)
    if lc is not None and lc._gba is not None and not critical:
        # compaction would have to finish the asynchronous post-loop GBA
        # first; wait for it unless a store is critically full
        return False
    return critical or ((pt_occ > 0.85 and pt_dead > 0.10)
                        or (kf_occ > 0.85 and kf_dead > 0.10))


def compact_map(system) -> dict:
    """Compact points and keyframes. The caller must have drained the
    pipelines (no frame in flight, mapper idle). Returns
    {"points_freed", "keyframes_freed"}."""
    m = system.map
    tr = system.tracker
    n_pt, n_kf = m.n_points, m.n_keyframes

    # ---- permutations (creation order preserved) -----------------------
    anc = _nearest_live_ancestor(m)
    perm_kf = np.where(m.kf_valid[:n_kf])[0]
    lut_kf = np.full(max(n_kf, 1), -1, np.int64)
    lut_kf[perm_kf] = np.arange(len(perm_kf))
    perm_pt = np.where(m.pt_valid[:n_pt])[0]
    lut_pt = np.full(max(n_pt, 1), -1, np.int64)
    lut_pt[perm_pt] = np.arange(len(perm_pt))

    # ---- trajectory records (before the keyframe arrays move) ----------
    # records referencing a culled keyframe re-express their relative
    # pose through its nearest live ancestor (ref: System.cc:303-311)
    for r in tr.trajectory:
        k = r.ref_kf
        if 0 <= k < n_kf and not m.kf_valid[k]:
            a = int(anc[k])
            r.rel_pose = (r.rel_pose.astype(np.float64)
                          @ m.kf_pose[k].astype(np.float64)
                          @ np.linalg.inv(m.kf_pose[a].astype(np.float64))
                          ).astype(np.float32)
            r.ref_kf = a
        if 0 <= r.ref_kf < n_kf:
            r.ref_kf = int(lut_kf[r.ref_kf])

    # ---- observation table ---------------------------------------------
    n = m._obs_n
    obs = m._obs[:n]
    alive = m._obs_alive[:n].copy()
    alive &= m.kf_valid[np.clip(obs[:, 0], 0, m.max_keyframes - 1)]
    alive &= m.pt_valid[np.clip(obs[:, 1], 0, m.max_points - 1)]
    rows = obs[alive].copy()
    rows[:, 0] = lut_kf[rows[:, 0]]
    rows[:, 1] = lut_pt[rows[:, 1]]
    rows = rows[(rows[:, 0] >= 0) & (rows[:, 1] >= 0)]
    m._obs[: len(rows)] = rows
    m._obs_alive[: len(rows)] = True
    m._obs_alive[len(rows):] = False
    m._obs_n = len(rows)
    m._obs_dirty = True

    # ---- point arrays ---------------------------------------------------
    # reference keyframes first (they are keyframe ids): dead refs chain
    # to the nearest live ancestor
    ref = m.pt_ref_kf[:n_pt].copy()
    first = m.pt_first_kf[:n_pt].copy()
    for arr in (ref, first):
        ok = (arr >= 0) & (arr < n_kf)
        arr[ok] = lut_kf[anc[arr[ok]]]
    m.pt_ref_kf[:n_pt] = ref
    m.pt_first_kf[:n_pt] = first
    n_live_pt = len(perm_pt)
    for name in ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist",
                 "pt_desc_u8", "pt_class", "pt_ref_kf", "pt_first_kf",
                 "pt_visible", "pt_found"):
        a = getattr(m, name)
        a[:n_live_pt] = a[perm_pt]
    m.pt_valid[:n_live_pt] = True
    m.pt_valid[n_live_pt:] = False
    m.n_points = n_live_pt

    # ---- keyframe arrays -------------------------------------------------
    n_live_kf = len(perm_kf)
    parent = m.kf_parent[:n_kf].copy()
    new_parent = np.full(m.max_keyframes, -1, np.int32)
    for i, old in enumerate(perm_kf):
        p = int(parent[old])
        if 0 <= p < n_kf:
            new_parent[i] = lut_kf[anc[p]]
    m.kf_pose[:n_live_kf] = m.kf_pose[perm_kf]
    m.kf_cov[:n_live_kf] = m.kf_cov[perm_kf]
    m.kf_data = ([m.kf_data[old] for old in perm_kf]
                 + [None] * (m.max_keyframes - n_live_kf))
    m.kf_parent[:] = new_parent
    m.kf_valid[:n_live_kf] = True
    m.kf_valid[n_live_kf:] = False
    m.n_keyframes = n_live_kf

    # ---- device mirrors --------------------------------------------------
    dev = tr.device
    cap = tr.dmap.capacity
    perm_pad = np.full(cap, -1, np.int32)
    perm_pad[:n_live_pt] = perm_pt
    tr.dmap = compact_device_map(tr.dmap, to_device(perm_pad, dev))
    kperm_pad = np.zeros(tr.kf_store.capacity, np.int32)
    kperm_pad[:n_live_kf] = perm_kf
    tr.kf_store = compact_kf_store(tr.kf_store, to_device(kperm_pad, dev))

    # tracker device id arrays + carry
    lut_pad = np.full(cap, -1, np.int32)
    lut_pad[:n_pt] = lut_pt[:n_pt]
    lut_dev = to_device(lut_pad, dev)
    tr._ref_pt_idx = remap_ids(tr._ref_pt_idx, lut_dev)
    tr._local_ids_dev = remap_ids(tr._local_ids_dev, lut_dev)
    tr.carry = tr.carry._replace(pt_idx=remap_ids(tr.carry.pt_idx, lut_dev))
    if 0 <= tr.last_kf_id < n_kf:
        tr.last_kf_id = int(lut_kf[anc[tr.last_kf_id]])
    else:
        tr.last_kf_id = -1

    lc = getattr(system, "loop_closer", None)
    if lc is not None:
        _remap_loop_closer(lc, lut_kf, anc, n_kf)
    return {"points_freed": int(n_pt - n_live_pt),
            "keyframes_freed": int(n_kf - n_live_kf)}


def _remap_loop_closer(lc, lut_kf: np.ndarray, anc: np.ndarray,
                       n_kf: int) -> None:
    """The loop closer's keyframe ids through the compaction: the
    database (dead keyframes leave it), the consistency groups, the loop
    edges (ends chain to their nearest live ancestor) and the last loop
    keyframe."""

    def kmap(k: int) -> int:
        return int(lut_kf[anc[k]]) if 0 <= k < n_kf else -1

    db = lc.db
    db.bow = {int(lut_kf[k]): v for k, v in db.bow.items()
              if 0 <= k < n_kf and lut_kf[k] >= 0}
    db.bow_arr = {}  # keyed by old ids; db.score rebuilds entries lazily
    db.inverted = {}
    for nk, v in db.bow.items():
        for wid in v:
            db.inverted.setdefault(wid, []).append(nk)
    lc.consistent_groups = [
        (g2, c) for g, c in lc.consistent_groups
        if (g2 := {int(lut_kf[k]) for k in g
                   if 0 <= k < n_kf and lut_kf[k] >= 0})]
    lc.loop_edges = [(kmap(i), kmap(j), T) for i, j, T in lc.loop_edges
                     if kmap(i) >= 0 and kmap(j) >= 0 and kmap(i) != kmap(j)]
    if 0 <= lc.last_loop_kf < n_kf:
        lc.last_loop_kf = kmap(lc.last_loop_kf)
