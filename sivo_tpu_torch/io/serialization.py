"""Map / session serialization.

The reference cannot save or reload its map (SURVEY §5.4: "Checkpoint /
resume — none"; Localization Mode reuses only the in-memory map). This
module adds that capability: the full MapState (keyframes with their
keypoint arrays, points, observation table) round-trips through one
compressed .npz so a mapping session can be resumed or replayed in
localization mode.
"""

from __future__ import annotations

import numpy as np

from sivo_tpu_torch.runtime.map_state import KeyFrameData, MapState

_KF_FIELDS = (
    "xy", "level", "angle", "desc_u8", "u_right", "depth",
    "sem_class", "sem_confidence", "sem_entropy", "semantic",
)


def save_map(path: str, m: MapState) -> None:
    """Serialize the host map. Callers with a live pipeline should
    flush first (System.flush finishes pending keyframe bookkeeping);
    a queued-but-unadmitted keyframe would leave kf_data[k] = None
    here, which raises a clear error instead of an AttributeError."""
    for k in range(m.n_keyframes):
        if m.kf_data[k] is None:
            raise RuntimeError(
                f"save_map: keyframe {k} has pending host bookkeeping"
                " — call System.flush() before saving"
            )
    K = m.n_keyframes
    P = m.n_points
    payload: dict[str, np.ndarray] = {
        "meta": np.array(
            [K, P, m.max_keyframes, m.max_points, m.kp_capacity,
             m.n_levels],
            np.int64,
        ),
        "scale_factor": np.array([m.scale_factor], np.float64),
        "kf_pose": m.kf_pose[:K],
        "kf_cov": m.kf_cov[:K],
        "kf_valid": m.kf_valid[:K],
        "kf_frame_id": np.array(
            [m.kf_data[k].frame_id for k in range(K)], np.int64
        ),
        "kf_timestamp": np.array(
            [m.kf_data[k].timestamp for k in range(K)], np.float64
        ),
        "pt_pos": m.pt_pos[:P],
        "pt_normal": m.pt_normal[:P],
        "pt_min_dist": m.pt_min_dist[:P],
        "pt_max_dist": m.pt_max_dist[:P],
        "pt_desc_u8": m.pt_desc_u8[:P],
        "pt_class": m.pt_class[:P],
        "pt_valid": m.pt_valid[:P],
        "pt_ref_kf": m.pt_ref_kf[:P],
        "pt_first_kf": m.pt_first_kf[:P],
        "observations": m.observations(),
    }
    for field in _KF_FIELDS:
        payload[f"kfd_{field}"] = np.stack(
            [getattr(m.kf_data[k], field) for k in range(K)]
        )
    np.savez_compressed(path, **payload)


def load_map(path: str) -> MapState:
    z = np.load(path, allow_pickle=False)
    K, P, max_kf, max_pt, kp_cap, n_levels = z["meta"]
    m = MapState(
        max_keyframes=int(max_kf),
        max_points=int(max_pt),
        kp_capacity=int(kp_cap),
        n_levels=int(n_levels),
        scale_factor=float(z["scale_factor"][0]),
    )
    m.n_keyframes = int(K)
    m.n_points = int(P)
    m.kf_pose[:K] = z["kf_pose"]
    m.kf_cov[:K] = z["kf_cov"]
    m.kf_valid[:K] = z["kf_valid"]
    for k in range(K):
        m.kf_data[k] = KeyFrameData(
            frame_id=int(z["kf_frame_id"][k]),
            timestamp=float(z["kf_timestamp"][k]),
            desc_bits=None,
            **{f: z[f"kfd_{f}"][k] for f in _KF_FIELDS},
        )
    for name in (
        "pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist",
        "pt_desc_u8", "pt_class", "pt_valid", "pt_ref_kf",
        "pt_first_kf",
    ):
        getattr(m, name)[:P] = z[name]
    obs = np.asarray(z["observations"], np.int64)
    m._obs_reserve(len(obs))
    m._obs[: len(obs)] = obs
    m._obs_alive[: len(obs)] = True
    m._obs_n = len(obs)
    m._obs_dirty = True
    return m
