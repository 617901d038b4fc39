"""Trajectory output writers, byte-format compatible with the reference.

A verbatim copy of ``sivo_tpu/io/trajectory.py`` (numpy only; importing
the original would load JAX through ``sivo_tpu``'s package
``__init__``).

ref: src/orbslam/System.cc:274-336 SaveTrajectoryKITTI: frame poses are
stored relative to their reference keyframe at track time; at save time
each is re-chained through the (possibly BA/loop-corrected) keyframe
pose, normalized so the first keyframe sits at the origin, and written
as the camera-to-world 3x4 row-major with ``fixed << setprecision(9)``;
System.cc:245-272 Shutdown writes keyframes_points.txt counts.
"""

from __future__ import annotations

import numpy as np


def _fmt(v: float) -> str:
    """std::fixed << std::setprecision(9) of a float."""
    return f"{v:.9f}"


def kitti_line(Tcw: np.ndarray) -> str:
    """One KITTI pose line from a world->camera pose: Rwc | twc
    row-major (ref: System.cc:322-333)."""
    Tcw = Tcw.astype(np.float64)
    Rwc = Tcw[:3, :3].T
    twc = -Rwc @ Tcw[:3, 3]
    vals = [
        Rwc[0, 0], Rwc[0, 1], Rwc[0, 2], twc[0],
        Rwc[1, 0], Rwc[1, 1], Rwc[1, 2], twc[1],
        Rwc[2, 0], Rwc[2, 1], Rwc[2, 2], twc[2],
    ]
    # the reference computes in float32 cv::Mats then prints
    vals32 = [np.float32(v) for v in vals]
    return " ".join(_fmt(float(v)) for v in vals32)


def chained_frame_poses(
    rel_poses: list[np.ndarray],  # per-frame Tcr (frame rel. to ref KF)
    ref_kfs: list[int],
    kf_poses: np.ndarray,  # (K, 4, 4) current (optimized) KF Tcw
    first_kf: int = 0,
) -> np.ndarray:
    """Re-chain per-frame relative poses through their reference
    keyframes (ref: System.cc:303-321): Tcw_frame = Tcr * Tkw * Two."""
    Two = np.linalg.inv(kf_poses[first_kf].astype(np.float64))
    out = []
    for Tcr, k in zip(rel_poses, ref_kfs):
        Trw = kf_poses[k].astype(np.float64) @ Two
        out.append((Tcr.astype(np.float64) @ Trw).astype(np.float32))
    return np.stack(out)


def save_trajectory_kitti(path: str, poses_cw: np.ndarray) -> None:
    """ref: System.cc:274-336 (poses already chained/normalized)."""
    with open(path, "w") as f:
        for Tcw in poses_cw:
            f.write(kitti_line(Tcw) + "\n")


def save_keyframes_points(
    path: str, n_keyframes: int, n_points: int
) -> None:
    """ref: System.cc:263-271."""
    with open(path, "w") as f:
        f.write(f"Final number of keyframes: {n_keyframes}\n")
        f.write(f"Final number of map points: {n_points}\n")
