"""Offline visualization (viewer substitute).

The reference runs a live Pangolin GL viewer + OpenCV frame window on
their own threads (ref: src/orbslam/Viewer.cc, FrameDrawer.cc,
MapDrawer.cc). On a headless TPU host the equivalent is offline: frame
overlays (tracked keypoints over the semantic image, with the
reference's green-square style and status bar, ref: FrameDrawer.cc:
37-177) and a top-down map render (points + keyframe trajectory +
covisibility, ref: MapDrawer.cc:41-257), written as PNGs.
"""

from __future__ import annotations

import numpy as np

from sivo_tpu_torch.select.semantic import CLASS_COLOURS_BGR


def semantic_overlay(
    gray: np.ndarray, classes: np.ndarray, alpha: float = 0.6
) -> np.ndarray:
    """Blend the class palette over the image (the reference's frame
    view draws ON the semantic overlay, ref: FrameDrawer.cc:167-177;
    palette ref: bayesian_segnet.cpp:91-117 + generateSegmentedImage)."""
    lut = np.zeros((256, 3), np.uint8)
    lut[: len(CLASS_COLOURS_BGR)] = CLASS_COLOURS_BGR
    colour = lut[classes.astype(np.uint8)]
    base = np.repeat(gray[..., None], 3, axis=-1).astype(np.float32)
    return (
        (1 - alpha) * base + alpha * colour.astype(np.float32)
    ).clip(0, 255).astype(np.uint8)


def draw_frame(
    gray: np.ndarray,
    classes: np.ndarray,
    kp_xy: np.ndarray,
    kp_tracked: np.ndarray,
    kp_valid: np.ndarray,
    status: str = "",
) -> np.ndarray:
    """FrameDrawer equivalent: green squares + dots on tracked
    keypoints (ref: FrameDrawer.cc:37-165), over the semantic overlay,
    with a status bar."""
    import cv2

    img = semantic_overlay(gray, classes)
    r = 5
    for (x, y), tracked, ok in zip(kp_xy, kp_tracked, kp_valid):
        if not ok:
            continue
        p1 = (int(x - r), int(y - r))
        p2 = (int(x + r), int(y + r))
        colour = (0, 255, 0) if tracked else (255, 0, 0)
        cv2.rectangle(img, p1, p2, colour)
        cv2.circle(img, (int(x), int(y)), 2, colour, -1)
    if status:
        bar = np.zeros((20, img.shape[1], 3), np.uint8)
        cv2.putText(
            bar, status, (5, 14), cv2.FONT_HERSHEY_PLAIN, 1,
            (255, 255, 255), 1,
        )
        img = np.concatenate([img, bar], axis=0)
    return img


def draw_map_topdown(
    pt_pos: np.ndarray,
    pt_valid: np.ndarray,
    kf_poses: np.ndarray,
    traj_poses: np.ndarray | None = None,
    size: int = 800,
    pad: float = 5.0,
) -> np.ndarray:
    """MapDrawer equivalent (x-z top-down): map points (black), keyframe
    frusta positions (blue), trajectory (green)
    (ref: MapDrawer.cc:41-257)."""
    import cv2

    img = np.full((size, size, 3), 255, np.uint8)
    pts = pt_pos[pt_valid]
    centers = np.stack(
        [-(T[:3, :3].T @ T[:3, 3]) for T in kf_poses]
    ) if len(kf_poses) else np.zeros((0, 3))
    allxz = np.concatenate(
        [pts[:, [0, 2]], centers[:, [0, 2]]]
        if len(pts) else [centers[:, [0, 2]]]
    )
    if len(allxz) == 0:
        return img
    lo = allxz.min(0) - pad
    hi = allxz.max(0) + pad
    scale = (size - 20) / max((hi - lo).max(), 1e-6)

    def to_px(xz):
        p = (xz - lo) * scale + 10
        return p[..., 0].astype(int), (size - 10 - p[..., 1]).astype(int)

    if len(pts):
        xs, ys = to_px(pts[:, [0, 2]])
        ok = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        img[ys[ok], xs[ok]] = (40, 40, 40)
    if traj_poses is not None and len(traj_poses):
        tc = np.stack(
            [-(T[:3, :3].T @ T[:3, 3]) for T in traj_poses]
        )
        xs, ys = to_px(tc[:, [0, 2]])
        for i in range(1, len(xs)):
            cv2.line(
                img, (xs[i - 1], ys[i - 1]), (xs[i], ys[i]),
                (0, 180, 0), 2,
            )
    for c in centers:
        x, y = to_px(c[[0, 2]][None])
        cv2.circle(img, (int(x[0]), int(y[0])), 4, (200, 80, 0), -1)
    return img


def render_session(system, out_dir: str) -> None:
    """Dump the final map view for a finished System session."""
    import os

    import cv2

    os.makedirs(out_dir, exist_ok=True)
    m = system.map
    traj = system.frame_poses()
    img = draw_map_topdown(
        m.pt_pos[: m.n_points],
        m.pt_valid[: m.n_points],
        m.kf_pose[: m.n_keyframes],
        traj,
    )
    cv2.imwrite(os.path.join(out_dir, "map_topdown.png"), img)
