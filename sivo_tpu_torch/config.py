"""Configuration system.

A copy of the JAX package's ``sivo_tpu/config.py`` (dataclasses only),
so that the port imports nothing of ``sivo_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Mirrors the reference's three config mechanisms (ref:
src/orbslam/Tracking.cc:64-165 reads an OpenCV ``cv::FileStorage`` YAML;
config/kitti/*.yaml carry camera intrinsics / ORB / semantic thresholds;
the Caffe prototxt carries the network + MC sample count) as plain
dataclasses plus a loader for the same YAML key names, so reference
config files drop in unchanged.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class CameraConfig:
    """Stereo pinhole camera (ref: config/kitti/KITTI03.yaml:7-31)."""

    fx: float = 721.5377
    fy: float = 721.5377
    cx: float = 500.5593
    cy: float = 161.3540
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 1024
    height: int = 352
    fps: float = 10.0
    bf: float = 387.5744  # stereo baseline (m) times fx
    rgb: int = 0  # 0: BGR, 1: RGB

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor settings (ref: config/kitti/KITTI03.yaml:44-58,
    src/orbslam/ORBextractor.cc constants)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Behavioral constants of the reference extractor
    # (ref: src/orbslam/ORBextractor.cc:70-72, :756).
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19
    cell_size: int = 30
    # Fixed capacity of padded keypoint arrays on device (>= n_features).
    max_keypoints: int = 2048


@dataclass(frozen=True)
class SemanticConfig:
    """Semantic selection thresholds (ref: config/kitti/KITTI03.yaml:33-38,
    src/orbslam/Tracking.cc:148-165)."""

    th_confidence: float = 0.65
    th_entropy_reduction: float = 4.0
    num_classes: int = 15
    mc_samples: int = 3  # prototxt input_dim[0]; "SET SAMPLE SIZE HERE"
    static_class_max: int = 8  # Classes::TERRAIN (ref: Frame.cc:190)
    # True = the SIVO paper's greedy sequential selection with a
    # covariance-only Kalman update after every accepted feature
    # (arXiv 1811.11946 §III-B; sivo_helpers.cpp:221-240). False =
    # batch scoring against the static per-frame covariance, which is
    # what the reference BINARY actually does — its update function is
    # implemented but never called (see select/info.py::
    # sequential_selection_stereo for the verification).
    sequential_selection: bool = True
    # floor for sequential mode: accept positive-information candidates
    # until this many are taken, then the Kalman-shrunk threshold
    # self-limits (pure greedy collapses to ~5-10 features — the
    # information-theoretic minimum — which real matching attrition
    # cannot survive)
    seq_min_select: int = 32
    # conv compute dtype for the SegNet forward. The reference runs
    # f32 on GPU (Caffe Net<float>, bayesian_segnet.cpp:59); on TPU the
    # MXU is a bf16 engine and f32 convs pay a 3-pass penalty. The
    # posterior math (softmax/mean/entropy) always stays f32
    # (segnet.py), so only conv activations round — measured class
    # agreement vs f32 forward: see PROGRESS notes r5.
    cnn_dtype: str = "bfloat16"


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking policy constants (ref: src/orbslam/Tracking.cc, appendix A
    of SURVEY.md)."""

    th_depth: float = 40.0  # close/far threshold, x baseline
    min_init_keypoints: int = 500  # Tracking.cc:454
    init_covariance: float = 1e-6  # Tracking.cc:460-462
    motion_process_noise: float = 0.01  # sivo_helpers.cpp:263
    # keyframe policy (Tracking.cc:825-919)
    min_frames_between_kf: int = 0
    close_tracked_max: int = 30  # SIVO-modified (Tracking.cc:872-874)
    close_nontracked_min: int = 70
    th_ref_ratio: float = 0.75
    max_local_keyframes: int = 80  # Tracking.cc:1183
    # matching windows
    motion_search_th: int = 7  # stereo (Tracking.cc:729)
    min_motion_matches: int = 20
    min_matches_map: int = 10
    min_local_map_inliers: int = 30
    # acceleration sanity bound in metres/frame^2 (beyond the
    # reference; see runtime/track_step.py — implausible motion-stage
    # jumps reroute to the prediction-free reference-KF fallback)
    max_accel_m: float = 0.5


@dataclass(frozen=True)
class MappingConfig:
    """Local mapping policy constants (ref: src/orbslam/LocalMapping.cc)."""

    found_ratio_min: float = 0.25  # LocalMapping.cc:173
    min_obs_stereo: int = 3
    n_triangulate_neighbors: int = 10  # LocalMapping.cc:205
    parallax_cos_max: float = 0.9998
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.8
    scale_consistency_factor: float = 1.5
    kf_cull_redundancy: float = 0.9  # LocalMapping.cc:727-792


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing policy constants (ref: src/orbslam/LoopClosing.cc)."""

    min_kfs_since_last_loop: int = 10
    covisibility_consistency_th: int = 3
    min_bow_matches: int = 20
    sim3_ransac_prob: float = 0.99
    sim3_ransac_min_inliers: int = 20
    sim3_ransac_max_iters: int = 300
    min_total_matches: int = 40
    essential_edge_min_weight: int = 100
    # Sim3 pre-gate (beyond the reference, round-3 measurement: 55-58
    # Sim3 evaluations / ~9.5 s for ONE true loop on self-similar
    # corridor scenery): a consistency-passing candidate dispatches the
    # multi-round-trip Sim3 attempt only when its L1 score clears
    # margin * min_score — a true revisit scores well above the worst
    # covisible neighbour, a corridor lookalike hovers just over it.
    sim3_score_margin: float = 1.3


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)

    def replace(self, **kw: Any) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# OpenCV-FileStorage-style YAML loader (same key names as the reference).
# ---------------------------------------------------------------------------

def _parse_opencv_yaml(text: str) -> dict[str, float]:
    """Parse the subset of OpenCV ``cv::FileStorage`` YAML the reference uses:
    flat ``Section.key: value`` scalars, ``#`` comments, a ``%YAML:1.0``
    header. (ref: config/kitti/KITTI03.yaml)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("%"):
            continue
        m = re.match(r"^([\w.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip().strip('"')
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


def load_settings(path: str, base: SystemConfig | None = None) -> SystemConfig:
    """Load a reference-format settings YAML into a SystemConfig.

    Key names follow src/orbslam/Tracking.cc:64-165 exactly so the
    reference's config/kitti/*.yaml files work verbatim.
    """
    base = base or SystemConfig()
    with open(path) as f:
        kv = _parse_opencv_yaml(f.read())

    def get(name: str, default: float) -> float:
        return kv.get(name, default)

    cam = CameraConfig(
        fx=get("Camera.fx", base.camera.fx),
        fy=get("Camera.fy", base.camera.fy),
        cx=get("Camera.cx", base.camera.cx),
        cy=get("Camera.cy", base.camera.cy),
        k1=get("Camera.k1", base.camera.k1),
        k2=get("Camera.k2", base.camera.k2),
        p1=get("Camera.p1", base.camera.p1),
        p2=get("Camera.p2", base.camera.p2),
        width=int(get("Camera.width", base.camera.width)),
        height=int(get("Camera.height", base.camera.height)),
        fps=get("Camera.fps", base.camera.fps),
        bf=get("Camera.bf", base.camera.bf),
        rgb=int(get("Camera.RGB", base.camera.rgb)),
    )
    orb = dataclasses.replace(
        base.orb,
        n_features=int(get("ORBextractor.nFeatures", base.orb.n_features)),
        scale_factor=get("ORBextractor.scaleFactor", base.orb.scale_factor),
        n_levels=int(get("ORBextractor.nLevels", base.orb.n_levels)),
        ini_th_fast=int(get("ORBextractor.iniThFAST", base.orb.ini_th_fast)),
        min_th_fast=int(get("ORBextractor.minThFAST", base.orb.min_th_fast)),
    )
    sem = dataclasses.replace(
        base.semantic,
        th_confidence=get("ThConfidence", base.semantic.th_confidence),
        th_entropy_reduction=get(
            "ThEntropyReduction", base.semantic.th_entropy_reduction
        ),
    )
    if not 0.0 < sem.th_confidence < 1.0:  # ref: Tracking.cc:153-160
        raise ValueError(
            f"ThConfidence must be in (0, 1), got {sem.th_confidence}"
        )
    trk = dataclasses.replace(
        base.tracking, th_depth=get("ThDepth", base.tracking.th_depth)
    )
    return dataclasses.replace(
        base, camera=cam, orb=orb, semantic=sem, tracking=trk
    )
