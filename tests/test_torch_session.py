"""The port's own SLAM session end to end on the CPU (its frontend, its
tracker and its mapper; no JAX in the loop: no JAX frontend runs, so no
descriptor path of the JAX package is involved, and the JAX package
appears only as the reference trajectory writer in (c)).

(a) ``System.track_stereo`` for 4 frames of the VO world of
    tests/test_tracking.py with SegNet basic running (seeded random
    weights, 3 MC samples) and the renderer's semantics as
    ``sem_override``: every frame tracked, a keyframe mapped.
(b) ``track_frame(pipeline=True)`` at depth 2 on that world's 14 frames
    (0.5 m per frame), then ``flush``: 0 lost and ATE < 0.3 m, the
    bounds of tests/test_tracking.py, with local BA applied.
    In a run of 9 of those frames, the fifth stripped of its semantic
    keypoints is lost and puts the path into crisis mode, which retires
    every frame in flight.
(c) ``save_trajectory_kitti`` writes the reference's format (one
    ``std::fixed``, 9-decimal 3x4 row per frame), byte-equal to the JAX
    package's writer on the same poses; ``shutdown`` writes the counts.
(d) Localization mode freezes the map while tracking continues (as
    tests/test_system_modes.py holds the JAX package), and ``reset``
    clears the session but keeps the frame ids sequence-global.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sivo_tpu.io import trajectory as j_traj
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic
from sivo_tpu_torch.runtime import frame as t_frame
from sivo_tpu_torch.runtime.system import System
from sivo_tpu_torch.runtime.tracking import TrackingState

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM = t_config.CameraConfig(fx=180.0, fy=180.0, cx=160.0, cy=96.0,
                            width=320, height=192, bf=180.0 * 0.54, fps=10.0)


def make_cfg():
    cfg = t_config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=CAM,
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
        tracking=dataclasses.replace(cfg.tracking, min_init_keypoints=150),
        semantic=dataclasses.replace(cfg.semantic, th_entropy_reduction=0.02),
    )


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.make_world(CAM, seed=0)
    gt = synthetic.forward_trajectory(n_frames=14, speed=0.5)
    left, right, cls_maps = synthetic.render_sequence(world, gt)
    return gt, left, right, cls_maps


def test_track_stereo_with_segnet(sequence):
    gt, left, right, cls_maps = sequence
    system = System(cfg=make_cfg(), device=CPU, max_keyframes=32,
                    max_points=8192)
    poses = []
    for i in range(4):
        cls, conf, ent = synthetic.structured_semantics(cls_maps[i], seed=7)
        # (H, W) grey left image: broadcast to the CNN's 3 channels
        poses.append(system.track_stereo(left[i], right[i], i * 0.1,
                                         sem_override=(cls, conf, ent,
                                                       False)))
    system.flush()
    assert all(p is not None and np.isfinite(p).all() for p in poses)
    assert system.state == TrackingState.OK and system.n_lost() == 0
    assert system.map.n_keyframes >= 2
    assert system.timer.counts["map.finish_host"] >= 1
    assert synthetic.ate_rmse(system.frame_poses(), gt[:4]) < 0.3


@pytest.fixture(scope="module")
def frames(sequence):
    """The port's frontend on the 14 frames, constant semantics."""
    _, left, right, _ = sequence
    statics = t_frame.make_statics(make_cfg())
    cls, conf, ent = synthetic.constant_semantics(CAM.height, CAM.width)
    return [t_frame.build_frame_nosegnet(statics, left[i], right[i], cls,
                                         conf, ent, device=CPU)
            for i in range(len(left))]


@pytest.fixture(scope="module")
def pipelined(sequence, frames):
    gt = sequence[0]
    system = System(cfg=make_cfg(), device=CPU, max_keyframes=64,
                    max_points=20000, pipeline_depth=2)
    returned = [system.track_frame(f, i * 0.1, pipeline=True)
                for i, f in enumerate(frames)]
    system.flush()
    return system, gt, returned


def test_pipelined_session_tracks(pipelined):
    system, gt, returned = pipelined
    assert system.tracker.inflight_count == 0
    assert system.n_lost() == 0
    # depth 2: the first tracked frames return nothing while in flight
    assert returned[0] is not None and returned[1] is None
    poses = system.frame_poses()
    assert poses.shape == (len(gt), 4, 4)
    ate = synthetic.ate_rmse(poses, gt)
    assert ate < 0.3, ate
    assert system.mapper.ba_solves >= 1
    assert not system.mapper.busy
    assert system.map.n_keyframes >= 2 and system.map.n_points > 100
    # CPU tensors: every keyframe's host copy has landed by the next frame
    assert system.mapper.admit_waits == 0


def test_mapper_defers_an_admission_whose_copy_has_not_landed():
    """The mapper admits a lone queued keyframe only once its host
    bookkeeping copy has landed, waiting one frame at most; each wait is
    counted."""

    class NotLanded:
        def done(self):
            return False

    system = System(cfg=make_cfg(), device=CPU, max_keyframes=8,
                    max_points=1024)
    tracker, mapper = system.tracker, system.mapper
    tracker._kf_host_pending[0] = (NotLanded(), 0, 0.0, np.eye(4))
    mapper.on_keyframe(0)
    mapper.advance(tracker)
    assert mapper.admit_waits == 1 and mapper.queue_len == 1
    assert mapper.busy


def test_crisis_mode_retires_synchronously(frames):
    """A frame whose tracking collapses (no semantic keypoints) is lost;
    once its summary is retired, the next pipelined call is in crisis
    mode and retires every frame in flight, then the path runs deep
    again."""
    system = System(cfg=make_cfg(), device=CPU, max_keyframes=64,
                    max_points=20000, pipeline_depth=2)
    blank = frames[4]._replace(semantic=torch.zeros_like(frames[4].semantic))
    seq = frames[:4] + [blank] + frames[5:9]
    inflight = []
    for i, f in enumerate(seq):
        system.track_frame(f, i * 0.1, pipeline=True)
        inflight.append(system.tracker.inflight_count)
    assert system.crisis_frames == 1
    assert inflight == [0, 1, 2, 2, 2, 2, 2, 0, 1]
    system.flush()
    assert [r.lost for r in system.tracker.trajectory].count(True) == 1
    assert system.tracker.trajectory[4].lost


def test_trajectory_and_counts_files(pipelined, tmp_path):
    system, gt, _ = pipelined
    path = tmp_path / "CameraTrajectory.txt"
    system.save_trajectory_kitti(str(path))
    text = path.read_text()
    lines = text.splitlines()
    assert len(lines) == len(gt)
    vals = np.array([[float(v) for v in line.split()] for line in lines])
    assert vals.shape == (len(gt), 12)
    # the first keyframe sits at the origin
    np.testing.assert_allclose(vals[0], [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                               atol=1e-6)
    assert all(len(v.split(".")[1]) == 9 for v in lines[0].split())
    # byte-equal to the JAX package's writer on the same poses
    ref = tmp_path / "ref.txt"
    j_traj.save_trajectory_kitti(str(ref), system.frame_poses())
    assert ref.read_text() == text

    counts = tmp_path / "keyframes_points.txt"
    system.shutdown(str(counts))
    n_pts = int(system.map.pt_valid[: system.map.n_points].sum())
    assert counts.read_text() == (
        f"Final number of keyframes: {system.map.n_keyframes}\n"
        f"Final number of map points: {n_pts}\n")


def test_localization_mode_freezes_map(frames):
    system = System(cfg=make_cfg(), device=CPU, max_keyframes=64,
                    max_points=20000)
    for i in range(5):
        system.track_frame(frames[i], i * 0.1)
    system.activate_localization_mode()
    assert not system.mapper.busy
    kfs, pts = system.map.n_keyframes, system.map.n_points
    ok = sum(system.track_frame(frames[i], i * 0.1) is not None
             for i in range(5, 9))
    system.flush()
    assert system.map.n_keyframes == kfs  # no new keyframes
    assert system.map.n_points == pts
    assert ok >= 3  # still localizes
    system.deactivate_localization_mode()
    assert not system.tracker.only_tracking


def test_reset_keeps_frame_ids(frames):
    system = System(cfg=make_cfg(), device=CPU, max_keyframes=64,
                    max_points=20000)
    for i in range(3):
        system.track_frame(frames[i], i * 0.1)
    system.reset()
    assert system.n_resets == 1
    assert system.map.n_keyframes == 0 and system.map.n_points == 0
    assert system.state == TrackingState.NO_IMAGES_YET
    assert system.tracker.mapper is system.mapper
    assert system.track_frame(frames[3], 0.3) is not None  # re-initializes
    assert system.tracker.trajectory[-1].frame_id == 3
    assert system.map.n_keyframes == 1
