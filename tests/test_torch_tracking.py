"""The slice end to end on the CPU, on the VO world of
tests/test_tracking.py.

(a) Tracker parity: the same JAX ``build_frame_nosegnet`` frames go into
    the JAX Tracker and the port's Tracker (no mapper). Per-frame poses
    agree to 1e-3 m and 1e-3 rad, with equal lost and keyframe counts.
    Measured: at most 5e-5 m and 3e-6 (rotation-matrix entries) over the
    10 frames. The anchor's RANSAC draws differ between the frameworks;
    its LM polish converges to the same optimum.
(b) The port's own frontend and tracker on the 14 frames: 0 lost and
    ATE < 0.3 m, the bounds of tests/test_tracking.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu import config as j_config
from sivo_tpu.io import synthetic
from sivo_tpu.runtime import frame as j_frame
from sivo_tpu.runtime.map_state import MapState as JMapState
from sivo_tpu.runtime.tracking import Tracker as JTracker
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.runtime import frame as t_frame
from sivo_tpu_torch.runtime.map_state import MapState
from sivo_tpu_torch.runtime.tracking import Tracker, TrackingState

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM_FIELDS = dict(fx=180.0, fy=180.0, cx=160.0, cy=96.0, width=320,
                  height=192, bf=180.0 * 0.54, fps=10.0)
CAM = j_config.CameraConfig(**CAM_FIELDS)
N_PARITY = 10


def make_cfg(config):
    """The test configuration built from ``config``, the JAX package's
    config module or the port's."""
    cfg = config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=config.CameraConfig(**CAM_FIELDS),
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
        tracking=dataclasses.replace(cfg.tracking, min_init_keypoints=150),
        semantic=dataclasses.replace(cfg.semantic, th_entropy_reduction=0.02),
    )


def _map():
    return dict(max_keyframes=64, max_points=20000, kp_capacity=1024)


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.make_world(CAM, seed=0)
    gt = synthetic.forward_trajectory(n_frames=14, speed=0.5)
    left, right, _ = synthetic.render_sequence(world, gt)
    sem = synthetic.constant_semantics(CAM.height, CAM.width)
    return gt, left, right, sem


@pytest.fixture(scope="module")
def parity_run(sequence):
    gt, left, right, (cls, conf, ent) = sequence
    statics = j_frame.make_statics(make_cfg(j_config))
    jt = JTracker(cfg=make_cfg(j_config), map=JMapState(**_map()))
    tt = Tracker(cfg=make_cfg(t_config), map=MapState(**_map()), device=CPU)
    poses_j, poses_t = [], []
    for i in range(N_PARITY):
        fj = j_frame.build_frame_nosegnet(
            statics, jnp.asarray(left[i]), jnp.asarray(right[i]),
            jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent),
        )
        ft = t_frame.Frame(*(torch.from_numpy(np.array(x)) for x in fj))
        poses_j.append(jt.track(fj, timestamp=i * 0.1))
        poses_t.append(tt.track(ft, timestamp=i * 0.1))
    return jt, tt, poses_j, poses_t


def test_tracker_parity_poses(parity_run):
    _, _, poses_j, poses_t = parity_run
    for i, (pj, pt) in enumerate(zip(poses_j, poses_t)):
        assert (pj is None) == (pt is None), i
        if pj is None:
            continue
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], rtol=0, atol=1e-3,
                                   err_msg=f"frame {i} translation")
        # rotation: geodesic angle between the two estimates
        c = (np.trace(pt[:3, :3] @ pj[:3, :3].T) - 1.0) / 2.0
        assert np.arccos(np.clip(c, -1.0, 1.0)) < 1e-3, i


def test_tracker_parity_counts(parity_run):
    jt, tt, poses_j, poses_t = parity_run
    assert sum(p is None for p in poses_t) == sum(p is None for p in poses_j)
    assert sum(p is None for p in poses_t) == 0
    assert tt.map.n_keyframes == jt.map.n_keyframes
    assert tt.map.n_points == jt.map.n_points
    assert tt.state == TrackingState.OK
    np.testing.assert_allclose(tt.last_cov, jt.last_cov, rtol=1e-2,
                               atol=1e-9)


@pytest.fixture(scope="module")
def own_run(sequence):
    gt, left, right, (cls, conf, ent) = sequence
    cfg = make_cfg(t_config)
    statics = t_frame.make_statics(cfg)
    tracker = Tracker(cfg=cfg, map=MapState(**_map()), device=CPU)
    est = []
    for i in range(len(gt)):
        f = t_frame.build_frame_nosegnet(statics, left[i], right[i], cls,
                                         conf, ent, device=CPU)
        est.append(tracker.track(f, timestamp=i * 0.1))
    return tracker, gt, est


def test_port_slice_tracks(own_run):
    tracker, gt, est = own_run
    assert est[0] is not None
    assert sum(p is None for p in est) == 0
    ate = synthetic.ate_rmse(np.stack(est), gt)
    assert ate < 0.3, ate
    assert tracker.map.n_keyframes >= 1 and tracker.map.n_points > 100
    live = tracker.map.pt_valid[: tracker.map.n_points]
    assert (tracker.map.pt_class[: tracker.map.n_points][live] <= 8).all()
    cov = tracker.last_cov
    assert np.isfinite(cov).all() and np.trace(cov) < 1.0
    assert (np.linalg.eigvalsh(cov) > 0).all()
