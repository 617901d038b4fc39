"""The port's pipelined session on the CPU with its copies landing late,
as on the card (``tools/late_copies.delayed_landing``: each
``HostCopy`` answers "not landed" to its first 0-5 polls, drawn from a
seeded generator), on the 14-frame VO world of
tests/test_torch_session.py (b) at ``pipeline_depth=3``, where local BA
applies. For each seed: no frame lost, every pose finite, every
map-health count of phase 11's per-frame record (``chip_smoke.
FrameLog``) zero, and at least one frame carried a world correction
from the mapper's BA, re-chained at its retire: the harness reaches the
path where BA lands while frames are in flight.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic
from sivo_tpu_torch.runtime import frame as t_frame
from sivo_tpu_torch.runtime.system import System
from tools.late_copies import delayed_landing

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM = t_config.CameraConfig(fx=180.0, fy=180.0, cx=160.0, cy=96.0,
                            width=320, height=192, bf=180.0 * 0.54, fps=10.0)
DEPTH = 3
HEALTH = ("kf_nonfinite", "pt_nonfinite", "pt_nonfinite_host",
          "pt_unobserved")


def make_cfg():
    cfg = t_config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=CAM,
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
        tracking=dataclasses.replace(cfg.tracking, min_init_keypoints=150),
        semantic=dataclasses.replace(cfg.semantic, th_entropy_reduction=0.02),
    )


@pytest.fixture(scope="module")
def world():
    scene = synthetic.make_world(CAM, seed=0)
    gt = synthetic.forward_trajectory(n_frames=14, speed=0.5)
    left, right, _ = synthetic.render_sequence(scene, gt)
    statics = t_frame.make_statics(make_cfg())
    cls, conf, ent = synthetic.constant_semantics(CAM.height, CAM.width)
    frames = [t_frame.build_frame_nosegnet(statics, left[i], right[i], cls,
                                           conf, ent, device=CPU)
              for i in range(len(left))]
    return gt, frames


# seeds whose draws let the mapper's first BA land while frames are in
# flight: of seeds 0-20 these three do; with the others the first BA's
# copies wait until flush in these 14 frames, after every frame retired
@pytest.mark.parametrize("seed", [3, 5, 20])
def test_session_with_late_copies(world, seed):
    gt, frames = world
    system = System(cfg=make_cfg(), device=CPU, max_keyframes=64,
                    max_points=20000, pipeline_depth=DEPTH)
    with (delayed_landing(seed, DEPTH + 2) as counts,
          cs.FrameLog(system) as log):
        for i, f in enumerate(frames):
            system.track_frame(f, i * 0.1, pipeline=True)
        system.flush()
    assert counts["refused"] > 0 and counts["late"] < counts["copies"]
    assert system.n_lost() == 0
    poses = system.frame_poses()
    assert poses.shape == (len(gt), 4, 4) and np.isfinite(poses).all()
    assert synthetic.ate_rmse(poses, gt) < 0.3
    assert system.mapper.ba_solves >= 1
    recs = log.records
    assert [r["fid"] for r in recs] == list(range(len(gt)))
    assert all(r[k] == 0 for r in recs[1:] for k in HEALTH)
    assert any(r["correction_t"] >= 0 for r in recs)
