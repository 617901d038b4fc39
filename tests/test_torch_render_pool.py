"""``chip_smoke.PooledRender`` (the bench worlds rendered by worker
processes, one frame per task) against ``render_sequence`` in this
process, on two frames of each world at 320x192: left, right and class
rasters equal, exactly, all at once and one frame at a time."""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.io import synthetic

CAM = dataclasses.replace(SystemConfig().camera, fx=180.0, fy=180.0,
                          cx=160.0, cy=96.0, width=320, height=192,
                          bf=180.0 * 0.54)
POSES = {"loop": synthetic.square_loop_trajectory(
             n_frames=190, half=9.5, corner_r=3.5, jitter=0.03)[[0, 120]],
         "dumbbell": synthetic.figure8_trajectory(300)[[0, 250]]}


@pytest.mark.parametrize("kind", sorted(POSES))
def test_pooled_render_equals_serial(kind):
    poses = POSES[kind]
    pool = chip_smoke.PooledRender(kind, CAM, poses)
    got = pool.result()
    want = synthetic.render_sequence(chip_smoke.bench_world(kind, CAM),
                                     poses, ss=2)
    for name, g, w in zip(("left", "right", "classes"), got, want):
        assert g.shape == w.shape == (2, 192, 320), name
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert pool.workers == 2 and all(f.done() for f in pool.futures)
    # one frame as the pool hands it out
    for g, w in zip(pool.frame(1), want):
        np.testing.assert_array_equal(g, w[1])
