"""The port's copies of the JAX package's numpy-only modules stay equal
to their originals: ``sivo_tpu_torch/config.py`` (the default
``SystemConfig``, field for field) and ``sivo_tpu_torch/io/synthetic.py``
(a tiny world rendered by both, array for array, exactly)."""

import dataclasses

import numpy as np

from sivo_tpu import config as j_config
from sivo_tpu.io import synthetic as j_synth
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic as t_synth

CAM_FIELDS = dict(fx=90.0, fy=90.0, cx=64.0, cy=40.0, width=128,
                  height=80, bf=90.0 * 0.54, fps=10.0)


def test_default_system_config_equal():
    assert (dataclasses.asdict(t_config.SystemConfig())
            == dataclasses.asdict(j_config.SystemConfig()))


def test_replaced_camera_config_equal():
    assert (dataclasses.asdict(t_config.CameraConfig(**CAM_FIELDS))
            == dataclasses.asdict(j_config.CameraConfig(**CAM_FIELDS)))


def _render(synth, config):
    cam = config.CameraConfig(**CAM_FIELDS)
    world = synth.make_world(cam, seed=3)
    gt = synth.forward_trajectory(n_frames=3, speed=0.5)
    left, right, cls = synth.render_sequence(world, gt)
    sem = synth.structured_semantics(cls[0], seed=7)
    loop = synth.make_loop_world(cam, seed=0, outer=16.0, inner=6.0)
    gt_loop = synth.square_loop_trajectory(n_frames=190, half=9.5,
                                           corner_r=3.5, jitter=0.03)[:2]
    l2, r2, c2 = synth.render_sequence(loop, gt_loop, ss=2)
    return [gt, *left, *right, *cls, *sem, gt_loop, *l2, *r2, *c2]


def test_synthetic_renders_equal():
    got = _render(t_synth, t_config)
    want = _render(j_synth, j_config)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_ate_rmse_equal():
    rng = np.random.default_rng(0)
    gt = j_synth.forward_trajectory(n_frames=6, speed=0.5)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (6, 3))
    assert t_synth.ate_rmse(est, gt) == j_synth.ate_rmse(est, gt)
