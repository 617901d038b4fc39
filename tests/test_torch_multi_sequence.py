"""The multi-sequence runner (``parallel/multi_sequence.py``, a copy of the
JAX package's, held by tests/test_torch_copies.py) driving the port's
``System`` on the CPU, at tests/test_system_modes.py's 320x192
configuration on its corridor world: sequence "a" is frames 0-7 and "b"
frames 0-5, each ``track_stereo`` with SegNet basic running and constant
semantics as ``sem_override``.

Interleaved round-robin by ``run_sequences``, each sequence's
``SequenceResult`` equals exactly that of the same ``System`` run alone
on its frames: the sessions share the launch counters, the
``device_const`` cache and the default stream, and no state of one
reaches the other. Each session tracks every frame (ATE < 0.1 m, at
least 2 keyframes). The JAX package's runner is held against the
port's, both sessions fed the same frames, in
tests/test_torch_parallel.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic
from sivo_tpu_torch.parallel import multi_sequence as t_ms
from sivo_tpu_torch.runtime.system import System

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM_FIELDS = dict(fx=180.0, fy=180.0, cx=160.0, cy=96.0, width=320,
                  height=192, bf=180.0 * 0.54, fps=10.0)
FRAMES = {"a": 8, "b": 6}


def make_cfg(config):
    """tests/test_system_modes.py's configuration, from either package's
    config module."""
    cfg = config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=config.CameraConfig(**CAM_FIELDS),
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
        tracking=dataclasses.replace(cfg.tracking, min_init_keypoints=150),
        semantic=dataclasses.replace(cfg.semantic, th_entropy_reduction=0.02),
    )


SYSTEM_KWARGS = dict(max_keyframes=64, max_points=20000)


def make_sequences():
    """name -> [(left, right, timestamp, sem_override)] of the corridor
    world's frames, and its ground truth."""
    world = synthetic.make_world(t_config.CameraConfig(**CAM_FIELDS), seed=0)
    gt = synthetic.forward_trajectory(n_frames=18, speed=0.4)
    left, right, _ = synthetic.render_sequence(world, gt)
    cls, conf, ent = synthetic.constant_semantics(CAM_FIELDS["height"],
                                                  CAM_FIELDS["width"])
    sem = (cls, conf, ent, False)
    return {name: [(left[i], right[i], i * 0.1, sem) for i in range(n)]
            for name, n in FRAMES.items()}, gt


@pytest.fixture(scope="module")
def sequences():
    return make_sequences()


def port_system(name):
    return System(cfg=make_cfg(t_config), device=CPU, **SYSTEM_KWARGS)


def _fields(r):
    return (r.name, r.n_frames, r.n_lost, r.n_keyframes, r.n_points)


@pytest.fixture(scope="module")
def interleaved(sequences):
    seqs, _ = sequences
    return t_ms.run_sequences(port_system, seqs)


def test_interleaved_equals_alone(sequences, interleaved):
    seqs, _ = sequences
    for name, seq in seqs.items():
        alone = t_ms.run_sequences(port_system, {name: seq})[name]
        got = interleaved[name]
        assert _fields(got) == _fields(alone)
        assert got.poses.dtype == alone.poses.dtype
        np.testing.assert_array_equal(got.poses, alone.poses)


def test_interleaved_sessions_track(sequences, interleaved):
    seqs, gt = sequences
    for name, n in FRAMES.items():
        r = interleaved[name]
        assert r.n_frames == n and r.poses.shape == (n, 4, 4)
        assert r.n_lost == 0 and r.n_keyframes >= 2
        assert synthetic.ate_rmse(r.poses, gt[:n]) < 0.1
