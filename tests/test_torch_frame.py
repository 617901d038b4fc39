"""Parity of the port's whole frontend (``build_frame_nosegnet``) with
the JAX package's on one 320x192 frame (the camera of
tests/test_tracking.py).

The JAX reference is composed from the un-jitted ``frontend_pre`` and
``frontend_post`` with ``SIVO_FORCE_PALLAS=1``, so its descriptors come
from the Pallas kernel (interpreted) with u8 canvas semantics, the
semantics of the port's kernel K1. The variable is read while tracing,
which is why the jitted ``build_frame*`` (whose cache may hold the XLA
trace) are not used.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu import config as j_config
from sivo_tpu.io import synthetic
from sivo_tpu.runtime import frame as j_frame
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.ops import orb as t_orb
from sivo_tpu_torch.runtime import frame as t_frame

torch.set_num_threads(2)
CAM_FIELDS = dict(fx=180.0, fy=180.0, cx=160.0, cy=96.0, width=320,
                  height=192, bf=180.0 * 0.54, fps=10.0)
CAM = j_config.CameraConfig(**CAM_FIELDS)


def _cfg(config):
    """The test configuration built from ``config``, the JAX package's
    config module or the port's."""
    cfg = config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=config.CameraConfig(**CAM_FIELDS),
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
    )


@pytest.fixture(scope="module")
def frames():
    world = synthetic.make_world(CAM, seed=0)
    gt = synthetic.forward_trajectory(n_frames=3, speed=0.5)
    left, right, cls_map = synthetic.render_sequence(world, gt[2:3])
    cls, conf, ent = synthetic.structured_semantics(cls_map[0], seed=7)

    mp = pytest.MonkeyPatch()
    mp.setenv("SIVO_FORCE_PALLAS", "1")
    try:
        statics = j_frame.make_statics(_cfg(j_config))
        pre = j_frame.frontend_pre(
            None, None, statics, jnp.asarray(left[0]),
            jnp.asarray(right[0]), None,
            sem_override=(jnp.asarray(cls), jnp.asarray(conf),
                          jnp.asarray(ent), False),
            use_cnn_static=False,
        )
        assert pre.prep_l is not None  # the Pallas path was taken
        fj = j_frame.frontend_post(statics, pre)
    finally:
        mp.undo()
    ft = t_frame.build_frame_nosegnet(
        t_frame.make_statics(_cfg(t_config)), left[0], right[0], cls, conf, ent,
        device=torch.device("cpu"),
    )
    fj = {k: np.asarray(v) for k, v in fj._asdict().items()}
    ft = {k: v.numpy() for k, v in ft._asdict().items()}
    return fj, ft


def _keys(f):
    """(level, x, y) per valid keypoint -> slot."""
    idx = np.where(f["valid"])[0]
    return {(int(f["level"][i]), float(f["xy"][i, 0]), float(f["xy"][i, 1])):
            i for i in idx}


def test_keypoints_identical(frames):
    fj, ft = frames
    kj, kt = _keys(fj), _keys(ft)
    shared = set(kj) & set(kt)
    # level 0 sees the same input on both sides; resized levels differ by
    # <= 4e-4 grey (antialias filters), which can flip a bf16 FAST score
    # now and then. Measured on this frame: 592 of 592 identical.
    assert len(kj) > 400
    assert len(shared) >= 0.99 * max(len(kj), len(kt)), (len(shared),
                                                         len(kj), len(kt))


def test_descriptors_and_angles_on_shared_keypoints(frames):
    fj, ft = frames
    kj, kt = _keys(fj), _keys(ft)
    shared = sorted(set(kj) & set(kt))
    ij = np.array([kj[k] for k in shared])
    it = np.array([kt[k] for k in shared])
    bits_j = fj["desc_bits"][ij]
    bits_t = t_orb.unpack_bits(torch.from_numpy(ft["desc_u8"][it])).numpy()
    ham = np.abs(bits_j - bits_t).sum(axis=1)
    # measured: mean 0.0017 bits, one keypoint off by one bit
    assert ham.mean() < 1.0, ham.mean()
    np.testing.assert_array_equal(ft["desc_bits"][it], bits_t)
    dang = np.angle(np.exp(1j * (fj["angle"][ij] - ft["angle"][it])))
    assert np.median(np.abs(dang)) < 1e-4


def test_semantics_and_stereo(frames):
    fj, ft = frames
    kj, kt = _keys(fj), _keys(ft)
    shared = sorted(set(kj) & set(kt))
    ij = np.array([kj[k] for k in shared])
    it = np.array([kt[k] for k in shared])
    for name in ("sem_class", "semantic"):
        np.testing.assert_array_equal(ft[name][it], fj[name][ij])
    np.testing.assert_array_equal(ft["sem_entropy"][it], fj["sem_entropy"][ij])
    both = (fj["u_right"][ij] > 0) & (ft["u_right"][it] > 0)
    either = (fj["u_right"][ij] > 0) | (ft["u_right"][it] > 0)
    assert both.sum() > 100 and both.sum() >= 0.97 * either.sum()
    du = np.abs(fj["u_right"][ij][both] - ft["u_right"][it][both])
    # measured: the same 325 matches, u_right within 4e-5 px
    assert du.max() < 0.05, du.max()
