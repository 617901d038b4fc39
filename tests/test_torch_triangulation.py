"""Triangulation: the port (``sivo_tpu_torch/ops/triangulation.py``)
against the JAX package on rendered keyframe pairs.

The VO world of tests/test_tracking.py (320x192) is rendered along its
forward trajectory; the JAX frontend (``build_frame_nosegnet``, constant
semantics) makes the keyframes. Frame 0 is the new keyframe and frames
2, 4 and 6 its B = 3 neighbours, at N = 1024 keypoint slots, with the
ground-truth poses; each keyframe's free keypoints are its semantic
ones. A fourth, padding neighbour (``nb_valid`` False) must accept
nothing.

Tolerances: ``kp2`` (the epipolar Hamming argmin, first index on ties)
exactly equal; ``xw`` within 1e-3 m where accepted (float32 4x4 SVDs
from two LAPACK paths); the fundamental matrices within 1e-5 of their
largest entry (the (2, 2) entry is a sum of cancelling ~1e-2 terms).
``accepted`` equal, except where a gate's float32 input lies within
float32 rounding of its threshold: each differing entry must have a
parallax cosine within 1e-6 of 0.9998 (computed in float64). Such an
entry flips with the summation order of a 3-vector dot product, which
differs between XLA and PyTorch and, in PyTorch, between batch shapes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu import config as j_config
from sivo_tpu.io import synthetic
from sivo_tpu.ops import triangulation as j_tri
from sivo_tpu.runtime import frame as j_frame
from sivo_tpu.runtime import tracking as j_tracking
from sivo_tpu_torch.geometry.projection import CameraParams
from sivo_tpu_torch.ops import triangulation as t_tri

torch.set_num_threads(2)
CAM_FIELDS = dict(fx=180.0, fy=180.0, cx=160.0, cy=96.0, width=320,
                  height=192, bf=180.0 * 0.54, fps=10.0)
NEIGHBOURS = (2, 4, 6)


@pytest.fixture(scope="module")
def pairs():
    cfg = j_config.SystemConfig()
    cfg = dataclasses.replace(
        cfg, camera=j_config.CameraConfig(**CAM_FIELDS),
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024))
    cam = j_tracking.make_camera(cfg)
    world = synthetic.make_world(cfg.camera, seed=0)
    gt = synthetic.forward_trajectory(n_frames=7, speed=0.5)
    left, right, _ = synthetic.render_sequence(world, gt)
    cls, conf, ent = synthetic.constant_semantics(cfg.camera.height,
                                                  cfg.camera.width)
    statics = j_frame.make_statics(cfg)
    frames = {i: j_frame.build_frame_nosegnet(
        statics, jnp.asarray(left[i]), jnp.asarray(right[i]),
        jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent))
        for i in (0,) + NEIGHBOURS}
    f1 = {k: np.asarray(v) for k, v in frames[0]._asdict().items()}
    nbs = [{k: np.asarray(v) for k, v in frames[i]._asdict().items()}
           for i in NEIGHBOURS]
    # a padding neighbour (a copy of the first, marked invalid)
    nbs.append(nbs[0])
    T2 = np.stack([gt[i] for i in NEIGHBOURS] + [gt[NEIGHBOURS[0]]]
                  ).astype(np.float32)
    args = dict(
        T1w=gt[0].astype(np.float32), xy1=f1["xy"], level1=f1["level"],
        desc1=f1["desc_u8"], free1=f1["semantic"], ur1=f1["u_right"],
        sem_class1=f1["sem_class"], sem_conf1=f1["sem_confidence"],
        sem_ent1=f1["sem_entropy"],
        cov1=(np.eye(6) * 1e-4).astype(np.float32),
        T2w=T2, xy2=np.stack([n["xy"] for n in nbs]),
        level2=np.stack([n["level"] for n in nbs]),
        desc2=np.stack([n["desc_u8"] for n in nbs]),
        free2=np.stack([n["semantic"] for n in nbs]),
        sem_class2=np.stack([n["sem_class"] for n in nbs]),
        nb_valid=np.array([True, True, True, False]),
    )
    th = (float(cfg.semantic.th_confidence), 0.02)
    j_res = j_tri.triangulate_neighbors(
        *(jnp.asarray(v) for v in args.values()),
        jnp.float32(th[0]), jnp.float32(th[1]), cam,
        cfg.orb.scale_factor, cfg.orb.n_levels)
    t_res = t_tri.triangulate_neighbors(
        *(torch.from_numpy(np.array(v)) for v in args.values()), th[0], th[1],
        CameraParams(*cam), cfg.orb.scale_factor, cfg.orb.n_levels)
    j_np = {k: np.asarray(v) for k, v in j_res._asdict().items()}
    t_np = {k: v.numpy() for k, v in t_res._asdict().items()}
    return cam, args, j_np, t_np


def test_fundamental_matrix_matches_jax(pairs):
    cam, args, _, _ = pairs
    for T2 in args["T2w"][:3]:
        Fj = np.asarray(j_tri.fundamental_matrix(
            jnp.asarray(args["T1w"]), jnp.asarray(T2), cam))
        Ft = t_tri.fundamental_matrix(torch.from_numpy(args["T1w"]),
                                      torch.from_numpy(T2),
                                      CameraParams(*cam)).numpy()
        np.testing.assert_allclose(Ft, Fj, rtol=0,
                                   atol=1e-5 * np.abs(Fj).max())


def _parallax_cos64(cam, args, kp2):
    """(B, N) float64 cosine between the two viewing rays of each match."""
    def rays(xy, R):
        xn = np.stack([(xy[..., 0] - cam.cx) / cam.fx,
                       (xy[..., 1] - cam.cy) / cam.fy,
                       np.ones(xy.shape[:-1])], axis=-1)
        return xn @ R.astype(np.float64)

    xy2m = np.take_along_axis(args["xy2"], kp2[..., None].astype(int), 1)
    r1 = rays(args["xy1"].astype(np.float64), args["T1w"][:3, :3])[None]
    r2 = rays(xy2m.astype(np.float64), args["T2w"][:, :3, :3])
    return (np.sum(r1 * r2, -1) / np.linalg.norm(r1, axis=-1)
            / np.linalg.norm(r2, axis=-1))


def test_matches_and_acceptance_equal(pairs):
    cam, args, j, t = pairs
    np.testing.assert_array_equal(t["kp2"], j["kp2"])
    np.testing.assert_array_equal(t["kp1"], j["kp1"])
    differ = t["accepted"] != j["accepted"]
    cos = _parallax_cos64(cam, args, j["kp2"])
    assert (np.abs(cos[differ] - 0.9998) < 1e-6).all(), cos[differ]
    assert differ.sum() <= 2, differ.sum()
    # a real triangulation: every valid neighbour accepts points, the
    # padding neighbour none
    assert (t["accepted"][:3].sum(axis=1) > 20).all(), t["accepted"].sum(1)
    assert not t["accepted"][3].any()


def test_points_match_where_accepted(pairs):
    _, _, j, t = pairs
    acc = j["accepted"]
    err = np.linalg.norm(t["xw"][acc] - j["xw"][acc], axis=-1)
    assert err.max() <= 1e-3, err.max()
