"""The SLAM session (``System`` with the local mapper) against the JAX
package on the CPU, on the VO world of tests/test_compact.py (320x192,
10 frames at 0.4 m per frame).

(a) Parity: the same JAX ``build_frame_nosegnet`` frames go into the
    JAX ``System.track_frame`` and the port's, their descriptors from
    the JAX package's K1 with the kernel's semantics (interpreted; the
    port's K1 semantics, ``tests/jax_kernel_semantics.py``), not its
    CPU XLA path, each call followed by
    ``system.mapper.drain(system.tracker)``, which makes both mappers
    deterministic (the JAX package's stage completion is otherwise a
    thread future). Per-frame poses from ``frame_poses()`` (re-chained
    through the BA-corrected keyframes) agree within 1e-4 m (measured
    5.7e-6 m) and 1e-3 rad (the float32 rotations' own floor: 7e-4);
    lost frames, keyframes and BA solves are equal. Map points:
    within 1% (measured equal) because a triangulated point whose
    parallax cosine sits within float32 rounding of the 0.9998 gate can
    be accepted by one framework and not the other (see
    tests/test_torch_triangulation.py).
(b) Compaction (the port of tests/test_compact.py's test): culled
    points and a culled keyframe are reclaimed, the host and device
    stores stay in lockstep, the trajectory survives re-chaining, and
    tracking continues over the compacted map.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu import config as j_config
from sivo_tpu.io import synthetic
from sivo_tpu.runtime import frame as j_frame
from sivo_tpu.runtime.system import System as JSystem
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.runtime import compact as compact_mod
from sivo_tpu_torch.runtime import device_map
from sivo_tpu_torch.runtime import frame as t_frame
from sivo_tpu_torch.runtime.system import System
from tests.jax_kernel_semantics import k1_kernel_semantics

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM_FIELDS = dict(fx=180.0, fy=180.0, cx=160.0, cy=96.0, width=320,
                  height=192, bf=180.0 * 0.54, fps=10.0)
N_FRAMES = 10


def make_cfg(config):
    """tests/test_compact.py's configuration, from the JAX package's
    config module or the port's."""
    cfg = config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=config.CameraConfig(**CAM_FIELDS),
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
        tracking=dataclasses.replace(cfg.tracking, min_init_keypoints=150),
        semantic=dataclasses.replace(cfg.semantic, th_entropy_reduction=0.02),
    )


def _system_kwargs():
    return dict(max_keyframes=64, max_points=20000)


@pytest.fixture(scope="module")
def frames():
    """The JAX frontend's frames of the 10-frame run, and ground truth."""
    world = synthetic.make_world(j_config.CameraConfig(**CAM_FIELDS), seed=0)
    gt = synthetic.forward_trajectory(n_frames=N_FRAMES, speed=0.4)
    left, right, _ = synthetic.render_sequence(world, gt)
    cls, conf, ent = synthetic.constant_semantics(CAM_FIELDS["height"],
                                                  CAM_FIELDS["width"])
    statics = j_frame.make_statics(make_cfg(j_config))
    with k1_kernel_semantics():
        fj = [j_frame.build_frame_nosegnet(
            statics, jnp.asarray(left[i]), jnp.asarray(right[i]),
            jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent))
            for i in range(N_FRAMES)]
    ft = [t_frame.Frame(*(torch.from_numpy(np.array(x)) for x in f))
          for f in fj]
    return fj, ft, gt


@pytest.fixture(scope="module")
def parity_run(frames):
    fj, ft, gt = frames
    js = JSystem(cfg=make_cfg(j_config), **_system_kwargs())
    ts = System(cfg=make_cfg(t_config), device=CPU, **_system_kwargs())
    for s, seq in ((js, fj), (ts, ft)):
        for i, f in enumerate(seq):
            s.track_frame(f, i * 0.1)
            s.mapper.drain(s.tracker)
    return js, ts, gt


def test_session_parity_poses(parity_run):
    js, ts, _ = parity_run
    pj, pt = js.frame_poses(), ts.frame_poses()
    assert pj.shape == pt.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0, atol=1e-4)
    for i in range(N_FRAMES):
        c = (np.trace(pt[i, :3, :3] @ pj[i, :3, :3].T) - 1.0) / 2.0
        assert np.arccos(np.clip(c, -1.0, 1.0)) < 1e-3, i


def test_session_parity_counts(parity_run):
    js, ts, gt = parity_run
    assert ts.n_lost() == js.n_lost() == 0
    assert ts.map.n_keyframes == js.map.n_keyframes >= 3
    n_ba = ts.timer.counts["map.ba_apply"]
    assert n_ba == js.timer.counts["map.ba_apply"] >= 1
    assert ts.mapper.ba_solves == n_ba
    assert abs(ts.map.n_points - js.map.n_points) <= 0.01 * js.map.n_points
    live_t = int(ts.map.pt_valid[: ts.map.n_points].sum())
    live_j = int(js.map.pt_valid[: js.map.n_points].sum())
    assert abs(live_t - live_j) <= 0.01 * live_j
    assert synthetic.ate_rmse(ts.frame_poses(), gt) < 0.1
    # the mapper ran its K2 fusion searches: forward into each
    # neighbour and the reverse search, for each keyframe with one
    assert ts.mapper.fuse_searches >= 2


@pytest.fixture(scope="module")
def compact_system(frames):
    _, ft, gt = frames
    system = System(cfg=make_cfg(t_config), device=CPU, **_system_kwargs())
    for i in range(6):
        system.track_frame(ft[i], i * 0.1)
    system.flush()
    return system, ft, gt


def test_compaction_preserves_tracking_and_geometry(compact_system):
    system, ft, gt = compact_system
    m, tr = system.map, system.tracker
    assert m.n_keyframes >= 2 and m.n_points > 100

    # cull ~30% of the points and (if possible) one mid keyframe
    rng = np.random.default_rng(0)
    live = np.where(m.pt_valid[: m.n_points])[0]
    kill = rng.choice(live, size=len(live) // 3, replace=False)
    m.pt_valid[kill] = False
    tr.dmap = device_map.invalidate_points(
        tr.dmap, torch.from_numpy(kill.astype(np.int32)))
    killed_kf = None
    if m.n_keyframes >= 4:
        killed_kf = 1
        m.kf_valid[killed_kf] = False
        m._obs_dirty = True

    n_pt_before = int(m.pt_valid[: m.n_points].sum())
    n_kf_before = int(m.kf_valid[: m.n_keyframes].sum())
    poses_before = system.frame_poses().copy()
    obs_before = len(m.observations())

    stats = compact_mod.compact_map(system)
    assert stats["points_freed"] >= len(kill)
    if killed_kf is not None:
        assert stats["keyframes_freed"] >= 1

    # live counts preserved, stores contiguous
    assert m.n_points == n_pt_before
    assert m.pt_valid[: m.n_points].all()
    assert m.n_keyframes == n_kf_before
    assert m.kf_valid[: m.n_keyframes].all()
    assert all(m.kf_data[k] is not None for k in range(m.n_keyframes))
    # observation table: no dangling ids
    obs = m.observations()
    assert len(obs) <= obs_before
    assert (obs[:, 0] < m.n_keyframes).all() and (obs[:, 0] >= 0).all()
    assert (obs[:, 1] < m.n_points).all() and (obs[:, 1] >= 0).all()
    # device mirror in lockstep
    dm_valid = tr.dmap.pt_valid.numpy()
    assert int(tr.dmap.n_points) == m.n_points
    np.testing.assert_array_equal(dm_valid[: m.n_points],
                                  m.pt_valid[: m.n_points])
    assert not dm_valid[m.n_points:].any()
    # spanning tree stays time-ordered
    for k in range(1, m.n_keyframes):
        assert -1 <= m.kf_parent[k] < k

    # trajectory re-chaining survives (same world-frame poses)
    poses_after = system.frame_poses()
    assert poses_after.shape == poses_before.shape
    np.testing.assert_allclose(poses_after[:, :3, 3], poses_before[:, :3, 3],
                               atol=5e-2)

    # tracking continues over the compacted map
    ok = sum(system.track_frame(ft[i], i * 0.1) is not None
             for i in range(6, N_FRAMES))
    system.flush()
    assert ok >= 3
    assert not any(r.lost for r in tr.trajectory[-3:])


def test_should_compact_thresholds():
    class Obj:
        pass

    s, m = Obj(), Obj()
    s.map = m
    m.max_points, m.max_keyframes = 100, 10
    m.n_points, m.n_keyframes = 50, 5
    m.pt_valid = np.ones(100, bool)
    m.kf_valid = np.ones(10, bool)
    assert not compact_mod.should_compact(s)
    m.n_points = 90
    m.pt_valid[:30] = False  # 1/3 dead
    assert compact_mod.should_compact(s)


def test_system_needs_a_card_or_a_cpu_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        System(cfg=make_cfg(t_config))
