"""The port's loop closer (``sivo_tpu_torch/runtime/loopclosing.py``)
against the JAX package's on the drifted out-and-back map of
tests/test_loopclosing.py (320x192, 13 keyframes whose x drifts 0.04 m
per keyframe; its keypoints described by the JAX package's K1 with the
kernel's semantics, as the port's K1, ``tests/jax_kernel_semantics.py``):
the JAX map, device mirrors and vocabulary are copied into the port's
before the JAX closer runs, and both ``process_keyframe`` loops run over
every keyframe.

Parity, float32 on the CPU: the loop closes at the same keyframe against
the same candidate (exact), with the same loop edges; the loop edge's
transform (the Sim3 g12 as SE3, fixed scale) within 1e-4, and every
corrected keyframe's centre (m) and rotation entries within 1e-4
(measured 1.2e-6 and 4.8e-7 with K1's semantics). The Sim3 RANSAC's
minimal sets are the JAX package's own (``jax.random`` draws keyed by
the keyframe index, recomputed here from the seed of the port's
generator), as in tests/test_torch_sim3.py; the port's own draws are
run too and must close the loop and halve the late drift, the JAX
test's own check.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.optim import sim3_opt
from sivo_tpu_torch.place import vocabulary as t_voc
from sivo_tpu_torch.runtime import device_map as t_dm
from sivo_tpu_torch.runtime import kf_store as t_kfs
from sivo_tpu_torch.runtime import loopclosing as t_lc
from sivo_tpu_torch.runtime import map_state as t_ms
from sivo_tpu_torch.runtime.tracking import Tracker, make_camera
from sivo_tpu.runtime.loopclosing import LoopCloser as JLoopCloser
from tests.jax_kernel_semantics import k1_kernel_semantics
from tests.test_loopclosing import loop_setup  # noqa: F401 (fixture)
from tests.test_torch_sim3 import _jax_sets

torch.set_num_threads(2)
CPU = torch.device("cpu")


def port_config(cfg_j):
    """The port's SystemConfig with the JAX one's values."""
    cfg = t_config.SystemConfig()
    return dataclasses.replace(cfg, **{
        f.name: type(getattr(cfg, f.name))(
            **dataclasses.asdict(getattr(cfg_j, f.name)))
        for f in dataclasses.fields(cfg)})


def port_map(jm):
    """A port MapState holding a copy of the JAX map's state."""
    tm = t_ms.MapState(max_keyframes=jm.max_keyframes,
                       max_points=jm.max_points, kp_capacity=jm.kp_capacity,
                       n_levels=jm.n_levels, scale_factor=jm.scale_factor)
    for name, value in vars(jm).items():
        if name != "kf_data":
            setattr(tm, name, copy.deepcopy(value))
    tm.kf_data = [None if d is None else t_ms.KeyFrameData(**{
        f.name: copy.deepcopy(getattr(d, f.name))
        for f in dataclasses.fields(d)}) for d in jm.kf_data]
    return tm


def port_tracker(cfg, tm, jtracker):
    """A port Tracker whose device map and keyframe store hold copies of
    the JAX tracker's."""
    tr = Tracker(cfg=cfg, map=tm, device=CPU)

    def t(x):
        return torch.from_numpy(np.array(x))

    tr.dmap = t_dm.DeviceMap(*(t(x) for x in jtracker.dmap))
    tr.kf_store = t_kfs.DeviceKFStore(*(t(x) for x in jtracker.kf_store))
    return tr


def port_vocabulary(vj):
    return t_voc.Vocabulary(
        k=vj.k, depth=vj.depth,
        centroids=t_voc._pack_bits_np(np.asarray(vj.centroids)),
        children=np.asarray(vj.children), word_id=np.asarray(vj.word_id),
        word_weights=np.asarray(vj.word_weights), n_words=vj.n_words)


def _run(lc, tracker, n_kf):
    for k in range(n_kf):
        if lc.process_keyframe(tracker, k):
            return k
    return None


def _jax_draw_sets(valid, generator, n_hypotheses=128):
    """The JAX package's minimal sets for the keyframe the port's
    generator was seeded with (the JAX closer keys jax.random with it)."""
    sets = _jax_sets(generator.initial_seed(), valid.numpy(), n_hypotheses)
    return torch.from_numpy(sets.astype(np.int64))


@pytest.fixture(scope="module")
def k1_loop_setup(request):
    """tests/test_loopclosing.py's map, built with K1's semantics."""
    with k1_kernel_semantics():
        return request.getfixturevalue("loop_setup")


@pytest.fixture(scope="module")
def closed(k1_loop_setup):
    cfg_j, cam_j, jm, jtr, vj, gt, kf_poses = k1_loop_setup
    cfg = port_config(cfg_j)
    n_kf = jm.n_keyframes
    # the port's copies first: the JAX closer edits its map in place
    t_own = (port_map(jm), None)
    t_par = port_map(jm)
    own_tr = port_tracker(cfg, t_own[0], jtr)
    par_tr = port_tracker(cfg, t_par, jtr)
    vt = port_vocabulary(vj)

    lc_j = JLoopCloser(cfg=cfg_j, map=jm, cam=cam_j, voc=vj)
    at_j = _run(lc_j, jtr, n_kf)

    lc_t = t_lc.LoopCloser(cfg=cfg, map=t_par, cam=make_camera(cfg), voc=vt)
    mp = pytest.MonkeyPatch()
    mp.setattr(sim3_opt, "draw_sets", _jax_draw_sets)
    try:
        at_t = _run(lc_t, par_tr, n_kf)
    finally:
        mp.undo()

    lc_own = t_lc.LoopCloser(cfg=cfg, map=t_own[0], cam=make_camera(cfg),
                             voc=vt)
    at_own = _run(lc_own, own_tr, n_kf)
    return dict(gt=gt, kf_poses=kf_poses, n_kf=n_kf,
                jax=(lc_j, jm, at_j), port=(lc_t, t_par, at_t),
                own=(lc_own, t_own[0], at_own))


def test_loop_closes_at_the_same_keyframe_and_candidate(closed):
    lc_j, _, at_j = closed["jax"]
    lc_t, _, at_t = closed["port"]
    assert at_j is not None and at_t == at_j
    assert lc_t.loops_closed == lc_j.loops_closed == 1
    ev_j, ev_t = lc_j.loop_events[0], lc_t.loop_events[0]
    assert (ev_t["kf"], ev_t["cand"]) == (ev_j["kf"], ev_j["cand"])
    assert [(i, j) for i, j, _ in lc_t.loop_edges] == [
        (i, j) for i, j, _ in lc_j.loop_edges]
    # the loop closer's searches: brute force, guided Sim3, loop fuse
    assert lc_t.k2_searches >= 4
    assert lc_t.k2_launches == 0  # CPU tensors take the plain path


def test_loop_edge_g12_matches_jax(closed):
    lc_j, lc_t = closed["jax"][0], closed["port"][0]
    for (_, _, Tj), (_, _, Tt) in zip(lc_j.loop_edges, lc_t.loop_edges):
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-4)


def test_corrected_keyframe_poses_match_jax(closed):
    _, jm, _ = closed["jax"]
    _, tm, _ = closed["port"]
    n = closed["n_kf"]
    assert jm.n_keyframes == tm.n_keyframes == n
    cj = np.stack([-p[:3, :3].T @ p[:3, 3] for p in jm.kf_pose[:n]])
    ct = np.stack([-p[:3, :3].T @ p[:3, 3] for p in tm.kf_pose[:n]])
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_pose[:n, :3, :3],
                               jm.kf_pose[:n, :3, :3], rtol=0, atol=1e-4)


@pytest.mark.parametrize("run", ["port", "own"])
def test_late_drift_is_halved(closed, run):
    """tests/test_loopclosing.py's check, on the port with the JAX
    package's minimal sets and with its own draws."""
    _, m, at = closed[run]
    gt, kf_poses, n = closed["gt"], closed["kf_poses"], closed["n_kf"]
    assert at is not None, "no loop closed"

    def err(pose, k):
        return np.linalg.norm((pose @ np.linalg.inv(gt[k]))[:3, 3])

    before = np.array([err(kf_poses[k], k) for k in range(n)])
    after = np.array([err(m.kf_pose[k], k) for k in range(n)])
    late = slice(at - 3, n)
    assert after[late].mean() < 0.5 * before[late].mean(), (before, after)
    assert after.max() < 0.5 * before.max()


def test_bow_revisit_scores(closed):
    lc_t = closed["port"][0]
    n = closed["n_kf"]
    b0, b_last, b_mid = lc_t._bow(0), lc_t._bow(n - 1), lc_t._bow(6)
    assert t_voc.l1_score(b0, b_last) > t_voc.l1_score(b0, b_mid)
    lc_j = closed["jax"][0]
    assert lc_j._bow(0) == b0


def test_jax_sets_helper_is_keyed_like_the_closer():
    valid = torch.zeros(40, dtype=torch.bool)
    valid[:25] = True
    gen = torch.Generator()
    gen.manual_seed(7)
    sets = _jax_draw_sets(valid, gen).numpy()
    g = jax.random.gumbel(jax.random.key(7), (128, 40))
    want = np.asarray(jax.lax.top_k(np.where(valid.numpy()[None], g,
                                             -np.inf), 3)[1])
    np.testing.assert_array_equal(sets, want)
    assert (sets < 25).all()
