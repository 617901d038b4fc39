"""Parity of the port's geometry, selection math, pose LM, EPnP and
device-map updates with the JAX package on seeded numpy inputs, on the
CPU. All float32; tolerances are stated per test with their reason."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.geometry import projection as j_proj
from sivo_tpu.geometry import se3 as j_se3
from sivo_tpu.optim import pose_lm as j_lm
from sivo_tpu.place import pnp as j_pnp
from sivo_tpu.runtime import device_map as j_dm
from sivo_tpu.select import info as j_info
from sivo_tpu_torch.geometry import projection as t_proj
from sivo_tpu_torch.geometry import se3 as t_se3
from sivo_tpu_torch.optim import pose_lm as t_lm
from sivo_tpu_torch.place import pnp as t_pnp
from sivo_tpu_torch.runtime import device_map as t_dm
from sivo_tpu_torch.runtime.tracking import merge_local_ids
from sivo_tpu_torch.select import info as t_info

torch.set_num_threads(2)
CAM_ARGS = dict(fx=721.5377, fy=721.5377, cx=500.5593, cy=161.354,
                bf=387.5744, width=1024, height=352)
J_CAM = j_proj.CameraParams(**CAM_ARGS)
T_CAM = t_proj.CameraParams(**CAM_ARGS)


def _t(x):
    return torch.from_numpy(np.array(x))


def _twists(seed, n=64, rot=1.0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, 3:] *= rot
    xi[:4, 3:] = 0.0  # identity rotation: the Taylor branches
    xi[4:8, 3:] *= 1e-5
    return xi


def test_se3_matches_jax():
    xi = _twists(0)
    T_j, T_t = j_se3.exp(jnp.asarray(xi)), t_se3.exp(_t(xi))
    # float32 trig and 3x3 products: agreement to a few ulps of O(1)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=2e-6)
    np.testing.assert_allclose(t_se3.log(T_t).numpy(),
                               np.asarray(j_se3.log(T_j)), atol=2e-5)
    np.testing.assert_allclose(t_se3.inverse(T_t).numpy(),
                               np.asarray(j_se3.inverse(T_j)), atol=5e-6)
    np.testing.assert_allclose(t_se3.adjoint(T_t).numpy(),
                               np.asarray(j_se3.adjoint(T_j)), atol=5e-6)
    p = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_se3.transform(T_t, _t(p)).numpy(),
        np.asarray(j_se3.transform(T_j, jnp.asarray(p))), atol=5e-6)


def test_projection_matches_jax():
    rng = np.random.default_rng(2)
    pw = (rng.normal(size=(500, 3)) * [5, 2, 10] + [0, 0, 12]).astype(
        np.float32)
    normals = rng.normal(size=(500, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    dmin = rng.uniform(0.5, 3, 500).astype(np.float32)
    dmax = (dmin * rng.uniform(2, 40, 500)).astype(np.float32)
    T = np.asarray(j_se3.exp(jnp.asarray(_twists(3, 1, 0.05)[0:1])))[0]
    out_j = j_proj.frustum_check(J_CAM, jnp.asarray(T), jnp.asarray(pw),
                                 jnp.asarray(normals), jnp.asarray(dmin),
                                 jnp.asarray(dmax))
    out_t = t_proj.frustum_check(T_CAM, _t(T), _t(pw), _t(normals),
                                 _t(dmin), _t(dmax))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for a, b in zip(out_j[1:], out_t[1:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-4)
    lvl_j = j_proj.predict_scale(out_j[2], jnp.asarray(dmax), 1.2, 8)
    lvl_t = t_proj.predict_scale(out_t[2], _t(dmax), 1.2, 8)
    np.testing.assert_array_equal(lvl_t.numpy(), np.asarray(lvl_j))
    uv = rng.uniform(0, 500, (50, 2)).astype(np.float32)
    depth = rng.uniform(1, 40, 50).astype(np.float32)
    np.testing.assert_allclose(
        t_proj.unproject_stereo(T_CAM, _t(uv), _t(depth)).numpy(),
        np.asarray(j_proj.unproject_stereo(J_CAM, jnp.asarray(uv),
                                           jnp.asarray(depth))), rtol=1e-6)


def _selection_inputs(seed, n=700):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 40, n)], 1).astype(np.float32)
    sigma2 = (1.44 ** rng.integers(0, 8, n)).astype(np.float32)
    ent = rng.uniform(0, 2, n).astype(np.float32)
    cand = rng.uniform(size=n) < 0.6
    cov = np.eye(6, dtype=np.float32) * 1e-3
    cov[:3, :3] += 2e-3
    return pts, sigma2, ent, cand, cov


def test_entropy_scores_match_jax():
    pts, sigma2, ent, _, cov = _selection_inputs(4)
    sj = j_info.entropy_reduction_stereo(
        jnp.asarray(cov), jnp.asarray(pts), jnp.asarray(sigma2),
        jnp.asarray(ent), 721.5, 721.5, 0.537)
    st = t_info.entropy_reduction_stereo(_t(cov), _t(pts), _t(sigma2),
                                         _t(ent), 721.5, 721.5, 0.537)
    # slogdet of a float32 3x3 (LU in both libraries, other pivot and sum
    # orders): measured 2.5e-4 bits worst case on scores of 6-10 bits
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=5e-4)


@pytest.mark.parametrize("th", [4.0, 9.0])
def test_sequential_selection_matches_jax(th):
    """The greedy walk (more than SEL_CAP candidates, so the cap binds):
    the same accepts, covariance within float32 round-off."""
    pts, sigma2, ent, cand, cov = _selection_inputs(5)
    sel_j, cov_j, last_j = j_info.sequential_selection_stereo(
        jnp.asarray(cov), jnp.asarray(pts), jnp.asarray(sigma2),
        jnp.asarray(ent), jnp.asarray(cand), jnp.float32(th),
        721.5, 721.5, 0.537)
    sel_t, cov_t, last_t = t_info.sequential_selection_stereo(
        _t(cov), _t(pts), _t(sigma2), _t(ent), _t(cand), th,
        721.5, 721.5, 0.537)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert float(last_t) == float(last_j)
    # hundreds of float32 Kalman updates: the small off-diagonal terms
    # carry cancellation error, so compare against the matrix's scale
    # (measured: 3e-9 on a diagonal of 1e-5)
    scale = float(np.abs(np.asarray(cov_j)).max())
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-3,
                               atol=1e-3 * scale)
    assert 10 < int(sel_t.sum()) < int(cand.sum())


def _pose_problem(seed, n=400):
    rng = np.random.default_rng(seed)
    T_true = np.asarray(j_se3.exp(jnp.asarray(_twists(seed, 1, 0.1))))[0]
    pc = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 30, n)], 1)
    pw = (np.linalg.inv(T_true) @ np.c_[pc, np.ones(n)].T).T[:, :3]
    uvr = np.asarray(j_proj.project_stereo(J_CAM, jnp.asarray(pc,
                                                              jnp.float32)))
    uvr = uvr + rng.normal(0, 0.7, uvr.shape)
    out = rng.uniform(size=n) < 0.1  # outliers
    uvr[out, :2] += rng.uniform(-40, 40, (out.sum(), 2))
    level = rng.integers(0, 8, n)
    obs = dict(points=pw.astype(np.float32), uvr=uvr.astype(np.float32),
               sigma2=(1.44 ** level).astype(np.float32),
               is_stereo=rng.uniform(size=n) < 0.7,
               valid=rng.uniform(size=n) < 0.95)
    T0 = T_true.copy()
    T0[:3, 3] += [0.05, -0.03, 0.1]
    return T_true, T0.astype(np.float32), obs


def test_pose_lm_matches_jax():
    T_true, T0, obs = _pose_problem(6)
    rj = j_lm.optimize_pose_impl(
        jnp.asarray(T0), j_lm.PoseObservations(
            **{k: jnp.asarray(v) for k, v in obs.items()}), J_CAM)
    rt = t_lm.optimize_pose(
        _t(T0), t_lm.PoseObservations(**{k: _t(v) for k, v in obs.items()}),
        T_CAM)
    # 4x10 float32 LM steps from the same start: same optimum to ~1e-5 m
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-4)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.covariance.numpy(),
                               np.asarray(rj.covariance), rtol=1e-2,
                               atol=1e-10)
    assert np.abs(rt.pose.numpy()[:3, 3] - T_true[:3, 3]).max() < 0.01


def test_epnp_matches_jax():
    """The deterministic EPnP core on fixed minimal sets (the RANSAC
    draws differ by design: jax.random vs torch.Generator)."""
    T_true, _, obs = _pose_problem(7, n=96)
    pw = obs["points"].reshape(16, 6, 3)
    uv = obs["uvr"][:, :2].reshape(16, 6, 2)
    Tj = np.asarray(j_pnp._epnp(jnp.asarray(pw), jnp.asarray(uv), J_CAM))
    Tt = t_pnp._epnp(_t(pw), _t(uv), T_CAM).numpy()
    # eigen-decompositions of near-degenerate 12x12 systems in float32
    # differ by solver; compare the estimates where JAX's is near truth
    good = np.abs(Tj[:, :3, 3] - T_true[:3, 3]).max(1) < 0.5
    assert good.sum() >= 8
    np.testing.assert_allclose(Tt[good], Tj[good], atol=5e-2)


def test_kabsch_discards_a_non_finite_hypothesis():
    """A hypothesis whose camera points are not finite (EPnP on a
    degenerate set) comes out NaN, as in the JAX package, instead of
    raising in the CPU SVD; the others are solved as before."""
    rng = np.random.default_rng(4)
    src = rng.uniform(-2, 2, (2, 6, 3)).astype(np.float32)
    T = np.asarray(j_se3.exp(jnp.asarray([0.1, -0.2, 0.3, 0.05, -0.1, 0.2],
                                         jnp.float32)))
    dst = src @ T[:3, :3].T + T[:3, 3]
    dst[1, 2] = np.nan
    got = t_pnp._kabsch(_t(src), _t(dst)).numpy()
    want = np.asarray(j_pnp._kabsch(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], T, rtol=0, atol=1e-5)
    assert not np.isfinite(want[1]).all()
    assert np.isnan(got[1]).all()


def test_epnp_discards_a_set_with_a_non_finite_point(monkeypatch):
    """A minimal set holding a point with no finite position (a map
    point gone non-finite) gives a NaN EPnP hypothesis, as in the JAX
    package, where the port's eigh raised on it; the other sets are
    solved as the JAX package solves them, and the RANSAC keeps their
    pose."""
    T_true, _, obs = _pose_problem(5, n=200)
    rng = np.random.default_rng(5)
    pw, uv = obs["points"].copy(), obs["uvr"][:, :2].copy()
    pw[0] = np.nan
    sets = np.stack([np.arange(6)] + [rng.choice(np.arange(1, 200), 6,
                                                 replace=False)
                                      for _ in range(15)])
    Tj = np.asarray(j_pnp._epnp(jnp.asarray(pw[sets]),
                                jnp.asarray(uv[sets]), J_CAM))
    Tt = t_pnp._epnp(_t(pw[sets]), _t(uv[sets]), T_CAM).numpy()
    assert not np.isfinite(Tj[0]).all() and np.isnan(Tt[0]).all()
    # as in test_epnp_matches_jax: the sets whose JAX estimate is near
    # the truth (near-degenerate float32 eigen-solves differ by solver)
    good = np.abs(Tj[1:, :3, 3] - T_true[:3, 3]).max(1) < 0.5
    assert good.sum() >= 8
    np.testing.assert_allclose(Tt[1:][good], Tj[1:][good], atol=5e-2)
    monkeypatch.setattr(t_pnp, "draw_sets",
                        lambda valid, generator, n_hypotheses: _t(sets))
    valid = obs["valid"].copy()
    valid[0] = False
    res = t_pnp.ransac_pnp(_t(pw), _t(uv), _t(obs["sigma2"]), _t(valid),
                           None, T_CAM, n_hypotheses=16)
    assert bool(res.ok) and np.isfinite(res.pose.numpy()).all()
    np.testing.assert_allclose(res.pose.numpy()[:3, 3], T_true[:3, 3],
                               atol=0.05)


def test_ransac_pnp_finds_the_pose():
    T_true, _, obs = _pose_problem(8)
    g = torch.Generator().manual_seed(0)
    res = t_pnp.ransac_pnp(_t(obs["points"]), _t(obs["uvr"][:, :2]),
                           _t(obs["sigma2"]), _t(obs["valid"]), g, T_CAM)
    assert bool(res.ok)
    np.testing.assert_allclose(res.pose.numpy()[:3, 3], T_true[:3, 3],
                               atol=0.05)


def test_device_map_updates_match_jax():
    rng = np.random.default_rng(9)
    cap, n = 64, 40
    dj = j_dm.make_device_map(cap)
    dt = t_dm.make_device_map(cap, torch.device("cpu"))
    for step in range(3):
        sel = rng.uniform(size=n) < 0.6
        xw = rng.normal(size=(n, 3)).astype(np.float32) * 5
        desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        cls = rng.integers(0, 12, n).astype(np.uint8)
        lvl = rng.integers(0, 8, n).astype(np.int32)
        center = rng.normal(size=3).astype(np.float32)
        dj, ids_j = j_dm.add_points(dj, *map(jnp.asarray, (
            sel, xw, desc, cls, lvl, center)))
        dt, ids_t = t_dm.add_points(dt, *map(_t, (sel, xw, desc, cls, lvl,
                                                  center)))
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        pt_idx = np.where(rng.uniform(size=n) < 0.5,
                          rng.permutation(cap)[:n], -1).astype(np.int32)
        obs_desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        dj = j_dm.observe_points(dj, jnp.asarray(pt_idx), jnp.asarray(cls),
                                 jnp.asarray(obs_desc))
        dt = t_dm.observe_points(dt, _t(pt_idx), _t(cls), _t(obs_desc))
    for name in dj._fields:
        np.testing.assert_allclose(getattr(dt, name).numpy(),
                                   np.asarray(getattr(dj, name)),
                                   rtol=1e-6, err_msg=name)


def test_merge_local_ids_is_a_stable_compaction():
    new = torch.tensor([5, -1, 7, -1, 9], dtype=torch.int32)
    prev = torch.tensor([1, 2, -1, 3, -1, -1], dtype=torch.int32)
    out = merge_local_ids(new, prev)
    np.testing.assert_array_equal(out.numpy(), [5, 7, 9, 1, 2, 3])
