"""The loop closer's full-map BA, port against JAX package, on a problem
assembled by ``ba_build.build_problem`` from a map: 6 keyframes along a
line, 400 points at 4-12 m each seen by every keyframe whose image holds
it (stereo, 0.3 px noise, 3% gross outliers), poses perturbed by 2 cm /
0.6 deg and points by 5 cm, keyframe 0 fixed. The JAX map is copied into
a port map, so both packages assemble from the same state.

Tolerances, float32 on the CPU: the assembled problems equal; the dense
Schur solve (``local_ba.global_bundle_adjustment``, 10 iterations, robust
kernel off) and the PCG solve (``gba_cg``: begin, 10 steps, finish)
each give keyframe poses within 1e-4 (matrix entries; measured 7.4e-5),
equal inlier masks and the final chi2 within rtol 1e-6. Points: 99%
within 1e-3 m and all within 2e-2 m (measured 6.3e-4 and 1.1e-2 m
dense, 5.5e-4 and 5.8e-3 m PCG). The points cannot agree to 1e-4 m: one
iteration from identical inputs already leaves 3e-4 m (the float32 sums
of the two frameworks differ in order, and a point at 12 m from a 0.5 m
baseline is ill-conditioned along its depth), and once chi2 has
converged the LM keeps accepting steps whose chi2 change is float32
noise, so each framework walks its far points along the flat directions
differently. Each float32 solve lies as far from the port's float64
solve on the same problem as from the other (``test_gba_near_float64``:
poses within 2e-4, points within 2e-2 m). ``apply_solution`` writes the
same poses and erases the same observations in both maps, and each map
then holds its own solve's points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.config import SystemConfig as JConfig
from sivo_tpu.geometry import se3 as j_se3
from sivo_tpu.geometry.projection import CameraParams as JCam
from sivo_tpu.optim import ba_build as j_build
from sivo_tpu.optim import gba_cg as j_cg
from sivo_tpu.optim import local_ba as j_ba
from sivo_tpu.runtime.map_state import KeyFrameData, MapState
from sivo_tpu.runtime.tracking import Tracker as JTracker
from sivo_tpu_torch.geometry.projection import CameraParams as TCam
from sivo_tpu_torch.optim import ba_build as t_build
from sivo_tpu_torch.optim import gba_cg as t_cg
from sivo_tpu_torch.optim import local_ba as t_ba
from sivo_tpu_torch.runtime.tracking import Tracker as TTracker
from tests.test_torch_loopclosing import port_config, port_map

torch.set_num_threads(2)
CPU = torch.device("cpu")
J_CAM = JCam(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=250.0, width=640,
             height=480)
T_CAM = TCam(*J_CAM)
K, P, N_KP = 6, 400, 512
CAPS = (8, 1024, 4096)  # keyframes, points, observations
SF = 1.2


def make_map():
    """A JAX MapState of K keyframes and P points, observed with noise."""
    rng = np.random.default_rng(5)
    gt = []
    for k in range(K):
        xi = np.zeros(6, np.float32)
        xi[2] = -0.4 * k
        xi[:3] += rng.normal(0, 0.05, 3)
        gt.append(np.asarray(j_se3.exp(jnp.asarray(xi))))
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 12, P)], -1).astype(np.float32)
    m = MapState(max_keyframes=16, max_points=2048, kp_capacity=N_KP)
    obs = []
    for k in range(K):
        xc = pts @ gt[k][:3, :3].T + gt[k][:3, 3]
        u = J_CAM.fx * xc[:, 0] / xc[:, 2] + J_CAM.cx
        v = J_CAM.fy * xc[:, 1] / xc[:, 2] + J_CAM.cy
        ur = u - J_CAM.bf / xc[:, 2]
        vis = (xc[:, 2] > 1) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
        level = rng.integers(0, 3, N_KP).astype(np.int32)
        xy = np.zeros((N_KP, 2), np.float32)
        u_right = np.full(N_KP, -1.0, np.float32)
        ids = np.where(vis)[0]
        noise = rng.normal(0, 0.3, (len(ids), 3))
        out = rng.uniform(size=len(ids)) < 0.03
        noise[out] += rng.uniform(20, 40, (int(out.sum()), 3))
        xy[ids] = np.stack([u[ids], v[ids]], -1) + noise[:, :2]
        u_right[ids] = ur[ids] + noise[:, 2]
        data = KeyFrameData(
            frame_id=k, timestamp=0.1 * k, xy=xy, level=level,
            angle=np.zeros(N_KP, np.float32),
            desc_u8=np.zeros((N_KP, 32), np.uint8), desc_bits=None,
            u_right=u_right, depth=np.full(N_KP, -1.0, np.float32),
            sem_class=np.zeros(N_KP, np.uint8),
            sem_confidence=np.ones(N_KP, np.float32),
            sem_entropy=np.zeros(N_KP, np.float32),
            semantic=np.ones(N_KP, bool))
        xi = np.concatenate([rng.normal(0, 0.02, 3),
                             rng.normal(0, 0.01, 3)]).astype(np.float32)
        pose = gt[k] if k == 0 else (
            np.asarray(j_se3.exp(jnp.asarray(xi))) @ gt[k])
        m.add_keyframe(pose.astype(np.float32),
                       np.eye(6, dtype=np.float32) * 1e-4, data)
        obs.append((k, ids))
    noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    m.add_points(noisy, np.zeros((P, 32), np.uint8), np.zeros(P, np.uint8),
                 0, np.arange(P), np.zeros(P, np.int32))
    for k, ids in obs:
        if k > 0:
            m.add_observations(k, ids, ids)
    return m


@pytest.fixture(scope="module")
def maps():
    jm = make_map()
    return jm, port_map(jm)


def _built(maps):
    jm, tm = maps
    kfs = list(range(K))
    fixed = np.array([k == 0 for k in kfs])
    jb = j_build.build_problem(jm, kfs, fixed, *CAPS, SF)
    tb = t_build.build_problem(tm, kfs, fixed, *CAPS, SF, CPU)
    return jb, tb


@pytest.fixture(scope="module")
def solved(maps):
    (jp, jctx), (tp, tctx) = _built(maps)
    out = {"dense": (j_ba.global_bundle_adjustment(jp, J_CAM, iterations=10),
                     t_ba.global_bundle_adjustment(tp, T_CAM, iterations=10))}
    out["pcg"] = (_pcg(j_cg, jp, J_CAM), _pcg(t_cg, tp, T_CAM))
    return out, (jp, jctx), (tp, tctx)


def test_build_problem_matches_jax(maps):
    (jp, jctx), (tp, tctx) = _built(maps)
    for name, a, b in zip(jp._fields, jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert tctx["o"] == jctx["o"] > 1000
    np.testing.assert_array_equal(tctx["pt_ids"], jctx["pt_ids"])
    np.testing.assert_array_equal(tctx["rows"], jctx["rows"])


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_gba_matches_jax(solved, solver):
    out, (jp, _), _ = solved
    j, t = out[solver]
    np.testing.assert_allclose(t.kf_pose.numpy(), np.asarray(j.kf_pose),
                               rtol=0, atol=1e-4)
    dp = np.abs(t.pt_pos.numpy() - np.asarray(j.pt_pos)).max(-1)
    assert np.percentile(dp, 99) <= 1e-3 and dp.max() <= 2e-2, dp.max()
    np.testing.assert_array_equal(t.obs_inlier.numpy(),
                                  np.asarray(j.obs_inlier))
    np.testing.assert_allclose(float(t.chi2), float(j.chi2), rtol=1e-6)
    # the solve classified: the 3% gross outliers (and, with the robust
    # kernel off, the observations they drag) are out, most are in
    inl = t.obs_inlier.numpy()[np.asarray(jp.obs_valid)]
    assert 0.8 < inl.mean() < 0.97
    np.testing.assert_array_equal(t.kf_pose[0].numpy(),
                                  np.asarray(jp.kf_pose[0]))


def _pcg(cg, prob, cam):
    c = cg.gba_cg_begin(prob, cam)
    for _ in range(10):
        c = cg.gba_cg_step(c, prob, cam)
    return cg.gba_cg_finish(c, prob, cam)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_gba_near_float64(solved, solver):
    out, _, (tp, _) = solved
    p64 = t_ba.BAProblem(*(x.double() if x.dtype == torch.float32 else x
                           for x in tp))
    ref = (t_ba.global_bundle_adjustment(p64, T_CAM, iterations=10)
           if solver == "dense" else _pcg(t_cg, p64, T_CAM))
    for impl, res in zip(("jax", "torch"), out[solver]):
        np.testing.assert_allclose(np.asarray(res.kf_pose),
                                   ref.kf_pose.numpy(), rtol=0, atol=2e-4,
                                   err_msg=impl)
        dp = np.abs(np.asarray(res.pt_pos) - ref.pt_pos.numpy()).max()
        assert dp <= 2e-2, (impl, dp)


def test_apply_solution_matches_jax(maps, solved):
    out, (_, jctx), (_, tctx) = solved
    j, t = out["dense"]
    jm = make_map()  # fresh maps: the same state as the fixture's
    tm = port_map(jm)
    jtr = JTracker(cfg=JConfig(), map=jm)
    ttr = TTracker(cfg=port_config(JConfig()), map=tm, device=CPU)
    j_build.apply_solution(jm, jtr, jctx, {
        "kf_pose": np.asarray(j.kf_pose), "pt_pos": np.asarray(j.pt_pos),
        "inlier": np.asarray(j.obs_inlier)})
    t_build.apply_solution(tm, ttr, tctx, {
        "kf_pose": t.kf_pose.numpy(), "pt_pos": t.pt_pos.numpy(),
        "inlier": t.obs_inlier.numpy()}, t.pt_pos)
    np.testing.assert_allclose(tm.kf_pose[:K], jm.kf_pose[:K], rtol=0,
                               atol=1e-4)
    # each map holds its own solve's points (which agree as above)
    ids = tctx["pt_ids"]
    np.testing.assert_array_equal(tm.pt_pos[ids], t.pt_pos[: len(ids)])
    np.testing.assert_array_equal(jm.pt_pos[ids],
                                  np.asarray(j.pt_pos)[: len(ids)])
    np.testing.assert_array_equal(tm.observations(), jm.observations())
    assert len(tm.observations()) < tctx["o"]
    np.testing.assert_allclose(ttr.dmap.pt_pos[:P].numpy(), tm.pt_pos[:P],
                               rtol=0, atol=0)
