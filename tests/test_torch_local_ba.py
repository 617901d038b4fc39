"""Local BA: the port (``sivo_tpu_torch/optim/local_ba.py``) against the
JAX package on the problems of tests/test_local_ba.py (K = 8 keyframes,
P = 512 points, stereo observations with 0.1-0.2 px noise, keyframe 0
fixed), without and with 10% gross outliers.

Parity tolerances, float32 on the CPU (the two frameworks sum the
scattered blocks in different orders): keyframe poses within 1e-4
(matrix entries; measured <= 1.6e-6), ``obs_inlier`` equal, the final
chi2 within rtol 1e-5, the newest-keyframe covariance within rtol 1e-2
(measured 3e-5 of its largest entry). Points: 99% within 2.5e-3 m and
all within 1e-2 m (measured 1.6e-3 and 6.9e-3 m). The points differ
along the depth of the far ones (8-30 m from a 0.5 m baseline): after
the first LM round they agree to 5e-5 m, then the ten undamped
iterations move them along directions where the objective is flat
below float32 resolution (the chi2 agrees to 1e-6 relative), so the
summation order decides where they stop: each float32 solve, the JAX
package's and the port's, lies as far from the port's solve in float64
on the same problem (``test_float32_solves_near_float64``: points
within 1e-2 m, poses within 1e-5).

The four properties of tests/test_local_ba.py (recovery, fixed gauge,
outlier demotion, covariance) are parametrised over both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.optim import local_ba as j_ba
from sivo_tpu_torch.geometry.projection import CameraParams
from sivo_tpu_torch.optim import local_ba as t_ba
from tests.test_local_ba import CAM as J_CAM
from tests.test_local_ba import K, make_problem, pose_errors

torch.set_num_threads(2)
T_CAM = CameraParams(*J_CAM)
# name -> (make_problem kwargs, newest keyframe)
PROBLEMS = {"clean": (dict(noise=0.1), K - 1),
            "gauge": (dict(), 1),
            "outliers": (dict(noise=0.1, outlier_frac=0.1), K - 1)}


def _as_numpy(res):
    return {k: np.asarray(v) for k, v in res._asdict().items()}


@pytest.fixture(scope="module")
def solved():
    """{name: (problem, ground-truth poses and points, outlier mask,
    {"jax": result, "torch": result})}, results as numpy dicts."""
    out = {}
    for name, (kw, newest) in PROBLEMS.items():
        prob, gt_poses, gt_pts, mask_out = make_problem(**kw)
        j_res = j_ba.local_bundle_adjustment(prob, jnp.int32(newest), J_CAM)
        t_prob = t_ba.BAProblem(*(torch.from_numpy(np.array(x))
                                  for x in prob))
        t_res = t_ba.local_bundle_adjustment(t_prob, newest, T_CAM)
        out[name] = (prob, gt_poses, gt_pts, mask_out,
                     {"jax": _as_numpy(j_res), "torch": _as_numpy(t_res)})
    return out


@pytest.mark.parametrize("name", ["clean", "outliers"])
def test_port_matches_jax(solved, name):
    _, _, _, _, res = solved[name]
    j, t = res["jax"], res["torch"]
    np.testing.assert_allclose(t["kf_pose"], j["kf_pose"], rtol=0, atol=1e-4)
    dp = np.abs(t["pt_pos"] - j["pt_pos"])
    assert np.percentile(dp, 99) <= 2.5e-3 and dp.max() <= 1e-2, dp.max()
    np.testing.assert_array_equal(t["obs_inlier"], j["obs_inlier"])
    np.testing.assert_allclose(t["newest_cov"], j["newest_cov"], rtol=1e-2,
                               atol=1e-12)
    np.testing.assert_allclose(t["chi2"], j["chi2"], rtol=1e-5)


@pytest.mark.parametrize("name", ["clean", "outliers"])
def test_float32_solves_near_float64(solved, name):
    prob, _, _, _, res = solved[name]
    newest = PROBLEMS[name][1]
    p64 = t_ba.BAProblem(*(
        torch.from_numpy(np.array(x, np.float64 if np.asarray(x).dtype
                                  == np.float32 else None))
        for x in prob))
    ref = _as_numpy(t_ba.local_bundle_adjustment(p64, newest, T_CAM))
    for impl in ("jax", "torch"):
        np.testing.assert_allclose(res[impl]["kf_pose"], ref["kf_pose"],
                                   rtol=0, atol=1e-5, err_msg=impl)
        dp = np.abs(res[impl]["pt_pos"] - ref["pt_pos"]).max()
        assert dp <= 1e-2, (impl, dp)


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_ba_recovers_poses_and_points(solved, impl):
    prob, gt_poses, gt_pts, _, res = solved["clean"]
    errs = pose_errors(res[impl]["kf_pose"], gt_poses)
    init_errs = pose_errors(np.asarray(prob.kf_pose), gt_poses)
    assert errs.max() < 0.2 * init_errs.max(), (errs, init_errs)
    assert errs.max() < 5e-3, errs
    pt_err = np.linalg.norm(res[impl]["pt_pos"] - gt_pts, axis=-1)
    assert np.median(pt_err) < 0.05, np.median(pt_err)


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_ba_gauge_fixed_kf_unchanged(solved, impl):
    prob, _, _, _, res = solved["gauge"]
    np.testing.assert_allclose(res[impl]["kf_pose"][0],
                               np.asarray(prob.kf_pose[0]), atol=1e-7)


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_ba_outlier_demotion(solved, impl):
    _, gt_poses, _, mask_out, res = solved["outliers"]
    assert res[impl]["obs_inlier"][mask_out].mean() < 0.05
    errs = pose_errors(res[impl]["kf_pose"], gt_poses)
    assert errs.max() < 1e-2, errs


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_ba_marginal_covariance_sane(solved, impl):
    cov = solved["clean"][4][impl]["newest_cov"]
    assert np.isfinite(cov).all()
    np.testing.assert_allclose(cov, cov.T, atol=1e-8)
    assert (np.linalg.eigvalsh(cov) > 0).all()
    assert np.trace(cov) < 1e-3, np.trace(cov)
