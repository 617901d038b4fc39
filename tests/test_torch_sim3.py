"""The port's Sim3 geometry and Sim3 solvers against the JAX package on
the CPU, on seeded numpy inputs (float32).

Tolerances: the Sim3 ops and Horn's alignment agree to atol 1e-5 (3x3
products, trig, a 3x3 SVD); ``optimize_sim3`` and the RANSAC, fed the
JAX package's own minimal sets (``jax.random`` draws, recomputed here
from the same key), pick the same hypothesis, give equal inlier masks
and s, R, t within 1e-4 (ten Gauss-Newton steps of float32 normal
equations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.geometry import projection as j_proj
from sivo_tpu.geometry import se3 as j_se3
from sivo_tpu.geometry import sim3 as j_sim3
from sivo_tpu.optim import sim3_opt as j_opt
from sivo_tpu_torch.geometry import projection as t_proj
from sivo_tpu_torch.geometry import sim3 as t_sim3
from sivo_tpu_torch.optim import sim3_opt as t_opt

torch.set_num_threads(2)
CAM_ARGS = dict(fx=721.5377, fy=721.5377, cx=500.5593, cy=161.354,
                bf=387.5744, width=1024, height=352)
J_CAM = j_proj.CameraParams(**CAM_ARGS)
T_CAM = t_proj.CameraParams(**CAM_ARGS)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sims(seed, n=32):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[:4, 3:6] = 0.0  # identity rotation: the small-angle branches
    xi[4:8, 3:6] *= 1e-5
    xi[:, 6] *= 0.3
    return xi


def _close(gt, gj, atol):
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


def test_sim3_exp_log_compose_inverse_apply():
    xi = _sims(0)
    gj, gt = j_sim3.exp(jnp.asarray(xi)), t_sim3.exp(_t(xi))
    _close(gt, gj, 1e-5)
    np.testing.assert_allclose(t_sim3.log(gt).numpy(),
                               np.asarray(j_sim3.log(gj)), atol=1e-5)
    hj, ht = j_sim3.exp(jnp.asarray(_sims(1))), t_sim3.exp(_t(_sims(1)))
    _close(t_sim3.compose(gt, ht), j_sim3.compose(gj, hj), 1e-5)
    _close(t_sim3.inverse(gt), j_sim3.inverse(gj), 1e-5)
    x = np.random.default_rng(2).normal(0, 3, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_sim3.apply(gt, _t(x)).numpy(),
        np.asarray(j_sim3.apply(gj, jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(t_sim3.to_se3(gt).numpy(),
                               np.asarray(j_sim3.to_se3(gj)), atol=1e-5)
    T = np.asarray(j_se3.exp(jnp.asarray(xi[:, :6])))
    _close(t_sim3.from_se3(_t(T)), j_sim3.from_se3(jnp.asarray(T)), 0)
    _close(t_sim3.identity(), j_sim3.identity(), 0)


def test_sim3_log_at_identity_is_finite_and_zero():
    g = t_sim3.identity()
    xi = t_sim3.log(g)
    assert torch.equal(xi, torch.zeros(7))
    val, (jac,) = t_sim3.jacobians_at_zero(
        lambda d: t_sim3.log(t_sim3.compose(t_sim3.exp(d), g)), 1, (), 7,
        xi)
    assert torch.isfinite(jac).all()
    np.testing.assert_allclose(jac.numpy(), np.eye(7), atol=1e-6)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_alignment_matches_jax(fix_scale):
    rng = np.random.default_rng(3)
    p2 = rng.normal(0, 2, (64, 5, 3)).astype(np.float32)  # 64 batched sets
    g = j_sim3.exp(jnp.asarray(_sims(4, 64)))
    p1 = np.array(j_sim3.apply(
        j_sim3.Sim3(g.s[:, None], g.R[:, None], g.t[:, None]),
        jnp.asarray(p2)))
    p1 += rng.normal(0, 0.01, p1.shape).astype(np.float32)
    gj = j_sim3.horn_alignment(jnp.asarray(p1), jnp.asarray(p2), fix_scale)
    gt = t_sim3.horn_alignment(_t(p1), _t(p2), fix_scale)
    _close(gt, gj, 1e-5)


def _pair_problem(seed, n=96, n_out=20):
    """Matched camera-frame points of two keyframes related by a
    fixed-scale Sim3, pixel noise, and ``n_out`` gross outliers."""
    rng = np.random.default_rng(seed)
    pc2 = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 25, n)], -1).astype(np.float32)
    xi = np.array([0.3, -0.05, 0.4, 0.01, 0.08, -0.02, 0.0], np.float32)
    g = j_sim3.exp(jnp.asarray(xi))
    pc1 = np.array(j_sim3.apply(g, jnp.asarray(pc2)))
    uv1 = np.asarray(j_proj.project(J_CAM, jnp.asarray(pc1)))
    uv2 = np.asarray(j_proj.project(J_CAM, jnp.asarray(pc2)))
    uv1 = uv1 + rng.normal(0, 0.7, uv1.shape).astype(np.float32)
    uv2 = uv2 + rng.normal(0, 0.7, uv2.shape).astype(np.float32)
    pc1 = pc1 + rng.normal(0, 0.02, pc1.shape).astype(np.float32)
    pc1[:n_out] += rng.normal(0, 2.0, (n_out, 3)).astype(np.float32)
    level1 = rng.integers(0, 4, n)
    level2 = rng.integers(0, 4, n)
    s1 = (1.2 ** (2.0 * level1)).astype(np.float32)
    s2 = (1.2 ** (2.0 * level2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-7:] = False
    return pc1, pc2, uv1.astype(np.float32), uv2.astype(np.float32), s1, s2, \
        valid


def test_optimize_sim3_matches_jax():
    pc1, pc2, uv1, uv2, s1, s2, valid = _pair_problem(5)
    g0 = np.asarray(j_se3.exp(jnp.asarray(
        [0.25, 0.0, 0.35, 0.0, 0.07, 0.0], jnp.float32)))
    args = (pc1, pc2, uv1, uv2, s1, s2, valid)
    rj = j_opt.optimize_sim3(j_sim3.from_se3(jnp.asarray(g0)),
                             *map(jnp.asarray, args), J_CAM)
    rt = t_opt.optimize_sim3(t_sim3.from_se3(_t(g0)), *map(_t, args), T_CAM)
    _close(rt.g12, rj.g12, 1e-4)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 50


def _jax_sets(key_seed, valid, n_hypotheses=128):
    """The JAX RANSAC's minimal sets (sim3_opt.ransac_sim3's draws)."""
    g = jax.random.gumbel(jax.random.key(key_seed),
                          (n_hypotheses, len(valid)))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(g, 3)[1])


@pytest.mark.parametrize("seed", [6, 7])
def test_ransac_sim3_with_jax_sets_matches_jax(seed):
    pc1, pc2, uv1, uv2, s1, s2, valid = _pair_problem(seed)
    args = (pc1, pc2, uv1, uv2, s1, s2, valid)
    rj = j_opt.ransac_sim3(*map(jnp.asarray, args), jax.random.key(seed),
                           J_CAM, fix_scale=True)
    sets = _jax_sets(seed, valid)
    rt = t_opt.evaluate_hypotheses(_t(sets).long(), *map(_t, args), T_CAM,
                                   fix_scale=True)
    _close(rt.g12, rj.g12, 1e-4)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 50


def test_ransac_sim3_own_draws_find_the_transform():
    pc1, pc2, uv1, uv2, s1, s2, valid = _pair_problem(8)
    gen = torch.Generator().manual_seed(8)
    res = t_opt.ransac_sim3(*map(_t, (pc1, pc2, uv1, uv2, s1, s2, valid)),
                            gen, T_CAM)
    g = j_sim3.exp(jnp.asarray(
        np.array([0.3, -0.05, 0.4, 0.01, 0.08, -0.02, 0.0], np.float32)))
    np.testing.assert_allclose(res.g12.R.numpy(), np.asarray(g.R), atol=5e-3)
    np.testing.assert_allclose(res.g12.t.numpy(), np.asarray(g.t), atol=5e-2)
    assert not bool(res.inliers[:20].any())  # gross outliers rejected
    sets = t_opt.draw_sets(_t(valid), gen)
    assert sets.shape == (128, 3) and bool(_t(valid)[sets].all())
