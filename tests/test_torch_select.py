"""Parity of the port's selection helpers with the JAX package's on
seeded inputs, in float32:

* ``select/info.py``: ``mono_jacobian_point``, ``stereo_jacobian_point``,
  ``joint_covariance``, ``mutual_information`` and
  ``kalman_update_stereo`` (the cases of the JAX package's
  tests/test_info.py, batched), atol 1e-5 plus rtol 1e-6 of each value
  (the Jacobians' entries reach ~10^2, where one float32 ulp is ~10^-5);
  ``mutual_information`` so on a well-conditioned joint covariance, and
  within 1e-3 bits of the float64 determinant form at the KITTI scale;
* ``select/semantic.py``: ``selection_gate`` exactly on random rasters
  (``Classes`` is held in tests/test_torch_copies.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.geometry import se3 as j_se3
from sivo_tpu.select import info as j_info
from sivo_tpu.select import semantic as j_sem
from sivo_tpu_torch.select import info as t_info
from sivo_tpu_torch.select import semantic as t_sem

FX, FY, B = 721.5377, 721.5377, 387.5744 / 721.5377
TOL = dict(rtol=1e-6, atol=1e-5)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _inputs(seed: int = 0):
    """Points at depths 3-30 m, a rotation, an SPD pose covariance and
    stereo Jacobians of the points, all float32."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, 16), rng.uniform(-2, 2, 16),
                    rng.uniform(3, 30, 16)], -1).astype(np.float32)
    R = np.asarray(j_se3.exp(jnp.array([0.1, 0.2, -0.1, 0.05, -0.02,
                                        0.3])))[:3, :3].astype(np.float32)
    A = rng.normal(size=(6, 6))
    S = ((A @ A.T + 6 * np.eye(6)) * 1e-3).astype(np.float32)
    J = np.array(j_info.stereo_jacobian_pose(FX, FY, B, jnp.asarray(pts)))
    N = (2.25 * np.eye(3)).astype(np.float32)
    return pts, R, S, J, N


def test_point_jacobians_match_jax():
    pts, R, *_ = _inputs()
    _close(t_info.mono_jacobian_point(FX, FY, torch.from_numpy(pts),
                                      torch.from_numpy(R)),
           j_info.mono_jacobian_point(FX, FY, jnp.asarray(pts),
                                      jnp.asarray(R)))
    _close(t_info.stereo_jacobian_point(FX, FY, B, torch.from_numpy(pts),
                                        torch.from_numpy(R)),
           j_info.stereo_jacobian_point(FX, FY, B, jnp.asarray(pts),
                                        jnp.asarray(R)))


def test_point_jacobian_against_the_projection():
    """The JAX package's own check: d(proj)/d(camera point) @ R."""
    X, Y, Z = 1.5, -2.0, 10.0
    _, R, *_ = _inputs()
    proj = np.array([[FX / Z, 0, -FX * X / Z**2],
                     [0, FY / Z, -FY * Y / Z**2],
                     [FX / Z, 0, -FX * (X - B) / Z**2]])
    p = torch.tensor([X, Y, Z])
    np.testing.assert_allclose(
        t_info.stereo_jacobian_point(FX, FY, B, p, torch.from_numpy(R)),
        proj @ R, rtol=1e-4)


@pytest.mark.parametrize("m", [2, 3])
def test_joint_covariance_matches_jax(m):
    _, _, S, J, N = _inputs(1)
    J, N = J[:, :m], N[:m, :m]
    got = t_info.joint_covariance(torch.from_numpy(S), torch.from_numpy(J),
                                  torch.from_numpy(N))
    assert got.shape == (16, 6 + m, 6 + m)
    _close(got, j_info.joint_covariance(jnp.asarray(S), jnp.asarray(J),
                                        jnp.asarray(N)))


def test_mutual_information_matches_jax():
    """On a well-conditioned joint covariance (the Jacobians scaled by
    1e-2): in float32 the 9x9 log-determinant of the KITTI-scaled joint
    (entries from 1e-3 to 1e5) differs by ~1e-3 bits between two LAPACK
    implementations, which the next test bounds."""
    _, _, S, J, N = _inputs(2)
    joint = np.asarray(j_info.joint_covariance(
        jnp.asarray(S), jnp.asarray(J * 1e-2), jnp.asarray(N)))
    _close(t_info.mutual_information(torch.from_numpy(joint.copy())),
           j_info.mutual_information(jnp.asarray(joint)))


def test_mutual_information_against_the_determinant_form():
    """The JAX package's check at the KITTI scale: the float64 ratio of
    determinants (sivo_helpers.cpp:182-219) within 1e-3 bits, and the
    fused form within 1e-2."""
    _, _, S, J, N = _inputs(2)
    S64, J64, N64 = (x.astype(np.float64) for x in (S, J, N))
    joint = np.block([[S64[None].repeat(16, 0), S64 @ J64.transpose(0, 2, 1)],
                      [J64 @ S64, J64 @ S64 @ J64.transpose(0, 2, 1) + N64]])
    want = 0.5 * np.log2(np.linalg.det(S64) * np.linalg.det(joint[:, 6:, 6:])
                         / np.linalg.det(joint))
    got = t_info.mutual_information(torch.from_numpy(
        joint.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    fused = t_info.stereo_mutual_information(
        torch.from_numpy(S), torch.from_numpy(J.copy()), torch.from_numpy(N))
    np.testing.assert_allclose(fused.numpy(), want, atol=1e-2)


def test_kalman_update_matches_jax_and_shrinks():
    _, _, S, J, N = _inputs(3)
    got = t_info.kalman_update_stereo(torch.from_numpy(S),
                                      torch.from_numpy(J[0]),
                                      torch.from_numpy(N))
    want = j_info.kalman_update_stereo(jnp.asarray(S), jnp.asarray(J[0]),
                                       jnp.asarray(N))
    _close(got, want)
    assert float(torch.trace(got)) < float(np.trace(S)) + 1e-6
    np.testing.assert_allclose(got.numpy(), got.numpy().T, atol=1e-5)


def test_selection_gate_matches_jax_exactly():
    rng = np.random.default_rng(4)
    classes = rng.integers(0, 15, (40, 60)).astype(np.uint8)
    confidence = rng.uniform(0, 1, (40, 60)).astype(np.float32)
    confidence[::7] = 0.65  # at the threshold
    depth = rng.uniform(-1, 20, (40, 60)).astype(np.float32)
    depth[::5, ::3] = 0.0
    got = t_sem.selection_gate(torch.from_numpy(classes),
                               torch.from_numpy(confidence),
                               torch.from_numpy(depth), 0.65)
    want = np.asarray(j_sem.selection_gate(
        jnp.asarray(classes), jnp.asarray(confidence), jnp.asarray(depth),
        0.65))
    assert got.dtype == torch.bool and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), want)
