"""The port's essential-graph optimizer against the JAX package on the
CPU, on tests/test_pose_graph.py's drifted-circle problem (12 keyframes,
odometry drift, one loop edge) and on a padded problem shaped as the
loop closer builds it (invalid vertices, invalid edges, extra
covisibility edges). Vertices agree within 1e-4 after 20 Gauss-Newton
iterations of float32 normal equations; the drift correction is checked
as in the JAX test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.geometry import se3 as j_se3
from sivo_tpu.optim import pose_graph as j_pg
from sivo_tpu_torch.optim import pose_graph as t_pg

torch.set_num_threads(2)


def _loop_problem(n_kf=12, drift=0.05, seed=0, pad_k=0, pad_e=0,
                  extra_edges=0):
    """tests/test_pose_graph.py's problem, optionally padded with invalid
    vertices and edges and given extra true-measurement edges."""
    rng = np.random.default_rng(seed)
    true = []
    for k in range(n_kf):
        ang = 2 * np.pi * k / n_kf
        xi = np.array([np.cos(ang) * 5, 0, np.sin(ang) * 5, 0, ang, 0],
                      np.float32)
        true.append(np.asarray(j_se3.exp(jnp.asarray(xi))))
    true = np.stack(true)
    est = [true[0]]
    for k in range(1, n_kf):
        rel_true = true[k] @ np.linalg.inv(true[k - 1])
        noise = np.asarray(j_se3.exp(jnp.asarray(
            rng.normal(0, drift, 6).astype(np.float32))))
        est.append(noise @ rel_true @ est[-1])
    est = np.stack(est)
    edges = [(k, k - 1) for k in range(1, n_kf)] + [(n_kf - 1, 0)]
    for _ in range(extra_edges):
        i, j = sorted(rng.choice(n_kf, 2, replace=False))[::-1]
        edges.append((int(i), int(j)))
    meas = np.stack([true[i] @ np.linalg.inv(true[j]) for i, j in edges])
    K, E = n_kf + pad_k, len(edges) + pad_e
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:n_kf] = est
    mR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    mR[:len(edges)] = meas[:, :3, :3]
    mt = np.zeros((E, 3), np.float32)
    mt[:len(edges)] = meas[:, :3, 3]
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ei[:len(edges)], ej[:len(edges)] = zip(*edges)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    valid = np.zeros(K, bool)
    valid[:n_kf] = True
    ev = np.zeros(E, bool)
    ev[:len(edges)] = True
    fields = dict(s=np.ones(K, np.float32), R=poses[:, :3, :3].copy(),
                  t=poses[:, :3, 3].copy(), fixed=fixed, valid=valid,
                  edge_i=ei, edge_j=ej, meas_s=np.ones(E, np.float32),
                  meas_R=mR, meas_t=mt, edge_valid=ev)
    return fields, true, est


@pytest.mark.parametrize("shape", ["test_pose_graph", "padded"])
def test_essential_graph_matches_jax(shape):
    kw = {} if shape == "test_pose_graph" else dict(
        pad_k=20, pad_e=40, extra_edges=6, seed=1)
    fields, true, est = _loop_problem(**kw)
    sj, Rj, tj = j_pg.optimize_essential_graph(j_pg.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in fields.items()}), iterations=20)
    st, Rt, tt = t_pg.optimize_essential_graph(t_pg.PoseGraphProblem(
        **{k: torch.from_numpy(v) for k, v in fields.items()}), iterations=20)
    for a, b in ((st, sj), (Rt, Rj), (tt, tj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)

    # the drift correction of tests/test_pose_graph.py, on the port alone
    def errs(R, t):
        out = []
        for k in range(len(true)):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3], T[:3, 3] = R[k], t[k]
            d = np.asarray(j_se3.log(jnp.asarray(np.linalg.inv(true[k]) @ T)))
            out.append(np.linalg.norm(d))
        return np.array(out)

    before = errs(est[:, :3, :3], est[:, :3, 3])
    after = errs(Rt.numpy(), tt.numpy())
    assert after.max() < 0.35 * before.max()
    np.testing.assert_allclose(Rt[0].numpy(), est[0][:3, :3], atol=1e-6)
