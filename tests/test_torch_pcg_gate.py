"""``chip_smoke.py``'s PCG gate helpers and phase 7's record, on the CPU
at small shapes: a PCG problem saved on a gate's miss
(``save_pcg_problem``) loads back equal, with and without the card's
solve, and ``phase_pcg`` saves it where it outlives the failed gate;
the CPU's side solved in background processes (``PcgNoise``) equals the
same solves in this process; the card-against-CPU tolerance is the
larger of ``PCG_TOLS`` and twice the CPU's largest noise
(``pcg_bound``, ``pcg_misses``); ``tools/pcg_repeat.py``'s point blocks
are the Gauss-Newton blocks of the points; phase 7's closures are read
off its record (``loop_closed_at``).
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams
from sivo_tpu_torch.optim import gba_cg, local_ba
from tools import pcg_repeat

CAM = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=250.0,
                   width=640, height=480)


def small_problem(seed: int = 0, k: int = 4, p: int = 24):
    """``k`` keyframes 0.4 m apart along x looking down z, ``p`` points
    at 4-8 m seen by every keyframe (stereo, 0.3 px noise), poses and
    points perturbed; keyframe 0 fixed; two padding slots of each."""
    rng = np.random.default_rng(seed)
    poses = np.stack([np.asarray(se3.exp(torch.tensor(
        [-0.4 * i, 0, 0, *rng.normal(0, 0.01, 3)], dtype=torch.float32)))
        for i in range(k)])
    pts = np.stack([rng.uniform(-2, 2, p), rng.uniform(-1, 1, p),
                    rng.uniform(4, 8, p)], -1)
    okf, opt, uvr = [], [], []
    for i, T in enumerate(poses):
        xc = pts @ T[:3, :3].T + T[:3, 3]
        u = CAM.fx * xc[:, 0] / xc[:, 2] + CAM.cx
        v = CAM.fy * xc[:, 1] / xc[:, 2] + CAM.cy
        ur = u - CAM.bf / xc[:, 2]
        okf += [i] * p
        opt += list(range(p))
        uvr.append(np.stack([u, v, ur], -1) + rng.normal(0, 0.3, (p, 3)))
    o = len(okf)
    noisy = poses.copy()
    for i in range(1, k):
        noisy[i] = np.asarray(se3.exp(torch.tensor(
            rng.normal(0, 0.01, 6), dtype=torch.float32))) @ poses[i]

    def pad(a, n, fill=0):
        return np.concatenate([a, np.full((n,) + a.shape[1:], fill,
                                          a.dtype)])

    f32 = torch.float32
    return local_ba.BAProblem(
        kf_pose=torch.tensor(pad(noisy, 2), dtype=f32),
        kf_fixed=torch.tensor(pad(np.arange(k) == 0, 2)),
        kf_valid=torch.tensor(pad(np.ones(k, bool), 2)),
        pt_pos=torch.tensor(pad(pts + rng.normal(0, 0.05, pts.shape), 2),
                            dtype=f32),
        pt_valid=torch.tensor(pad(np.ones(p, bool), 2)),
        obs_kf=torch.tensor(pad(np.array(okf, np.int32), 2)),
        obs_pt=torch.tensor(pad(np.array(opt, np.int32), 2)),
        obs_uvr=torch.tensor(pad(np.concatenate(uvr), 2), dtype=f32),
        obs_sigma2=torch.tensor(pad(np.ones(o), 2, 1.0), dtype=f32),
        obs_is_stereo=torch.tensor(pad(np.ones(o, bool), 2)),
        obs_valid=torch.tensor(pad(np.ones(o, bool), 2)))


def test_saved_problem_loads_back_equal(tmp_path):
    prob = small_problem()
    card = cs._pcg_solve(prob, CAM, iterations=2)
    for name, with_card in (("miss.pt", card), ("plain.pt", None)):
        path = str(tmp_path / name)
        assert cs.save_pcg_problem(path, prob, CAM, with_card) > 0
        got, cam, solve = cs.load_pcg_problem(path)
        assert cam == CAM
        for field, a, b in zip(prob._fields, prob, got):
            assert a.dtype == b.dtype and torch.equal(a, b), field
        if with_card is None:
            assert solve is None
        else:
            for field, a, b in zip(card._fields, card, solve):
                assert a.dtype == b.dtype and torch.equal(a, b), field


def test_pcg_bound_is_twice_the_cpu_noise():
    floors = [{"pose": 3e-4, "point_p99": 1e-4, "point_max": -0.02,
               "chi2_rel": 1e-7, "inlier_differ": 2},
              {"pose": 1e-5, "point_p99": 2e-3, "point_max": 0.005,
               "chi2_rel": -4e-6, "inlier_differ": 0}]
    most, tol = cs.pcg_bound(floors)
    assert most == {"pose": 3e-4, "point_p99": 2e-3, "point_max": 0.02,
                    "chi2_rel": 4e-6, "inlier_differ": 2}
    assert tol == {"pose": 6e-4, "point_p99": 4e-3, "point_max": 0.04,
                   "chi2_rel": 8e-6}
    assert set(tol) == set(cs.PCG_TOLS)
    inside = {**tol, "inlier_differ": 4}
    assert cs.pcg_misses(inside, floors) == []
    assert cs.pcg_misses({**inside, "pose": 6.1e-4, "inlier_differ": 5},
                         floors) == ["pose", "inlier"]
    # below the noise the fixed tolerances hold
    quiet = [{k: 0.0 for k in most}]
    assert cs.pcg_bound(quiet)[1] == cs.PCG_TOLS
    assert cs.pcg_misses({**cs.PCG_TOLS, "inlier_differ": 1}, quiet) == [
        "inlier"]


def _equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_pcg_noise_equals_the_solves_in_process(monkeypatch):
    monkeypatch.setattr(cs, "RENDER_WORKERS", 2)
    monkeypatch.setattr(cs, "PCG_SHUFFLES", 2)
    prob = small_problem(seed=2)
    with cs.PcgNoise(prob, CAM) as noise:
        cpu, cpu_ms, f64, shuffled = noise.result()
    assert cpu_ms > 0 and len(shuffled) == 2
    assert _equal(noise.prob, prob)
    assert _equal(cpu, cs._pcg_solve(prob, CAM))
    assert _equal(f64, cs._pcg_solve(cs._f64(prob), CAM))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed, sh in enumerate(shuffled):
            assert _equal(sh, cs._pcg_shuffled(prob, CAM, seed))
    finally:
        torch.set_num_threads(threads)


class _Noise:
    """``PcgNoise``'s results made in this process."""

    def __init__(self, prob, cam):
        self.prob = prob
        self.solves = (cs._pcg_solve(prob, cam), 1.0,
                       cs._pcg_solve(cs._f64(prob), cam),
                       [cs._pcg_shuffled(prob, cam, 0)])

    def result(self):
        return self.solves


def test_phase_pcg_saves_a_miss_that_outlives_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # the float64 noise, measured on a miss, solved in this process
    monkeypatch.setattr(cs, "pcg_orders", lambda prob, cam, seeds: [
        cs._pcg_shuffled(prob, cam, s) for s in seeds])
    prob = small_problem(seed=3)
    # a "card" that solves with another focal length misses every gate
    card_cam = CAM._replace(fx=CAM.fx * 1.05)
    miss_dir = tmp_path / "misses"
    with pytest.raises(AssertionError, match="card against CPU"):
        cs.phase_pcg("a problem", (prob, card_cam), False,
                     _Noise(prob, CAM), str(miss_dir))
    (path,) = miss_dir.iterdir()
    got, cam, card = cs.load_pcg_problem(str(path))
    assert cam == card_cam and _equal(got, prob)
    assert _equal(card, cs._pcg_solve(prob, card_cam))
    # a solve that agrees passes and saves nothing
    out = cs.phase_pcg("same", (prob, CAM), False, _Noise(prob, CAM),
                       str(tmp_path / "none"))
    assert out["card_vs_cpu"]["pose"] == 0.0
    assert not (tmp_path / "none").exists()


def test_point_blocks_are_the_gauss_newton_blocks():
    prob = small_problem(seed=1)
    kp, pp, lam, _ = gba_cg.gba_cg_begin(prob, CAM)
    Hpp_d, Hpp_inv, has = pcg_repeat.point_blocks(kp, pp, lam, prob, CAM)
    assert has.tolist() == prob.pt_valid.tolist()
    # padding points get the identity block
    assert torch.equal(Hpp_d[~has], torch.eye(3).expand(2, 3, 3))
    # J^T W J of the residuals' Jacobian in the points, by autograd
    p64 = cs._f64(prob)

    def residuals(pts):
        return local_ba._residuals(kp.double(), pts, p64, CAM)[0]

    J = torch.autograd.functional.jacobian(residuals, pp.double())
    n = torch.arange(J.shape[0])
    Jp = J[n, :, p64.obs_pt.long()]  # (O, 3 rows, 3)
    rows = torch.cat([torch.ones(len(n), 2, dtype=torch.float64),
                      p64.obs_is_stereo[:, None].double()], -1)
    w = (p64.obs_valid.double() / p64.obs_sigma2)[:, None] * rows
    H = torch.zeros(Hpp_d.shape, dtype=torch.float64).index_add_(
        0, p64.obs_pt.long(), (Jp * w[..., None]).transpose(-1, -2) @ Jp)
    H = H + (float(lam) + 1e-9) * torch.eye(3, dtype=torch.float64)
    assert torch.allclose(Hpp_d[has].double(), H[has], rtol=1e-4)
    eye = torch.eye(3, dtype=torch.float64).expand(int(has.sum()), 3, 3)
    assert torch.allclose(Hpp_inv[has].double() @ Hpp_d[has].double(), eye,
                          atol=1e-4)


def test_loop_closed_at_reads_loop_corrections():
    log = cs.FrameLog(None)
    log.records = [
        {"fid": 0, "reanchor": "[]"},
        {"fid": 1, "reanchor": json.dumps([["ba", 0.01, 0.001]])},
        {"fid": 2, "reanchor": json.dumps([["loop", 0.4, 0.02],
                                            ["gba", 0.01, 0.0]])},
        {"fid": 3, "reanchor": json.dumps([["gba", 0.2, 0.01]])},
    ]
    assert cs.loop_closed_at(log) == [2]
