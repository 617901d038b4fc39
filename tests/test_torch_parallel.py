"""The port's multi-device paths on the CPU: ``parallel/sharded_ba.py``,
``segment_image(group=)`` and ``entry.py``, with ``torch.distributed``
ranks spawned as gloo processes that meet through a ``file://`` store in
a temporary directory (``parallel/ranks.py``), so concurrent test
workers cannot collide on a port.

(a) ``partition_problem`` against the JAX package's on
    tests/test_local_ba.py's problem (K = 8 keyframes, P = 512 points,
    8192 observation slots) with 8 shards: every observation field and
    the validity mask equal exactly. The JAX package's two tests of
    tests/test_sharded_ba.py, carried over: the partition keeps >= 95% of
    the observations, each in its point's shard, and the sharded solver
    lands where ``global_bundle_adjustment`` does.
(b) ``sharded_bundle_adjustment`` on 8 gloo ranks against the JAX
    package's on the 8-device virtual CPU mesh of tests/conftest.py, on
    the same partitioned arrays, 10 iterations, without and with Huber,
    and on the problem padded with invalid keyframes and points, so that
    half the shards hold only padding slots (the JAX package lets their
    point indices go negative; the port points them at local point 0):
    camera centres within 1e-3 m and rotations within 1e-3 rad
    (measured 2.0e-6 m and 2.7e-8 rad), points' median difference <=
    1e-3 m (measured 3.9e-6 m), chi2 within 1% (measured 5.7e-6
    relative) and ``obs_inlier`` equal on >= 99.5% of the observations
    (measured all). Every rank returns the same result within float32
    rounding (measured equal). Against the port's single-device
    ``global_bundle_adjustment``, with tests/test_sharded_ba.py's bounds:
    the largest pose error 7.03e-4 in both.
(c) ``segment_image(group=)`` on 4 gloo ranks, each with its own
    numpy-drawn dropout masks (2 samples each), against one process's
    call on the 8 masks stacked: rasters within atol 1e-6, classes
    equal. The convolutions run in float64 here (softmax, the means and
    the entropy in float32, as always), so that what differs is the
    order of the float32 sums of the means.
(d) ``entry.dryrun_multichip(8, device="cpu")`` passes; the dry run and
    ``entry()`` raise without a card when no device is named, and the
    dry run raises when asked for more ranks than cards;
    ``sharded_bundle_adjustment`` raises without a process group.
(e) ``run_sequences`` against the JAX package's, on
    tests/test_torch_multi_sequence.py's two sequences (8 + 6 frames of
    tests/test_system_modes.py's corridor at 320x192), both packages'
    sessions fed through a thin adapter: each pair's frame from the JAX
    frontend (``build_frame_nosegnet``, the override's semantics) goes to
    ``track_frame`` and the mapper is drained after every call, as
    tests/test_torch_system.py feeds and drains both sessions (the JAX
    package's mapper completes in a thread otherwise; its CPU frontend
    takes the XLA descriptor path, whose semantics the port does not
    follow, tests/test_torch_frame.py). Poses within 1e-3 m and 1e-3 rad
    (measured 1.8e-5 m and 1.2e-6 rad), lost frames and keyframes equal.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sivo_tpu import config as j_config
from sivo_tpu.parallel import multi_sequence as j_ms
from sivo_tpu.parallel import sharded_ba as j_sh
from sivo_tpu.runtime import frame as j_frame
from sivo_tpu.runtime.system import System as JSystem
from sivo_tpu_torch import entry
from sivo_tpu_torch.geometry.projection import CameraParams
from sivo_tpu_torch.models import segnet
from sivo_tpu_torch.optim import local_ba as t_ba
from sivo_tpu_torch.parallel import ranks
from sivo_tpu_torch.parallel import multi_sequence as t_ms
from sivo_tpu_torch.parallel import sharded_ba as t_sh
from sivo_tpu_torch.runtime import frame as t_frame
from tests.test_local_ba import CAM as J_CAM
from tests.test_local_ba import P, make_problem, pose_errors
from tests.test_torch_multi_sequence import (FRAMES, SYSTEM_KWARGS, make_cfg,
                                             make_sequences, port_system)

torch.set_num_threads(2)
T_CAM = CameraParams(*J_CAM)
N_SHARDS = 8
SEG_RANKS, SEG_SAMPLES = 4, 2  # MC samples per rank
SEG_H, SEG_W = 32, 64


def _to_torch(prob) -> t_ba.BAProblem:
    return t_ba.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob))


def _as_numpy(res) -> dict:
    return {k: np.asarray(v) for k, v in res._asdict().items()}


def _centres(T: np.ndarray) -> np.ndarray:
    T = T.astype(np.float64)
    return -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])


def _rotation_angles(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Angle of each A_k^T B_k, from its skew part and its trace (an
    arccos of the trace alone reads float32 rounding as ~5e-4 rad)."""
    R = np.einsum("kji,kjl->kil", A[:, :3, :3].astype(np.float64),
                  B[:, :3, :3].astype(np.float64))
    w = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], axis=-1) / 2.0
    c = (np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0
    return np.arctan2(np.linalg.norm(w, axis=-1), c)


# -- (a) partition ------------------------------------------------------------

def test_partition_matches_jax():
    prob, *_ = make_problem()
    want = j_sh.partition_problem(prob, N_SHARDS)
    got = t_sh.partition_problem(_to_torch(prob), N_SHARDS)
    for name in ("obs_kf", "obs_pt", "obs_uvr", "obs_sigma2",
                 "obs_is_stereo", "obs_valid", "pt_pos", "kf_pose"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_partition_keeps_all_observations():
    prob, *_ = make_problem()
    part = t_sh.partition_problem(_to_torch(prob), N_SHARDS)
    # nearly all observations kept (shard-boundary straddlers are
    # dropped by the static partitioning; inherently a few percent)
    assert int(part.obs_valid.sum()) >= int(np.sum(prob.obs_valid)) * 0.95
    # each obs references a point in its shard
    shard_of_pt = part.obs_pt.numpy() // (P // N_SHARDS)
    shard_of_obs = np.repeat(np.arange(N_SHARDS),
                             part.obs_kf.shape[0] // N_SHARDS)
    valid = part.obs_valid.numpy()
    np.testing.assert_array_equal(shard_of_pt[valid], shard_of_obs[valid])


def test_partition_needs_divisible_caps():
    prob, *_ = make_problem()
    with pytest.raises(ValueError, match="divide"):
        t_sh.partition_problem(_to_torch(prob), 3)


# -- (b) the sharded solver ---------------------------------------------------

def _padded(prob):
    """``prob`` in caps of 12 keyframes (4 invalid, identity poses) and
    1024 points (512 invalid, at the origin): with 8 shards, shards 4-7
    own no valid point and their observation slots are all padding."""
    def pad(x, n, fill):
        x = np.asarray(x)
        tail = np.full((n - x.shape[0],) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, tail])

    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (12, 4, 4))
    return prob._replace(
        kf_pose=np.concatenate([np.asarray(prob.kf_pose), eye[8:]]),
        kf_fixed=pad(prob.kf_fixed, 12, False),
        kf_valid=pad(prob.kf_valid, 12, False),
        pt_pos=pad(prob.pt_pos, 2 * P, 0.0),
        pt_valid=pad(prob.pt_valid, 2 * P, False))


# case -> (use_huber, padded)
SHARDED_CASES = {"plain": (False, False), "huber": (True, False),
                 "padded": (False, True)}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{case: (JAX result, every port rank's result)}, each on one
    partitioned problem given to both, and the plain problem with its
    ground truth."""
    prob, gt_poses, gt_pts, _ = make_problem(noise=0.1)
    mesh = Mesh(np.array(jax.devices()[:N_SHARDS]), ("ba",))
    work = str(tmp_path_factory.mktemp("sharded_ba"))
    out = {}
    for case, (use_huber, padded) in SHARDED_CASES.items():
        part = j_sh.partition_problem(_padded(prob) if padded else prob,
                                      N_SHARDS)
        j_res = j_sh.sharded_bundle_adjustment(part, J_CAM, mesh,
                                               iterations=10,
                                               use_huber=use_huber)
        t_res = t_sh.solve_on_ranks(_to_torch(part), T_CAM, N_SHARDS, work,
                                    backend="gloo",
                                    devices=["cpu"] * N_SHARDS,
                                    iterations=10, use_huber=use_huber)
        out[case] = (_as_numpy(j_res), [_as_numpy(r) for r in t_res])
    return out, prob, gt_poses, gt_pts


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_matches_jax(sharded, case):
    out, *_ = sharded
    j, t_all = out[case]
    t = t_all[0]
    dc = np.linalg.norm(_centres(t["kf_pose"]) - _centres(j["kf_pose"]),
                        axis=-1)
    assert dc.max() <= 1e-3, dc
    assert _rotation_angles(t["kf_pose"], j["kf_pose"]).max() <= 1e-3
    # the P valid points (the padded case's others stay at the origin)
    dp = np.linalg.norm(t["pt_pos"][:P] - j["pt_pos"][:P], axis=-1)
    assert np.median(dp) <= 1e-3, np.median(dp)
    np.testing.assert_allclose(t["chi2"], j["chi2"], rtol=1e-2)
    assert np.mean(t["obs_inlier"] == j["obs_inlier"]) >= 0.995
    np.testing.assert_allclose(t["newest_cov"], j["newest_cov"], rtol=1e-2,
                               atol=1e-9)


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_ranks_replicate(sharded, case):
    out, *_ = sharded
    t_all = out[case][1]
    assert len(t_all) == N_SHARDS
    for other in t_all[1:]:
        for name, value in t_all[0].items():
            if value.dtype == bool:
                np.testing.assert_array_equal(other[name], value)
            else:
                np.testing.assert_allclose(other[name], value, rtol=1e-5,
                                           atol=1e-6, err_msg=name)


def test_sharded_matches_single_device(sharded):
    out, prob, gt_poses, gt_pts = sharded
    res_sh = out["plain"][1][0]
    res_one = _as_numpy(t_ba.global_bundle_adjustment(
        _to_torch(prob), T_CAM, iterations=10))
    errs_sh = pose_errors(res_sh["kf_pose"], gt_poses)
    errs_one = pose_errors(res_one["kf_pose"], gt_poses)
    # both converge to the optimum within noise
    assert errs_sh.max() < 5e-3, errs_sh
    assert abs(errs_sh.max() - errs_one.max()) < 2e-3
    pt_err = np.linalg.norm(res_sh["pt_pos"] - gt_pts, axis=-1)
    assert np.median(pt_err) < 0.1


def test_sharded_raises_without_process_group():
    assert not dist.is_initialized()
    prob, *_ = make_problem()
    part = t_sh.partition_problem(_to_torch(prob), 1)
    with pytest.raises(RuntimeError, match="process group"):
        t_sh.sharded_bundle_adjustment(part, T_CAM, iterations=1)


# -- (c) SegNet's MC samples split over ranks ---------------------------------

def _seg_model() -> segnet.SegNet:
    # float64 convolutions: batches of 2 and 8 samples may take different
    # convolution algorithms, whose float32 sums differ by ~1e-6 before
    # any reduction over ranks
    model = segnet.SegNet(variant="basic", dtype=torch.float64)
    model.load_state_dict(segnet.init_params(seed=3))
    return model.eval()


def _seg_masks(n_samples: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.uniform(size=s) < 0.5)
            for s in _seg_model().dropout_shapes(SEG_H, SEG_W, n_samples)]


def _seg_image() -> torch.Tensor:
    rng = np.random.default_rng(12)
    return torch.from_numpy(rng.uniform(0, 255, (SEG_H, SEG_W, 3))
                            .astype(np.float32))


def _segment_rank(rank: int, device: torch.device) -> dict:
    """One rank's ``segment_image(group=)`` on its slice of the masks."""
    masks = [m[rank * SEG_SAMPLES:(rank + 1) * SEG_SAMPLES]
             for m in _seg_masks(SEG_RANKS * SEG_SAMPLES)]
    with torch.no_grad():
        out = segnet.segment_image(_seg_model(), _seg_image(), None,
                                   SEG_SAMPLES, masks=masks,
                                   group=dist.group.WORLD)
    return dict(zip(("classes", "confidence", "entropy"), out))


def test_segment_image_group_matches_one_process():
    outs = ranks.spawn(_segment_rank, SEG_RANKS, backend="gloo",
                       devices=["cpu"] * SEG_RANKS)
    with torch.no_grad():
        want = segnet.segment_image(_seg_model(), _seg_image(), None,
                                    SEG_RANKS * SEG_SAMPLES,
                                    masks=_seg_masks(SEG_RANKS * SEG_SAMPLES))
    for got in outs:
        torch.testing.assert_close(got["classes"], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got["confidence"], want[1], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(got["entropy"], want[2], rtol=0,
                                   atol=1e-6)


# -- (d) the entry points -----------------------------------------------------

def test_dryrun_multichip_on_cpu_ranks():
    out = entry.dryrun_multichip(8, device="cpu")
    assert out["classes"].shape == (entry.DRY_H, entry.DRY_W)
    assert out["scores"].shape == (entry.DRY_KEYPOINTS * 8,)
    assert out["ba_pt_pos"].shape == (entry.DRY_POINTS * 8, 3)
    # points started 0.01 m off converge on noise-free observations
    prob, _ = entry.dry_ba_problem(8, torch.device("cpu"))
    assert float((out["ba_pt_pos"] - (prob.pt_pos - 0.01)).abs().max()) < 1e-3


def test_entry_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.entry()


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks asked for, 1 cards"):
        entry.dryrun_multichip(2)


def test_entry_forward_on_cpu():
    fn, args = entry.entry(device="cpu")
    classes, confidence, entropy = fn(*args)
    assert classes.shape == (entry.HEIGHT, entry.WIDTH)
    assert classes.dtype == torch.uint8
    assert torch.isfinite(confidence).all() and torch.isfinite(entropy).all()
    assert float(entropy.min()) >= 0.0


# -- (e) the multi-sequence runner -------------------------------------------

class FrameFed:
    """A session fed prebuilt frames, one per ``track_stereo`` call in
    order, its mapper drained after every call."""

    def __init__(self, system, frames):
        self.system = system
        self.frames = iter(frames)

    def track_stereo(self, left, right, t, sem_override=None):
        pose = self.system.track_frame(next(self.frames), t)
        self.system.mapper.drain(self.system.tracker)
        return pose

    def __getattr__(self, name):
        return getattr(self.system, name)


def test_runner_matches_jax():
    seqs, _ = make_sequences()
    cfg = make_cfg(j_config)
    statics = j_frame.make_statics(cfg)
    j_frames = []
    for left, right, _, (cls, conf, ent, _) in seqs["a"]:
        j_frames.append(j_frame.build_frame_nosegnet(
            statics, jnp.asarray(left), jnp.asarray(right),
            jnp.asarray(cls), jnp.asarray(conf), jnp.asarray(ent)))
    t_frames = [t_frame.Frame(*(torch.from_numpy(np.array(x)) for x in f))
                for f in j_frames]
    want = j_ms.run_sequences(
        lambda name: FrameFed(JSystem(cfg=cfg, **SYSTEM_KWARGS),
                              j_frames), seqs)
    got = t_ms.run_sequences(
        lambda name: FrameFed(port_system(name), t_frames), seqs)
    assert sorted(got) == sorted(want) == sorted(FRAMES)
    for name in FRAMES:
        g, w = got[name], want[name]
        assert (g.n_frames, g.n_lost, g.n_keyframes) == (
            w.n_frames, w.n_lost, w.n_keyframes)
        np.testing.assert_allclose(g.poses[:, :3, 3], w.poses[:, :3, 3],
                                   rtol=0, atol=1e-3)
        angle = _rotation_angles(g.poses, w.poses)
        assert angle.max() < 1e-3, angle
