"""Relocalization through the keyframe database: the port of
tests/test_system_modes.py's kidnapped-robot test, with the JAX
package's System on the same frames alongside.

Both Systems map the 18-frame corridor of tests/test_system_modes.py
(320x192, fps 3 so that it makes more than 5 keyframes; the JAX
package's frames, described by its K1 with the kernel's semantics as the
port's K1, ``tests/jax_kernel_semantics.py``) with a
vocabulary trained on its first 4 frames, each frame followed by
``flush`` (which drains the mapper and the loop closer, so both runs
are deterministic). Then the believed pose is teleported 4 m ahead with
frame-to-frame continuity severed, and frame 2 is replayed twice: the
first call is lost, the second relocalizes. Checked: the keyframe
databases hold the same keyframes, the port's relocalization asked the
database for exactly the candidates the JAX database gives for that
frame (exact), its pose lies within 0.5 m of ground truth (the JAX
test's bound) and ``reloc_successes >= 1``, and its K2 searches were
counted (brute force and projection rounds; no launches on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.place import vocabulary as j_voc
from sivo_tpu.runtime.system import System as JSystem
from sivo_tpu.runtime.tracking import TrackingState as JState
from sivo_tpu_torch.runtime import frame as t_frame
from sivo_tpu_torch.runtime.system import System
from sivo_tpu_torch.runtime.tracking import TrackingState
from tests.jax_kernel_semantics import k1_kernel_semantics
from tests.test_system_modes import world_and_frames  # noqa: F401 (fixture)
from tests.test_torch_loopclosing import port_config, port_vocabulary

torch.set_num_threads(2)
CPU = torch.device("cpu")
N_MAP = 18


def _kidnap_jax(system, bogus):
    tr = system.tracker
    tr.carry = tr.carry._replace(
        pose=jnp.asarray(bogus), has_velocity=jnp.asarray(False),
        pt_idx=jnp.full_like(tr.carry.pt_idx, -1))
    tr.last_pose = bogus
    tr._ref_pt_idx = jnp.full_like(tr._ref_pt_idx, -1)
    tr._local_ids_dev = jnp.full_like(tr._local_ids_dev, -1)


def _kidnap_port(system, bogus):
    tr = system.tracker
    tr.carry = tr.carry._replace(
        pose=torch.from_numpy(bogus),
        has_velocity=torch.zeros((), dtype=torch.bool),
        pt_idx=torch.full_like(tr.carry.pt_idx, -1))
    tr.last_pose = bogus
    tr._ref_pt_idx = torch.full_like(tr._ref_pt_idx, -1)
    tr._local_ids_dev = torch.full_like(tr._local_ids_dev, -1)


@pytest.fixture(scope="module")
def k1_world_and_frames(request):
    """The corridor's frames, described with K1's semantics."""
    with k1_kernel_semantics():
        return request.getfixturevalue("world_and_frames")


@pytest.fixture(scope="module")
def kidnapped(k1_world_and_frames):
    cfg_j, gt, fj = k1_world_and_frames
    desc = [np.asarray(f.desc_u8)[np.asarray(f.semantic)] for f in fj[:4]]
    vj = j_voc.train(np.concatenate(desc), k=8, depth=3, seed=0)
    cfg_j = dataclasses.replace(
        cfg_j, camera=dataclasses.replace(cfg_j.camera, fps=3.0))
    ft = [t_frame.Frame(*(torch.from_numpy(np.array(x)) for x in f))
          for f in fj]
    js = JSystem(cfg=cfg_j, max_keyframes=64, max_points=20000,
                 vocabulary=vj)
    ts = System(cfg=port_config(cfg_j), device=CPU, max_keyframes=64,
                max_points=20000, vocabulary=port_vocabulary(vj))
    for s, frames in ((js, fj), (ts, ft)):
        for i in range(N_MAP):
            s.track_frame(frames[i], i * 0.1)
            s.flush()
    bogus = gt[N_MAP - 1].copy()
    bogus[2, 3] += 4.0
    bogus = bogus.astype(np.float32)
    _kidnap_jax(js, bogus)
    _kidnap_port(ts, bogus)
    out = {}
    for name, s, frames in (("jax", js, fj), ("port", ts, ft)):
        p1 = s.track_frame(frames[2], 1.0)
        lost = s.tracker.state
        p2 = s.track_frame(frames[2], 1.1)
        out[name] = (p1, lost, p2)
    # the candidates the JAX database gives for frame 2
    lc = js.loop_closer
    words, _ = j_voc.transform(lc.voc, fj[2].desc_bits, fj[2].semantic)
    bow = j_voc.bow_vector(lc.voc, words)
    cands_j = lc.db.detect_relocalization_candidates(bow,
                                                     lc._covis_groups())
    return js, ts, gt, out, cands_j


def test_both_maps_reach_relocalization(kidnapped):
    js, ts, _, _, _ = kidnapped
    assert ts.map.n_keyframes == js.map.n_keyframes > 5
    assert sorted(ts.loop_closer.db.bow) == sorted(js.loop_closer.db.bow)


def test_kidnapped_robot_relocalizes(kidnapped):
    _, ts, gt, out, _ = kidnapped
    p1, lost, p2 = out["port"]
    assert p1 is None and lost == TrackingState.LOST
    assert p2 is not None, "relocalization failed"
    c_est = -p2[:3, :3].T @ p2[:3, 3]
    c_gt = -gt[2][:3, :3].T @ gt[2][:3, 3]
    assert np.linalg.norm(c_est - c_gt) < 0.5, (c_est, c_gt)
    assert ts.reloc_successes >= 1
    assert ts.tracker.state == TrackingState.OK
    # brute force + at least the coarse projection round, on the CPU's
    # plain path
    assert ts.reloc_k2_searches >= 2 and ts.reloc_k2_launches == 0


def test_jax_system_relocalizes_too(kidnapped):
    js, _, gt, out, _ = kidnapped
    p1, lost, p2 = out["jax"]
    assert p1 is None and lost == JState.LOST and p2 is not None
    assert js.reloc_successes >= 1


def test_relocalization_candidates_equal_jax(kidnapped):
    _, ts, _, _, cands_j = kidnapped
    assert ts.reloc_candidates and ts.reloc_candidates[0] == cands_j
    assert len(cands_j) >= 1
