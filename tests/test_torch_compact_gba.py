"""Compaction with a paced PCG global BA in flight, the port against the
JAX package: tests/test_loopclosing.py's drifted out-and-back map
(320x192, 13 keyframes) with the closers' PCG branch forced as in
tests/test_torch_loopclosing_pcg.py. After the closure, with its GBA in
flight, keyframe 5 is culled (and erased from the keyframe database, as
the mapper's cull callback does) and a third of the points die; then
``System._compact``'s order runs: ``finish_gba`` applies the solve,
whose problem holds pre-compaction ids, and ``compact_map`` slides the
live entries down and remaps the loop closer's state.

Parity, float32 on the CPU: the same slots freed; equal observation
tables, spanning trees, keyframe databases, loop edges, consistency
groups and last loop keyframe after the remap; every remaining
keyframe's centre and rotation within 1e-3 (m) of the JAX package's.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.runtime import compact as j_compact
from sivo_tpu.runtime import device_map as j_dm
from sivo_tpu.runtime.loopclosing import LoopCloser as JLoopCloser
from sivo_tpu_torch.optim import sim3_opt
from sivo_tpu_torch.runtime import compact as t_compact
from sivo_tpu_torch.runtime import device_map as t_dm
from sivo_tpu_torch.runtime import loopclosing as t_lc
from sivo_tpu_torch.runtime.tracking import make_camera
from tests.test_loopclosing import loop_setup  # noqa: F401 (fixture)
from tests.test_torch_loopclosing import (
    _jax_draw_sets, _run, port_config, port_map, port_tracker,
    port_vocabulary)
from tests.test_torch_loopclosing_pcg import GBA_BUCKETS, GBA_KF, _centres

CULLED_KF = 5


class _Carry(NamedTuple):
    """The one field of a tracking carry that compaction remaps."""

    pt_idx: object


class _Session:
    """What ``compact_map`` reads of a System."""

    def __init__(self, m, tracker, loop_closer):
        self.map, self.tracker, self.loop_closer = m, tracker, loop_closer


def _cull(m, lc, rng_seed=0):
    """Kill keyframe CULLED_KF and a third of the live points (host
    side); returns the killed point ids."""
    live = np.where(m.pt_valid[: m.n_points])[0]
    kill = np.random.default_rng(rng_seed).choice(live, len(live) // 3,
                                                  replace=False)
    m.pt_valid[kill] = False
    m.kf_valid[CULLED_KF] = False
    m._obs_dirty = True
    lc.on_keyframe_culled(CULLED_KF)
    return kill.astype(np.int32)


@pytest.fixture(scope="module")
def compacted(loop_setup):  # noqa: F811
    cfg_j, cam_j, jm, jtr, vj, _, _ = loop_setup
    cfg = port_config(cfg_j)
    n_kf = jm.n_keyframes
    tm = port_map(jm)  # before the JAX closer edits its map in place
    tr = port_tracker(cfg, tm, jtr)
    mp = pytest.MonkeyPatch()
    try:
        for cls in (JLoopCloser, t_lc.LoopCloser):
            mp.setattr(cls, "GBA_KF", GBA_KF)
            mp.setattr(cls, "GBA_BUCKETS", GBA_BUCKETS)
        lc_j = JLoopCloser(cfg=cfg_j, map=jm, cam=cam_j, voc=vj)
        at_j = _run(lc_j, jtr, n_kf)
        pending_j = lc_j._gba is not None
        kill = _cull(jm, lc_j)
        jtr.dmap = j_dm.invalidate_points(jtr.dmap, kill)
        lc_j.finish_gba(jtr)
        # the trackers of a built map have tracked no frame: give each
        # the carry field compaction remaps, the first slots' ids
        ids = np.arange(jm.kp_capacity, dtype=np.int32)
        jtr.carry = _Carry(jnp.asarray(ids))
        stats_j = j_compact.compact_map(_Session(jm, jtr, lc_j))

        mp.setattr(sim3_opt, "draw_sets", _jax_draw_sets)
        lc_t = t_lc.LoopCloser(cfg=cfg, map=tm, cam=make_camera(cfg),
                               voc=port_vocabulary(vj))
        at_t = _run(lc_t, tr, n_kf)
        pending_t = lc_t._gba is not None
        kill_t = _cull(tm, lc_t)
        tr.dmap = t_dm.invalidate_points(tr.dmap, torch.from_numpy(kill_t))
        lc_t.finish_gba(tr)
        tr.carry = _Carry(torch.from_numpy(ids))
        stats_t = t_compact.compact_map(_Session(tm, tr, lc_t))
    finally:
        mp.undo()
    return dict(n_kf=n_kf, kill=(kill, kill_t),
                jax=(lc_j, jm, jtr, at_j, pending_j, stats_j),
                port=(lc_t, tm, tr, at_t, pending_t, stats_t))


def test_compaction_after_pcg_matches_jax(compacted):
    lc_j, jm, _, at_j, pending_j, stats_j = compacted["jax"]
    lc_t, tm, tr, at_t, pending_t, stats_t = compacted["port"]
    kill_j, kill_t = compacted["kill"]
    np.testing.assert_array_equal(kill_t, kill_j)
    assert at_j is not None and at_t == at_j
    assert pending_j and pending_t  # the PCG solve was in flight
    assert lc_t.gba_dispatched == {"dense": 0, "pcg": 1}
    assert lc_t.gba_applied == 1 and lc_t._gba is None
    assert stats_t == stats_j
    assert stats_t["keyframes_freed"] == 1
    assert stats_t["points_freed"] >= len(kill_t)
    n = tm.n_keyframes
    assert (n, tm.n_points) == (jm.n_keyframes, jm.n_points)
    assert n == compacted["n_kf"] - 1
    np.testing.assert_array_equal(tm.observations(), jm.observations())
    np.testing.assert_array_equal(tm.kf_parent, jm.kf_parent)
    assert tm.pt_valid[: tm.n_points].all()
    assert int(tr.dmap.n_points) == tm.n_points
    np.testing.assert_array_equal(tr.carry.pt_idx.numpy(),
                                  np.asarray(compacted["jax"][2].carry.pt_idx))
    # the loop closer's keyframe ids after the remap
    assert [(i, j) for i, j, _ in lc_t.loop_edges] == [
        (i, j) for i, j, _ in lc_j.loop_edges]
    assert lc_t.last_loop_kf == lc_j.last_loop_kf
    assert sorted(lc_t.db.bow) == sorted(lc_j.db.bow)
    assert {k: sorted(v) for k, v in lc_t.db.inverted.items()} == {
        k: sorted(v) for k, v in lc_j.db.inverted.items()}
    assert [(sorted(g), c) for g, c in lc_t.consistent_groups] == [
        (sorted(g), c) for g, c in lc_j.consistent_groups]
    np.testing.assert_allclose(_centres(tm.kf_pose[:n]),
                               _centres(jm.kf_pose[:n]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_pose[:n, :3, :3],
                               jm.kf_pose[:n, :3, :3], rtol=0, atol=1e-3)
