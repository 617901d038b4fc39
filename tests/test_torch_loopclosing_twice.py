"""Two loop closures in one session, the port's loop closer against the
JAX package's: tests/test_loopclosing.py's drifted map built along an
out-and-back driven twice (320x192, 25 keyframes whose x drifts 0.04 m
per keyframe, described with K1's semantics as in
tests/test_torch_loopclosing.py; ``forward_trajectory`` is patched for
the fixture so that its out-and-back becomes out, back, out, back).
The second revisit of
the start comes 12 keyframes after the first, past the closer's
10-keyframe gap (``min_kfs_since_last_loop``).

Both closers run ``process_keyframe`` over every keyframe (the port with
the JAX package's Sim3 minimal sets, as in
tests/test_torch_loopclosing.py), so the first closure's global BA is
applied on a later keyframe's poll and the second closure corrects a
map that holds the first one's loop edge; ``finish_gba`` then applies
the second closure's GBA. Parity, float32 on the CPU: two closures at
the same keyframes against the same candidates, the same loop edges and
GBA dispatches, and every keyframe's centre and rotation within 1e-3
(m) of the JAX package's at the end.
"""

import numpy as np
import pytest

from sivo_tpu.io import synthetic as j_synthetic
from sivo_tpu.runtime.loopclosing import LoopCloser as JLoopCloser
from sivo_tpu_torch.optim import sim3_opt
from sivo_tpu_torch.runtime import loopclosing as t_lc
from sivo_tpu_torch.runtime.tracking import make_camera
from tests.test_loopclosing import loop_setup  # noqa: F401 (fixture)
from tests.test_torch_loopclosing import (  # noqa: F401 (fixture)
    _jax_draw_sets, k1_loop_setup, port_config, port_map, port_tracker,
    port_vocabulary)


@pytest.fixture(scope="module")
def driven_twice():
    """While the module runs, ``forward_trajectory`` returns the
    out-and-back, which loop_setup drives out and back again."""
    forward = j_synthetic.forward_trajectory

    def out_and_back(*args, **kwargs):
        fwd = forward(*args, **kwargs)
        return np.concatenate([fwd, fwd[::-1][1:]])

    mp = pytest.MonkeyPatch()
    mp.setattr(j_synthetic, "forward_trajectory", out_and_back)
    yield
    mp.undo()


def _run_all(lc, tracker, n_kf):
    closed = [k for k in range(n_kf) if lc.process_keyframe(tracker, k)]
    lc.finish_gba(tracker)
    return closed


def _centres(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


@pytest.fixture(scope="module")
def closed_twice(driven_twice, k1_loop_setup):  # noqa: F811
    cfg_j, cam_j, jm, jtr, vj, _, _ = k1_loop_setup
    cfg = port_config(cfg_j)
    n_kf = jm.n_keyframes
    tm = port_map(jm)  # before the JAX closer edits its map in place
    tr = port_tracker(cfg, tm, jtr)
    lc_j = JLoopCloser(cfg=cfg_j, map=jm, cam=cam_j, voc=vj)
    at_j = _run_all(lc_j, jtr, n_kf)
    lc_t = t_lc.LoopCloser(cfg=cfg, map=tm, cam=make_camera(cfg),
                           voc=port_vocabulary(vj))
    mp = pytest.MonkeyPatch()
    mp.setattr(sim3_opt, "draw_sets", _jax_draw_sets)
    try:
        at_t = _run_all(lc_t, tr, n_kf)
    finally:
        mp.undo()
    return dict(n_kf=n_kf, jax=(lc_j, jm, at_j), port=(lc_t, tm, at_t))


def test_two_closures_match_jax(closed_twice):
    lc_j, _, at_j = closed_twice["jax"]
    lc_t, _, at_t = closed_twice["port"]
    assert closed_twice["n_kf"] == 25
    assert len(at_j) == 2 and at_t == at_j
    assert at_j[1] - at_j[0] >= 10
    assert lc_t.loops_closed == lc_j.loops_closed == 2
    assert [(e["kf"], e["cand"]) for e in lc_t.loop_events] == [
        (e["kf"], e["cand"]) for e in lc_j.loop_events]
    assert [(i, j) for i, j, _ in lc_t.loop_edges] == [
        (i, j) for i, j, _ in lc_j.loop_edges]
    # each closure's GBA dispatched (dense: 25 keyframes) and applied
    assert lc_t.gba_dispatched == {"dense": 2, "pcg": 0}
    assert lc_t.gba_applied == 2
    assert lc_j._gba is None and lc_t._gba is None


def test_two_closures_poses_match_jax(closed_twice):
    _, jm, _ = closed_twice["jax"]
    _, tm, _ = closed_twice["port"]
    n = closed_twice["n_kf"]
    np.testing.assert_allclose(_centres(tm.kf_pose[:n]),
                               _centres(jm.kf_pose[:n]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_pose[:n, :3, :3],
                               jm.kf_pose[:n, :3, :3], rtol=0, atol=1e-3)
