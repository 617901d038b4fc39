"""The loop closer's PCG global BA branch, the port's against the JAX
package's, through the closers themselves: tests/test_loopclosing.py's
drifted out-and-back map (320x192, 13 keyframes; described with K1's
semantics as in tests/test_torch_loopclosing.py), with the dense GBA's
keyframe cap (``GBA_KF``) lowered to 8 and a single PCG bucket of 10
keyframes (``GBA_BUCKETS``) in both closers, so that the closure's GBA
takes the PCG branch with a keyframe window (13 keyframes > 10): the
loop neighbourhoods first, then the most recent keyframes.

Both closers run ``process_keyframe`` over every keyframe (the port with
the JAX package's Sim3 minimal sets, as in
tests/test_torch_loopclosing.py), then ``finish_gba`` drives the paced
solve (begin, 10 steps, finish) and applies it. Parity, float32 on the
CPU: the same closure, the same dispatches (one PCG, no dense), the same
bucket and window, one window cap bind each, one application each, and
every keyframe's centre and rotation within 1e-3 (m) of the JAX
package's after the application, which moved the keyframes.
"""

import numpy as np
import pytest

from sivo_tpu.optim import ba_build as j_build
from sivo_tpu.optim import gba_cg as j_cg
from sivo_tpu.optim import local_ba as j_ba
from sivo_tpu.runtime.loopclosing import LoopCloser as JLoopCloser
from sivo_tpu_torch.optim import ba_build as t_build
from sivo_tpu_torch.optim import sim3_opt
from sivo_tpu_torch.runtime import loopclosing as t_lc
from sivo_tpu_torch.runtime.tracking import make_camera
from tests.test_loopclosing import loop_setup  # noqa: F401 (fixture)
from tests.test_torch_loopclosing import (  # noqa: F401 (fixture)
    _jax_draw_sets, _run, k1_loop_setup, port_config, port_map,
    port_tracker, port_vocabulary)

GBA_KF = 8
GBA_BUCKETS = ((10, 8192, 16384),)


def _centres(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


@pytest.fixture(scope="module")
def pcg_closed(k1_loop_setup):  # noqa: F811
    cfg_j, cam_j, jm, jtr, vj, _, _ = k1_loop_setup
    cfg = port_config(cfg_j)
    n_kf = jm.n_keyframes
    tm = port_map(jm)  # before the JAX closer edits its map in place
    tr = port_tracker(cfg, tm, jtr)
    calls = {"jax": {"dense": 0, "pcg": 0, "kfs": [], "caps": []},
             "port": {"kfs": [], "caps": []}}
    mp = pytest.MonkeyPatch()
    try:
        for cls in (JLoopCloser, t_lc.LoopCloser):
            mp.setattr(cls, "GBA_KF", GBA_KF)
            mp.setattr(cls, "GBA_BUCKETS", GBA_BUCKETS)
        for name, mod, fn in (("dense", j_ba, "global_bundle_adjustment"),
                              ("pcg", j_cg, "gba_cg_begin")):
            def counted(*args, _fn=getattr(mod, fn), _name=name, **kwargs):
                calls["jax"][_name] += 1
                return _fn(*args, **kwargs)
            mp.setattr(mod, fn, counted)
        for impl, mod in (("jax", j_build), ("port", t_build)):
            def kept(m, kfs, fixed, *caps, _fn=mod.build_problem,
                     _impl=impl):
                calls[_impl]["kfs"].append(list(kfs))
                calls[_impl]["caps"].append(tuple(caps[:3]))
                return _fn(m, kfs, fixed, *caps)
            mp.setattr(mod, "build_problem", kept)

        lc_j = JLoopCloser(cfg=cfg_j, map=jm, cam=cam_j, voc=vj)
        at_j = _run(lc_j, jtr, n_kf)
        applied_j = lc_j._gba is not None
        before_j = jm.kf_pose[:n_kf].copy()
        lc_j.finish_gba(jtr)

        mp.setattr(sim3_opt, "draw_sets", _jax_draw_sets)
        lc_t = t_lc.LoopCloser(cfg=cfg, map=tm, cam=make_camera(cfg),
                               voc=port_vocabulary(vj))
        at_t = _run(lc_t, tr, n_kf)
        applied_t = lc_t._gba is not None
        before_t = tm.kf_pose[:n_kf].copy()
        lc_t.finish_gba(tr)
    finally:
        mp.undo()
    return dict(n_kf=n_kf, calls=calls, before=(before_j, before_t),
                jax=(lc_j, jm, at_j, applied_j),
                port=(lc_t, tm, at_t, applied_t))


def test_pcg_dispatch_matches_jax(pcg_closed):
    lc_j, _, at_j, pending_j = pcg_closed["jax"]
    lc_t, _, at_t, pending_t = pcg_closed["port"]
    calls = pcg_closed["calls"]
    assert at_j is not None and at_t == at_j
    assert pending_j and pending_t  # a GBA in flight after the closure
    assert (calls["jax"]["dense"], calls["jax"]["pcg"]) == (0, 1)
    assert lc_t.gba_dispatched == {"dense": 0, "pcg": 1}
    assert lc_t.gba_applied == 1
    assert calls["port"]["caps"] == calls["jax"]["caps"] == [
        GBA_BUCKETS[0][:3]]
    # the window: 10 of the 13 keyframes, keyframe 0 (fixed) among them
    assert calls["port"]["kfs"] == calls["jax"]["kfs"]
    kfs = calls["port"]["kfs"][0]
    assert len(kfs) == GBA_BUCKETS[0][0] < pcg_closed["n_kf"] and 0 in kfs
    assert lc_t.cap_binds.get("gba_window") == lc_j.cap_binds.get(
        "gba_window") == 1


def test_pcg_applied_poses_match_jax(pcg_closed):
    _, jm, _, _ = pcg_closed["jax"]
    _, tm, _, _ = pcg_closed["port"]
    n = pcg_closed["n_kf"]
    assert jm.n_keyframes == tm.n_keyframes == n
    np.testing.assert_allclose(_centres(tm.kf_pose[:n]),
                               _centres(jm.kf_pose[:n]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_pose[:n, :3, :3],
                               jm.kf_pose[:n, :3, :3], rtol=0, atol=1e-3)
    # the solve moved the keyframes it was given, in both packages
    for m, before in zip((jm, tm), pcg_closed["before"]):
        moved = np.abs(_centres(m.kf_pose[:n]) - _centres(before)).max()
        assert moved > 1e-4, moved
