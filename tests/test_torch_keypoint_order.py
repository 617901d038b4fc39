"""Keypoint slot order, the port against the JAX package, at full size
on dumbbell434's frame 250 (``make_dumbbell_world(seed=0)`` along
``figure8_trajectory``, the default 352x1024 configuration, 2048
slots): the frontend's pyramid, FAST and ``select_keypoints``, as
``build_frame_nosegnet`` runs them.

On this frame the two packages put the same six level-1 keypoints in
slots 700-705, rotated by one. The cause is float rounding, not the
port's tie order:

* the antialiased resize of level 1 rounds differently in the two
  frameworks (up to 4.5e-3 of a grey level here; tolerance 1e-2);
* FAST takes differences of bfloat16 grey levels, whose step from 128
  to 256 is 1, so where a ring pixel straddles a rounding boundary a
  score moves by 1 (level 1 (232, 553): 55 in JAX, 56 in the port; at
  most 4 such pixels on the frame, each by at most 1);
* the slot sort key ``level * 1e9 - score`` is float32, whose step at
  level 1 is 64, so every level-1 score from 32.25 to 95.75 shares a
  key, and the order inside such a run is the per-level ranking before
  it: the keypoint whose score moved jumps from the end of its run to
  the front.

Held: given the JAX package's own score map, the port's selection
equals JAX's slot for slot (the tie order is JAX's; this is what
integer parity needs). On its own score map the port selects the same
keypoints, and each slot whose keypoint differs lies inside a run of
equal sort keys in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.config import SystemConfig as JConfig
from sivo_tpu.io import synthetic
from sivo_tpu.ops import fast as j_fast
from sivo_tpu.ops import image as j_image
from sivo_tpu.ops import orb as j_orb
from sivo_tpu.runtime import frame as j_frame
from sivo_tpu_torch.config import SystemConfig as TConfig
from sivo_tpu_torch.ops import fast as t_fast
from sivo_tpu_torch.ops import image as t_image
from sivo_tpu_torch.ops import orb as t_orb
from sivo_tpu_torch.runtime import frame as t_frame

torch.set_num_threads(2)
CPU = torch.device("cpu")
FRAME = 250
PYRAMID_ATOL = 1e-2  # grey levels; measured 4.5e-3
MAX_SCORES_APART = 4  # FAST scores apart, each by <= 1; measured 1


@pytest.fixture(scope="module")
def selections():
    cfg = JConfig()
    world = synthetic.make_dumbbell_world(cfg.camera, seed=0)
    pose = synthetic.figure8_trajectory(synthetic.figure8_lap_frames())
    left, _, _ = synthetic.render_sequence(world, pose[FRAME:FRAME + 1],
                                           ss=2)
    gray = left[0].astype(np.float32)
    js, ts = j_frame.make_statics(cfg), t_frame.make_statics(TConfig())

    @jax.jit
    def jax_front(g):
        raw, _ = j_image.build_pyramid(g, js.spec)
        valid = j_image.level_valid_mask(js.spec, margin=16)
        score = j_fast.detect(raw, valid, ini_threshold=js.ini_th,
                              min_threshold=js.min_th)
        return raw, score, j_orb.select_keypoints(score, js.spec, js.budgets,
                                                  js.max_keypoints)

    raw_j, score_j, sel_j = jax_front(jnp.asarray(gray))
    raw_t, _ = t_image.build_pyramid(torch.from_numpy(gray), ts.spec)
    valid_t = t_image.level_valid_mask(ts.spec, margin=16, device=CPU)
    score_t = t_fast.detect(raw_t, valid_t, ini_threshold=ts.ini_th,
                            min_threshold=ts.min_th)
    sel_t = t_orb.select_keypoints(score_t, ts.spec, ts.budgets,
                                   ts.max_keypoints)
    # the port's selection on the JAX package's score map
    score_jt = torch.from_numpy(np.asarray(score_j, np.float32)).to(
        torch.bfloat16)
    sel_jt = t_orb.select_keypoints(score_jt, ts.spec, ts.budgets,
                                    ts.max_keypoints)
    as_np = lambda sel: tuple(np.asarray(a) for a in sel)  # noqa: E731
    return {"raw": (np.asarray(raw_j), raw_t.numpy()),
            "score": (np.asarray(score_j, np.float32),
                      score_t.float().numpy()),
            "jax": as_np(sel_j),
            "port": tuple(a.numpy() for a in sel_t),
            "port_on_jax_scores": tuple(a.numpy() for a in sel_jt)}


def _key(sel):
    """The float32 slot sort key of ``select_keypoints``."""
    _, level, score, _ = sel
    return level.astype(np.float32) * np.float32(1e9) - score


def test_pyramid_and_scores_within_rounding(selections):
    raw_j, raw_t = selections["raw"]
    np.testing.assert_allclose(raw_t, raw_j, rtol=0, atol=PYRAMID_ATOL)
    sj, st = selections["score"]
    apart = ~((sj == st) | (np.isneginf(sj) & np.isneginf(st)))
    assert apart.sum() <= MAX_SCORES_APART
    for y in zip(*np.where(apart)):
        a, b = sj[y], st[y]
        assert np.isfinite(a) and np.isfinite(b), y
        # one bfloat16 step of a grey level in [128, 256)
        assert abs(a - b) <= 1.0, (y, a, b)


def test_selection_on_the_same_scores_is_jax_slot_for_slot(selections):
    for a, b in zip(selections["port_on_jax_scores"], selections["jax"]):
        np.testing.assert_array_equal(a, b)


def test_own_selection_apart_only_inside_tied_keys(selections):
    xy_j, lv_j, _, v_j = selections["jax"]
    xy_t, lv_t, _, v_t = selections["port"]
    np.testing.assert_array_equal(v_t, v_j)

    def kps(xy, lv, v):
        return sorted(map(tuple, np.c_[xy[v], lv[v]].tolist()))

    assert kps(xy_t, lv_t, v_t) == kps(xy_j, lv_j, v_j)
    apart = np.where((xy_t != xy_j).any(1) | (lv_t != lv_j))[0]
    key_j, key_t = _key(selections["jax"]), _key(selections["port"])
    for s in apart:
        run_j = key_j == key_j[s]
        run_t = key_t == key_t[s]
        assert run_j.sum() > 1 and run_t.sum() > 1, s
        # the keypoint in this slot of the port sits in the same run of
        # tied keys in JAX's order
        where_j = np.where((xy_j == xy_t[s]).all(1) & (lv_j == lv_t[s]))[0]
        assert len(where_j) == 1 and run_j[where_j[0]], s
    # on this frame: slots 700-705, rotated by one
    np.testing.assert_array_equal(apart, np.arange(700, 706))
    np.testing.assert_array_equal(xy_t[701:706], xy_j[700:705])
    np.testing.assert_array_equal(xy_t[700], xy_j[705])
