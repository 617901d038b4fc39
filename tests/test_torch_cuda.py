"""Kernels K1 and K2 on the card against their plain PyTorch versions.

These tests need a CUDA card and nvcc (the kernels are built from
sivo_tpu_torch/csrc on first use); elsewhere they skip. On the GPU
machine: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports JAX, which that machine lacks). The
full-size checks are in chip_smoke.py; these cover the edge shapes:
K2 rows not a multiple of a CTA's 32 or a warp's 16, columns not a
multiple of the 8-column mma block, the 128-column tile or the 4-CTA
cluster split (and not of 4, which takes the attributes element by
element), ties whose columns fall in different CTAs of a cluster, no
columns, one row, warps with no valid row beside warps with one; K1
keypoints not a multiple of a block's 16, keypoints at and past the
clamp edges, a flat patch. K2 is also held at the mapper's fusion
parameters (th 3, nn_ratio 1.0, accept at TH_LOW) through
``matching.search_by_projection_points`` and at the loop closer's Sim3
parameters (``use_ur`` False, window th 7.5 at level +-1, TH_HIGH)
through ``matching.search_by_sim3``; the SLAM session (``System`` with
the local mapper) runs on the card against the same run on the CPU, and
so does the loop closer on tests/test_loopclosing.py's drifted
out-and-back map, built here with the port's own frontend. SegNet's
standard variant runs on the card in float32 against the CPU, and three
training steps of SegNet basic (``models/train.train_step``, the same
injected masks) do too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic
from sivo_tpu_torch.models import segnet, train
from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.ops import kernel_match, kernel_orb, matching, orb
from sivo_tpu_torch.optim import sim3_opt
from sivo_tpu_torch.place import vocabulary as t_voc
from sivo_tpu_torch.runtime import device_map, kf_store
from sivo_tpu_torch.runtime import frame as t_frame
from sivo_tpu_torch.runtime.loopclosing import LoopCloser
from sivo_tpu_torch.runtime.map_state import KeyFrameData, MapState
from sivo_tpu_torch.runtime.system import System
from sivo_tpu_torch.runtime.tracking import Tracker, make_camera

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _k1_both(cuda, raw, blur, lvl, xy):
    args = [torch.from_numpy(x).to(cuda) for x in (raw, blur, lvl, xy)]
    before = kernel_orb.LAUNCHES
    ang_k, desc_k = kernel_orb.orient_and_describe(*args)
    assert kernel_orb.LAUNCHES == before + 1
    ang_p, desc_p = kernel_orb.orient_and_describe_plain(*args)
    torch.cuda.synchronize()
    assert float((ang_k - ang_p).abs().max()) <= 1e-4
    assert torch.equal(orb.unpack_bits(desc_k), orb.unpack_bits(desc_p))
    return ang_k.cpu().numpy(), desc_k.cpu().numpy()


def test_k1_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    L, H, W, n = 3, 96, 160, 77  # n not a multiple of the block
    raw = rng.uniform(-3, 260, (L, H, W)).astype(np.float32)
    blur = rng.uniform(-3, 260, (L, H, W)).astype(np.float32)
    xy = np.stack([rng.integers(-20, W, n), rng.integers(-20, H, n)],
                  1).astype(np.float32)
    lvl = rng.integers(0, L, n).astype(np.int32)
    _k1_both(cuda, raw, blur, lvl, xy)


def test_k1_half_values_and_clamp_edges(cuda):
    """Exact .5 pixels (round half to even), values outside 0..255, and
    keypoints at, inside and past every clamp edge."""
    rng = np.random.default_rng(1)
    L, H, W = 2, 80, 120
    raw = (rng.integers(-40, 560, (L, H, W)) / 2).astype(np.float32)
    blur = (rng.integers(-40, 560, (L, H, W)) / 2).astype(np.float32)
    edge_x = [-60, -20, -1, 0, 1, W - 38, W - 37, W - 20, W, W + 50]
    edge_y = [-60, -19, -1, 0, 1, H - 38, H - 37, H - 20, H, H + 50]
    xy = np.array([(x, y) for x in edge_x for y in edge_y], np.float32)
    xy[::3] += 0.75  # truncated toward zero
    lvl = rng.integers(0, L, len(xy)).astype(np.int32)
    _k1_both(cuda, raw, blur, lvl, xy)


def test_k1_flat_patch(cuda):
    """m01 = m10 = 0: every bit 0 and angle 0."""
    L, H, W = 1, 64, 64
    canvas = np.full((L, H, W), 77.0, np.float32)
    xy = np.full((33, 2), 7.0, np.float32)
    lvl = np.zeros(33, np.int32)
    ang, desc = _k1_both(cuda, canvas, canvas.copy(), lvl, xy)
    assert (desc == 0).all() and (ang == 0).all()


def _k2_problem(cuda, n, m, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(k, lo, hi):
        return lo + (hi - lo) * torch.rand(k, generator=g, device=cuda)

    a = torch.randint(0, 256, (n, 32), generator=g, device=cuda,
                      dtype=torch.uint8)
    b = torch.randint(0, 256, (m, 32), generator=g, device=cuda,
                      dtype=torch.uint8)
    k = min(n, m) // 2
    b[:k] = a[:k]  # exact copies: ties at distance 0
    lvl = torch.floor(rnd(n, 0, 8))
    radius = torch.where(rnd(n, 0, 1) < 0.2, float("inf"), rnd(n, 20, 200))
    row = kernel_match.pack_row_attr(rnd(n, 0, 1024), rnd(n, 0, 352),
                                     rnd(n, 0, 1024), radius, lvl - 1, lvl,
                                     rnd(n, 0, 1) < 0.8)
    col = kernel_match.pack_col_attr_t(
        rnd(m, 0, 1024), rnd(m, 0, 352),
        torch.where(rnd(m, 0, 1) < 0.5, rnd(m, 0, 1024), -1.0),
        torch.floor(rnd(m, 0, 8)), rnd(m, 0, 1) < 0.9)
    return a, b, row, col


@pytest.mark.parametrize("n,m,use_ur", [(2048, 2048, True), (37, 53, True),
                                         (1, 300, False), (300, 1, False),
                                         (257, 0, True), (1, 2048, True),
                                         (17, 129, False), (33, 515, True),
                                         (100, 1663, False)])
def test_k2_kernel_equals_plain(cuda, n, m, use_ur):
    a, b, row, col = _k2_problem(cuda, n, m, seed=n + m)
    before = kernel_match.LAUNCHES
    out_k = kernel_match.masked_hamming_top2(a, b, row, col, use_ur)
    assert kernel_match.LAUNCHES == before + 1
    if m == 0:
        assert torch.isinf(out_k[0]).all() and (out_k[2] == 0).all()
        assert torch.isinf(out_k[1]).all() and (out_k[3] == 0).all()
        return
    out_p = kernel_match.masked_hamming_top2_plain(a, b, row, col, use_ur)
    torch.cuda.synchronize()
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p)


@pytest.mark.parametrize("use_ur", [True, False])
def test_k2_sparse_valid_rows(cuda, use_ur):
    """Few valid rows, as on the main path: most 16-row warps hold none
    and scan nothing, beside warps whose one valid row is their first,
    their last, or in the last, partial warp."""
    n, m = 301, 700
    a, b, row, col = _k2_problem(cuda, n, m, seed=11)
    valid = torch.zeros(n, dtype=torch.bool, device=cuda)
    valid[[0, 15, 47, 64, 65, 200, 300]] = True
    row[:, 6] = valid.float()
    out_k = kernel_match.masked_hamming_top2(a, b, row, col, use_ur)
    out_p = kernel_match.masked_hamming_top2_plain(a, b, row, col, use_ur)
    torch.cuda.synchronize()
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p)
    assert bool(torch.isfinite(out_k[0][valid]).any())
    assert torch.isinf(out_k[0][~valid]).all()


def test_k2_ties_across_cluster_ctas(cuda):
    """Row 0's descriptor sits at distance 0 in columns scanned by
    different CTAs of the cluster (128-column tiles dealt round-robin to
    4 CTAs): the first index is best and the second index second."""
    n, m = 3, 1100
    a, b, row, col = _k2_problem(cuda, n, m, seed=5)
    b[:] = a[1]  # every column at some equal distance from row 0 ...
    for j in (1000, 700, 517, 133):  # tiles 7, 5, 4, 1: CTAs 3, 1, 0, 1
        b[j] = a[0]
    ones = torch.ones(n, device=cuda)
    row = kernel_match.pack_row_attr(0 * ones, 0 * ones, 0 * ones,
                                     ones * float("inf"), -ones, 9 * ones,
                                     ones > 0)
    col = kernel_match.pack_col_attr_t(*(torch.zeros(m, device=cuda)
                                         for _ in range(4)),
                                       torch.ones(m, device=cuda) > 0)
    out_k = kernel_match.masked_hamming_top2(a, b, row, col, False)
    out_p = kernel_match.masked_hamming_top2_plain(a, b, row, col, False)
    torch.cuda.synchronize()
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p)
    assert float(out_k[0][0]) == 0.0 and float(out_k[1][0]) == 0.0
    assert int(out_k[2][0]) == 133 and int(out_k[3][0]) == 517
    # row 1 equals every other column: ties everywhere, indices 0 and 1
    assert int(out_k[2][1]) == 0 and int(out_k[3][1]) == 1


def test_wrappers_reject_bad_inputs(cuda):
    a = torch.zeros((8, 32), dtype=torch.uint8, device=cuda)
    row = torch.zeros((8, 8), device=cuda)
    col = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):
        kernel_match.masked_hamming_top2(a, a.float(), row, col)
    with pytest.raises(ValueError):
        kernel_match.masked_hamming_top2(a, a, row.cpu(), col)
    raw = torch.zeros((1, 64, 64), dtype=torch.uint8, device=cuda)
    lvl = torch.zeros(4, dtype=torch.int32, device=cuda)
    xy = torch.zeros((4, 2), device=cuda)
    with pytest.raises(ValueError):
        kernel_orb.orb_describe_cuda(raw, raw, lvl, xy)
    with pytest.raises(ValueError):
        kernel_orb.orb_describe_cuda(raw.float(), raw.float(), lvl.long(),
                                     xy)


def test_k2_fusion_search_equals_plain(cuda):
    """The mapper's fusion search (``mapping._fuse_search``): 2048
    candidate points projected into 2048 keypoints, th 3.0, nn_ratio
    1.0, TH_LOW acceptance; the card's result equals the CPU's."""
    rng = np.random.default_rng(7)
    n, m = 2048, 2048
    cur_xy = np.stack([rng.uniform(0, 1024, m), rng.uniform(0, 352, m)],
                      1).astype(np.float32)
    cur_desc = rng.integers(0, 256, (m, 32)).astype(np.uint8)
    pick = rng.integers(0, m, n)
    pt_desc = cur_desc[pick].copy()
    flip = rng.uniform(0, 1, (n, 32)) < 0.05  # near duplicates
    pt_desc[flip] ^= np.uint8(1)
    uvr = np.concatenate([cur_xy[pick] + rng.normal(0, 2, (n, 2)),
                          rng.uniform(0, 1024, (n, 1))], 1).astype(np.float32)
    args = dict(
        pt_desc=pt_desc, pt_visible=rng.uniform(0, 1, n) < 0.6,
        pt_uvr=uvr, pt_level=rng.integers(0, 8, n).astype(np.int32),
        pt_view_cos=rng.uniform(0.9, 1.0, n).astype(np.float32),
        cur_xy=cur_xy, cur_level=rng.integers(0, 8, m).astype(np.int32),
        cur_desc=cur_desc,
        cur_ur=np.where(rng.uniform(0, 1, m) < 0.5, -1.0,
                        rng.uniform(0, 1024, m)).astype(np.float32),
        cur_valid=rng.uniform(0, 1, m) < 0.9,
        scales=(1.2 ** np.arange(8)).astype(np.float32))

    def search(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in args.items()}
        return matching.search_by_projection_points(
            **t, th=3.0, nn_ratio=1.0, accept_th=matching.TH_LOW)

    before = kernel_match.LAUNCHES
    on_card = search(cuda)
    assert kernel_match.LAUNCHES == before + 1
    on_cpu = search(torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    assert int(on_cpu.n_matches) > 100


def _vo_cfg():
    cfg = t_config.SystemConfig()
    cam = t_config.CameraConfig(fx=180.0, fy=180.0, cx=160.0, cy=96.0,
                                width=320, height=192, bf=180.0 * 0.54,
                                fps=10.0)
    return dataclasses.replace(
        cfg, camera=cam,
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
        tracking=dataclasses.replace(cfg.tracking, min_init_keypoints=150),
        semantic=dataclasses.replace(cfg.semantic, th_entropy_reduction=0.02),
    )


def test_system_on_card_matches_cpu(cuda):
    """tests/test_torch_system.py's 10-frame VO world: the port's
    frontend on the CPU makes the frames once; the session runs on the
    card and on the CPU, the mapper drained after every frame. Lost and
    keyframe counts equal, poses within 1e-3 m."""
    cfg = _vo_cfg()
    world = synthetic.make_world(cfg.camera, seed=0)
    gt = synthetic.forward_trajectory(n_frames=10, speed=0.4)
    left, right, _ = synthetic.render_sequence(world, gt)
    cls, conf, ent = synthetic.constant_semantics(cfg.camera.height,
                                                  cfg.camera.width)
    statics = t_frame.make_statics(cfg)
    cpu = torch.device("cpu")
    frames = [t_frame.build_frame_nosegnet(statics, left[i], right[i], cls,
                                           conf, ent, device=cpu)
              for i in range(len(gt))]
    runs = {}
    for dev in (cuda, cpu):
        system = System(cfg=cfg, device=dev, max_keyframes=64,
                        max_points=20000)
        for i, f in enumerate(frames):
            system.track_frame(t_frame.Frame(*(x.to(dev) for x in f)),
                               i * 0.1)
            system.mapper.drain(system.tracker)
        runs[dev.type] = system
    card, host = runs["cuda"], runs["cpu"]
    assert card.n_lost() == host.n_lost() == 0
    assert card.map.n_keyframes == host.map.n_keyframes
    assert card.mapper.ba_solves >= 1
    assert card.mapper.points_triangulated > 0
    assert card.mapper.fuse_searches >= 2
    np.testing.assert_allclose(card.frame_poses()[:, :3, 3],
                               host.frame_poses()[:, :3, 3], rtol=0,
                               atol=1e-3)


def test_k2_sim3_search_equals_plain(cuda):
    """The loop closer's guided search (``matching.search_by_sim3``): two
    K2 launches at use_ur False, the window th * scale at level +-1;
    2048 keypoints a side related by a known Sim3, with missing points
    on both sides. The card's matches equal the CPU's."""
    rng = np.random.default_rng(11)
    n = 2048
    pc1 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 30, n)], 1).astype(np.float32)
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.array([0.4, -0.1, 0.3], np.float32)
    perm = rng.permutation(n)
    pc2 = ((pc1 - t) @ R)[perm].astype(np.float32)
    desc1 = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    desc2 = desc1[perm].copy()
    desc2[rng.uniform(0, 1, (n, 32)) < 0.05] ^= np.uint8(4)
    fx, fy, cx, cy = 700.0, 700.0, 512.0, 176.0

    def xy(pc):
        return (np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                          fy * pc[:, 1] / pc[:, 2] + cy], 1)
                + rng.normal(0, 1.5, (n, 2))).astype(np.float32)

    level1 = rng.integers(0, 8, n).astype(np.int32)
    arrays = [np.float32(1.0), R, t, pc1, rng.uniform(size=n) < 0.8, xy(pc1),
              level1, desc1, pc2, rng.uniform(size=n) < 0.8, xy(pc2),
              level1[perm], desc2, (1.2 ** np.arange(8)).astype(np.float32)]

    def search(dev):
        args = [torch.from_numpy(np.array(a)).to(dev) for a in arrays]
        return matching.search_by_sim3(*args, fx, fy, cx, cy)

    before = kernel_match.LAUNCHES
    on_card = search(cuda)
    assert kernel_match.LAUNCHES == before + 2
    on_cpu = search(torch.device("cpu"))
    assert torch.equal(on_card.cpu(), on_cpu)
    assert int((on_cpu >= 0).sum()) > 500


def _drifted_loop_map(dev, frames, kf_poses, cfg):
    """tests/test_loopclosing.py's map: each frame a keyframe at its
    drifted pose, 400 stereo points per keyframe, 150 shared with the
    previous keyframe; host map, device map and keyframe store in
    lockstep, on ``dev``."""
    m = MapState(max_keyframes=64, max_points=20000, kp_capacity=1024)
    tracker = Tracker(cfg=cfg, map=m, device=dev)
    cam = cfg.camera
    prev_ids = None
    for i, f in enumerate(frames):
        h = {k: getattr(f, k).cpu().numpy() for k in (
            "xy", "level", "angle", "desc_u8", "u_right", "depth", "valid")}
        nkp = len(h["xy"])
        data = KeyFrameData(
            frame_id=i, timestamp=i * 0.1, xy=h["xy"].copy(),
            level=h["level"].copy(), angle=h["angle"], desc_u8=h["desc_u8"],
            desc_bits=None, u_right=h["u_right"].copy(),
            depth=h["depth"].copy(), sem_class=np.zeros(nkp, np.uint8),
            sem_confidence=np.ones(nkp, np.float32),
            sem_entropy=np.zeros(nkp, np.float32), semantic=h["valid"])
        kf = m.add_keyframe(kf_poses[i], np.eye(6, dtype=np.float32) * 1e-4,
                            data)
        kp_idx = np.where((data.depth > 0) & data.semantic)[0][:400]
        T = kf_poses[i].astype(np.float64)
        Tinv = np.linalg.inv(T)
        z = data.depth[kp_idx]
        pc = np.stack([(data.xy[kp_idx, 0] - cam.cx) * z / cam.fx,
                       (data.xy[kp_idx, 1] - cam.cy) * z / cam.fy, z], -1)
        pw = (pc @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
        ids = m.add_points(pw, data.desc_u8[kp_idx],
                           data.sem_class[kp_idx], kf, kp_idx,
                           data.level[kp_idx])

        def t(a):
            return torch.from_numpy(np.array(a)).to(dev)

        kf_store.insert(tracker.kf_store, kf, xy=t(data.xy),
                        level=t(data.level), angle=t(data.angle),
                        desc_u8=t(data.desc_u8), u_right=t(data.u_right),
                        semantic=t(data.semantic),
                        sem_class=t(data.sem_class),
                        sem_confidence=t(data.sem_confidence),
                        sem_entropy=t(data.sem_entropy))
        sel = np.zeros(nkp, bool)
        sel[kp_idx] = True
        xw = np.zeros((nkp, 3), np.float32)
        xw[kp_idx] = pw
        tracker.dmap, dev_ids = device_map.add_points(
            tracker.dmap, t(sel), t(xw), t(data.desc_u8), t(data.sem_class),
            t(data.level), t((-T[:3, :3].T @ T[:3, 3]).astype(np.float32)),
            cfg.orb.scale_factor, cfg.orb.n_levels)
        np.testing.assert_array_equal(dev_ids.cpu().numpy()[kp_idx], ids)
        if prev_ids is not None:
            share = prev_ids[:150]
            slots = np.arange(850, 850 + len(share))
            pc_s = m.pt_pos[share].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
            zs = np.maximum(pc_s[:, 2], 0.1)
            us = cam.fx * pc_s[:, 0] / zs + cam.cx
            data.xy[slots, 0] = us
            data.xy[slots, 1] = cam.fy * pc_s[:, 1] / zs + cam.cy
            data.u_right[slots] = us - cam.bf / zs
            data.depth[slots] = zs
            data.level[slots] = 0
            m.add_observations(kf, share, slots)
        prev_ids = ids
    return m, tracker


_DRAW_SETS = sim3_opt.draw_sets


def _sets_drawn_on_the_cpu(valid, generator, n_hypotheses=128):
    """sim3_opt.draw_sets with a CPU generator of the same seed, so that
    the card and the CPU try the same minimal sets."""
    gen = torch.Generator().manual_seed(generator.initial_seed())
    return _DRAW_SETS(valid.cpu(), gen, n_hypotheses).to(valid.device)


def test_loop_closer_on_card_matches_cpu(cuda, monkeypatch):
    """The loop closer on the out-and-back map of tests/test_loopclosing.py
    (320x192, 13 keyframes, x drift 0.04 m per keyframe), on the card and
    on the CPU with the same Sim3 minimal sets: the loop closes at the
    same keyframe against the same candidate, corrected keyframe centres
    within 1e-3 m, and on the card every K2 search launched the kernel."""
    cfg = _vo_cfg()
    cfg = dataclasses.replace(cfg, orb=dataclasses.replace(
        cfg.orb, n_features=600, max_keypoints=1024))
    world = synthetic.make_world(cfg.camera, seed=0)
    fwd = synthetic.forward_trajectory(n_frames=7, speed=0.8, yaw_rate=0.0)
    gt = np.concatenate([fwd, fwd[::-1][1:]])
    left, right, _ = synthetic.render_sequence(world, gt)
    cls, conf, ent = synthetic.constant_semantics(cfg.camera.height,
                                                  cfg.camera.width)
    statics = t_frame.make_statics(cfg)
    cpu = torch.device("cpu")
    frames = [t_frame.build_frame_nosegnet(statics, left[i], right[i], cls,
                                           conf, ent, device=cpu)
              for i in range(len(gt))]
    drift = np.zeros((len(gt), 6), np.float32)
    drift[:, 0] = 0.04 * np.arange(len(gt))
    kf_poses = np.stack([se3.exp(torch.from_numpy(d)).numpy() @ g
                         for d, g in zip(drift, gt)]).astype(np.float32)
    desc = np.concatenate([f.desc_u8.numpy()[f.valid.numpy()]
                           for f in frames])
    voc = t_voc.train(desc, k=8, depth=3, seed=0)
    monkeypatch.setattr(sim3_opt, "draw_sets", _sets_drawn_on_the_cpu)
    runs = []
    for dev in (cuda, cpu):
        m, tracker = _drifted_loop_map(dev, frames, kf_poses, cfg)
        lc = LoopCloser(cfg=cfg, map=m, cam=make_camera(cfg), voc=voc)
        at = next((k for k in range(m.n_keyframes)
                   if lc.process_keyframe(tracker, k)), None)
        runs.append((lc, m, at))
    (lc_c, m_c, at_c), (lc_h, m_h, at_h) = runs
    assert at_c is not None and at_c == at_h
    assert lc_c.loop_events[0]["cand"] == lc_h.loop_events[0]["cand"]
    n = m_h.n_keyframes
    centres = [np.stack([-p[:3, :3].T @ p[:3, 3] for p in mm.kf_pose[:n]])
               for mm in (m_c, m_h)]
    np.testing.assert_allclose(centres[0], centres[1], rtol=0, atol=1e-3)
    assert lc_c.k2_launches == lc_c.k2_searches >= 4
    assert lc_h.k2_launches == 0
    assert lc_c.gba_applied == lc_h.gba_applied


def test_segnet_standard_on_card_matches_cpu(cuda):
    """SegNet standard at 64x128 in float32 with seeded weights (BN
    statistics off their defaults): the deterministic forward and the MC
    posterior with the same injected masks, card against CPU. TF32 is
    off (utils/precision), so the two differ by float32 summation order
    only."""
    state = segnet.init_params(0, variant="standard")
    rng = np.random.default_rng(1)
    for k in state:
        if k.endswith((".scale", ".var")):
            state[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, state[k].shape).astype(np.float32))
        elif k.endswith((".shift", ".mean", ".bias")):
            state[k] = torch.from_numpy(
                rng.normal(0, 0.1, state[k].shape).astype(np.float32))
    img = torch.from_numpy(rng.uniform(0, 255, (64, 128, 3)).astype(
        np.float32))
    masks = [torch.from_numpy(rng.uniform(size=sh) < 0.5) for sh in
             segnet.SegNet("standard").dropout_shapes(64, 128, 3)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = segnet.SegNet("standard", dtype=torch.float32)
        model.load_state_dict(state)
        model = model.to(dev).eval()
        with torch.no_grad():
            probs = model(img.to(dev))
            post = segnet.segment_image(model, img.to(dev), None, 3,
                                        masks=[m.to(dev) for m in masks])
        out[dev.type] = [probs.cpu(), *(x.cpu() for x in post)]
    probs_k, cls_k, conf_k, ent_k = out["cuda"]
    probs_c, cls_c, conf_c, ent_c = out["cpu"]
    torch.testing.assert_close(probs_k, probs_c, rtol=0, atol=1e-4)
    assert float((cls_k != cls_c).float().mean()) <= 1e-3
    torch.testing.assert_close(conf_k, conf_c, rtol=0, atol=1e-4)
    torch.testing.assert_close(ent_k, ent_c, rtol=0, atol=1e-3)


def test_training_steps_on_card_match_cpu(cuda):
    """SegNet basic at 32x64, batch 2, the same batch and injected
    keep-masks, card against CPU over three Adam steps: the float32 loss
    at the start (rtol 1e-5); then in float64 at every step the loss
    (rtol 1e-5) and the gradients (atol 1e-5 x the tensor's max |g|)
    from the same weights, and the weights after both devices'
    ``torch.optim.Adam`` take the CPU's gradients (atol 1e-10). Both
    devices step on the same gradients because Adam's update is +-lr
    wherever |g| is rounding noise, and a few steps of a loss that jumps
    about at this learning rate amplify those flips. The
    gradients are held in float64 because in float32 a pre-activation
    within rounding of 0 can fall on the other side of a ReLU on the
    card than on the CPU, which moves a few weights' gradients by
    percents of the largest for some draws of the weights
    (``init_params(seed=0)`` at this size)."""
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.uniform(0, 255, (2, 32, 64, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, (2, 32, 64)))
    weights = torch.from_numpy(train.class_balance_weights(
        labels.numpy(), 15))
    masks = [torch.from_numpy(rng.uniform(size=sh) < 0.5) for sh in
             segnet.SegNet().dropout_shapes(32, 64, 2)]
    devs = {"cuda": cuda, "cpu": torch.device("cpu")}
    loss32, models, opts = {}, {}, {}
    for name, dev in devs.items():
        model = segnet.SegNet().to(dev)
        model.load_state_dict(segnet.init_params(seed=0))
        with torch.no_grad():
            loss32[name] = float(train.loss_fn(
                model, images.to(dev), labels.to(dev), weights.to(dev),
                masks=[m.to(dev) for m in masks]))
        model = segnet.SegNet(dtype=torch.float64)
        model.load_state_dict(segnet.init_params(seed=0))
        models[name] = model.to(dev, torch.float64)
        opts[name] = torch.optim.Adam(models[name].parameters(), lr=1e-3)
    assert loss32["cuda"] == pytest.approx(loss32["cpu"], rel=1e-5)
    for _ in range(3):
        losses, grads = {}, {}
        for name, dev in devs.items():
            opts[name].zero_grad(set_to_none=True)
            loss = train.loss_fn(
                models[name], images.to(dev, torch.float64), labels.to(dev),
                weights.to(dev, torch.float64),
                masks=[m.to(dev) for m in masks])
            loss.backward()
            losses[name] = float(loss.detach())
            grads[name] = {k: p.grad.cpu()
                           for k, p in models[name].named_parameters()}
        assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)
        for k, g in grads["cpu"].items():
            torch.testing.assert_close(grads["cuda"][k], g, rtol=0,
                                       atol=1e-5 * float(g.abs().max()))
        for k, p in models["cuda"].named_parameters():
            p.grad.copy_(grads["cpu"][k])
        opts["cuda"].step()
        opts["cpu"].step()
        card = dict(models["cuda"].named_parameters())
        for k, p in models["cpu"].named_parameters():
            torch.testing.assert_close(card[k].detach().cpu(), p.detach(),
                                       rtol=0, atol=1e-10)
