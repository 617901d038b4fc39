"""``chip_smoke.FrameLog``, phase 11's per-frame record, on a 12-frame
pipelined session of the port on the CPU (the VO world of
tests/test_torch_session.py, ``pipeline_depth=3``): one record per
frame, in frame order, every map-health count zero, the tracking step's
per-search counts filled where the search ran, the ``.npz`` read back
equal, and the field names those of ``tools/dumbbell_port_parity.py``'s
port side, so that a card record lines up with a CPU lockstep.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic
from sivo_tpu_torch.runtime import frame as t_frame
from sivo_tpu_torch.runtime.system import System

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM = t_config.CameraConfig(fx=180.0, fy=180.0, cx=160.0, cy=96.0,
                            width=320, height=192, bf=180.0 * 0.54, fps=10.0)
N_FRAMES = 12
PARITY = Path(__file__).resolve().parents[1] / "tools" / (
    "dumbbell_port_parity.py")
HEALTH = ("kf_nonfinite", "pt_nonfinite", "pt_nonfinite_host",
          "pt_unobserved")


def make_cfg():
    cfg = t_config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=CAM,
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
        tracking=dataclasses.replace(cfg.tracking, min_init_keypoints=150),
        semantic=dataclasses.replace(cfg.semantic, th_entropy_reduction=0.02),
    )


def parity_constant(name: str) -> tuple:
    """A tuple constant of the parity tool, read from its source (the
    tool puts JAX on the CPU at HIGHEST precision when imported)."""
    for node in ast.parse(PARITY.read_text()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


@pytest.fixture(scope="module")
def session():
    world = synthetic.make_world(CAM, seed=0)
    gt = synthetic.forward_trajectory(n_frames=14, speed=0.5)[:N_FRAMES]
    left, right, _ = synthetic.render_sequence(world, gt)
    cfg = make_cfg()
    statics = t_frame.make_statics(cfg)
    cls, conf, ent = synthetic.constant_semantics(CAM.height, CAM.width)
    system = System(cfg=cfg, device=CPU, max_keyframes=64,
                    max_points=20000, pipeline_depth=3)
    with cs.FrameLog(system) as log:
        for i in range(N_FRAMES):
            f = t_frame.build_frame_nosegnet(statics, left[i], right[i],
                                             cls, conf, ent, device=CPU)
            system.track_frame(f, i * 0.1, pipeline=True)
        system.flush()
    log.finish()
    return system, log


def test_one_record_per_frame_and_healthy(session):
    system, log = session
    recs = log.records
    assert [r["fid"] for r in recs] == list(range(N_FRAMES))
    assert system.n_lost() == 0 and not any(r["lost"] for r in recs)
    assert all(r[k] == 0 for r in recs[1:] for k in HEALTH)
    assert all(r[k] == 0 for r in recs
               for k in ("kf_nonfinite", "pt_nonfinite_host"))
    assert log.first_lost() is None and log.first_unhealthy() is None
    # the first frame initializes the map; the others are retired from
    # tickets, the last three by flush
    assert recs[0]["kf"] == 0 and recs[0]["ok"] == -1
    assert [r["call"] for r in recs[-3:]] == [N_FRAMES] * 3
    assert all(r["depth"] == 3 and not r["crisis"] for r in recs[1:-3])
    for r, t in zip(recs, system.tracker.trajectory):
        np.testing.assert_array_equal(r["pose"], t.pose)
        assert r["ref_kf"] == t.ref_kf
    assert sum(r["kf"] >= 0 for r in recs) == system.map.n_keyframes
    assert 0.0 < max(r["jump"] for r in recs) < 1.0  # 0.5 m per frame


def test_per_search_counts(session):
    _, log = session
    tracked = log.records[1:]
    # every frame searches the local map twice and polishes its pose
    assert all(r["local_n"] >= 0 and r["local_inl"] >= 0
               and r["research_n"] >= 0 and r["final_inl"] >= 0
               for r in tracked)
    assert all(r["final_inl"] <= r["research_n"] + r["n_tracked"]
               for r in tracked)
    # the anchor runs every second frame and right after a keyframe
    anchored = [r for r in tracked if r["bf_n"] >= 0]
    assert anchored and all(r["pnp_inl"] >= 0 and r["anchor_inl"] >= 0
                            and r["pnp_ok"] in (0, 1) for r in anchored)
    assert all(r["pnp_inl"] == r["anchor_inl"] == -1
               for r in tracked if r["bf_n"] < 0)
    # the local BA's re-anchors were recorded at the calls that made them
    stages = ",".join(r["stages"] for r in log.records)
    assert "map.ba_apply" in stages and "map.triangulate" in stages


def test_npz_round_trips(session, tmp_path):
    _, log = session
    path = tmp_path / "record.npz"
    assert log.save(str(path)) == path.stat().st_size > 0
    z = np.load(path)
    assert set(z.files) == set(log.records[0])
    for k in z.files:
        got = z[k]
        assert len(got) == N_FRAMES
        for g, r in zip(got, log.records):
            np.testing.assert_array_equal(g, r[k])


def test_field_names_match_the_parity_tool(session):
    _, log = session
    assert cs.RECORD_SUMMARY == parity_constant("SUMMARY_FIELDS")
    shared = ({f.lower() for f in cs.RECORD_SUMMARY}
              | set(parity_constant("RETIRED_FIELDS")) - {"sel"})
    assert shared <= set(log.records[0])
