"""The shell of the port against the JAX package's: ``io/kitti``,
``io/serialization`` and ``viz/replay`` (copies, held source-equal, the
last two up to their import line), and the command line
``python -m sivo_tpu_torch.cli``.

The command line runs end to end on the CPU (``--device cpu``) on its
own 12-frame KITTI directory made by ``tools/make_kitti_fixture``, held
to ``tests/test_cli_drive.py``'s checks and to the JAX package's command
line on the same directory, both ``--no-semantics``. Measured on that
directory (CPU, both runs pipelined): camera centres within 0.0204 m of
the JAX run's over 7.4 m of travel, rotation entries within 0.0015,
keyframes 5 against 4; the JAX mapper's stage timing and the CPU's
float reductions move the port's run by ~1 mm between runs. The test
holds centres within 0.06 m, rotation entries within 0.01 and keyframes
within 2.
"""

import inspect
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from sivo_tpu.io import kitti as j_kitti
from sivo_tpu.io import serialization as j_ser
from sivo_tpu.runtime import map_state as j_ms
from sivo_tpu.viz import replay as j_replay
from sivo_tpu_torch import cli
from sivo_tpu_torch.io import kitti as t_kitti
from sivo_tpu_torch.io import serialization as t_ser
from sivo_tpu_torch.runtime import map_state as t_ms
from sivo_tpu_torch.viz import replay as t_replay
from tools.make_kitti_fixture import make_fixture

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 12
SAVE_FRAMES = 3


# -- copies -------------------------------------------------------------------

def _source_lines(module, package, import_line):
    src = inspect.getsource(module).splitlines()
    imp = import_line.format(package=package)
    assert src.count(imp) == 1
    return [line for line in src if line != imp]


def test_kitti_source_equal():
    assert inspect.getsource(t_kitti) == inspect.getsource(j_kitti)


@pytest.mark.parametrize("pair", [
    (t_ser, j_ser, "from {package}.runtime.map_state import KeyFrameData, "
     "MapState"),
    (t_replay, j_replay, "from {package}.select.semantic import "
     "CLASS_COLOURS_BGR"),
], ids=["serialization", "replay"])
def test_source_equal_up_to_the_import(pair):
    port, jax_mod, line = pair
    assert (_source_lines(port, "sivo_tpu_torch", line)
            == _source_lines(jax_mod, "sivo_tpu", line))


# -- io/kitti -----------------------------------------------------------------

def test_kitti_loader_on_a_tiny_directory(tmp_path):
    rng = np.random.default_rng(0)
    for side in ("image_2", "image_3"):
        (tmp_path / side).mkdir()
    for i in range(3):
        cv2.imwrite(str(tmp_path / "image_2" / f"{i:06d}.png"),
                    rng.integers(0, 256, (40, 70, 3)).astype(np.uint8))
        cv2.imwrite(str(tmp_path / "image_3" / f"{i:06d}.png"),
                    rng.integers(0, 256, (40, 70)).astype(np.uint8))
    (tmp_path / "times.txt").write_text("0.0\n1.037e-01\n2.074e-01\n")
    t_seq = t_kitti.load_sequence(str(tmp_path))
    j_seq = j_kitti.load_sequence(str(tmp_path))
    assert len(t_seq) == len(j_seq) == 3
    assert t_seq.left_paths == j_seq.left_paths
    assert t_seq.right_paths == j_seq.right_paths
    np.testing.assert_array_equal(t_seq.timestamps, j_seq.timestamps)
    for i in range(3):
        (tl, tr), (jl, jr) = t_seq.read(i), j_seq.read(i)
        assert tl.shape == (40, 70, 3) and tr.shape == (40, 70)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(t_kitti.center_crop(tl, 32, 64),
                                      j_kitti.center_crop(jl, 32, 64))
    with pytest.raises(ValueError, match="smaller than target"):
        t_kitti.center_crop(tl, 48, 64)


# -- io/serialization ---------------------------------------------------------

def _make_map(ms, seed=0):
    """A small map built through MapState's own API: three keyframes,
    their points and cross observations, one point invalidated."""
    rng = np.random.default_rng(seed)
    m = ms.MapState(max_keyframes=8, max_points=64, kp_capacity=16)
    n = 16
    for k in range(3):
        data = ms.KeyFrameData(
            frame_id=2 * k, timestamp=0.1 * k,
            xy=rng.uniform(0, 100, (n, 2)).astype(np.float32),
            level=rng.integers(0, 8, n).astype(np.int32),
            angle=rng.uniform(-3, 3, n).astype(np.float32),
            desc_u8=rng.integers(0, 256, (n, 32)).astype(np.uint8),
            desc_bits=None,
            u_right=rng.uniform(-1, 100, n).astype(np.float32),
            depth=rng.uniform(-1, 30, n).astype(np.float32),
            sem_class=rng.integers(0, 15, n).astype(np.uint8),
            sem_confidence=rng.uniform(0, 1, n).astype(np.float32),
            sem_entropy=rng.uniform(0, 3, n).astype(np.float32),
            semantic=rng.uniform(size=n) < 0.8)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.1 * k, 0.0, -0.5 * k]
        m.add_keyframe(pose, np.eye(6, dtype=np.float32) * 0.01 * (k + 1),
                       data)
        pos = (rng.normal(0, 1, (5, 3)) + [0, 0, 6]).astype(np.float32)
        m.add_points(pos, rng.integers(0, 256, (5, 32)).astype(np.uint8),
                     rng.integers(0, 9, 5).astype(np.uint8), k,
                     np.arange(5), rng.integers(0, 8, 5).astype(np.int32))
        if k:
            m.add_observations(k, np.arange(5), np.arange(5, 10))
    m.mark_points_invalid([2])
    return m


MAP_ARRAYS = ("kf_pose", "kf_cov", "kf_valid", "pt_pos", "pt_normal",
              "pt_min_dist", "pt_max_dist", "pt_desc_u8", "pt_class",
              "pt_valid", "pt_ref_kf", "pt_first_kf")
KF_FIELDS = ("frame_id", "timestamp", "xy", "level", "angle", "desc_u8",
             "u_right", "depth", "sem_class", "sem_confidence",
             "sem_entropy", "semantic")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_map_saved_by_one_package_loads_in_the_other(writer, tmp_path):
    ser, ms, reader = ((j_ser, j_ms, t_ser) if writer == "jax"
                       else (t_ser, t_ms, j_ser))
    m = _make_map(ms)
    path = str(tmp_path / "map.npz")
    ser.save_map(path, m)
    back = reader.load_map(path)
    assert (back.n_keyframes, back.n_points) == (m.n_keyframes, m.n_points)
    assert (back.max_keyframes, back.max_points, back.kp_capacity,
            back.n_levels, back.scale_factor) == (
        m.max_keyframes, m.max_points, m.kp_capacity, m.n_levels,
        m.scale_factor)
    for name in MAP_ARRAYS:
        np.testing.assert_array_equal(getattr(back, name), getattr(m, name))
    for k in range(m.n_keyframes):
        for f in KF_FIELDS:
            np.testing.assert_array_equal(getattr(back.kf_data[k], f),
                                          getattr(m.kf_data[k], f))
    np.testing.assert_array_equal(back.observations(), m.observations())


# -- viz/replay ---------------------------------------------------------------

def test_draw_frame_images_equal():
    rng = np.random.default_rng(1)
    gray = rng.uniform(0, 255, (48, 80)).astype(np.float32)
    classes = rng.integers(0, 15, (48, 80)).astype(np.uint8)
    xy = rng.uniform(0, 80, (30, 2)).astype(np.float32)
    tracked, valid = rng.uniform(size=30) < 0.5, rng.uniform(size=30) < 0.8
    for status in ("", "frame 3  KFs 2  state OK"):
        got = t_replay.draw_frame(gray, classes, xy, tracked, valid, status)
        want = j_replay.draw_frame(gray, classes, xy, tracked, valid, status)
        assert got.shape == ((68 if status else 48), 80, 3)
        np.testing.assert_array_equal(got, want)


def test_map_renders_equal(tmp_path):
    m = _make_map(t_ms)
    traj = np.stack([m.kf_pose[k] for k in (0, 0, 1, 2, 2)])
    args = (m.pt_pos[: m.n_points], m.pt_valid[: m.n_points],
            m.kf_pose[: m.n_keyframes], traj)
    got = t_replay.draw_map_topdown(*args, size=200)
    np.testing.assert_array_equal(got,
                                  j_replay.draw_map_topdown(*args, size=200))
    assert (got != 255).any()
    session = types.SimpleNamespace(map=m, frame_poses=lambda: traj)
    for name, mod in (("t", t_replay), ("j", j_replay)):
        mod.render_session(session, str(tmp_path / name))
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "t" / "map_topdown.png")),
        cv2.imread(str(tmp_path / "j" / "map_topdown.png")))


# -- the command line ---------------------------------------------------------

def test_cli_without_arguments_prints_usage(capsys):
    assert cli.main([]) == 1
    assert "usage: python -m sivo_tpu_torch.cli" in capsys.readouterr().err
    assert cli.main(["a", "b", "c", "d", "e", "--device"]) == 1


def test_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, system = cli.run(["-", "settings.yaml", "basic_prototxt", "-", "."])
    assert (rc, system) == (1, None)
    assert "--device cpu" in capsys.readouterr().err


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    return Path(make_fixture(str(tmp_path_factory.mktemp("cli12")),
                             n_frames=N_FRAMES))


@pytest.fixture(scope="module")
def cli_runs(kitti_dir, tmp_path_factory):
    """The port's command line, the JAX package's on the same directory,
    and the port's with ``--save-frames`` on its first frames, run at
    once as subprocesses. Returns {name: (returncode, stdout, stderr,
    working directory)}."""
    short = tmp_path_factory.mktemp("cli_short")
    for side in ("image_2", "image_3"):
        (short / side).mkdir()
        for i in range(SAVE_FRAMES):
            shutil.copy(kitti_dir / side / f"{i:06d}.png", short / side)
    (short / "times.txt").write_text("".join(
        (kitti_dir / "times.txt").read_text().splitlines(True)[:SAVE_FRAMES]))
    settings = str(kitti_dir / "settings.yaml")
    commands = {
        "port": ["sivo_tpu_torch.cli", "-", settings, "basic_prototxt", "-",
                 str(kitti_dir), "--no-semantics", "--device", "cpu"],
        "jax": ["sivo_tpu.cli", "-", settings, "basic_prototxt", "-",
                str(kitti_dir), "--no-semantics"],
        "save": ["sivo_tpu_torch.cli", "-", settings, "basic_prototxt", "-",
                 str(short), "--no-semantics", "--device", "cpu",
                 "--save-frames", "frames"],
    }
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    procs = {}
    try:
        for name, args in commands.items():
            cwd = tmp_path_factory.mktemp(name)
            procs[name] = (cwd, subprocess.Popen(
                [sys.executable, "-m", *args], cwd=cwd, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        runs = {}
        for name, (cwd, proc) in procs.items():
            out, err = proc.communicate(timeout=1200)
            runs[name] = (proc.returncode, out, err, cwd)
        return runs
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _trajectory(cwd: Path, n: int) -> np.ndarray:
    rows = [ln.split() for ln in
            (cwd / "CameraTrajectory.txt").read_text().strip().splitlines()]
    assert len(rows) == n
    P = np.array([[float(x) for x in row] for row in rows])
    assert P.shape == (n, 12)
    return P.reshape(n, 3, 4)


def _keyframes(cwd: Path) -> int:
    text = (cwd / "keyframes_points.txt").read_text()
    nums = [int(s) for s in text.split() if s.isdigit()]
    assert "keyframes" in text.lower() and "points" in text.lower()
    assert nums and all(n > 0 for n in nums)
    return nums[0]


def test_cli_end_to_end_on_the_cpu(cli_runs, kitti_dir):
    """tests/test_cli_drive.py's checks on the port's command line."""
    rc, out, err, cwd = cli_runs["port"]
    assert rc == 0, err[-2000:]
    assert f"Images in the sequence: {N_FRAMES}" in out
    assert "Semantics bypassed" in out
    assert "median tracking time" in out
    P = _trajectory(cwd, N_FRAMES)
    np.testing.assert_allclose(P[0], np.eye(4)[:3], atol=1e-5)
    gt = np.load(kitti_dir / "gt_poses.npy")
    gt_rel = np.linalg.inv(gt[0]) @ gt[N_FRAMES - 1]
    gt_dist = float(np.linalg.norm(np.linalg.inv(gt_rel)[:3, 3]))
    est_dist = float(np.linalg.norm(P[-1][:, 3]))
    assert 0.3 * gt_dist < est_dist < 3.0 * gt_dist
    _keyframes(cwd)


def test_cli_trajectory_matches_the_jax_cli(cli_runs):
    rc, _, err, jax_cwd = cli_runs["jax"]
    assert rc == 0, err[-2000:]
    port, ref = (_trajectory(cli_runs[k][3], N_FRAMES) for k in ("port",
                                                                  "jax"))
    # KITTI rows are Rwc | twc: twc is the camera centre
    np.testing.assert_allclose(port[:, :, 3], ref[:, :, 3], rtol=0,
                               atol=0.06)
    np.testing.assert_allclose(port[:, :, :3], ref[:, :, :3], rtol=0,
                               atol=0.01)
    assert abs(_keyframes(cli_runs["port"][3]) - _keyframes(jax_cwd)) <= 2


def test_cli_saves_frame_overlays_and_the_map(cli_runs):
    rc, out, err, cwd = cli_runs["save"]
    assert rc == 0, err[-2000:]
    assert "Frame overlays + map render written to frames/" in out
    _trajectory(cwd, SAVE_FRAMES)
    for i in range(SAVE_FRAMES):
        img = cv2.imread(str(cwd / "frames" / f"frame_{i:06d}.png"))
        assert img is not None and img.shape == (352 + 20, 1024, 3)
    top = cv2.imread(str(cwd / "frames" / "map_topdown.png"))
    assert top is not None and top.shape == (800, 800, 3)
