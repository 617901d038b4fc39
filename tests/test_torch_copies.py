"""The port's copies of the JAX package's numpy-only modules stay equal
to their originals: ``sivo_tpu_torch/config.py`` (the default
``SystemConfig``, field for field), ``sivo_tpu_torch/io/synthetic.py``
(a tiny world rendered by both, array for array, exactly),
``sivo_tpu_torch/io/trajectory.py`` (every function's source, and the
files both write) and ``StageTimer`` of
``sivo_tpu_torch/utils/profiling.py`` (its class source; its
``scalar_sync`` takes a tensor and reads the same element), the numpy
functions of ``sivo_tpu_torch/place/vocabulary.py`` (``bow_vector``,
``l1_score``, ``bow_arrays``, ``l1_score_arrays``: source for source, up
to the JAX package's ``jnp.ndarray`` annotation of the words)
and ``sivo_tpu_torch/place/database.py`` (the whole module's source, up
to its import of the vocabulary module). The shell's copies are listed
in ``SHELL_COPIES`` and held file for file here, up to the import lines
that name the package; their own test files hold them function by
function and by behaviour: ``io/kitti.py``, ``io/serialization.py`` and
``viz/replay.py`` (``tests/test_torch_shell.py``), the protobuf wire
functions of ``models/caffe_io.py`` (``tests/test_torch_caffe_io.py``),
``native/sivo_native.cpp`` (``tests/test_torch_native.py``) and
``select/semantic.CLASS_COLOURS_BGR``. ``select/semantic.Classes`` is
held member for member, and ``models/train.class_balance_weights``
source for source. ``parallel/multi_sequence.py`` is held file for file
(it imports nothing of either package)."""

import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from sivo_tpu import config as j_config
from sivo_tpu.io import synthetic as j_synth
from sivo_tpu.io import trajectory as j_traj
from sivo_tpu.place import database as j_db
from sivo_tpu.place import vocabulary as j_voc
from sivo_tpu.utils import profiling as j_prof
from sivo_tpu.select import semantic as j_sem
from sivo_tpu.models import train as j_train
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic as t_synth
from sivo_tpu_torch.io import trajectory as t_traj
from sivo_tpu_torch.place import database as t_db
from sivo_tpu_torch.place import vocabulary as t_voc
from sivo_tpu_torch.select import semantic as t_sem
from sivo_tpu_torch.models import train as t_train
from sivo_tpu_torch.utils import profiling as t_prof

ROOT = Path(__file__).resolve().parents[1]

CAM_FIELDS = dict(fx=90.0, fy=90.0, cx=64.0, cy=40.0, width=128,
                  height=80, bf=90.0 * 0.54, fps=10.0)


def test_default_system_config_equal():
    assert (dataclasses.asdict(t_config.SystemConfig())
            == dataclasses.asdict(j_config.SystemConfig()))


def test_replaced_camera_config_equal():
    assert (dataclasses.asdict(t_config.CameraConfig(**CAM_FIELDS))
            == dataclasses.asdict(j_config.CameraConfig(**CAM_FIELDS)))


def _render(synth, config):
    cam = config.CameraConfig(**CAM_FIELDS)
    world = synth.make_world(cam, seed=3)
    gt = synth.forward_trajectory(n_frames=3, speed=0.5)
    left, right, cls = synth.render_sequence(world, gt)
    sem = synth.structured_semantics(cls[0], seed=7)
    loop = synth.make_loop_world(cam, seed=0, outer=16.0, inner=6.0)
    gt_loop = synth.square_loop_trajectory(n_frames=190, half=9.5,
                                           corner_r=3.5, jitter=0.03)[:2]
    l2, r2, c2 = synth.render_sequence(loop, gt_loop, ss=2)
    return [gt, *left, *right, *cls, *sem, gt_loop, *l2, *r2, *c2]


def test_synthetic_renders_equal():
    got = _render(t_synth, t_config)
    want = _render(j_synth, j_config)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_ate_rmse_equal():
    rng = np.random.default_rng(0)
    gt = j_synth.forward_trajectory(n_frames=6, speed=0.5)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (6, 3))
    assert t_synth.ate_rmse(est, gt) == j_synth.ate_rmse(est, gt)


TRAJECTORY_FUNCTIONS = ("_fmt", "kitti_line", "chained_frame_poses",
                        "save_trajectory_kitti", "save_keyframes_points")


def _public_functions(module):
    return sorted(name for name, obj in vars(module).items()
                  if inspect.isfunction(obj)
                  and obj.__module__ == module.__name__)


def test_trajectory_copy_has_the_same_functions():
    assert (_public_functions(t_traj) == _public_functions(j_traj)
            == sorted(TRAJECTORY_FUNCTIONS))


@pytest.mark.parametrize("name", TRAJECTORY_FUNCTIONS)
def test_trajectory_function_source_equal(name):
    assert (inspect.getsource(getattr(t_traj, name))
            == inspect.getsource(getattr(j_traj, name)))


def test_trajectory_files_equal(tmp_path):
    rng = np.random.default_rng(1)
    gt = j_synth.forward_trajectory(n_frames=5, speed=0.5)
    rel = [p @ np.linalg.inv(gt[0]) for p in gt]
    kf = gt[[0, 2]].copy()
    kf[1, :3, 3] += rng.normal(0, 0.1, 3)
    refs = [0, 0, 1, 1, 1]
    for mod, name in ((t_traj, "t"), (j_traj, "j")):
        poses = mod.chained_frame_poses(rel, refs, kf)
        mod.save_trajectory_kitti(str(tmp_path / f"{name}.txt"), poses)
        mod.save_keyframes_points(str(tmp_path / f"{name}_n.txt"), 2, 77)
    for suffix in (".txt", "_n.txt"):
        assert ((tmp_path / f"t{suffix}").read_bytes()
                == (tmp_path / f"j{suffix}").read_bytes())


def test_stage_timer_source_equal():
    assert (inspect.getsource(t_prof.StageTimer)
            == inspect.getsource(j_prof.StageTimer))
    timer = t_prof.StageTimer()
    with timer.stage("track"):
        pass
    assert timer.counts["track"] == 1
    assert timer.report_reference_style().startswith("median tracking time")


def test_scalar_sync_reads_the_first_element():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 1.5
    assert t_prof.scalar_sync(x) == j_prof.scalar_sync(np.asarray(x)) == 1.5


VOCABULARY_COPIES = ("bow_vector", "l1_score", "bow_arrays",
                     "l1_score_arrays")


@pytest.mark.parametrize("name", VOCABULARY_COPIES)
def test_vocabulary_function_source_equal(name):
    assert (inspect.getsource(getattr(t_voc, name))
            == inspect.getsource(getattr(j_voc, name)).replace(
                "words: jnp.ndarray", "words: np.ndarray"))


def test_database_source_equal_up_to_the_import():
    def lines(module, package):
        src = inspect.getsource(module).splitlines()
        imp = f"from {package}.place import vocabulary as voc_mod"
        assert src.count(imp) == 1
        return [line for line in src if line != imp]

    assert lines(t_db, "sivo_tpu_torch") == lines(j_db, "sivo_tpu")


# port file -> (original, lines that may differ only in the package name)
SHELL_COPIES = {
    "io/kitti.py": ("io/kitti.py", ()),
    "io/serialization.py": ("io/serialization.py", (
        "from {}.runtime.map_state import KeyFrameData, MapState",)),
    "viz/replay.py": ("viz/replay.py", (
        "from {}.select.semantic import CLASS_COLOURS_BGR",)),
    "native/sivo_native.cpp": ("native/sivo_native.cpp", ()),
}


@pytest.mark.parametrize("port_file", sorted(SHELL_COPIES))
def test_shell_copy_equal(port_file):
    original, imports = SHELL_COPIES[port_file]
    got = (ROOT / "sivo_tpu_torch" / port_file).read_text()
    want = (ROOT / "sivo_tpu" / original).read_text()
    for line in imports:
        assert got.count(line.format("sivo_tpu_torch")) == 1
        got = got.replace(line.format("sivo_tpu_torch"),
                          line.format("sivo_tpu"))
    assert got == want


def test_caffe_io_wire_code_equal():
    """The wire code (``_read_varint`` .. ``save_segnet_params``) is one
    contiguous block in both files."""
    def block(path):
        text = path.read_text()
        start = text.index("# minimal protobuf wire decoding")
        return text[start: text.index("def merge_params(")]

    assert (block(ROOT / "sivo_tpu_torch" / "models" / "caffe_io.py")
            == block(ROOT / "sivo_tpu" / "models" / "caffe_io.py"))


def test_class_colours_equal():
    np.testing.assert_array_equal(t_sem.CLASS_COLOURS_BGR,
                                  j_sem.CLASS_COLOURS_BGR)


def test_classes_equal_member_for_member():
    assert ([(c.name, c.value) for c in t_sem.Classes]
            == [(c.name, c.value) for c in j_sem.Classes])
    assert t_sem.STATIC_CLASS_MAX == j_sem.STATIC_CLASS_MAX


def test_class_balance_weights_source_equal():
    assert (inspect.getsource(t_train.class_balance_weights)
            == inspect.getsource(j_train.class_balance_weights))


def test_multi_sequence_copy_equal():
    got = (ROOT / "sivo_tpu_torch" / "parallel" / "multi_sequence.py")
    want = ROOT / "sivo_tpu" / "parallel" / "multi_sequence.py"
    assert got.read_text() == want.read_text()
