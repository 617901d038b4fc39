"""The port's offline tools (``sivo_tpu_torch/tools/``) against the JAX
package's (``tools/train_offline_vocab.py``, ``tools/
train_bench_segnet.py``), on the CPU at small sizes:

* the vocabulary tool's six worlds and trajectories are the JAX tool's
  (the spec lists' source compared); one 1-frame world at a small
  camera yields uint8 (n, 32) descriptors; the tool's ``main``, given a
  seeded descriptor set, writes the words the JAX package's ``train``
  makes of it; its default output lies outside ``sivo_tpu/``;
* the bench trainer selects the JAX tool's training set (every 8th
  frame, half resolution, gray repeated to three channels), and its
  ``main`` renders, trains, writes a ``.caffemodel`` that loads back
  and reports a holdout accuracy (the renderer replaced by small
  frames, two steps); its default output lies outside ``sivo_tpu/``
  and neither tool names the JAX tools' ``/tmp`` files.
"""

import dataclasses
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.place import vocabulary as j_voc
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.io import synthetic
from sivo_tpu_torch.models import caffe_io, segnet
from sivo_tpu_torch.place import vocabulary as t_voc
from sivo_tpu_torch.tools import train_bench_segnet as t_bench
from sivo_tpu_torch.tools import train_offline_vocab as t_vocab_tool

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _spec_block(text: str) -> str:
    start = text.index("    specs = [\n")
    return text[start: text.index("\n    ]\n", start)]


def test_vocab_worlds_are_the_jax_tools():
    jax_src = (ROOT / "tools" / "train_offline_vocab.py").read_text()
    port_src = inspect.getsource(t_vocab_tool.world_specs)
    assert _spec_block(port_src) == _spec_block(jax_src)
    specs = t_vocab_tool.world_specs(t_config.SystemConfig().camera, 3)
    assert len(specs) == 6 and all(len(traj) == 3 for _, traj in specs)


def test_one_frame_world_yields_packed_descriptors(monkeypatch):
    """One 1-frame world at a 320x192 camera (the configuration and the
    worlds replaced through the module's names)."""
    cfg = t_config.SystemConfig()
    cfg = dataclasses.replace(
        cfg, camera=t_config.CameraConfig(
            fx=180.0, fy=180.0, cx=160.0, cy=96.0, width=320, height=192,
            bf=180.0 * 0.54, fps=10.0),
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024))

    def one_world(cam, frames_per_world):
        return [(synthetic.make_world(cam, seed=37, length=200.0,
                                      half_width=8.0),
                 synthetic.forward_trajectory(frames_per_world, speed=0.8,
                                              yaw_rate=0.004, seed=5))]

    monkeypatch.setattr(t_vocab_tool, "SystemConfig", lambda: cfg)
    monkeypatch.setattr(t_vocab_tool, "world_specs", one_world)
    desc = t_vocab_tool.collect_descriptors(1, CPU)
    assert desc.dtype == np.uint8 and desc.ndim == 2
    assert desc.shape[1] == 32 and 0 < desc.shape[0] <= 1024


def test_vocab_tool_writes_the_jax_words(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (30, 32), dtype=np.uint8)
    bits = np.unpackbits(base[rng.integers(0, 30, 900)], axis=1,
                         bitorder="little")
    bits ^= (rng.uniform(size=bits.shape) < 0.05).astype(np.uint8)
    desc = np.packbits(bits, axis=1, bitorder="little")
    monkeypatch.setattr(t_vocab_tool, "collect_descriptors",
                        lambda n, device: desc)
    out = tmp_path / "voc.npz"
    t_vocab_tool.main(["--frames-per-world", "1", "--k", "6", "--depth",
                       "3", "--out", str(out), "--device", "cpu"])
    got = t_voc.load_npz(str(out))
    want = j_voc.train(desc, k=6, depth=3, seed=0)
    assert got.n_words == want.n_words > 1
    np.testing.assert_array_equal(
        got.centroids, j_voc._pack_bits_np(np.asarray(want.centroids)))
    for field in ("children", "word_id", "word_weights"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    valid = np.ones(len(desc), bool)
    words, _ = t_voc.transform(got, torch.from_numpy(desc),
                               torch.from_numpy(valid))
    words_j, _ = j_voc.transform(want, jnp.asarray(bits, jnp.float32),
                                 jnp.asarray(valid))
    np.testing.assert_array_equal(words.numpy(), np.asarray(words_j))
    assert len(t_voc.bow_vector(got, words.numpy())) > 0


def test_default_outputs_lie_outside_the_jax_package():
    for module in (t_vocab_tool, t_bench):
        out = module.DEFAULT_OUT.resolve()
        assert ROOT / "build" in out.parents
        assert ROOT / "sivo_tpu" not in out.parents
        assert "/tmp/sivo" not in inspect.getsource(module)


def test_bench_training_set_is_the_jax_tools():
    rng = np.random.default_rng(1)
    left = rng.integers(0, 256, (20, 32, 64), dtype=np.uint8)
    cls = rng.integers(0, 15, (20, 32, 64)).astype(np.uint8)
    imgs, labels = t_bench.training_set(left, cls)
    # tools/train_bench_segnet.py's selection, written out
    sel = np.arange(0, 20, 8)
    want = np.repeat(left[sel, ::2, ::2].astype(np.float32)[..., None], 3,
                     axis=-1)
    np.testing.assert_array_equal(imgs, want)
    np.testing.assert_array_equal(labels, cls[sel, ::2, ::2])
    assert imgs.dtype == np.float32 and labels.dtype == np.int32


def test_bench_trainer_main_on_small_frames(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    shape = (t_bench.N_LAP, 32, 64)
    cls = np.kron(rng.integers(0, 3, (t_bench.N_LAP, 4, 8)),
                  np.ones((1, 8, 8), int)).astype(np.uint8)
    left = np.clip(cls * 90.0 + rng.normal(0, 8, shape), 0,
                   255).astype(np.uint8)
    seen = []

    def render(indices):
        seen.extend(indices)
        return left, cls

    monkeypatch.setattr(t_bench, "render_frames", render)
    out = tmp_path / "bench.caffemodel"
    acc = t_bench.main(["--out", str(out), "--steps", "2", "--device",
                        "cpu"])
    assert seen == sorted({*range(0, t_bench.N_LAP, 8), 4})
    assert 0.0 <= acc <= 1.0
    state = caffe_io.state_dict_from_caffemodel(
        str(out), "basic", segnet.init_params(seed=5))
    assert state.keys() == segnet.init_params(seed=0).keys()


def test_tools_need_a_card_or_a_cpu_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (t_vocab_tool, t_bench):
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main([])
