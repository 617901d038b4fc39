"""The port's native library (``sivo_tpu_torch/native``) against the JAX
package's.

``sivo_native.cpp`` is a byte-equal copy. The port builds it with the
host C++ compiler on first use; here, where ``c++`` exists, it must
build. Its vocabulary parse equals the Python parse and the JAX
package's native parse on a text vocabulary, ``vocabulary.load_text``
takes it (and counts the parse), and its inverted file gives the JAX
package's ``NativeInvertedFile`` counts.

The JAX package's library is used where it was built; otherwise this
test compiles the JAX package's own source into its temporary directory
and points the JAX bindings at it, so it never builds inside
``sivo_tpu/``.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sivo_tpu import native as j_native
from sivo_tpu.place import vocabulary as j_voc
from sivo_tpu_torch import native as t_native
from sivo_tpu_torch.place import vocabulary as t_voc

ROOT = Path(__file__).resolve().parents[1]


def test_source_is_a_byte_equal_copy():
    assert (t_native.SOURCE.read_bytes()
            == (ROOT / "sivo_tpu" / "native" / "sivo_native.cpp").read_bytes())


def test_library_builds_here():
    assert t_native.compiler() is not None
    assert t_native.available()
    assert t_native.library_path().exists()


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    if not j_native.available():
        so = tmp_path / "libsivo_native.so"
        subprocess.run([t_native.compiler(), *t_native.CXX_FLAGS, "-o",
                        str(so), str(Path(j_native._DIR) / "sivo_native.cpp")],
                       check=True, capture_output=True, timeout=300)
        monkeypatch.setattr(j_native, "_SO", str(so))
        monkeypatch.setattr(j_native, "_LIB", None)
    assert j_native.available()
    return j_native


@pytest.fixture(scope="module")
def voc_txt(tmp_path_factory):
    rng = np.random.default_rng(0)
    descs = rng.integers(0, 256, (800, 32)).astype(np.uint8)
    voc = t_voc.train(descs, k=4, depth=3, seed=0)
    path = tmp_path_factory.mktemp("voc") / "voc.txt"
    t_voc.save_text(voc, str(path))
    return str(path)


def test_parse_equals_the_jax_native_parse(voc_txt, jax_native):
    got = t_native.parse_vocabulary_text(voc_txt)
    want = jax_native.parse_vocabulary_text(voc_txt)
    assert got[:2] == want[:2] == (4, 3)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _python_parse(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(t_native, "available", lambda: False)
        return t_voc.load_text(path)


def test_load_text_takes_the_native_parse_equal_to_python(voc_txt,
                                                          monkeypatch):
    before = t_native.PARSES
    fast = t_voc.load_text(voc_txt)
    assert t_native.PARSES == before + 1
    slow = _python_parse(voc_txt, monkeypatch)
    assert t_native.PARSES == before + 1
    assert (fast.k, fast.depth, fast.n_words) == (slow.k, slow.depth,
                                                  slow.n_words)
    for name in ("centroids", "children", "word_id", "word_weights"):
        a, b = getattr(fast, name), getattr(slow, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_text_equals_the_jax_load_text(voc_txt, jax_native):
    t = t_voc.load_text(voc_txt)
    j = j_voc.load_text(voc_txt)
    assert (t.k, t.depth, t.n_words) == (j.k, j.depth, j.n_words)
    np.testing.assert_array_equal(
        t.centroids, np.packbits(np.asarray(j.centroids).astype(np.uint8),
                                 axis=-1, bitorder="little"))
    np.testing.assert_array_equal(t.children, np.asarray(j.children))
    np.testing.assert_array_equal(t.word_id, np.asarray(j.word_id))
    np.testing.assert_array_equal(t.word_weights, np.asarray(j.word_weights))
    # the same words for the same descriptors
    rng = np.random.default_rng(1)
    d = rng.integers(0, 256, (64, 32)).astype(np.uint8)
    words, _ = t_voc.transform(t, torch.from_numpy(d),
                               torch.ones(64, dtype=torch.bool))
    j_words, _ = j_voc.transform(j, np.unpackbits(
        d, axis=-1, bitorder="little").astype(np.float32), np.ones(64, bool))
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_words))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_native.parse_vocabulary_text(str(tmp_path / "none.txt"))


def test_inverted_file_counts_equal_jax(jax_native):
    rng = np.random.default_rng(2)
    t_inv = t_native.NativeInvertedFile(500)
    j_inv = jax_native.NativeInvertedFile(500)
    words = {kf: rng.choice(500, 40, replace=False).astype(np.int32)
             for kf in range(20)}
    for kf, w in words.items():
        t_inv.add(kf, w)
        j_inv.add(kf, w)
    for kf in (3, 11):
        t_inv.erase(kf, words[kf][:15])
        j_inv.erase(kf, words[kf][:15])
    for _ in range(5):
        q = rng.choice(520, 60, replace=False).astype(np.int32)  # some > n
        got = t_inv.shared_counts(q, 24)
        np.testing.assert_array_equal(got, j_inv.shared_counts(q, 24))
    assert got.sum() > 0
