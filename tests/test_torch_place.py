"""The port's vocabulary and keyframe database against the JAX package on
the CPU. Everything here is integer-valued or a pure selection, so the
tolerance is exact equality: ``transform``'s words and parents on the
repository's offline vocabulary (``sivo_tpu/place/data/orbvoc_synth.npz``,
k=10, depth=5) and on a small vocabulary trained by both packages from
the same descriptors (whose arrays and idf weights are equal too); BoW
vectors; the database's loop and relocalization candidates; and the npz
and text round trips (the port reads the JAX package's files and the
JAX package the port's)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.place import database as j_db
from sivo_tpu.place import vocabulary as j_voc
from sivo_tpu_torch.place import database as t_db
from sivo_tpu_torch.place import vocabulary as t_voc

torch.set_num_threads(2)
OFFLINE = (Path(__file__).resolve().parents[1] / "sivo_tpu" / "place" / "data"
           / "orbvoc_synth.npz")


def _descriptors(seed, n, base=None, flip=0.08):
    """Random packed descriptors; with ``base``, noisy copies of it (so
    that descents share paths and distances tie)."""
    rng = np.random.default_rng(seed)
    if base is None:
        return rng.integers(0, 256, (n, 32), dtype=np.uint8)
    bits = np.unpackbits(base[rng.integers(0, len(base), n)], axis=1,
                         bitorder="little")
    bits ^= (rng.uniform(size=bits.shape) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1, bitorder="little")


@pytest.fixture(scope="module")
def offline():
    return j_voc.load_npz(str(OFFLINE)), t_voc.load_npz(str(OFFLINE))


@pytest.fixture(scope="module")
def trained():
    desc = np.concatenate([_descriptors(0, 600),
                           _descriptors(1, 600, _descriptors(2, 40))])
    return (j_voc.train(desc, k=8, depth=3, seed=0),
            t_voc.train(desc, k=8, depth=3, seed=0), desc)


def _words_both(vj, vt, desc, valid):
    bits = np.unpackbits(desc, axis=1, bitorder="little").astype(np.float32)
    wj, pj = j_voc.transform(vj, jnp.asarray(bits), jnp.asarray(valid))
    wt, pt = t_voc.transform(vt, torch.from_numpy(desc),
                             torch.from_numpy(valid))
    return (np.asarray(wj), np.asarray(pj)), (wt.numpy(), pt.numpy())


def _assert_same_words(j, t):
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[0].dtype == t[1].dtype == np.int32


def test_offline_vocabulary_arrays(offline):
    vj, vt = offline
    assert (vt.k, vt.depth, vt.n_words) == (vj.k, vj.depth, vj.n_words)
    np.testing.assert_array_equal(
        vt.centroids, j_voc._pack_bits_np(np.asarray(vj.centroids)))
    np.testing.assert_array_equal(vt.children, np.asarray(vj.children))
    np.testing.assert_array_equal(vt.word_id, np.asarray(vj.word_id))
    np.testing.assert_array_equal(vt.word_weights,
                                  np.asarray(vj.word_weights))


def test_transform_equal_on_the_offline_vocabulary(offline):
    vj, vt = offline
    rng = np.random.default_rng(3)
    # random descriptors, and noisy copies of the tree's own centroids,
    # whose descents pass close to ties
    desc = np.concatenate([
        _descriptors(4, 1024),
        _descriptors(5, 1024, vt.centroids[1:2000], flip=0.02)])
    valid = rng.uniform(size=len(desc)) < 0.9
    j, t = _words_both(vj, vt, desc, valid)
    _assert_same_words(j, t)
    assert len(np.unique(t[0][t[0] >= 0])) > 300
    assert (t[0][~valid] == -1).all() and (t[1][~valid] == -1).all()


def test_trained_vocabulary_equal(trained):
    vj, vt, desc = trained
    assert (vt.k, vt.depth, vt.n_words) == (vj.k, vj.depth, vj.n_words)
    np.testing.assert_array_equal(
        vt.centroids, j_voc._pack_bits_np(np.asarray(vj.centroids)))
    np.testing.assert_array_equal(vt.children, np.asarray(vj.children))
    np.testing.assert_array_equal(vt.word_id, np.asarray(vj.word_id))
    np.testing.assert_array_equal(vt.word_weights,
                                  np.asarray(vj.word_weights))
    valid = np.ones(len(desc), bool)
    _assert_same_words(*_words_both(vj, vt, desc, valid))


def test_bow_vectors_equal(trained):
    vj, vt, desc = trained
    j, t = _words_both(vj, vt, desc[:500], np.ones(500, bool))
    bj, bt = j_voc.bow_vector(vj, j[0]), t_voc.bow_vector(vt, t[0])
    assert bj == bt and abs(sum(bt.values()) - 1.0) < 1e-6


def _round_trips(voc_mod, voc, tmp_path, tag):
    voc_mod.save_npz(str(tmp_path / f"{tag}.npz"), voc)
    voc_mod.save_text(voc, str(tmp_path / f"{tag}.txt"))


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_files_round_trip_between_packages(trained, tmp_path, fmt):
    vj, vt, desc = trained
    _round_trips(j_voc, vj, tmp_path, "j")
    _round_trips(t_voc, vt, tmp_path, "t")
    load_t = t_voc.load_npz if fmt == "npz" else t_voc.load_text
    load_j = j_voc.load_npz if fmt == "npz" else j_voc.load_text
    valid = np.ones(len(desc), bool)
    want = _words_both(vj, vt, desc, valid)[1]
    for vt2 in (load_t(str(tmp_path / f"t.{fmt}")),
                load_t(str(tmp_path / f"j.{fmt}"))):
        assert vt2.n_words == vt.n_words
        np.testing.assert_allclose(vt2.word_weights, vt.word_weights,
                                   rtol=1e-6)
        got = _words_both(vj, vt2, desc, valid)[1]
        np.testing.assert_array_equal(got[0], want[0])
    vj2 = load_j(str(tmp_path / f"t.{fmt}"))
    np.testing.assert_array_equal(_words_both(vj2, vt, desc, valid)[0][0],
                                  want[0])


def _databases(vj, vt, n_kf=24):
    """Both databases fed the same 24 keyframes: three revisits of 8
    places, each keyframe a noisy copy of its place's descriptors."""
    places = [_descriptors(100 + p, 300) for p in range(8)]
    dbj = j_db.KeyFrameDatabase(n_words=vj.n_words)
    dbt = t_db.KeyFrameDatabase(n_words=vt.n_words)
    bows = []
    for kf in range(n_kf):
        desc = _descriptors(200 + kf, 300, places[kf % 8], flip=0.04)
        j, t = _words_both(vj, vt, desc, np.ones(300, bool))
        bj, bt = j_voc.bow_vector(vj, j[0]), t_voc.bow_vector(vt, t[0])
        assert bj == bt
        dbj.add(kf, bj)
        dbt.add(kf, bt)
        bows.append(bt)
    return dbj, dbt, bows


def test_database_candidates_equal(trained):
    vj, vt, _ = trained
    dbj, dbt, bows = _databases(vj, vt)
    # covisible groups: each keyframe with its temporal neighbours
    groups = {k: [n for n in (k - 1, k + 1, k - 2) if 0 <= n < 24]
              for k in range(24)}
    dbj.erase(5)
    dbt.erase(5)
    n_loop = 0
    for q in range(8, 24):
        connected = {q - 1, q - 2}
        scores_j, scores_t = {}, {}
        cj = dbj.detect_loop_candidates(q, bows[q], 0.01, connected, groups,
                                        scores_out=scores_j)
        ct = dbt.detect_loop_candidates(q, bows[q], 0.01, connected, groups,
                                        scores_out=scores_t)
        assert ct == cj and scores_t == scores_j
        n_loop += len(ct)
        assert (dbt.detect_relocalization_candidates(bows[q], groups)
                == dbj.detect_relocalization_candidates(bows[q], groups))
    assert n_loop > 0
    assert t_voc.l1_score(bows[0], bows[8]) > t_voc.l1_score(bows[0],
                                                             bows[9])
