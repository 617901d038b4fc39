"""The mapper's device-map and keyframe-store updates against the JAX
package: ``add_obs_counts``, ``invalidate_points``, ``set_positions``
(ids with -1 entries, which both drop, and repeated ids, which
``add_obs_counts`` counts each time) and ``kf_store.gather``, on
seeded random maps. Integer and boolean outputs must be equal, and
positions too (they are copied, not computed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.runtime import device_map as j_dm
from sivo_tpu.runtime import kf_store as j_kfs
from sivo_tpu_torch.runtime import device_map as t_dm
from sivo_tpu_torch.runtime import kf_store as t_kfs

CAP = 300


def _maps(seed):
    """The same random map as a JAX and a port DeviceMap."""
    rng = np.random.default_rng(seed)
    fields = dict(
        pt_pos=rng.normal(0, 5, (CAP, 3)).astype(np.float32),
        pt_normal=rng.normal(0, 1, (CAP, 3)).astype(np.float32),
        pt_min_dist=rng.uniform(0, 1, CAP).astype(np.float32),
        pt_max_dist=rng.uniform(1, 9, CAP).astype(np.float32),
        pt_desc_u8=rng.integers(0, 256, (CAP, 32)).astype(np.uint8),
        pt_desc_ring=rng.integers(0, 256, (CAP, 4, 32)).astype(np.uint8),
        pt_class=rng.integers(0, 16, CAP).astype(np.uint8),
        pt_valid=rng.uniform(0, 1, CAP) < 0.8,
        pt_obs_count=rng.integers(1, 9, CAP).astype(np.int32),
        pt_visible=rng.integers(1, 20, CAP).astype(np.int32),
        pt_found=rng.integers(0, 9, CAP).astype(np.int32),
        n_points=np.int32(250),
    )
    j = j_dm.DeviceMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    t = t_dm.DeviceMap(**{k: torch.from_numpy(np.array(v))
                          for k, v in fields.items()})
    return j, t


def _ids(seed, n=64):
    """Ids with -1 padding, repeats, and the first and last slots."""
    rng = np.random.default_rng(seed + 100)
    ids = rng.integers(0, CAP, n).astype(np.int32)
    ids[::5] = -1
    ids[1], ids[2], ids[3] = 0, CAP - 1, ids[4]
    return ids


def _assert_maps_equal(j, t):
    for name, a in j._asdict().items():
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(a), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_add_obs_counts_matches_jax(seed):
    j, t = _maps(seed)
    ids = _ids(seed)
    _assert_maps_equal(j_dm.add_obs_counts(j, jnp.asarray(ids)),
                       t_dm.add_obs_counts(t, torch.from_numpy(ids)))


@pytest.mark.parametrize("seed", [0, 1])
def test_invalidate_points_matches_jax(seed):
    j, t = _maps(seed)
    ids = _ids(seed)
    _assert_maps_equal(j_dm.invalidate_points(j, jnp.asarray(ids)),
                       t_dm.invalidate_points(t, torch.from_numpy(ids)))


def test_set_positions_matches_jax():
    j, t = _maps(2)
    ids = np.unique(_ids(2))  # BA write-back ids are distinct
    ids = np.concatenate([ids, np.full(7, -1, np.int32)])
    pos = np.random.default_rng(3).normal(0, 3, (len(ids), 3)).astype(
        np.float32)
    _assert_maps_equal(
        j_dm.set_positions(j, jnp.asarray(ids), jnp.asarray(pos)),
        t_dm.set_positions(t, torch.from_numpy(ids), torch.from_numpy(pos)))


def test_all_minus_one_changes_nothing():
    j, t = _maps(4)
    ids = np.full(16, -1, np.int32)
    out = t_dm.add_obs_counts(t_dm.invalidate_points(
        t, torch.from_numpy(ids)), torch.from_numpy(ids))
    _assert_maps_equal(j, out)


def test_kf_store_gather_matches_jax():
    rng = np.random.default_rng(5)
    K, N = 6, 40
    j_store = j_kfs.make_kf_store(K, N)
    t_store = t_kfs.make_kf_store(K, N, torch.device("cpu"))
    for slot in range(K):
        f = dict(
            xy=rng.uniform(0, 300, (N, 2)).astype(np.float32),
            level=rng.integers(0, 8, N).astype(np.int32),
            angle=rng.uniform(-3, 3, N).astype(np.float32),
            desc_u8=rng.integers(0, 256, (N, 32)).astype(np.uint8),
            u_right=rng.uniform(-1, 300, N).astype(np.float32),
            semantic=rng.uniform(0, 1, N) < 0.5,
            sem_class=rng.integers(0, 15, N).astype(np.uint8),
            sem_confidence=rng.uniform(0, 1, N).astype(np.float32),
            sem_entropy=rng.uniform(0, 3, N).astype(np.float32),
        )
        j_store = j_kfs.insert(j_store, jnp.int32(slot),
                               *(jnp.asarray(v) for v in f.values()))
        t_kfs.insert(t_store, slot,
                     **{k: torch.from_numpy(v) for k, v in f.items()})
    idx = np.array([4, 0, 0, 5, 2], np.int32)
    j_g = j_kfs.gather(j_store, jnp.asarray(idx))
    t_g = t_kfs.gather(t_store, torch.from_numpy(idx))
    for name, a in j_g._asdict().items():
        np.testing.assert_array_equal(getattr(t_g, name).numpy(),
                                      np.asarray(a), err_msg=name)
