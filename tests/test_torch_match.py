"""Parity of kernel K2's plain version (masked Hamming top-2), conflict
resolution and the three searches of the slice with the JAX package's
XLA branch (``matching._top2_masked`` on the CPU). Everything is
integer-valued or a pure selection, so the tolerance is exact equality
of distances and of both argmins, masked rows included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.ops import matching as j_match
from sivo_tpu_torch.ops import kernel_match
from sivo_tpu_torch.ops import matching as t_match

torch.set_num_threads(2)


def _pack(bits: np.ndarray) -> np.ndarray:
    """(N, 256) 0/1 -> (N, 32) uint8, LSB-first (the ORB packing)."""
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def _random_problem(seed, n=512, m=256, window=True):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(n, 256)) < 0.5).astype(np.float32)
    b = (rng.uniform(size=(m, 256)) < 0.5).astype(np.float32)
    # near-duplicates so that distances tie and the first-index rule shows
    b[: m // 4] = a[rng.integers(0, n, m // 4)]
    b[m // 4: 2 * (m // 4)] = b[: m // 4]
    u = rng.uniform(0, 1024, n).astype(np.float32)
    v = rng.uniform(0, 352, n).astype(np.float32)
    x = rng.uniform(0, 1024, m).astype(np.float32)
    y = rng.uniform(0, 352, m).astype(np.float32)
    radius = (rng.uniform(30, 120, n) if window
              else np.full(n, np.inf)).astype(np.float32)
    lvl_r = rng.integers(0, 8, n).astype(np.float32)
    lvl_c = rng.integers(0, 8, m).astype(np.float32)
    r_ur = rng.uniform(0, 1024, n).astype(np.float32)
    c_ur = np.where(rng.uniform(size=m) < 0.5, rng.uniform(0, 1024, m),
                    -1.0).astype(np.float32)
    r_valid = rng.uniform(size=n) < 0.9
    c_valid = rng.uniform(size=m) < 0.9
    return dict(a=a, b=b, u=u, v=v, ur=r_ur, radius=radius, lo=lvl_r - 1.0,
                hi=lvl_r, r_valid=r_valid, x=x, y=y, c_ur=c_ur,
                c_level=lvl_c, c_valid=c_valid)


def _both(p, use_ur):
    order = ("u", "v", "ur", "radius", "lo", "hi", "r_valid",
             "x", "y", "c_ur", "c_level", "c_valid")
    out_j = j_match._top2_masked(
        jnp.asarray(p["a"]), jnp.asarray(p["b"]),
        *(jnp.asarray(p[k]) for k in order), use_ur=use_ur,
    )
    out_t = t_match._top2_masked(
        torch.from_numpy(_pack(p["a"])), torch.from_numpy(_pack(p["b"])),
        *(torch.from_numpy(p[k]) for k in order), use_ur=use_ur,
    )
    return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t]


def _assert_equal(out_j, out_t):
    for name, a, b in zip(("best_d", "second_d", "best_j", "second_j"),
                          out_j, out_t):
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert out_t[2].dtype == np.int32 and out_t[0].dtype == np.float32


@pytest.mark.parametrize("use_ur", [True, False])
@pytest.mark.parametrize("window", [True, False])
def test_top2_plain_equals_xla_branch(use_ur, window):
    p = _random_problem(seed=3 + 2 * use_ur + window, window=window)
    out_j, out_t = _both(p, use_ur)
    _assert_equal(out_j, out_t)
    assert np.isfinite(out_t[0]).mean() > 0.5


@pytest.mark.parametrize("n,m", [(37, 53), (1, 300), (300, 1)])
def test_top2_ragged_shapes(n, m):
    p = _random_problem(seed=11, n=n, m=m)
    out_j, out_t = _both(p, True)
    _assert_equal(out_j, out_t)


def test_top2_masked_and_single_candidate_rows():
    p = _random_problem(seed=7, n=64, m=96)
    p["r_valid"][:16] = False  # fully masked rows
    # rows 16..31: exactly one column passes (a tight window on it)
    for i in range(16, 32):
        j = (5 * i) % 96
        p["u"][i], p["v"][i] = p["x"][j], p["y"][j]
        p["radius"][i] = 0.0
        p["lo"][i] = p["hi"][i] = p["c_level"][j]
        p["c_valid"][j] = True
    p["r_valid"][16:32] = True
    out_j, out_t = _both(p, False)
    _assert_equal(out_j, out_t)
    best_d, second_d, best_j, second_j = out_t
    assert np.isinf(best_d[:16]).all() and np.isinf(second_d[:16]).all()
    assert (best_j[:16] == 0).all() and (second_j[:16] == 0).all()
    assert np.isfinite(best_d[16:32]).all()
    assert np.isinf(second_d[16:32]).all() and (second_j[16:32] == 0).all()


@pytest.mark.parametrize("use_ur", [True, False])
@pytest.mark.parametrize("n,m", [(45, 130), (17, 515)])
def test_top2_masked_single_and_tied_rows_ragged(use_ur, n, m):
    """Ragged shapes (rows not a multiple of 16, columns not a multiple
    of 128) with fully masked rows, single-candidate rows, and rows
    whose candidates all tie at distance 0 (first index wins)."""
    p = _random_problem(seed=n + m + use_ur, n=n, m=m)
    p["r_valid"][:5] = False  # fully masked rows
    for i in range(5, 10):  # exactly one candidate: a tight window on it
        j = (7 * i) % m
        p["u"][i], p["v"][i] = p["x"][j], p["y"][j]
        p["radius"][i] = 0.0
        p["lo"][i] = p["hi"][i] = p["c_level"][j]
        p["r_valid"][i] = p["c_valid"][j] = True
        p["c_ur"][j] = -1.0
    tied = [m - 1, m // 2, 3]  # the same descriptor in three columns
    for i in range(10, 13):
        p["b"][tied] = p["a"][i]
        p["radius"][i] = np.inf
        p["lo"][i], p["hi"][i] = -1.0, 9.0
        p["r_valid"][i] = True
        p["c_valid"][tied] = True
        p["c_ur"][tied] = -1.0
    out_j, out_t = _both(p, use_ur)
    _assert_equal(out_j, out_t)
    best_d, second_d, best_j, second_j = out_t
    assert np.isinf(best_d[:5]).all() and (best_j[:5] == 0).all()
    assert np.isinf(second_d[5:10]).all() and (second_j[5:10] == 0).all()
    assert np.isfinite(best_d[5:10]).all()
    zero = np.flatnonzero((p["b"] == p["a"][12]).all(1) & p["c_valid"])
    assert zero[0] <= 3 and len(zero) >= 3
    assert best_d[12] == 0 and second_d[12] == 0
    assert best_j[12] == zero[0] and second_j[12] == zero[1]


def test_resolve_matches_jax():
    rng = np.random.default_rng(5)
    ns, nd = 400, 120
    best_d = rng.integers(0, 40, ns).astype(np.float32)
    best_j = rng.integers(0, nd, ns).astype(np.int32)
    matched = rng.uniform(size=ns) < 0.7
    rj = j_match._resolve(jnp.asarray(best_d), jnp.asarray(best_j),
                          jnp.asarray(matched), nd)
    rt = t_match._resolve(torch.from_numpy(best_d),
                          torch.from_numpy(best_j),
                          torch.from_numpy(matched), nd)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _frame_like(rng, n):
    bits = (rng.uniform(size=(n, 256)) < 0.5).astype(np.float32)
    return dict(
        bits=bits,
        xy=np.stack([rng.uniform(0, 640, n), rng.uniform(0, 200, n)],
                    1).astype(np.float32),
        level=rng.integers(0, 8, n).astype(np.int32),
        angle=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        ur=np.where(rng.uniform(size=n) < 0.6, rng.uniform(0, 640, n),
                    -1.0).astype(np.float32),
        valid=rng.uniform(size=n) < 0.9,
    )


def _noisy_copy(rng, f, flip=0.03, jitter=2.0):
    g = {k: v.copy() for k, v in f.items()}
    g["bits"] = np.where(rng.uniform(size=f["bits"].shape) < flip,
                         1.0 - f["bits"], f["bits"]).astype(np.float32)
    g["xy"] = (f["xy"] + rng.normal(0, jitter, f["xy"].shape)
               ).astype(np.float32)
    g["angle"] = (f["angle"] + rng.normal(0, 0.05, len(f["angle"]))
                  ).astype(np.float32)
    return g


def _tensors(f, packed_fn):
    return {k: (packed_fn(v) if k == "bits" else v) for k, v in f.items()}


def _cmp_result(rj, rt):
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


SCALES = (1.2 ** np.arange(8)).astype(np.float32)


@pytest.mark.parametrize("direction", ["none", "forward", "backward"])
def test_search_by_projection_frame_matches_jax(direction):
    rng = np.random.default_rng(21)
    prev = _frame_like(rng, 300)
    cur = _noisy_copy(rng, prev)
    proj = np.concatenate([prev["xy"], prev["ur"][:, None]], 1)
    proj_z = rng.uniform(-1, 30, 300).astype(np.float32)
    has = rng.uniform(size=300) < 0.8
    fwd, bwd = direction == "forward", direction == "backward"

    def run(lib, pack, arr):
        p, c = _tensors(prev, pack), _tensors(cur, pack)
        return lib.search_by_projection_frame(
            arr(p["bits"]), arr(has), arr(p["level"]), arr(p["angle"]),
            arr(proj), arr(proj_z), arr(c["xy"]), arr(c["level"]),
            arr(c["angle"]), arr(c["bits"]), arr(c["ur"]), arr(c["valid"]),
            arr(SCALES), 7.0, arr(np.asarray(fwd)), arr(np.asarray(bwd)),
        )

    rj = run(j_match, lambda b: b, jnp.asarray)
    rt = run(t_match, _pack, lambda x: torch.from_numpy(np.array(x)))
    _cmp_result(rj, rt)
    assert int(rt.n_matches) > 50


def test_search_by_projection_points_matches_jax():
    rng = np.random.default_rng(22)
    pts = _frame_like(rng, 256)
    cur = _noisy_copy(rng, pts)
    uvr = np.concatenate([pts["xy"], pts["ur"][:, None]], 1)
    view_cos = rng.uniform(0.99, 1.0, 256).astype(np.float32)
    visible = rng.uniform(size=256) < 0.85

    def run(lib, pack, arr, th):
        p, c = _tensors(pts, pack), _tensors(cur, pack)
        return lib.search_by_projection_points(
            arr(p["bits"]), arr(visible), arr(uvr), arr(p["level"]),
            arr(view_cos), arr(c["xy"]), arr(c["level"]), arr(c["bits"]),
            arr(c["ur"]), arr(c["valid"]), arr(SCALES), th=th,
        )

    rj = run(j_match, lambda b: b, jnp.asarray, jnp.float32(1.7))
    rt = run(t_match, _pack, lambda x: torch.from_numpy(np.array(x)),
             torch.tensor(1.7))
    _cmp_result(rj, rt)
    assert int(rt.n_matches) > 50


@pytest.mark.parametrize("check_rotation", [True, False])
def test_search_brute_force_matches_jax(check_rotation):
    rng = np.random.default_rng(23)
    src = _frame_like(rng, 320)
    dst = _noisy_copy(rng, src, flip=0.02)
    perm = rng.permutation(320)
    dst = {k: v[perm] for k, v in dst.items()}

    def run(lib, pack, arr):
        s, d = _tensors(src, pack), _tensors(dst, pack)
        return lib.search_brute_force(
            arr(s["bits"]), arr(s["valid"]), arr(s["angle"]),
            arr(d["bits"]), arr(d["valid"]), arr(d["angle"]),
            check_rotation=check_rotation,
        )

    rj = run(j_match, lambda b: b, jnp.asarray)
    rt = run(t_match, _pack, lambda x: torch.from_numpy(np.array(x)))
    _cmp_result(rj, rt)
    assert int(rt.n_matches) > 100


def test_hamming_u8_matches_bit_count():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (50, 32), dtype=np.uint8)
    want = np.unpackbits(a[:, None] ^ b[None], axis=-1).sum(-1)
    got = kernel_match.hamming_u8(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the dispatcher runs the plain version, which does
    not count as a kernel launch."""
    p = _random_problem(seed=2, n=40, m=30)
    before = kernel_match.LAUNCHES
    out_j, out_t = _both(p, True)
    assert kernel_match.LAUNCHES == before
    _assert_equal(out_j, out_t)


@pytest.mark.parametrize("scale", [1.0, 1.1])
def test_search_by_sim3_matches_jax(scale):
    """Guided Sim3 search (the loop closer's, two K2 calls at use_ur
    False): a keyframe pair related by a known Sim3, with permuted,
    noisy descriptors and missing points on both sides."""
    rng = np.random.default_rng(24)
    n = 300
    kf1 = _frame_like(rng, n)
    pc1 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 30, n)], 1).astype(np.float32)
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.array([0.4, -0.1, 0.3], np.float32)
    s = np.float32(scale)
    # p1 = s R p2 + t  ->  p2 = R^T (p1 - t) / s
    pc2 = ((pc1 - t) @ R / s).astype(np.float32)
    perm = rng.permutation(n)
    kf2 = {k: v[perm] for k, v in _noisy_copy(rng, kf1, flip=0.05).items()}
    pc2 = pc2[perm]
    fx, fy, cx, cy = 300.0, 300.0, 320.0, 100.0
    for f, pc in ((kf1, pc1), (kf2, pc2)):
        f["xy"] = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                            fy * pc[:, 1] / pc[:, 2] + cy], 1)
        f["xy"] = (f["xy"] + rng.normal(0, 1.5, f["xy"].shape)
                   ).astype(np.float32)
    has1 = rng.uniform(size=n) < 0.8
    has2 = rng.uniform(size=n) < 0.8

    def run(lib, pack, arr):
        a, b = _tensors(kf1, pack), _tensors(kf2, pack)
        return lib.search_by_sim3(
            arr(s), arr(R), arr(t), arr(pc1), arr(has1), arr(a["xy"]),
            arr(a["level"]), arr(a["bits"]), arr(pc2), arr(has2),
            arr(b["xy"]), arr(b["level"]), arr(b["bits"]), arr(SCALES),
            fx, fy, cx, cy)

    mj = run(j_match, lambda b: b, jnp.asarray)
    mt = run(t_match, _pack, lambda x: torch.from_numpy(np.array(x)))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.dtype == torch.int32
    hit = mt.numpy() >= 0
    assert hit.sum() > 100
    assert (perm[mt.numpy()[hit]] == np.arange(n)[hit]).mean() > 0.95
