"""Parity of the port's pyramid, FAST, keypoint selection and kernel K1
(IC angle + rBRIEF) with the JAX package, on the CPU.

K1 is held to the Pallas kernel run interpreted on the CPU, exactly as
tests/test_pallas_orb.py runs it (u8 canvas semantics), with that
test's tolerance: angle atol 1e-4, mean bit Hamming < 1, max <= 4. Here
the port's plain version runs, as it does for every CPU tensor.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu import config as j_config
from sivo_tpu.io import synthetic
from sivo_tpu.ops import fast as j_fast
from sivo_tpu.ops import image as j_image
from sivo_tpu.ops import orb as j_orb
from sivo_tpu.ops import pallas_orb
from sivo_tpu.runtime import frame as j_frame
from sivo_tpu_torch import config as t_config
from sivo_tpu_torch.ops import fast as t_fast
from sivo_tpu_torch.ops import image as t_image
from sivo_tpu_torch.ops import kernel_orb
from sivo_tpu_torch.ops import orb as t_orb
from sivo_tpu_torch.runtime import frame as t_frame

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM_FIELDS = dict(fx=180.0, fy=180.0, cx=160.0, cy=96.0, width=320,
                  height=192, bf=180.0 * 0.54, fps=10.0)
CAM = j_config.CameraConfig(**CAM_FIELDS)


def _cfg(config):
    """The test configuration built from ``config``, the JAX package's
    config module or the port's."""
    cfg = config.SystemConfig()
    return dataclasses.replace(
        cfg, camera=config.CameraConfig(**CAM_FIELDS),
        orb=dataclasses.replace(cfg.orb, n_features=600, max_keypoints=1024),
    )


def _k1_both(raw, blur, level, xy_level):
    ang_p, bits_p, _ = pallas_orb.orient_and_describe(
        jnp.asarray(raw), jnp.asarray(blur), jnp.asarray(level),
        jnp.asarray(xy_level),
    )
    ang_t, packed_t = kernel_orb.orient_and_describe(
        torch.from_numpy(raw), torch.from_numpy(blur),
        torch.from_numpy(level), torch.from_numpy(xy_level),
    )
    bits_t = t_orb.unpack_bits(packed_t).numpy()
    return np.asarray(ang_p), np.asarray(bits_p), ang_t.numpy(), bits_t


def test_k1_plain_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    L, H, W = 3, 96, 160
    raw = rng.integers(0, 255, (L, H, W)).astype(np.float32)
    blur = rng.integers(0, 255, (L, H, W)).astype(np.float32)
    n = 4 * pallas_orb.BK
    m = pallas_orb.BRIEF_MARGIN
    lvl = rng.integers(0, L, n).astype(np.int32)
    y = rng.integers(m, H - 2 * j_image.BORDER - m, n)
    x = rng.integers(m, W - 2 * j_image.BORDER - m, n)
    xy_level = np.stack([x, y], 1).astype(np.float32)
    ang_p, bits_p, ang_t, bits_t = _k1_both(raw, blur, lvl, xy_level)
    np.testing.assert_allclose(ang_t, ang_p, rtol=0, atol=1e-4)
    ham = np.abs(bits_t - bits_p).sum(axis=1)
    assert np.mean(ham) < 1.0, ham
    assert (ham <= 4).all(), ham


def test_k1_rounds_float_canvases_to_u8_and_clamps():
    """Non-integer canvases (the u8 rounding must match) and keypoints
    at and past the canvas edge (clamped, as the Pallas prepare does)."""
    rng = np.random.default_rng(1)
    L, H, W = 2, 80, 120
    raw = rng.uniform(-3, 260, (L, H, W)).astype(np.float32)
    blur = rng.uniform(-3, 260, (L, H, W)).astype(np.float32)
    n = 2 * pallas_orb.BK
    lvl = rng.integers(0, L, n).astype(np.int32)
    x = rng.integers(-25, W, n)
    y = rng.integers(-25, H, n)
    xy_level = np.stack([x, y], 1).astype(np.float32)
    ang_p, bits_p, ang_t, bits_t = _k1_both(raw, blur, lvl, xy_level)
    np.testing.assert_allclose(ang_t, ang_p, rtol=0, atol=1e-4)
    ham = np.abs(bits_t - bits_p).sum(axis=1)
    assert np.mean(ham) < 1.0 and (ham <= 4).all(), ham


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_plain_on_float_canvases_equals_pallas_prepare_path(seed):
    """The plain version takes the float canvases and rounds the pixels
    it reads; the JAX package's ``prepare`` rounds whole canvases to u8
    and its kernel (interpreted) describes. Canvases of half-integers
    from -20 to 280 exercise round-half-to-even and both clamp ends;
    keypoints reach past every edge. Descriptors must be equal; angles
    agree to 1e-6 (measured: 1.2e-7, atan2 in the last ulp)."""
    rng = np.random.default_rng(seed)
    L, H, W = 3, 96, 160
    raw = (rng.integers(-40, 560, (L, H, W)) / 2).astype(np.float32)
    blur = (rng.integers(-40, 560, (L, H, W)) / 2).astype(np.float32)
    assert (raw % 1 == 0.5).mean() > 0.4
    n = 6 * pallas_orb.BK
    lvl = rng.integers(0, L, n).astype(np.int32)
    xy = np.stack([rng.integers(-30, W, n), rng.integers(-30, H, n)],
                  1).astype(np.float32)
    ang_j, _, packed_j = pallas_orb.describe_prepared(*pallas_orb.prepare(
        jnp.asarray(raw), jnp.asarray(blur), jnp.asarray(lvl),
        jnp.asarray(xy)))
    ang_t, packed_t = kernel_orb.orient_and_describe_plain(
        *(torch.from_numpy(x) for x in (raw, blur, lvl, xy)))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), rtol=0,
                               atol=1e-6)


def test_kernel_tables_encode_pattern_and_mask():
    """The kernel's tables: the pattern rows as little-endian int8
    words, then each mask column as a word with bit r for row r."""
    t = kernel_orb.kernel_tables()
    assert t.dtype == np.int32 and t.shape == (288,)
    words = t[:256].view(np.uint32)
    for k in range(4):
        got = ((words >> (8 * k)) & 0xFF).astype(np.uint8).view(np.int8)
        np.testing.assert_array_equal(got, kernel_orb.PATTERN[:, k])
    mask = kernel_orb.ic_angle_mask().astype(bool)
    bits = (t[256:287, None] >> np.arange(31)[None, :]) & 1
    np.testing.assert_array_equal(bits.T.astype(bool), mask)
    assert t[287] == 0


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the dispatcher runs the plain version, which does
    not count as a kernel launch."""
    canvas = torch.zeros((1, 64, 64))
    before = kernel_orb.LAUNCHES
    angle, packed = kernel_orb.orient_and_describe(
        canvas, canvas, torch.zeros(3, dtype=torch.int32), torch.zeros(3, 2))
    assert kernel_orb.LAUNCHES == before
    assert angle.shape == (3,) and packed.shape == (3, 32)
    assert packed.dtype == torch.uint8


def test_k1_flat_patch_gives_zero_bits():
    """m01 = m10 = 0: cos = sin = 0, every sample at the centre, every
    bit 0 and angle 0 — the Pallas kernel's behaviour, followed."""
    L, H, W = 1, 64, 64
    raw = np.full((L, H, W), 77.0, np.float32)
    blur = np.full((L, H, W), 77.0, np.float32)
    xy_level = np.full((pallas_orb.BK, 2), 7.0, np.float32)
    lvl = np.zeros(pallas_orb.BK, np.int32)
    ang_p, bits_p, ang_t, bits_t = _k1_both(raw, blur, lvl, xy_level)
    assert (bits_p == 0).all() and (bits_t == 0).all()
    np.testing.assert_array_equal(ang_t, ang_p)


def test_ic_angle_mask_and_pattern_match_jax():
    np.testing.assert_array_equal(kernel_orb.ic_angle_mask(),
                                  j_orb.ic_angle_mask())
    np.testing.assert_array_equal(kernel_orb.PATTERN, j_orb._PATTERN)


@pytest.fixture(scope="module")
def rendered():
    world = synthetic.make_world(CAM, seed=0)
    gt = synthetic.forward_trajectory(n_frames=4, speed=0.5)
    left, right, _ = synthetic.render_sequence(world, gt[[0, 3]])
    return left, right


def test_pyramid_matches_jax(rendered):
    left, _ = rendered
    spec = t_frame.make_statics(_cfg(t_config)).spec
    jr, jb = j_image.build_pyramid(jnp.asarray(left[0], jnp.float32), spec)
    tr, tb = t_image.build_pyramid(torch.from_numpy(left[0]).float(), spec)
    # antialiased bilinear resize: PyTorch's filter and jax.image.resize
    # agree to ~4e-4 grey levels here (measured); the blur to ~1e-4
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=2e-3)


@pytest.mark.parametrize("image", [0, 1])
def test_fast_and_selection_exact_on_jax_canvases(rendered, image):
    """The same float canvases (JAX's build_pyramid) into both: FAST
    score maps and the selected keypoints must be identical."""
    left, right = rendered
    statics = j_frame.make_statics(_cfg(j_config))
    gray = (left if image == 0 else right)[1].astype(np.float32)
    raw, _ = j_image.build_pyramid(jnp.asarray(gray), statics.spec)
    region_j = j_image.level_valid_mask(statics.spec, margin=16)
    region_t = t_image.level_valid_mask(statics.spec, 16, CPU)
    np.testing.assert_array_equal(region_t.numpy(), np.asarray(region_j))
    score_j = j_fast.detect(raw, region_j)
    score_t = t_fast.detect(torch.from_numpy(np.array(raw)), region_t)
    np.testing.assert_array_equal(
        score_t.float().numpy(), np.asarray(score_j.astype(jnp.float32))
    )
    sel_j = j_orb.select_keypoints(score_j, statics.spec, statics.budgets,
                                   statics.max_keypoints)
    sel_t = t_orb.select_keypoints(score_t, statics.spec, statics.budgets,
                                   statics.max_keypoints)
    for a, b in zip(sel_j, sel_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(sel_t[3].sum()) > 300


def test_select_breaks_ties_by_index():
    """A flat score map: every cell ties, so the order is index order
    on both sides."""
    spec = j_image.make_pyramid_spec(64, 96, n_levels=2)
    score = np.full((2, spec.canvas_h, spec.canvas_w), 9.0, np.float32)
    budgets = (40, 20)
    sel_j = j_orb.select_keypoints(jnp.asarray(score), spec, budgets, 64)
    sel_t = t_orb.select_keypoints(torch.from_numpy(score), spec, budgets,
                                   64)
    for a, b in zip(sel_j, sel_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
