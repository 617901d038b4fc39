"""Parity of the port's SegNet (basic variant) with the Flax model, at
32x64 in float32, with the Flax weights carried over by
``params_from_flax``.

The MC-dropout path is compared with the same dropout masks on both
sides: the test injects them into the Flax model through
``flax.linen.intercept_methods`` (a test-only interceptor on
``nn.Dropout``) and into the port through its ``masks`` argument. The
variance functions (``mc_variance``, ``variance_image``,
``segment_image_with_variance``) are held to a numpy oracle and to the
JAX package's functions.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.models import segnet as j_seg
from sivo_tpu_torch.models import segnet as t_seg

torch.set_num_threads(2)
H, W = 32, 64


@pytest.fixture(scope="module")
def models():
    j_model = j_seg.SegNet(variant="basic")
    params = j_seg.init_params(j_model, jax.random.key(0), H, W)
    t_model = t_seg.SegNet(dtype=torch.float32)
    t_model.load_state_dict(
        t_seg.params_from_flax(jax.tree.map(np.asarray, params))
    )
    img = np.random.default_rng(3).uniform(0, 255, (H, W, 3))
    return j_model, params, t_model, img.astype(np.float32)


def test_deterministic_forward_matches_flax(models):
    j_model, params, t_model, img = models
    pj = np.asarray(j_model.apply(params, jnp.asarray(img), train=False))
    with torch.no_grad():
        pt = t_model(torch.from_numpy(img)).numpy()
    assert pt.shape == (H, W, 15)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)


def _injector(masks_nchw, keep, calls):
    """A Flax interceptor that replaces each dropout layer's draw with
    the next of ``masks_nchw`` (transposed to NHWC)."""
    masks_nhwc = [m.transpose(0, 2, 3, 1) for m in masks_nchw]

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            x = args[0]
            m = jnp.asarray(masks_nhwc[len(calls)])
            calls.append(x.shape)
            return jnp.where(m, x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return inject, masks_nhwc


def test_mc_posterior_matches_flax_with_injected_masks(models):
    j_model, params, t_model, img = models
    S = 3
    rng = np.random.default_rng(4)
    shapes = t_model.dropout_shapes(H, W, S)  # NCHW
    masks_nchw = [rng.uniform(size=s) < 0.5 for s in shapes]
    calls = []
    inject, masks_nhwc = _injector(masks_nchw, 1.0 - j_model.dropout_rate,
                                   calls)

    with nn.intercept_methods(inject):
        probs_j = j_model.apply(params, jnp.asarray(img), train=True,
                                rngs={"dropout": jax.random.key(1)},
                                mc_samples=S)
    assert len(calls) == 4
    assert [tuple(c) for c in calls] == [m.shape for m in masks_nhwc]
    cls_j, conf_j, ent_j = (np.asarray(x) for x in
                            j_seg.posterior(jnp.mean(probs_j, axis=0)))
    with torch.no_grad():
        cls_t, conf_t, ent_t = t_seg.segment_image(
            t_model, torch.from_numpy(img), None, S,
            masks=[torch.from_numpy(m) for m in masks_nchw],
        )
    np.testing.assert_array_equal(cls_t.numpy(), cls_j)
    np.testing.assert_allclose(conf_t.numpy(), conf_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ent_t.numpy(), ent_j, rtol=0, atol=1e-4)


def test_generator_dropout_is_seeded_and_stochastic(models):
    _, _, t_model, img = models
    x = torch.from_numpy(img)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return t_model(x, mc_samples=2, generator=g)

    a, b, c = run(5), run(5), run(6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 1e-6
    torch.testing.assert_close(a.sum(-1), torch.ones(2, H, W), rtol=0,
                               atol=1e-5)


def test_layers_match_flax():
    rng = np.random.default_rng(1)
    x = (np.abs(rng.normal(size=(1, 4, 6, 8))) * 100).astype(np.float32)
    lrn_j = np.asarray(j_seg.lrn(jnp.asarray(x)))
    lrn_t = t_seg.lrn(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(lrn_t.numpy().transpose(0, 2, 3, 1), lrn_j,
                               rtol=1e-6)
    # ties in a pooling window resolve to the first (row-major) index
    y = rng.integers(0, 3, size=(1, 8, 8, 4)).astype(np.float32)
    val_j, idx_j = j_seg.max_pool_argmax(jnp.asarray(y))
    val_t, idx_t = t_seg.max_pool_argmax(
        torch.from_numpy(y.transpose(0, 3, 1, 2)))
    np.testing.assert_array_equal(val_t.numpy().transpose(0, 2, 3, 1), val_j)
    np.testing.assert_array_equal(idx_t.numpy().transpose(0, 2, 3, 1), idx_j)
    up_j = j_seg.max_unpool(val_j, idx_j)
    up_t = t_seg.max_unpool(val_t, idx_t)
    np.testing.assert_array_equal(up_t.numpy().transpose(0, 2, 3, 1), up_j)


def test_seeded_init_is_reproducible_and_loads():
    a = t_seg.init_params(7)
    b = t_seg.init_params(7)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    model = t_seg.SegNet(dtype=torch.bfloat16)
    model.load_state_dict(a)
    n = sum(p.numel() for p in model.parameters())
    assert 1_300_000 < n < 1_500_000, n


def test_mc_variance_matches_numpy_oracle():
    # ref: bayesian_segnet.cpp:205-260: the sample variance (/(S-1)) of
    # the detected class's probability across the MC draws
    rng = np.random.default_rng(11)
    S, h, w, C = 4, 6, 8, 15
    probs = rng.dirichlet(np.ones(C), size=(S, h, w)).astype(np.float32)
    classes = np.argmax(probs.mean(axis=0), axis=-1).astype(np.uint8)
    got = t_seg.mc_variance(torch.from_numpy(probs),
                            torch.from_numpy(classes)).numpy()
    want = np.empty((h, w))
    for j in range(h):
        for k in range(w):
            v = probs[:, j, k, classes[j, k]].astype(np.float64)
            want[j, k] = ((v - v.mean()) ** 2).sum() / (S - 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)
    jax_var = np.asarray(j_seg.mc_variance(jnp.asarray(probs),
                                           jnp.asarray(classes)))
    np.testing.assert_allclose(got, jax_var, rtol=1e-6, atol=1e-9)


def test_variance_image_minmax_normalizes():
    # ref: bayesian_segnet.cpp:330-344: cv::NORM_MINMAX to [0, 1]
    v = torch.tensor([[0.5, 1.5], [2.5, 0.5]])
    img = t_seg.variance_image(v).numpy()
    assert img.min() == 0.0 and img.max() == 1.0
    np.testing.assert_allclose(img, [[0.0, 0.5], [1.0, 0.0]])
    # a constant raster stays finite (the 1e-30 floor), as in JAX
    flat = torch.full((3, 4), 0.25)
    np.testing.assert_array_equal(
        t_seg.variance_image(flat).numpy(),
        np.asarray(j_seg.variance_image(jnp.full((3, 4), 0.25))))


def test_segment_image_with_variance_matches_flax(models):
    """(classes, confidence, entropy, variance) against the JAX
    function with the same masks (atol 1e-4); run unjitted, so that the
    interceptor sees every dropout layer whatever was traced before."""
    j_model, params, t_model, img = models
    S = 3
    rng = np.random.default_rng(8)
    masks_nchw = [rng.uniform(size=s) < 0.5
                  for s in t_model.dropout_shapes(H, W, S)]
    calls = []
    inject, _ = _injector(masks_nchw, 1.0 - j_model.dropout_rate, calls)
    with nn.intercept_methods(inject):
        want = j_seg.segment_image_with_variance.__wrapped__(
            j_model, params, jnp.asarray(img), jax.random.key(1),
            mc_samples=S)
    assert len(calls) == 4
    with torch.no_grad():
        got = t_seg.segment_image_with_variance(
            t_model, torch.from_numpy(img), None, S,
            masks=[torch.from_numpy(m) for m in masks_nchw])
    cls_j, *rest_j = (np.asarray(x) for x in want)
    cls_t, *rest_t = (x.numpy() for x in got)
    assert [x.shape for x in got] == [(H, W)] * 4
    np.testing.assert_array_equal(cls_t, cls_j)
    for t, j in zip(rest_t, rest_j):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    assert float(rest_t[2].max()) > 0.0  # MC dropout varies somewhere


def test_segment_image_with_variance_shapes(models):
    _, _, t_model, img = models
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        cls, conf, ent, var = t_seg.segment_image_with_variance(
            t_model, torch.from_numpy(img), g, 3)
    assert var.shape == cls.shape == conf.shape == ent.shape == (H, W)
    assert float(var.min()) >= 0.0
    # three samples in [0, 1]: the Bessel-corrected variance is <= 1/3
    assert float(var.max()) <= 1.0 / 3.0


def test_inference_and_training_forwards_check_their_input(models):
    _, _, t_model, img = models
    x = torch.from_numpy(img)
    with pytest.raises(ValueError, match="one"):
        t_model(x[None])
    with pytest.raises(ValueError, match="batch"):
        t_model(x, train=True)
    with pytest.raises(ValueError, match="batch"):
        t_model(x[None], mc_samples=2, train=True)


def test_truncated_init_is_flax_lecun_normal():
    """``init_params`` draws Flax's LeCun normal: a standard normal
    truncated at 2 sigma (tails redrawn, not clipped), scaled to
    variance 1/fan_in."""
    state = t_seg.init_params(3)
    z = torch.cat([v.flatten() * v[0].numel() ** 0.5
                   for k, v in state.items() if k.endswith("weight")])
    assert float(z.abs().max()) <= 2.0 / 0.87962566103423978 + 1e-5
    assert abs(float(z.var()) - 1.0) < 0.02
    # a clipped normal would pile ~4.6% of the draws on the bounds
    at_bound = (z.abs() > 2.0 / 0.87962566103423978 - 1e-4).float().mean()
    assert float(at_bound) < 1e-3
