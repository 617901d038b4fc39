"""Parity of the port's SegNet "standard" variant (VGG16-style, Caffe BN
after every convolution but the last) with the Flax model, at 32x64 in
float32, with the Flax weights carried over by ``params_from_flax``.

The Flax BN parameters are made non-trivial (scale, shift, mean and var
away from their defaults) so the BN arithmetic is compared, not skipped.
The MC-dropout path is compared with the same six dropout masks on both
sides, injected into Flax through ``flax.linen.intercept_methods`` and
into the port through its ``masks`` argument.
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


def _perturbed_bn(params, seed=5):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)
    for name, leaf in tree["params"].items():
        if name.endswith("_bn"):
            c = leaf["scale"].shape[0]
            leaf["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            leaf["shift"] = rng.normal(0, 0.1, c).astype(np.float32)
            leaf["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            leaf["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    j_model = j_seg.SegNet(variant="standard")
    params = _perturbed_bn(j_seg.init_params(j_model, jax.random.key(0), H, W))
    t_model = t_seg.SegNet(variant="standard", dtype=torch.float32)
    t_model.load_state_dict(t_seg.params_from_flax(params))
    img = np.random.default_rng(3).uniform(0, 255, (H, W, 3))
    return j_model, params, t_model, img.astype(np.float32)


def test_deterministic_forward_matches_flax(models):
    j_model, params, t_model, img = models
    pj = np.asarray(j_model.apply(params, jnp.asarray(img), train=False))
    with torch.no_grad():
        pt = t_model(torch.from_numpy(img)).numpy()
    assert pt.shape == (H, W, 15)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)


def test_mc_posterior_matches_flax_with_injected_masks(models):
    j_model, params, t_model, img = models
    S = 3
    rng = np.random.default_rng(4)
    shapes = t_model.dropout_shapes(H, W, S)  # NCHW
    assert len(shapes) == 6
    masks_nchw = [rng.uniform(size=s) < 0.5 for s in shapes]
    masks_nhwc = [m.transpose(0, 2, 3, 1) for m in masks_nchw]
    keep = 1.0 - j_model.dropout_rate
    calls = []

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            x = args[0]
            m = jnp.asarray(masks_nhwc[len(calls)])
            calls.append(x.shape)
            return jnp.where(m, x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(inject):
        probs_j = j_model.apply(params, jnp.asarray(img), train=True,
                                rngs={"dropout": jax.random.key(1)},
                                mc_samples=S)
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


def test_flax_round_trip_is_the_identity(models):
    _, params, t_model, _ = models
    back = t_seg.flax_from_params(t_seg.params_from_flax(params))
    assert back["params"].keys() == params["params"].keys()
    for name, leaf in params["params"].items():
        assert back["params"][name].keys() == leaf.keys()
        for k, v in leaf.items():
            np.testing.assert_array_equal(back["params"][name][k], v)
    state = t_model.state_dict()
    again = t_seg.params_from_flax(t_seg.flax_from_params(state))
    assert again.keys() == state.keys()
    for k, v in state.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


def test_parameter_counts_equal_flax(models):
    _, params, t_model, _ = models
    n_flax = sum(int(np.asarray(x).size)
                 for x in jax.tree_util.tree_leaves(params))
    n_port = sum(p.numel() for p in t_model.parameters())
    assert n_port == n_flax
    # the seeded init has the same layout
    state = t_seg.init_params(0, variant="standard")
    assert sum(v.numel() for v in state.values()) == n_flax
    assert 29_000_000 < n_flax < 30_000_000, n_flax


def test_size_must_divide_by_32(models):
    j_model, _, t_model, _ = models
    img = np.zeros((48, 64, 3), np.float32)  # divisible by 16, not 32
    j_params = j_seg.init_params(j_model, jax.random.key(0), H, W)
    with pytest.raises(ValueError) as j_err:
        j_model.apply(j_params, jnp.asarray(img), train=False)
    with pytest.raises(ValueError, match="divisible by 32") as t_err:
        t_model(torch.from_numpy(img))
    assert str(t_err.value) == str(j_err.value)
    # the basic variant divides by 16 and accepts this size
    basic = t_seg.SegNet(dtype=torch.float32)
    basic.load_state_dict(t_seg.init_params(0))
    with torch.no_grad():
        assert basic(torch.from_numpy(img)).shape == (48, 64, 15)


def test_bfloat16_rounds_where_flax_does(models):
    """In bf16 the convolutions round and BN runs in float32 on both
    sides; the MC-free forward agrees within bf16's resolution."""
    j_model, params, _, img = models
    jb = j_seg.SegNet(variant="standard", dtype=jnp.bfloat16)
    pj = np.asarray(jb.apply(params, jnp.asarray(img), train=False))
    tb = t_seg.SegNet(variant="standard", dtype=torch.bfloat16)
    tb.load_state_dict(t_seg.params_from_flax(params))
    with torch.no_grad():
        pt = tb(torch.from_numpy(img)).numpy()
    assert np.isfinite(pt).all()
    np.testing.assert_allclose(pt.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=0.05)


def test_conv_flops_count():
    # 352x1024, MC=3: the encoder up to pool3 once, the rest 3 times
    flops = t_seg.conv_flops("standard", 352, 1024, 3)
    assert 1.05e12 < flops < 1.08e12, flops
    one = t_seg.conv_flops("standard", 352, 1024, 1)
    # stages 1-3 are a fixed cost outside the per-sample part
    assert flops - one == 2 * (t_seg.conv_flops("standard", 352, 1024, 2)
                               - one)
