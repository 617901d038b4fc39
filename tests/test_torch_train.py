"""Parity of the port's SegNet training (``sivo_tpu_torch/models/train.py``)
with the JAX package's (``sivo_tpu/models/train.py``), SegNet basic at
32x64 in float32 with the Flax weights carried over.

The dropout masks are the same on both sides: the JAX step is traced
under ``flax.linen.intercept_methods`` (a test-only interceptor on
``nn.Dropout``), which must happen inside ``_train_step``'s ``jit``, so
every JAX step gets a transformation object of its own (a new static
argument, a new trace). Under the step's ``vmap`` the injected mask is
not batched, so every image of the batch gets the same mask; the port
gets that mask repeated over the batch.

Adam's first step is -lr g / (|g| + eps), whose sign can flip between
the packages wherever |g| is float32 noise, so the tolerances come in
three parts:

* one step's loss (rtol 1e-5) and gradients (atol 1e-5 x the tensor's
  max |g|), from the JAX step with a transformation that keeps the
  gradients as its state;
* the optimizer alone: the JAX gradients through ``optax.adam`` and
  ``torch.optim.Adam`` (atol 1e-7);
* a three-step loss trajectory (rtol 1e-4).

Then the batches ``train_segnet`` draws (the same in both packages) and
the JAX package's own toy task (accuracy > 0.7 after 80 steps, and a
``.caffemodel`` round trip that gives the same classes).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sivo_tpu.models import segnet as j_seg
from sivo_tpu.models import train as j_train
from sivo_tpu_torch.models import caffe_io
from sivo_tpu_torch.models import segnet as t_seg
from sivo_tpu_torch.models import train as t_train

torch.set_num_threads(2)
H, W, B, LR = 32, 64, 2, 1e-3
CPU = torch.device("cpu")


def _toy_dataset(n=6, h=32, w=64, seed=0):
    """The JAX package's toy task (tests/test_train.py): class =
    brightness band, with distinct colour casts."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, h, w, 3), np.float32)
    labels = np.zeros((n, h, w), np.int32)
    for i in range(n):
        cls = rng.integers(0, 3, size=(4, 8))
        cls = np.kron(cls, np.ones((h // 4, w // 8), int))
        base = np.array([[40.0, 30, 35], [120, 130, 110], [220, 200, 210]])
        img = base[cls] + rng.normal(0, 8, size=(h, w, 3))
        images[i] = np.clip(img, 0, 255)
        labels[i] = cls
    return images, labels


@pytest.fixture(scope="module")
def setup():
    j_model = j_seg.SegNet(variant="basic", num_classes=15)
    params = j_seg.init_params(j_model, jax.random.key(0), H, W)
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, (4, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, 15, (4, H, W)).astype(np.int32)
    labels[:, :, : W // 2] = rng.integers(0, 4, (4, H, W // 2))
    weights = j_train.class_balance_weights(labels, 15)
    t_model = t_seg.SegNet(dtype=torch.float32)
    masks = [rng.uniform(size=s) < 0.5
             for s in t_model.dropout_shapes(H, W, 1)]  # NCHW, one image
    return j_model, params, images, labels, weights, masks


def _port_model(params) -> t_seg.SegNet:
    model = t_seg.SegNet(dtype=torch.float32)
    model.load_state_dict(
        t_seg.params_from_flax(jax.tree.map(np.asarray, params)))
    return model


def _port_masks(masks):
    return [torch.from_numpy(m).expand(B, -1, -1, -1) for m in masks]


def _jax_step(j_model, tx, params, opt_state, images, labels, weights,
              masks):
    """``_train_step`` traced under the interceptor that injects
    ``masks`` (NCHW, one image) into its dropout layers."""
    keep = 1.0 - j_model.dropout_rate
    masks_nhwc = [jnp.asarray(m.transpose(0, 2, 3, 1)) for m in masks]
    calls = []

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            x = args[0]
            m = masks_nhwc[len(calls)]
            calls.append(x.shape)
            return jnp.where(m, x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(inject):
        out = j_train._train_step(j_model, tx, params, opt_state,
                                  jnp.asarray(images), jnp.asarray(labels),
                                  jnp.asarray(weights), jax.random.key(1))
    assert [tuple(c) for c in calls] == [m.shape for m in masks_nhwc]
    return out


def _grad_keeper() -> optax.GradientTransformation:
    """A transformation that leaves the parameters as they are and keeps
    the step's gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_grads(setup):
    j_model, params, images, labels, weights, masks = setup
    tx = _grad_keeper()
    _, grads, loss = _jax_step(j_model, tx, params, tx.init(params),
                               images[:B], labels[:B], weights, masks)
    return float(loss), t_seg.params_from_flax(
        jax.tree.map(np.asarray, grads))


def test_class_balance_weights():
    labels = np.array([0] * 90 + [1] * 9 + [2] * 1)
    w = t_train.class_balance_weights(labels, 4)
    assert w[3] == 0.0  # absent class
    assert w[2] > w[1] > w[0] > 0
    rng = np.random.default_rng(2)
    many = rng.integers(0, 12, (3, 8, 16))
    np.testing.assert_array_equal(t_train.class_balance_weights(many, 15),
                                  j_train.class_balance_weights(many, 15))


def test_training_forward_matches_flax(setup):
    """``SegNet(..., train=True)`` on a batch against the Flax model's
    ``train=True`` forward of each image, the same masks (atol 1e-5)."""
    j_model, params, images, _, _, masks = setup
    keep = 1.0 - j_model.dropout_rate
    masks_nhwc = [jnp.asarray(m.transpose(0, 2, 3, 1)) for m in masks]
    calls = []

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            m = masks_nhwc[len(calls) % len(masks_nhwc)]
            calls.append(1)
            return jnp.where(m, args[0] / keep, jnp.zeros_like(args[0]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(inject):
        want = np.stack([np.asarray(j_model.apply(
            params, jnp.asarray(img), train=True,
            rngs={"dropout": jax.random.key(0)})) for img in images[:B]])
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(images[:B]),
                                  masks=_port_masks(masks), train=True)
    assert got.shape == (B, H, W, 15)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_loss_and_gradients_match_jax(setup):
    _, params, images, labels, weights, masks = setup
    loss_j, grads_j = _jax_grads(setup)
    model = _port_model(params)
    loss_t = t_train.loss_fn(model, torch.from_numpy(images[:B]),
                             torch.from_numpy(labels[:B]),
                             torch.from_numpy(weights),
                             masks=_port_masks(masks))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), loss_j, rtol=1e-5)
    grads_t = {k: p.grad for k, p in model.named_parameters()}
    assert grads_t.keys() == grads_j.keys()
    for k, g in grads_j.items():
        scale = float(g.abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(grads_t[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_adam_matches_optax(setup):
    """The JAX gradients (scaled differently at each of three steps)
    through ``optax.adam`` and ``torch.optim.Adam`` (atol 1e-7)."""
    _, params, *_ = setup
    _, grads = _jax_grads(setup)
    tx = optax.adam(LR)
    j_params = jax.tree.map(jnp.asarray, params)
    state = tx.init(j_params)
    model = _port_model(params)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    flax_grads = t_seg.flax_from_params(grads)
    for scale in (1.0, 0.5, -2.0):
        g = jax.tree.map(lambda x: jnp.asarray(x * scale), flax_grads)
        updates, state = tx.update(g, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in model.named_parameters():
            p.grad = grads[k] * scale
        opt.step()
    want = t_seg.params_from_flax(jax.tree.map(np.asarray, j_params))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-7, err_msg=k)


def test_three_step_loss_trajectory(setup):
    """Three Adam steps on the batches ``train_segnet`` would draw, the
    same masks at every step (rtol 1e-4)."""
    j_model, params, images, labels, weights, masks = setup
    tx = optax.adam(LR)
    j_params, state = params, tx.init(params)
    model = _port_model(params)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    rng = np.random.default_rng(0)
    losses_j, losses_t = [], []
    for _ in range(3):
        idx = rng.choice(len(images), size=B, replace=False)
        j_params, state, loss = _jax_step(
            j_model, tx, j_params, state, images[idx], labels[idx], weights,
            masks)
        losses_j.append(float(loss))
        losses_t.append(float(t_train.train_step(
            model, opt, torch.from_numpy(images[idx]),
            torch.from_numpy(labels[idx]), torch.from_numpy(weights),
            masks=_port_masks(masks))))
        # a new transformation object: the next JAX step is traced anew,
        # under the interceptor
        tx = optax.adam(LR)
    assert len(set(losses_j)) == 3
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)


def test_train_segnet_draws_the_jax_batches(monkeypatch):
    """``train_segnet`` uploads the batches the JAX package's does, in
    the same order (both steps replaced by recorders)."""
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 255, (5, 16, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 15, (5, 16, 32)).astype(np.int32)
    seen_j, seen_t = [], []

    def record_j(model, tx, params, opt_state, img_b, lab_b, w, key):
        seen_j.append(np.asarray(lab_b))
        return params, opt_state, jnp.zeros(())

    def record_t(model, optimizer, img_b, lab_b, w, generator=None,
                 masks=None):
        seen_t.append(lab_b.numpy())
        return torch.zeros(())

    monkeypatch.setattr(j_train, "_train_step", record_j)
    monkeypatch.setattr(t_train, "train_step", record_t)
    j_model = j_seg.SegNet(variant="basic")
    j_train.train_segnet(j_model, {}, images, labels, steps=7, batch=2,
                         seed=4)
    _, losses = t_train.train_segnet(t_seg.SegNet(), images, labels,
                                     steps=7, batch=2, seed=4, device=CPU)
    assert losses.shape == (7,) and len(seen_j) == len(seen_t) == 7
    for a, b in zip(seen_j, seen_t):
        np.testing.assert_array_equal(a, b)


def test_train_segnet_needs_a_card_or_a_cpu_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.train_segnet(t_seg.SegNet(), np.zeros((1, 16, 16, 3)),
                             np.zeros((1, 16, 16), np.int32), steps=1)


def test_toy_task_learns_and_round_trips(tmp_path):
    """The JAX package's toy task at its size, from its start: 6 images
    of 32x64, the Flax weights of ``jax.random.key(0)``, 80 steps,
    dropout 0.2, lr 2e-3; accuracy > 0.7, and the ``.caffemodel``
    written and read back segments to the same classes. (One start is
    one draw: over the first six keys the JAX package's own recipe ends
    between 0.48 and 0.90.)"""
    j_model = j_seg.SegNet(variant="basic", num_classes=15, dropout_rate=0.2)
    model = t_seg.SegNet(dropout_rate=0.2)
    model.load_state_dict(t_seg.params_from_flax(jax.tree.map(
        np.asarray, j_seg.init_params(j_model, jax.random.key(0), H, W))))
    images, labels = _toy_dataset()
    model, losses = t_train.train_segnet(model, images, labels, steps=80,
                                         batch=2, lr=2e-3, device=CPU)
    assert losses.shape == (80,) and bool(torch.isfinite(losses).all())
    assert float(losses[-10:].mean()) < float(losses[:10].mean())
    img = torch.from_numpy(images[0])
    with torch.no_grad():
        classes, _, _ = t_seg.segment_image(
            model, img, torch.Generator().manual_seed(1), 2)
    acc = float(np.mean(classes.numpy() == labels[0]))
    assert acc > 0.7, f"trained accuracy {acc}"

    path = str(tmp_path / "trained.caffemodel")
    caffe_io.save_segnet_params(path, t_seg.flax_from_params(
        model.state_dict()))
    loaded = t_seg.SegNet(dropout_rate=0.2)
    loaded.load_state_dict(caffe_io.state_dict_from_caffemodel(
        path, "basic", t_seg.init_params(seed=9)))
    with torch.no_grad():
        classes2, _, _ = t_seg.segment_image(
            loaded, img, torch.Generator().manual_seed(1), 2)
    np.testing.assert_array_equal(classes.numpy(), classes2.numpy())


def test_caffe_bn_statistics_are_trained_parameters():
    """As in the Flax model, the Caffe BN layers' mean and var are
    parameters, so Adam updates them."""
    model = t_seg.SegNet("standard")
    names = {k for k, _ in model.named_parameters()}
    assert {"bns.conv1_1_bn.mean", "bns.conv1_1_bn.var"} <= names


def test_deterministic_cudnn_restores_the_settings():
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    with t_train.deterministic_cudnn():
        assert cudnn.deterministic and not cudnn.benchmark
    assert (cudnn.deterministic, cudnn.benchmark) == before
