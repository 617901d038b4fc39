"""The port's SegNet recipe against the JAX package's, on the CPU, from
the same draws: whether a gap between their trained networks comes from
the code or from the recipe's randomness.

It reads a work directory written by ``tools/cnn40_jax_reference.py``
(``render_cache.npz``, ``trained_seed*.caffemodel``) and prints:

1. for each JAX network, the pixel accuracy and mean entropy (bits) of
   its posterior on holdout frame 4 at full resolution (MC = 3,
   float32), by the JAX package's ``segment_image`` and by the port's on
   the same ``.caffemodel`` (each with its own dropout draws);
2. the recipe (every 8th frame at 176x512, batch 2, lr 1e-3) trained by
   both packages from the same start: the JAX package's seed-0 Flax
   initialisation, the batches ``train_segnet(seed=0)`` draws, and the
   same dropout masks, drawn with numpy and injected (a Flax interceptor
   on ``nn.Dropout`` in JAX; ``train_step(masks=...)`` in the port).
   The mean loss of every 10 steps of each, then each network's holdout
   accuracy and mean entropy through the port's ``segment_image`` with
   one generator.

Run from the repository root (CPU; ~6 minutes on 8 cores for 150
steps): ``JAX_PLATFORMS=cpu python tools/cnn40_port_parity.py WORK_DIR
[STEPS]``
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from sivo_tpu.models import caffe_io as j_caffe_io  # noqa: E402
from sivo_tpu.models import segnet as j_seg  # noqa: E402
from sivo_tpu.models import train as j_train  # noqa: E402
from sivo_tpu_torch.models import caffe_io, segnet, train  # noqa: E402

HOLDOUT, EVERY, BATCH, LR, MC = 4, 8, 2, 1e-3, 3


def port_holdout(state, img, cls) -> tuple[float, float]:
    """Accuracy and mean entropy of the port's ``segment_image``."""
    net = segnet.SegNet("basic", 15)
    net.load_state_dict(state)
    with torch.no_grad():
        classes, _, entropy = segnet.segment_image(
            net, torch.from_numpy(img), torch.Generator().manual_seed(1), MC)
    return float((classes.numpy() == cls).mean()), float(entropy.mean())


def jax_networks(work: Path, img, cls) -> None:
    for path in sorted(work.glob("trained_seed*.caffemodel")):
        net = j_seg.SegNet(variant="basic", num_classes=15)
        params = j_caffe_io.merge_params(
            j_seg.init_params(net, jax.random.key(0), *img.shape[:2]),
            j_caffe_io.load_segnet_params(str(path), "basic"))
        classes, _, entropy = j_seg.segment_image(
            net, params, jnp.asarray(img), jax.random.key(1), mc_samples=MC)
        state = segnet.params_from_flax(jax.tree.map(np.asarray, params))
        acc, ent = port_holdout(state, img, cls)
        print(f"{path.name}: JAX accuracy "
              f"{float(np.mean(np.asarray(classes) == cls)):.4f}, entropy "
              f"{float(np.asarray(entropy).mean()):.4f} bits; the port on it: "
              f"accuracy {acc:.4f}, entropy {ent:.4f} bits", flush=True)


def jax_step_fn(model, tx, weights):
    """``_train_step``'s loss and Adam update with the dropout masks an
    argument: (B, h, w, C) per dropout layer, one per image."""
    keep = 1.0 - model.dropout_rate

    @jax.jit
    def step(params, opt_state, images, labels, masks):
        def loss_fn(p):
            def one(img, image_masks):
                calls = []

                def inject(next_fun, args, kwargs, context):
                    if isinstance(context.module, nn.Dropout) and \
                            context.method_name == "__call__":
                        x = args[0]
                        m = image_masks[len(calls)][None]
                        calls.append(x.shape)
                        return jnp.where(m, x / keep, jnp.zeros_like(x))
                    return next_fun(*args, **kwargs)

                with nn.intercept_methods(inject):
                    return model.apply(p, img, train=True,
                                       rngs={"dropout": jax.random.key(0)})

            probs = jax.vmap(one)(images, masks)
            logp = jnp.log(jnp.maximum(probs, 1e-12))
            ll = jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
            w = weights[labels]
            return -jnp.sum(w * ll) / jnp.maximum(jnp.sum(w), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return step


def shared_training(left, cls_maps, steps: int, img, cls) -> None:
    sel = np.arange(0, left.shape[0], EVERY)
    imgs = np.repeat(left[sel, ::2, ::2].astype(np.float32)[..., None], 3,
                     axis=-1)
    labels = cls_maps[sel, ::2, ::2].astype(np.int32)
    h, w = imgs.shape[1:3]
    j_model = j_seg.SegNet(variant="basic", num_classes=15)
    init = j_seg.init_params(j_model, jax.random.key(0), h, w)
    weights = j_train.class_balance_weights(labels, 15)
    t_model = segnet.SegNet("basic", 15)
    shapes = t_model.dropout_shapes(h, w, BATCH)
    rng = np.random.default_rng(0)  # train_segnet(seed=0)'s batches
    batches = [rng.choice(len(imgs), BATCH, replace=False)
               for _ in range(steps)]

    def masks(step):
        draw = np.random.default_rng(1000 + step)
        return [draw.uniform(size=s) < 1.0 - t_model.dropout_rate
                for s in shapes]  # (B, C, h, w)

    tx = optax.adam(LR)
    j_step = jax_step_fn(j_model, tx, jnp.asarray(weights))
    params, opt_state, j_losses = init, tx.init(init), []
    t0 = time.perf_counter()
    for s in range(steps):
        params, opt_state, loss = j_step(
            params, opt_state, jnp.asarray(imgs[batches[s]]),
            jnp.asarray(labels[batches[s]]),
            [jnp.asarray(m.transpose(0, 2, 3, 1)) for m in masks(s)])
        j_losses.append(float(loss))
    print(f"JAX: {steps} steps in {time.perf_counter() - t0:.0f} s",
          flush=True)

    t_model.load_state_dict(segnet.params_from_flax(
        jax.tree.map(np.asarray, init)))
    opt = torch.optim.Adam(t_model.parameters(), lr=LR)
    t_weights = torch.from_numpy(weights)
    t_losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        loss = train.train_step(
            t_model, opt, torch.from_numpy(imgs[batches[s]]),
            torch.from_numpy(labels[batches[s]]).long(), t_weights,
            masks=[torch.from_numpy(m) for m in masks(s)])
        t_losses.append(float(loss))
    print(f"port: {steps} steps in {time.perf_counter() - t0:.0f} s",
          flush=True)
    for a in range(0, steps, 10):
        print(f"steps {a}-{min(a + 10, steps) - 1}: mean loss JAX "
              f"{np.mean(j_losses[a:a + 10]):.4f}, port "
              f"{np.mean(t_losses[a:a + 10]):.4f}")
    for name, state in (
            ("JAX", segnet.params_from_flax(jax.tree.map(np.asarray,
                                                         params))),
            ("port", t_model.state_dict())):
        acc, ent = port_holdout(state, img, cls)
        print(f"{name} network after {steps} shared steps: holdout "
              f"accuracy {acc:.4f}, entropy {ent:.4f} bits")


def main() -> None:
    work = Path(sys.argv[1])
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 150
    torch.set_num_threads(8)
    z = np.load(work / "render_cache.npz")
    left, cls_maps = z["left"], z["cls"]
    img = np.repeat(left[HOLDOUT].astype(np.float32)[..., None], 3, axis=-1)
    jax_networks(work, img, cls_maps[HOLDOUT])
    shared_training(left, cls_maps, steps, img, cls_maps[HOLDOUT])


if __name__ == "__main__":
    main()
