"""SegNet training: Adam on a median-frequency-balanced log-likelihood
under MC dropout (port of ``sivo_tpu/models/train.py``).

The reference trains its Bayesian SegNet offline in Caffe and ships only
inference (ref: bayesian_segnet.cpp:46-66); this is that offline step,
so that train -> ``.caffemodel`` -> ``state_dict_from_caffemodel`` ->
``segment_image`` runs inside the port. Class weights follow the SegNet
paper's balancing, median(freq)/freq(c).

Each step is the JAX package's ``_train_step``: a training forward of
the batch (``SegNet(..., train=True)``: every image its own dropout
masks), the loss ``-sum(w log max(p, 1e-12)) / max(sum(w), 1)`` on the
softmax probabilities, and one ``torch.optim.Adam`` step, whose
defaults (betas 0.9/0.999, eps 1e-8 outside the square root) are
``optax.adam``'s. Batches are drawn as the JAX package draws them, so
both see the same images in the same order. Training runs in float32,
with cuDNN held to its deterministic algorithms, so that a seed gives
one network on a given card and software (the default algorithms sum
weight gradients in an order that varies from run to run, and 150
steps of batch 2 carry that far: holdout accuracies of 0.80-0.90 from
one seed).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from sivo_tpu_torch.models import segnet as segnet_mod


def class_balance_weights(
    labels: np.ndarray, num_classes: int
) -> np.ndarray:
    """Median-frequency balancing over a label corpus (SegNet paper
    §3.3): weight(c) = median(freq)/freq(c); absent classes get 0."""
    counts = np.bincount(
        np.asarray(labels).reshape(-1), minlength=num_classes
    ).astype(np.float64)
    freq = counts / max(counts.sum(), 1)
    present = freq > 0
    med = np.median(freq[present]) if present.any() else 1.0
    w = np.zeros(num_classes, np.float64)
    w[present] = med / freq[present]
    return w.astype(np.float32)


def loss_fn(
    model: segnet_mod.SegNet,
    images: torch.Tensor,  # (B, H, W, 3) float 0..255
    labels: torch.Tensor,  # (B, H, W) integer class ids
    weights: torch.Tensor,  # (C,)
    generator: torch.Generator | None = None,
    masks: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """The class-weighted negative log-likelihood of one batch under
    dropout (masks from ``generator``, or the keep-masks ``masks``)."""
    probs = model(images, generator=generator, masks=masks, train=True)
    logp = torch.log(torch.clamp(probs, min=1e-12))
    labels = labels.long()
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    w = weights[labels]
    return -torch.sum(w * ll) / torch.clamp(torch.sum(w), min=1.0)


def train_step(
    model: segnet_mod.SegNet,
    optimizer: torch.optim.Optimizer,
    images: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    generator: torch.Generator | None = None,
    masks: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """One Adam step on one batch; returns the loss before the step, on
    the device (reading it is a sync)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, images, labels, weights, generator, masks)
    loss.backward()
    optimizer.step()
    return loss.detach()


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device``, or the current CUDA card when it is None; raises when
    there is none (a caller who wants the CPU passes it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("training runs on a CUDA card; none is "
                               "available (pass a CPU device to run on "
                               "the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block,
    its settings restored after."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = before


def train_segnet(
    model: segnet_mod.SegNet,
    images: np.ndarray,  # (N, H, W, 3) uint8/float
    labels: np.ndarray,  # (N, H, W) integer class ids
    *,
    steps: int = 200,
    batch: int = 2,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 0,
    device: torch.device | str | None = None,
) -> tuple[segnet_mod.SegNet, torch.Tensor]:
    """A small Adam loop over (image, label) rasters: moves ``model`` to
    the device, trains it in place and returns it with the (steps,)
    losses, still on the device. Images and labels stay on the host;
    each step uploads its batch. The loss is read on the host only every
    ``log_every`` steps, each read being a sync."""
    dev = resolve_device(device)
    model = model.to(dev)
    weights = torch.from_numpy(
        class_balance_weights(labels, model.num_classes)).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=dev).manual_seed(seed)
    n = images.shape[0]
    losses = []
    with deterministic_cudnn():
        for step in range(steps):
            idx = rng.choice(n, size=min(batch, n), replace=False)
            img_b = torch.from_numpy(
                np.asarray(images[idx], np.float32)).to(dev)
            lab_b = torch.from_numpy(
                np.asarray(labels[idx], np.int64)).to(dev)
            losses.append(train_step(model, optimizer, img_b, lab_b,
                                     weights, generator))
            if log_every and step % log_every == 0:
                print(f"  [train] step {step} loss "
                      f"{float(losses[-1]):.4f}", flush=True)
    return model, torch.stack(losses)
