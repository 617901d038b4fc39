"""Bayesian SegNet, "basic" and "standard" variants, as an ``nn.Module``
(port of ``sivo_tpu/models/segnet.py``).

Layout is NCHW (PyTorch's convolution layout); ``params_from_flax``
turns the JAX package's Flax parameter tree (HWIO kernels, Caffe BN
leaves) into this module's state (OIHW), and ``flax_from_params`` turns
it back, so the port's weights can be written as a ``.caffemodel``
(``models/caffe_io.py``). The MC-dropout ensemble is an explicit batch
axis fanned out at the first dropout layer, so the deterministic
pre-dropout encoder runs once (the JAX package's ``mc_samples`` path).
Dropout masks come from an explicit ``torch.Generator``, or are passed
in (tests feed both frameworks the same masks). ``train=True`` is the
training forward: a batch of images, each with its own dropout masks
(the JAX package's ``train=True`` forward under a ``vmap`` over the
batch, ``models/train.py``).

Convolutions run in ``dtype`` (``cfg.semantic.cnn_dtype``, bf16 by
default): each casts its input to ``dtype``. The Caffe BN layers of the
standard variant run in float32, as the JAX package's float32 BN
parameters promote the activations there; ReLU and the pool follow in
float32. Softmax, the MC mean and the entropy run in float32.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (name, out_channels, kernel) per encoder stage / decoder block
_BASIC_ENCODER = (
    (("conv1", 64, 7),),
    (("conv2", 64, 7),),
    (("conv3", 64, 7),),
    (("conv4", 64, 7),),
)
_BASIC_DECODER = (
    (("conv_decode4", 64, 7),),
    (("conv_decode3", 64, 7),),
    (("conv_decode2", 64, 7),),
    (("conv_decode1", 64, 7),),
)
_STD_ENCODER = (
    (("conv1_1", 64, 3), ("conv1_2", 64, 3)),
    (("conv2_1", 128, 3), ("conv2_2", 128, 3)),
    (("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3)),
    (("conv4_1", 512, 3), ("conv4_2", 512, 3), ("conv4_3", 512, 3)),
    (("conv5_1", 512, 3), ("conv5_2", 512, 3), ("conv5_3", 512, 3)),
)
_STD_DECODER = (
    (("conv5_3_D", 512, 3), ("conv5_2_D", 512, 3), ("conv5_1_D", 512, 3)),
    (("conv4_3_D", 512, 3), ("conv4_2_D", 512, 3), ("conv4_1_D", 256, 3)),
    (("conv3_3_D", 256, 3), ("conv3_2_D", 256, 3), ("conv3_1_D", 128, 3)),
    (("conv2_2_D", 128, 3), ("conv2_1_D", 64, 3)),
    (("conv1_2_D", 64, 3),),
)


# variant -> (encoder, decoder, Caffe BN after each conv, encoder stages
# with dropout after their pool, decoder blocks with dropout after them,
# output conv (name, kernel))
VARIANTS = {
    "basic": (_BASIC_ENCODER, _BASIC_DECODER, False, (2, 3), (0, 1),
              ("dense_softmax_inner_prod", 1)),
    "standard": (_STD_ENCODER, _STD_DECODER, True, (2, 3, 4), (0, 1, 2),
                 ("conv1_1_D", 3)),
}


def _variant(variant: str) -> tuple:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    return VARIANTS[variant]


def conv_specs(variant: str, num_classes: int = 15
               ) -> list[tuple[str, int, int, int]]:
    """(name, in_channels, out_channels, kernel) of every convolution in
    call order, the output convolution last."""
    encoder, decoder, _, _, _, (out_name, out_k) = _variant(variant)
    specs, cin = [], 3
    for name, ch, k in (layer for block in encoder + decoder
                        for layer in block):
        specs.append((name, cin, ch, k))
        cin = ch  # max-unpooling keeps the channels
    specs.append((out_name, cin, num_classes, out_k))
    return specs


def lrn(x: torch.Tensor, local_size: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Caffe ACROSS_CHANNELS LRN over the channel dim (NCHW: dim 1):
    ``x / (k + alpha/n * sum_window x^2)^beta``, the window sum as a
    cumulative-sum difference as in the JAX package."""
    sq = x * x
    half = local_size // 2
    sq = F.pad(sq, (0, 0, 0, 0, half, half))
    csum = torch.cumsum(sq, dim=1)
    csum = F.pad(csum, (0, 0, 0, 0, 1, 0))
    n_ch = x.shape[1]
    win = csum[:, local_size:local_size + n_ch] - csum[:, :n_ch]
    scale = k + (alpha / local_size) * win
    return x / (scale ** beta)


def max_pool_argmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-overlapping 2x2 max pooling with the in-window argmax (0..3,
    row-major, first index on ties — Caffe's pooling mask)."""
    b, c, h, w = x.shape
    xw = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    xw = xw.reshape(b, c, h // 2, w // 2, 4)
    return torch.amax(xw, dim=-1), torch.argmax(xw, dim=-1)


def max_unpool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Scatter each value into the 2x2 slot named by ``idx``."""
    b, c, h, w = x.shape
    onehot = F.one_hot(idx.long(), 4).to(x.dtype)  # (b, c, h, w, 4)
    y = (x[..., None] * onehot).reshape(b, c, h, w, 2, 2)
    y = y.permute(0, 1, 2, 4, 3, 5)
    return y.reshape(b, c, h * 2, w * 2)


class CaffeBN(nn.Module):
    """Inference-form Caffe "BN" layer: ``y = x * inv + (shift - mean *
    inv)`` with ``inv = rsqrt(var + eps) * scale``, in float32. Weights
    with the statistics merged into scale and shift keep mean 0, var 1."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.shift = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        return (x.float() * inv[:, None, None]
                + (self.shift - self.mean * inv)[:, None, None])


class SegNet(nn.Module):
    """Bayesian SegNet.

    basic: LRN -> 4 x [conv7x7(64) + ReLU + 2x2 argmax pool], MC dropout
    after pool3/pool4, mirrored decoder with max-unpooling, 1x1 conv to
    classes, softmax. standard: VGG16-style 13-conv encoder with Caffe BN
    after every conv, 5 pools, mirrored decoder, MC dropout after
    pool3/4/5 and after decoder blocks 0/1/2, a 3x3 conv to classes
    (``conv1_1_D``, no BN, no ReLU), softmax.
    """

    def __init__(self, variant: str = "basic", num_classes: int = 15,
                 dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        (self._encoder, self._decoder, self._use_bn, self._enc_drop,
         self._dec_drop, (self._out_name, _)) = _variant(variant)
        self.variant = variant
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        convs, bns = {}, {}
        for name, cin, cout, k in conv_specs(variant, num_classes):
            convs[name] = nn.Conv2d(cin, cout, k, padding=k // 2)
            if self._use_bn and name != self._out_name:
                bns[f"{name}_bn"] = CaffeBN(cout)
        self.convs = nn.ModuleDict(convs)
        self.bns = nn.ModuleDict(bns)

    def dropout_shapes(self, height: int, width: int,
                       mc_samples: int) -> list[tuple[int, ...]]:
        """(S, C, h, w) shape of each dropout layer's mask, in call order
        (S: the MC samples, or the batch of the training forward)."""
        n_pools = len(self._encoder)
        shapes = []
        for i in self._enc_drop:
            div = 2 ** (i + 1)
            shapes.append((mc_samples, self._encoder[i][-1][1],
                           height // div, width // div))
        for i in self._dec_drop:
            div = 2 ** (n_pools - 1 - i)
            shapes.append((mc_samples, self._decoder[i][-1][1],
                           height // div, width // div))
        return shapes

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        conv = self.convs[name]
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), padding=conv.padding)

    def _block(self, x: torch.Tensor,
               spec: Sequence[tuple[str, int, int]]) -> torch.Tensor:
        for name, _, _ in spec:
            x = self._conv(name, x)
            if self._use_bn:
                x = self.bns[f"{name}_bn"](x)
            x = F.relu(x)
        return x

    def forward(
        self,
        image: torch.Tensor,
        mc_samples: int | None = None,
        generator: torch.Generator | None = None,
        masks: Sequence[torch.Tensor] | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        """image: (H, W, 3) float, raw 0..255 (the reference feeds raw
        float BGR, no mean subtraction).

        ``mc_samples=None``: deterministic (``train=False``) forward,
        returns (H, W, classes) probabilities. ``mc_samples=S``: MC
        dropout with masks drawn from ``generator`` (or taken from
        ``masks``, boolean keep-masks of ``dropout_shapes``), returns
        (S, H, W, classes). ``train=True``: ``image`` is a (B, H, W, 3)
        batch, each image with its own dropout masks (``dropout_shapes(H,
        W, B)``), nothing tiled; returns (B, H, W, classes).
        """
        if train and (mc_samples is not None or image.ndim != 4):
            raise ValueError("train=True takes a (B, H, W, 3) batch and "
                             "no mc_samples")
        if not train and image.ndim != 3:
            raise ValueError("inference takes one (H, W, 3) image")
        h, w = image.shape[-3], image.shape[-2]
        div = 2 ** len(self._encoder)
        if h % div or w % div:
            raise ValueError(
                f"SegNet '{self.variant}' needs H, W divisible by {div} "
                f"(got {h}x{w}); center-crop the input first "
                "(ref: System.cc:154-170 resizeImages)"
            )
        keep = 1.0 - self.dropout_rate
        drop_i = 0

        stochastic = train or mc_samples is not None

        def drop(x):
            nonlocal drop_i
            if not stochastic:
                return x
            if masks is not None:
                m = masks[drop_i]
            else:
                m = torch.rand(x.shape, generator=generator,
                               device=x.device) < keep
            drop_i += 1
            return torch.where(m, x / keep, torch.zeros_like(x))

        if train:
            x = image.to(self.dtype).permute(0, 3, 1, 2)
        else:
            x = image.to(self.dtype).permute(2, 0, 1)[None]
        if self.variant == "basic":
            x = lrn(x)
        pool_idx = []
        tiled = mc_samples is None
        for i, spec in enumerate(self._encoder):
            x, idx = max_pool_argmax(self._block(x, spec))
            pool_idx.append(idx)
            if i in self._enc_drop:
                if not tiled:
                    x = x.expand((mc_samples,) + x.shape[1:])
                    tiled = True
                x = drop(x)
        for i, spec in enumerate(self._decoder):
            x = max_unpool(x, pool_idx[len(pool_idx) - 1 - i])
            x = self._block(x, spec)
            if i in self._dec_drop:
                x = drop(x)
        logits = self._conv(self._out_name, x)
        probs = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
        return probs if stochastic else probs[0]


def conv_flops(variant: str, height: int, width: int, mc_samples: int,
               num_classes: int = 15) -> int:
    """Floating-point operations (2 per multiply-add) of the
    convolutions of one ``segment_image`` at this geometry: the encoder
    stages up to the first dropout run once, every later convolution
    once per MC sample."""
    encoder, decoder, _, enc_drop, _, _ = _variant(variant)
    n_pools = len(encoder)
    once = sum(len(block) for block in encoder[: min(enc_drop) + 1])
    # each convolution's resolution divisor, in call order
    divs = [2 ** i for i, block in enumerate(encoder) for _ in block]
    divs += [2 ** (n_pools - 1 - i) for i, block in enumerate(decoder)
             for _ in block]
    divs.append(1)
    total = 0
    for j, ((_, cin, cout, k), div) in enumerate(
            zip(conv_specs(variant, num_classes), divs)):
        macs = (height // div) * (width // div) * cin * cout * k * k
        total += 2 * macs * (1 if j < once else mc_samples)
    return total


def posterior(mean_probs: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W, C) MC-mean probabilities -> (classes uint8 argmax,
    confidence max prob, Shannon entropy in bits)."""
    classes = torch.argmax(mean_probs, dim=-1).to(torch.uint8)
    confidence = torch.amax(mean_probs, dim=-1)
    p = mean_probs
    plogp = torch.where(p > 0.0, p * torch.log2(torch.clamp(p, min=1e-30)),
                        torch.zeros_like(p))
    return classes, confidence, -torch.sum(plogp, dim=-1)


def segment_image(
    model: SegNet,
    image: torch.Tensor,
    generator: torch.Generator | None,
    mc_samples: int = 3,
    masks: Sequence[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full MC-dropout segmentation: (classes, confidence, entropy)."""
    probs = model(image, mc_samples=mc_samples, generator=generator,
                  masks=masks)
    return posterior(torch.mean(probs, dim=0))


def mc_variance(probs: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Per-pixel sample variance (Bessel, /(S-1)) across the MC draws of
    the softmax probability of the detected class (ref:
    bayesian_segnet.cpp:205-260 ``computeVariance``). probs: (S, H, W,
    C); classes: (H, W), the argmax of the MC mean. Returns (H, W)
    float32."""
    s = probs.shape[0]
    sel = torch.gather(
        probs, -1, classes.long()[None, ..., None].expand(s, -1, -1, 1)
    )[..., 0]  # (S, H, W)
    mean = torch.mean(sel, dim=0)
    return torch.sum((sel - mean[None]) ** 2, dim=0) / float(max(s - 1, 1))


def variance_image(variance: torch.Tensor) -> torch.Tensor:
    """Min-max normalise the variance raster to [0, 1] (ref:
    bayesian_segnet.cpp:330-344 ``generateVarianceImage``,
    cv::NORM_MINMAX)."""
    lo, hi = torch.amin(variance), torch.amax(variance)
    return (variance - lo) / torch.clamp(hi - lo, min=1e-30)


def segment_image_with_variance(
    model: SegNet,
    image: torch.Tensor,
    generator: torch.Generator | None,
    mc_samples: int = 3,
    masks: Sequence[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``segment_image`` plus the MC-variance raster: (classes,
    confidence, entropy, variance) (ref: bayesian_segnet.hpp:108-170).
    Off the per-frame path, as the reference's ``computeVariance``."""
    probs = model(image, mc_samples=mc_samples, generator=generator,
                  masks=masks)
    classes, confidence, entropy = posterior(torch.mean(probs, dim=0))
    return classes, confidence, entropy, mc_variance(probs, classes)


_BN_LEAVES = ("scale", "shift", "mean", "var")


def params_from_flax(tree: Any) -> dict[str, torch.Tensor]:
    """Flax parameter tree of the JAX package's ``SegNet`` as numpy
    arrays (``{'params': {conv: {'kernel': HWIO, 'bias': (O,)},
    conv_bn: {'scale', 'shift', 'mean', 'var'}}}``) -> this module's
    state dict (OIHW weights)."""
    params = tree["params"] if "params" in tree else tree
    state = {}
    for name, leaf in params.items():
        if "kernel" in leaf:
            kernel = np.asarray(leaf["kernel"], np.float32)
            state[f"convs.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
            state[f"convs.{name}.bias"] = torch.from_numpy(
                np.asarray(leaf["bias"], np.float32).copy())
        else:
            for k in _BN_LEAVES:
                state[f"bns.{name}.{k}"] = torch.from_numpy(
                    np.asarray(leaf[k], np.float32).copy())
    return state


def flax_from_params(state: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of ``params_from_flax``: this module's state dict ->
    ``{'params': {...}}`` of float32 numpy arrays (HWIO kernels)."""
    params: dict[str, dict[str, np.ndarray]] = {}
    for key, value in state.items():
        kind, name, leaf = key.split(".")
        arr = value.detach().cpu().to(torch.float32).numpy()
        if kind == "convs" and leaf == "weight":
            params.setdefault(name, {})["kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        else:
            params.setdefault(name, {})[leaf] = arr.copy()
    return {"params": params}


def init_params(seed: int, num_classes: int = 15,
                variant: str = "basic") -> dict[str, torch.Tensor]:
    """Seeded random weights without JAX, made with numpy: kernels from
    Flax's LeCun-normal default (a standard normal truncated at 2 sigma,
    its tails redrawn, scaled to variance 1/fan_in), zero biases, and
    Flax's BN defaults (scale 1, shift 0, mean 0, var 1)."""
    rng = np.random.default_rng(seed)
    state = {}
    specs = conv_specs(variant, num_classes)
    for name, cin, cout, k in specs:
        state[f"convs.{name}.weight"] = _lecun(rng, (cout, cin, k, k))
        state[f"convs.{name}.bias"] = torch.zeros(cout)
    if _variant(variant)[2]:
        for name, _, cout, _ in specs[:-1]:
            for k, fill in zip(_BN_LEAVES, (1.0, 0.0, 0.0, 1.0)):
                state[f"bns.{name}_bn.{k}"] = torch.full((cout,), fill)
    return state


def _lecun(rng: np.random.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    fan_in = int(np.prod(shape[1:]))
    z = rng.standard_normal(shape)
    out = np.abs(z) > 2.0
    while out.any():
        z[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(z) > 2.0
    # rescaled by Flax's truncation constant to unit variance
    z = z / 0.87962566103423978
    return torch.from_numpy((z / np.sqrt(fan_in)).astype(np.float32))


def dtype_of(name: str) -> torch.dtype:
    """``cfg.semantic.cnn_dtype`` string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
