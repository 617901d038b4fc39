"""Frame front end: a stereo pair to a Frame (port of
``sivo_tpu/runtime/frame.py``).

One function, ``build_frame``, runs the whole pipeline: Bayesian SegNet
MC sampling, both pyramids, FAST, keypoint selection, IC angle + rBRIEF
(kernel K1), semantic gating and stereo association. The JAX package's
split into two dispatched programs was a TPU workaround (a Mosaic
kernel whose operands are intermediates of the same program paid a
fixed penalty) and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sivo_tpu_torch.config import SystemConfig
from sivo_tpu_torch.models import segnet as segnet_mod
from sivo_tpu_torch.ops import image as image_ops
from sivo_tpu_torch.ops import orb as orb_ops
from sivo_tpu_torch.ops import stereo as stereo_ops
from sivo_tpu_torch.select import semantic as semantic_ops


class Frame(NamedTuple):
    """Padded SoA frame (capacity N = cfg.orb.max_keypoints); the field
    names and dtypes of the JAX package's Frame."""

    xy: torch.Tensor  # (N, 2) level-0 pixel coords
    level: torch.Tensor  # (N,) int32 octave
    angle: torch.Tensor  # (N,) float32 radians
    desc_bits: torch.Tensor  # (N, 256) float32
    desc_u8: torch.Tensor  # (N, 32) uint8
    u_right: torch.Tensor  # (N,) float32, -1 if no stereo match
    depth: torch.Tensor  # (N,) float32, -1 if no stereo match
    sem_class: torch.Tensor  # (N,) uint8 class at the keypoint pixel
    sem_confidence: torch.Tensor  # (N,)
    sem_entropy: torch.Tensor  # (N,) bits
    valid: torch.Tensor  # (N,) extracted keypoint
    semantic: torch.Tensor  # (N,) valid & static class
    classes_raster: torch.Tensor  # (H, W) uint8
    confidence_raster: torch.Tensor  # (H, W)
    entropy_raster: torch.Tensor  # (H, W)

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


class FrontendStatics(NamedTuple):
    """Per-configuration constants of the frontend."""

    spec: image_ops.PyramidSpec
    budgets: tuple[int, ...]
    max_keypoints: int
    ini_th: float
    min_th: float
    fx: float
    bf: float
    mc_samples: int


def make_statics(cfg: SystemConfig) -> FrontendStatics:
    spec = image_ops.make_pyramid_spec(
        cfg.camera.height, cfg.camera.width,
        cfg.orb.n_levels, cfg.orb.scale_factor,
    )
    return FrontendStatics(
        spec=spec,
        budgets=image_ops.per_level_budgets(cfg.orb.n_features, spec),
        max_keypoints=cfg.orb.max_keypoints,
        ini_th=float(cfg.orb.ini_th_fast),
        min_th=float(cfg.orb.min_th_fast),
        fx=cfg.camera.fx,
        bf=cfg.camera.bf,
        mc_samples=cfg.semantic.mc_samples,
    )


def _as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def _keypoints(gray: torch.Tensor, statics: FrontendStatics,
               valid_region: torch.Tensor
               ) -> tuple[orb_ops.Keypoints, torch.Tensor]:
    """gray (H, W) float32 -> (Keypoints, blurred canvas)."""
    raw, blur = image_ops.build_pyramid(gray, statics.spec)
    kps = orb_ops.extract(
        raw, blur, valid_region, statics.spec, statics.budgets,
        statics.max_keypoints, statics.ini_th, statics.min_th,
    )
    return kps, blur


def _assemble(statics: FrontendStatics, gray_l: torch.Tensor,
              gray_r: torch.Tensor, classes: torch.Tensor,
              confidence: torch.Tensor, entropy: torch.Tensor) -> Frame:
    """Both images' ORB, semantic gating of the left keypoints
    (ref: Frame.cc:177-203) and stereo matching of the semantic set
    against all right keypoints (ref: Frame.cc:144)."""
    # detection region [EDGE-3, size-(EDGE-3)) (ref: ORBextractor.cc:758-766)
    valid_region = image_ops.level_valid_mask(statics.spec, 16,
                                              gray_l.device)
    kps_l, blur_l = _keypoints(gray_l, statics, valid_region)
    kps_r, blur_r = _keypoints(gray_r, statics, valid_region)
    sem_class, sem_conf, sem_ent = semantic_ops.sample_rasters(
        classes, confidence, entropy, kps_l.xy
    )
    semantic = kps_l.valid & semantic_ops.static_class_mask(sem_class)
    matches = stereo_ops.match(
        kps_l._replace(valid=semantic), kps_r, blur_l, blur_r,
        statics.spec, statics.fx, statics.bf,
    )
    return Frame(
        xy=kps_l.xy, level=kps_l.level, angle=kps_l.angle,
        desc_bits=kps_l.desc_bits, desc_u8=kps_l.desc_u8,
        u_right=matches.u_right, depth=matches.depth,
        sem_class=sem_class, sem_confidence=sem_conf, sem_entropy=sem_ent,
        valid=kps_l.valid, semantic=semantic,
        classes_raster=classes, confidence_raster=confidence,
        entropy_raster=entropy,
    )


def build_frame(
    model: segnet_mod.SegNet,
    statics: FrontendStatics,
    img_left,
    img_right_gray,
    generator: torch.Generator,
    sem_override: tuple | None = None,
    use_cnn_static: bool | None = None,
    *,
    device: torch.device,
) -> Frame:
    """The per-frame frontend (ref call stack: SURVEY §3.2).

    ``img_left``: (H, W, 3) BGR or (H, W) grey, 0..255 (uint8 or float;
    a grey image is broadcast to 3 channels for the CNN). ``model``
    holds SegNet's weights; ``generator`` draws its dropout masks.

    ``sem_override``: optional (classes, confidence, entropy, use_cnn).
    With ``use_cnn`` False the given rasters replace SegNet's posterior
    (renderer semantics when no trained weights exist); SegNet still
    runs at full cost unless ``use_cnn_static`` is False, which says the
    override holds for the whole run and skips SegNet (the JAX package
    drops it from the compiled program). Quantized rasters are
    accepted: confidence uint8 (x1/255), entropy uint8 (x1/32).
    """
    left = _as_tensor(img_left, device, torch.float32)
    if left.dim() == 2:
        left = left[:, :, None].expand(-1, -1, 3)
    right = _as_tensor(img_right_gray, device, torch.float32)
    if sem_override is None or use_cnn_static is not False:
        with torch.no_grad():
            classes, confidence, entropy = segnet_mod.segment_image(
                model, left, generator, statics.mc_samples
            )
    if sem_override is not None:
        o_cls, o_conf, o_ent, use_cnn = sem_override
        if not use_cnn or use_cnn_static is False:
            o_conf = _as_tensor(o_conf, device)
            o_ent = _as_tensor(o_ent, device)
            if o_conf.dtype == torch.uint8:
                o_conf = o_conf.float() * (1.0 / 255.0)
            if o_ent.dtype == torch.uint8:
                o_ent = o_ent.float() * (1.0 / 32.0)
            classes = _as_tensor(o_cls, device)
            confidence = o_conf.float()
            entropy = o_ent.float()
    gray_l = image_ops.bgr_to_gray(left)
    return _assemble(statics, gray_l, right, classes, confidence, entropy)


def build_frame_nosegnet(
    statics: FrontendStatics,
    gray_left,
    gray_right,
    classes,
    confidence,
    entropy,
    *,
    device: torch.device,
) -> Frame:
    """Frontend with externally supplied semantic rasters."""
    return _assemble(
        statics,
        _as_tensor(gray_left, device, torch.float32),
        _as_tensor(gray_right, device, torch.float32),
        _as_tensor(classes, device),
        _as_tensor(confidence, device),
        _as_tensor(entropy, device),
    )
