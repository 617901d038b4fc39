"""Kernel K1: fused IC angle + rBRIEF, a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``sivo_tpu/ops/pallas_orb.py::_kernel``
(launched by ``_call``, reached through ``orient_and_describe``). Source:
``sivo_tpu_torch/csrc/orb_describe.cu``.

What it computes, per keypoint (level, x, y) of the float canvases: the
keypoint is clamped so its 37x37 patch lies inside the canvas, and every
pixel it reads is rounded to u8 (half to even, clamped to 0..255: the
reference runs IC_Angle and BRIEF on 8U images). Then the
intensity-centroid moments m01 = sum v*I and m10 = sum u*I over the
radius-15 circular mask of the raw canvas; cos = m10 / sqrt(max(m01^2 +
m10^2, 1e-18)) and sin = m01 / sqrt(...) straight from the moments; then
256 bits ``I(p1) < I(p2)`` on the blurred canvas at row = round(x*sin +
y*cos), col = round(x*cos - y*sin) of the pattern points. It writes the
angle atan2(m01, m10) and the 32 descriptor bytes packed LSB-first. A
flat patch (m01 = m10 = 0) gives cos = sin = 0, so every sample lands
on the centre and every bit is 0, as in the Pallas kernel.

What bounds it on the H100: device memory. The least it must read is
the pixels it uses once each: on the main path's frame, ~0.67M raw
pixels under the circular masks and ~0.48M sampled blurred pixels, as
float32, ~4.7 MB or ~1.4 us at 3.35 TB/s (``chip_smoke.py`` counts them
each run); its arithmetic (~19M ops) is far below that. The kernel
reads more: whole patch rows for every keypoint, overlapping patches
again, ~350 32-byte sectors per keypoint by count from the code (~23 MB
from L2 at 2048 keypoints), the likely limit of its time (PERF.md).

The design: it reads the float canvases itself (no whole-canvas u8
passes before it, one launch per image); a persistent grid of about one
block per SM stages the pattern and the circular mask (31 column
bit-masks from ``ic_angle_mask``) once; each warp takes one keypoint at
a time, reads its 31x31 raw patch a row per coalesced load (lane =
column, no division, no sqrt), reduces the moments with shuffles (exact
integers, so order does not matter), stages the 37x37 blurred patch as
u8 in shared memory, and each lane forms one output byte from 8 pattern
pairs.

The TPU kernel's aligned (48, 256) band DMA and its padded u8 canvases
were Mosaic tiling rules; this kernel reads the clamped patch directly.

On a CPU tensor ``orient_and_describe`` runs the plain PyTorch version
of the same semantics; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from sivo_tpu_torch.ops.image import BORDER
from sivo_tpu_torch.utils import kernels

HALF_PATCH = 15
BRIEF_MARGIN = 18
BRIEF_PATCH = 2 * BRIEF_MARGIN + 1

# the reference's bit_pattern_31_ (ref: ORBextractor.cc:153-410), a
# copy of the JAX package's ops/data/brief_pattern.npy: (256, 4) rows of
# x1 y1 x2 y2
PATTERN = np.load(
    Path(__file__).resolve().parent / "data" / "brief_pattern.npy"
).astype(np.int8)

LAUNCHES = 0  # kernel launches since the last reset (plain calls not counted)

_tables_cache: dict[torch.device, torch.Tensor] = {}


def ic_angle_mask() -> np.ndarray:
    """(31, 31) circular-patch mask of the reference's umax bounds
    (ref: ORBextractor.cc:431-447), symmetrized."""
    v = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    umax = np.round(np.sqrt(np.maximum(225 - v * v, 0))).astype(np.int32)
    m = np.abs(v)[None, :] <= umax[:, None]
    m = m & m.T
    return m.astype(np.float32)


def kernel_tables() -> np.ndarray:
    """(288,) int32 tables of the kernel: the pattern's 256 rows, each
    4 int8 as one little-endian word, then for each of the 31 columns of
    ``ic_angle_mask`` a word whose bit r is set where row r is inside,
    then a spare 0."""
    mask = ic_angle_mask().astype(bool)
    cols = (mask.astype(np.int64) << np.arange(31)[:, None]).sum(0)
    return np.concatenate([
        np.ascontiguousarray(PATTERN).view("<i4").reshape(-1),
        cols.astype(np.int32), np.zeros(1, np.int32),
    ])


def _tables_on(device: torch.device) -> torch.Tensor:
    if device not in _tables_cache:
        _tables_cache[device] = torch.from_numpy(kernel_tables()).to(device)
    return _tables_cache[device]


def clamp_coords(
    canvas_shape: tuple[int, ...],
    level: torch.Tensor,
    xy_level: torch.Tensor,
) -> torch.Tensor:
    """(N, 3) int32 (level, canvas y, canvas x): level coordinates
    truncated toward zero, moved into the canvas by ``BORDER`` and
    clamped so every 37x37 patch lies inside. Invalid slots (xy = -1)
    are clamped in bounds; the caller masks their outputs."""
    xy = xy_level.to(torch.int32)
    ymax = canvas_shape[1] - BRIEF_MARGIN - 1
    xmax = canvas_shape[2] - BRIEF_MARGIN - 1
    return torch.stack(
        [
            level.to(torch.int32),
            torch.clamp(xy[:, 1] + BORDER, BRIEF_MARGIN, ymax),
            torch.clamp(xy[:, 0] + BORDER, BRIEF_MARGIN, xmax),
        ],
        dim=1,
    )


def _patches_u8(canvas: torch.Tensor, coords: torch.Tensor,
                half: int) -> torch.Tensor:
    """(N, 2h+1, 2h+1) float32 patches around ``coords``, rounded half
    to even and clamped to 0..255 (the u8 values, as floats)."""
    off = torch.arange(-half, half + 1, device=canvas.device)
    lvl = coords[:, 0].long()[:, None, None]
    rows = (coords[:, 1].long()[:, None] + off)[:, :, None]
    cols = (coords[:, 2].long()[:, None] + off)[:, None, :]
    return torch.clamp(torch.round(canvas[lvl, rows, cols]), 0, 255)


def ic_moments(raw_canvas: torch.Tensor, coords: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m01, m10), each (N,) float32 (exact integers): sum v*I and sum
    u*I over the circular mask of the u8-rounded raw patch."""
    dev = raw_canvas.device
    praw = _patches_u8(raw_canvas, coords, HALF_PATCH)  # (N, 31, 31)
    mask = torch.from_numpy(ic_angle_mask()).to(dev)
    coord = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=dev,
                         dtype=torch.float32)
    wm = praw * mask[None]
    m01 = torch.sum(wm * coord[None, :, None], dim=(1, 2))  # sum v*I
    m10 = torch.sum(wm * coord[None, None, :], dim=(1, 2))  # sum u*I
    return m01, m10


def brief_offsets(m01: torch.Tensor, m10: torch.Tensor) -> torch.Tensor:
    """(N, 512) int64 flat offsets into the 37x37 blurred patch of the
    rotated pattern points: the 256 first points, then the 256 second."""
    dev = m01.device
    r = 1.0 / torch.sqrt(torch.clamp(m01 * m01 + m10 * m10, min=1e-18))
    a = (m10 * r)[:, None]  # cos
    b = (m01 * r)[:, None]  # sin
    pat = torch.from_numpy(PATTERN.astype(np.float32)).to(dev)

    def flat(px, py):
        row = torch.round(px * b + py * a).long() + BRIEF_MARGIN
        col = torch.round(px * a - py * b).long() + BRIEF_MARGIN
        return row * BRIEF_PATCH + col

    return torch.cat([flat(pat[None, :, 0], pat[None, :, 1]),
                      flat(pat[None, :, 2], pat[None, :, 3])], dim=1)


def orient_and_describe(
    raw_canvas: torch.Tensor,
    blur_canvas: torch.Tensor,
    level: torch.Tensor,
    xy_level: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(angle (N,) float32, packed descriptors (N, 32) uint8) for
    keypoints at integer level coordinates ``xy_level`` (N, 2) of the
    float canvases."""
    if raw_canvas.is_cuda:
        return orb_describe_cuda(raw_canvas, blur_canvas, level, xy_level)
    if raw_canvas.device.type == "cpu":
        return orient_and_describe_plain(raw_canvas, blur_canvas, level,
                                         xy_level)
    raise ValueError(f"no ORB descriptor path for device {raw_canvas.device}")


def orient_and_describe_plain(
    raw_canvas: torch.Tensor,
    blur_canvas: torch.Tensor,
    level: torch.Tensor,
    xy_level: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's semantics in plain PyTorch, on the same inputs: the
    CPU path, and the reference that the kernel is held to on the card."""
    coords = clamp_coords(raw_canvas.shape, level, xy_level)
    m01, m10 = ic_moments(raw_canvas, coords)
    pblur = _patches_u8(blur_canvas, coords, BRIEF_MARGIN)
    v = torch.gather(pblur.reshape(len(coords), -1), 1,
                     brief_offsets(m01, m10))
    bits = (v[:, :256] < v[:, 256:]).to(torch.int32).reshape(-1, 32, 8)
    weights = 1 << torch.arange(8, device=raw_canvas.device,
                                dtype=torch.int32)
    packed = torch.sum(bits * weights, dim=-1).to(torch.uint8)
    return torch.atan2(m01, m10), packed


def orb_describe_cuda(
    raw_canvas: torch.Tensor,
    blur_canvas: torch.Tensor,
    level: torch.Tensor,
    xy_level: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream. Inputs: (L, H, W) float32
    canvases, (N,) int32 levels and (N, 2) float32 level coordinates."""
    global LAUNCHES
    dev = raw_canvas.device
    n = level.shape[0] if level.dim() == 1 else -1
    for name, t, dtype, shape in (
        ("raw_canvas", raw_canvas, torch.float32, None),
        ("blur_canvas", blur_canvas, torch.float32, None),
        ("level", level, torch.int32, (n,)),
        ("xy_level", xy_level, torch.float32, (n, 2)),
    ):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
        if (t.dtype != dtype or not t.is_contiguous()
                or (shape is None and t.dim() != 3)
                or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError(
                f"{name}: need contiguous {dtype} of shape "
                f"{shape or '(L, H, W)'}, got {t.dtype} {tuple(t.shape)}"
            )
    if blur_canvas.shape != raw_canvas.shape:
        raise ValueError("raw and blurred canvas shapes differ")
    if xy_level.data_ptr() % 8:
        raise ValueError("xy_level must be 8-byte aligned")
    _, H, W = raw_canvas.shape
    if H < BRIEF_PATCH or W < BRIEF_PATCH:
        raise ValueError(f"canvas {H}x{W} smaller than a 37x37 patch")
    angle = torch.empty(n, dtype=torch.float32, device=dev)
    packed = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    if n == 0:
        return angle, packed
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.library().sivo_orb_describe(
        raw_canvas.data_ptr(), blur_canvas.data_ptr(), level.data_ptr(),
        xy_level.data_ptr(), _tables_on(dev).data_ptr(), angle.data_ptr(),
        packed.data_ptr(), n, H, W, BORDER, ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"orb_describe launch failed: CUDA error {err}")
    LAUNCHES += 1
    return angle, packed
