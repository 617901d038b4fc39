"""Kernel K2: masked Hamming top-2, a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``sivo_tpu/ops/pallas_match.py::_kernel``
(launched by ``masked_hamming_top2``, reached through
``ops/matching.py::_top2_masked``). Source:
``sivo_tpu_torch/csrc/hamming_top2.cu``.

What it computes: for each row i, the Hamming distance to every column
j, set to inf unless all of

    |x_j - u_i| <= r_i,  |y_j - v_i| <= r_i,  lo_i <= level_j <= hi_i,
    row i valid, column j valid, and (with use_ur)
    ur_j <= 0 or |ur_i - ur_j| <= r_i

hold; then the best and second-best distance and their first-index
argmins. The result equals the JAX package's XLA branch bit for bit,
edge cases included: a fully masked row gives best = second = inf and
both indices 0; a row with one finite entry gives second index 0 (the
argmin of an all-inf row).

Descriptors arrive packed, (N, 32) uint8 read as 8 x u32 (256 bits);
the TPU kernel's f32 0/1 matmul over unpacked bits was an MXU
workaround.

What bounds it on the H100. Its inputs and outputs are ~0.3 MB at the
main path's N = M = 2048 (~0.09 us at 3.35 TB/s). Every valid row needs
the window test against every column (~10 float ops a pair, 67
TFLOP/s); on the main path only a tenth of the rows or fewer are valid
(map points or keypoints with a point), so the bytes set the bound.
The distances of the pairs that pass run on the tensor cores as
256-bit AND + popcount, for which NVIDIA publishes no H100 rate; the
bound leaves them out. ``chip_smoke.py`` counts it from each run's
inputs (``k2_bound``).

The design (``csrc/hamming_top2.cu``), from measurements on the H100
(PERF.md): distances come from the tensor cores, one
``mma.m16n8k256.b1.and.popc`` per 16-row x 8-column block (Hamming =
popc(a) + popc(b) - 2 popc(a & b)), so brute force is not held by the
CUDA cores' popcount rate; a warp none of whose 16 rows is valid scans
nothing; a thread tests the windows of its four pairs, and a warp runs
the mma and the top-2 update only for blocks where some pair passes. A
CTA owns 32 rows (2 row warps x 4 column warps) and a cluster of 4 CTAs
splits that row tile's columns, so N = 2048 gives 256 CTAs, one wave on
132 SMs, and each column is read from L2 once per 32 rows (re-reading
the columns for every 16 rows held a CUDA-core design with 4 rows per
warp to the first design's speed).
Column tiles of 128 arrive through a two-stage cp.async ring while the
previous tile is scanned. Candidates are 32-bit keys ``distance << 23 |
index``, so every merge (threads by shuffles, warps through shared
memory, the cluster's CTAs through distributed shared memory) is a
min/max on keys that reproduces a serial scan's first-index ties; hence
``m < 2^23``. No (N, M) matrix reaches global memory. Ragged N and M
are handled inside the kernel.

On a CPU tensor ``masked_hamming_top2`` runs the plain PyTorch version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from sivo_tpu_torch.utils import kernels

LAUNCHES = 0  # kernel launches since the last reset (plain calls not counted)

_ROW_CHUNK = 256  # rows per step of the plain version (bounds its memory)
MAX_COLUMNS = 1 << 23  # the kernel's keys keep the column index in 23 bits


def pack_row_attr(u, v, ur, radius, lvl_lo, lvl_hi, valid) -> torch.Tensor:
    """(N,)-vectors -> (N, 8) float32 [u, v, ur, radius, lo, hi, valid, 0]."""
    cols = [u, v, ur, radius, lvl_lo, lvl_hi, valid]
    cols = [c.float() for c in cols] + [torch.zeros_like(u, dtype=torch.float32)]
    return torch.stack(cols, dim=1).contiguous()


def pack_col_attr_t(x, y, ur, level, valid) -> torch.Tensor:
    """(M,)-vectors -> (8, M) float32 [x, y, ur, level, valid, 0, 0, 0]."""
    z = torch.zeros_like(x, dtype=torch.float32)
    cols = [x, y, ur, level, valid]
    return torch.stack([c.float() for c in cols] + [z, z, z]).contiguous()


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each uint8 element (SWAR on bytes, no overflow)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def hamming_u8(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """(N, 32) x (M, 32) packed descriptors -> (N, M) int32 Hamming
    distances (XOR + popcount)."""
    xor = a_u8[:, None, :] ^ b_u8[None, :, :]
    return popcount_u8(xor).sum(-1, dtype=torch.int32)


def pair_mask(row_attr: torch.Tensor, col_attr_t: torch.Tensor,
              use_ur: bool) -> torch.Tensor:
    """(n, M) bool: which (row, column) pairs pass the window, level,
    validity and (with ``use_ur``) right-u tests."""
    x, y, c_ur, lvl, c_valid = (col_attr_t[k][None, :] for k in range(5))
    u, v, r_ur, radius, lo, hi, r_valid = (
        row_attr[:, k:k + 1] for k in range(7)
    )
    ok = (
        ((x - u).abs() <= radius) & ((y - v).abs() <= radius)
        & (lvl >= lo) & (lvl <= hi) & (r_valid > 0.5) & (c_valid > 0.5)
    )
    if use_ur:
        ok = ok & ((c_ur <= 0.0) | ((r_ur - c_ur).abs() <= radius))
    return ok


def masked_hamming_top2(
    a_u8: torch.Tensor,
    b_u8: torch.Tensor,
    row_attr: torch.Tensor,
    col_attr_t: torch.Tensor,
    use_ur: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_d, second_d, best_j, second_j), each (N,): float32
    distances (inf when masked) and int32 first-index argmins."""
    if a_u8.is_cuda:
        return masked_hamming_top2_cuda(a_u8, b_u8, row_attr, col_attr_t,
                                        use_ur)
    if a_u8.device.type == "cpu":
        return masked_hamming_top2_plain(a_u8, b_u8, row_attr, col_attr_t,
                                         use_ur)
    raise ValueError(f"no Hamming top-2 path for device {a_u8.device}")


def masked_hamming_top2_plain(
    a_u8: torch.Tensor,
    b_u8: torch.Tensor,
    row_attr: torch.Tensor,
    col_attr_t: torch.Tensor,
    use_ur: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's semantics in plain PyTorch (the XLA branch of
    ``matching._top2_masked``): the CPU path, and the reference that
    the kernel must equal on the card."""
    n, m = a_u8.shape[0], b_u8.shape[0]
    dev = a_u8.device
    out = [], [], [], []
    cols = torch.arange(m, device=dev)[None, :]
    for s in range(0, n, _ROW_CHUNK):
        ok = pair_mask(row_attr[s:s + _ROW_CHUNK], col_attr_t, use_ur)
        ham = hamming_u8(a_u8[s:s + _ROW_CHUNK], b_u8).float()
        dist = torch.where(ok, ham, torch.full_like(ham, float("inf")))
        best_j = torch.argmin(dist, dim=1)
        best_d = torch.gather(dist, 1, best_j[:, None])[:, 0]
        d2 = torch.where(cols == best_j[:, None],
                         torch.full_like(dist, float("inf")), dist)
        second_j = torch.argmin(d2, dim=1)
        second_d = torch.gather(d2, 1, second_j[:, None])[:, 0]
        for acc, t in zip(out, (best_d, second_d, best_j, second_j)):
            acc.append(t)
    if n == 0:
        e = torch.empty(0, device=dev)
        return e, e.clone(), e.int(), e.int()
    best_d, second_d, best_j, second_j = (torch.cat(t) for t in out)
    return best_d, second_d, best_j.to(torch.int32), second_j.to(torch.int32)


def masked_hamming_top2_cuda(
    a_u8: torch.Tensor,
    b_u8: torch.Tensor,
    row_attr: torch.Tensor,
    col_attr_t: torch.Tensor,
    use_ur: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on the current stream."""
    global LAUNCHES
    dev = a_u8.device
    n, m = a_u8.shape[0], b_u8.shape[0]
    for name, t, dtype, shape in (
        ("a_u8", a_u8, torch.uint8, (n, 32)),
        ("b_u8", b_u8, torch.uint8, (m, 32)),
        ("row_attr", row_attr, torch.float32, (n, 8)),
        ("col_attr_t", col_attr_t, torch.float32, (8, m)),
    ):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: need {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("a_u8", a_u8), ("b_u8", b_u8), ("row_attr", row_attr)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if m >= MAX_COLUMNS:
        raise ValueError(f"{m} columns; the kernel takes fewer than "
                         f"{MAX_COLUMNS}")
    best_d = torch.empty(n, dtype=torch.float32, device=dev)
    second_d = torch.empty(n, dtype=torch.float32, device=dev)
    best_j = torch.empty(n, dtype=torch.int32, device=dev)
    second_j = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best_d, second_d, best_j, second_j
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.library().sivo_hamming_top2(
        a_u8.data_ptr(), b_u8.data_ptr(), row_attr.data_ptr(),
        col_attr_t.data_ptr(), best_d.data_ptr(), second_d.data_ptr(),
        best_j.data_ptr(), second_j.data_ptr(), n, m, int(bool(use_ur)),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"hamming_top2 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return best_d, second_d, best_j, second_j
