"""Sim(3) utilities and the Horn closed-form similarity solver (port of
``sivo_tpu/geometry/sim3.py``; ref: Sim3Solver.cc:224-330).

Representation: (s, R, t) with action x -> s R x + t, batched over
leading dimensions, float32. Stereo SLAM fixes s = 1 in the solver
(ref: Sim3Solver fixed-scale flag); the full similarity path is kept.

``jacobians_at_zero`` gives the optimizers (``optim/sim3_opt``,
``optim/pose_graph``) the Jacobians that the JAX package takes with
``jax.jacfwd``: forward-mode AD (``torch.autograd.forward_ad``) in one
evaluation, with the perturbation directions as a leading batch axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from sivo_tpu_torch.geometry import se3


class Sim3(NamedTuple):
    s: torch.Tensor  # (...,)
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def identity(device: torch.device | None = None) -> Sim3:
    return Sim3(s=torch.ones((), device=device),
                R=torch.eye(3, device=device),
                t=torch.zeros(3, device=device))


def from_se3(T: torch.Tensor) -> Sim3:
    return Sim3(s=torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device),
                R=T[..., :3, :3], t=T[..., :3, 3])


def to_se3(g: Sim3) -> torch.Tensor:
    """Project to SE3: [sR -> R, t -> t/s] (ref: LoopClosing.cc
    CorrectLoop)."""
    return se3.make_pose(g.R, g.t / g.s[..., None])


def apply(g: Sim3, x: torch.Tensor) -> torch.Tensor:
    return g.s[..., None] * (g.R @ x[..., None])[..., 0] + g.t


def compose(a: Sim3, b: Sim3) -> Sim3:
    """a after b: x -> a(b(x))."""
    return Sim3(s=a.s * b.s, R=a.R @ b.R,
                t=a.s[..., None] * (a.R @ b.t[..., None])[..., 0] + a.t)


def inverse(g: Sim3) -> Sim3:
    Rt = g.R.transpose(-1, -2)
    inv_s = 1.0 / g.s
    return Sim3(s=inv_s, R=Rt,
                t=-(inv_s[..., None]) * (Rt @ g.t[..., None])[..., 0])


def horn_alignment(p1: torch.Tensor, p2: torch.Tensor,
                   fix_scale: bool = True) -> Sim3:
    """Closed-form similarity p2 -> p1 (ref: Sim3Solver.cc:224-330, Horn
    1987): g with p1 ~= g(p2), batched over leading dims; (..., M, 3)
    inputs. Rotation by the SVD form of absolute orientation; scale is
    Horn's symmetric ratio unless fixed."""
    c1 = p1.mean(dim=-2, keepdim=True)
    c2 = p2.mean(dim=-2, keepdim=True)
    q1, q2 = p1 - c1, p2 - c2
    H = q2.transpose(-1, -2) @ q1  # (..., 3, 3)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.zeros_like(H)
    D[..., 0, 0].fill_(1.0)  # fill_: a scalar setitem would sync
    D[..., 1, 1].fill_(1.0)
    D[..., 2, 2] = det
    R = V @ (D @ Ut)  # p2 -> p1
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    else:
        s = torch.sqrt(torch.sum(q1 * q1, dim=(-1, -2))
                       / torch.clamp(torch.sum(q2 * q2, dim=(-1, -2)),
                                     min=1e-12))
    t = c1[..., 0, :] - s[..., None] * (R @ c2[..., 0, :, None])[..., 0]
    return Sim3(s=s, R=R, t=t)


def log(g: Sim3) -> torch.Tensor:
    """(..., 7) [rho, phi, log s]; the translation part is the SE3 log of
    (R, t), a first-order Sim3 left Jacobian that pairs with ``exp``."""
    phi = se3.so3_log(g.R)
    rho = se3.log(se3.make_pose(g.R, g.t))[..., :3]
    return torch.cat([rho, phi, torch.log(g.s)[..., None]], dim=-1)


def exp(xi: torch.Tensor) -> Sim3:
    """Inverse of ``log``."""
    T = se3.exp(xi[..., :6])
    return Sim3(s=torch.exp(xi[..., 6]), R=T[..., :3, :3], t=T[..., :3, 3])


def jacobians_at_zero(fn: Callable[..., torch.Tensor], n_args: int,
                      batch_shape: tuple, dim: int, like: torch.Tensor
                      ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Value and Jacobians of ``fn(xi_1, ..., xi_n)`` at every xi = 0,
    each xi of shape ``batch_shape + (dim,)``: one forward-mode
    evaluation whose leading axis holds the ``n_args * dim`` unit
    directions. Returns (value (*batch, out), [(*batch, out, dim)] per
    argument)."""
    n_dir = n_args * dim
    eye = torch.eye(n_dir, dtype=like.dtype, device=like.device)
    shape = (n_dir, *batch_shape, dim)
    with fwAD.dual_level():
        args = []
        for a in range(n_args):
            tangent = eye[:, a * dim:(a + 1) * dim].reshape(
                n_dir, *(1,) * len(batch_shape), dim).expand(shape)
            args.append(fwAD.make_dual(
                torch.zeros(shape, dtype=like.dtype, device=like.device),
                tangent.contiguous()))
        primal, tangent = fwAD.unpack_dual(fn(*args))
    jac = tangent.movedim(0, -1)  # (*batch, out, n_dir)
    return primal[0], [jac[..., a * dim:(a + 1) * dim]
                       for a in range(n_args)]
