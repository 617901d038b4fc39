"""Entry points of the port: one forward of the flagship per-frame model,
and a dry run of the multi-device paths on tiny shapes (the port's
counterpart of the repository root's ``__graft_entry__.py``).

``python -m sivo_tpu_torch.entry`` runs ``entry()``'s forward, then
``dryrun_multichip`` over every card of the machine.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sivo_tpu_torch.geometry import se3
from sivo_tpu_torch.geometry.projection import CameraParams, project_stereo
from sivo_tpu_torch.models import segnet
from sivo_tpu_torch.optim.local_ba import BAProblem
from sivo_tpu_torch.parallel import ranks, sharded_ba
from sivo_tpu_torch.select import info

HEIGHT, WIDTH = 352, 1024
MC_SAMPLES = 3
# the dry run's tiny shapes
DRY_H, DRY_W = 32, 64
DRY_KEYPOINTS = 64  # per rank
DRY_KEYFRAMES, DRY_POINTS = 4, 16  # points per rank
DRY_BA_ITERATIONS = 3
# replicated outputs: equal on every rank up to float32 rounding
REPLICA_RTOL, REPLICA_ATOL = 1e-5, 1e-6


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available (pass device='cpu' "
                           "to run on the CPU)")


def forward(model: segnet.SegNet, image: torch.Tensor,
            generator: torch.Generator):
    """Bayesian SegNet's MC-dropout forward fused with the posterior head
    (classes, confidence, entropy): the per-frame semantic front end of
    the SLAM system."""
    with torch.no_grad():
        return segnet.segment_image(model, image, generator,
                                    mc_samples=MC_SAMPLES)


def entry(device=None):
    """(fn, args): ``forward`` on SegNet basic at 352x1024 (seeded
    weights, float32) with ``MC_SAMPLES`` dropout samples drawn from an
    explicit ``torch.Generator``. The arguments are on the card unless
    ``device`` names another."""
    if device is None:
        _need_card()
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    model = segnet.SegNet(variant="basic")
    model.load_state_dict(segnet.init_params(seed=0))
    model = model.to(dev).eval()
    image = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(1)
    return forward, (model, image, generator)


def dry_ba_problem(n_ranks: int, device: torch.device
                   ) -> tuple[BAProblem, CameraParams]:
    """The dry run's BA problem: 4 keyframes 0.2 m apart along z (the
    first fixed) seeing all ``16 * n_ranks`` points in stereo, the points
    started 0.01 m off."""
    cam = CameraParams(fx=100.0, fy=100.0, cx=32.0, cy=16.0, bf=50.0,
                       width=DRY_W, height=DRY_H)
    K, P = DRY_KEYFRAMES, DRY_POINTS * n_ranks
    rng = np.random.default_rng(0)
    pts_w = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                      rng.uniform(4, 12, P)], axis=-1).astype(np.float32)
    xi = torch.zeros((K, 6))
    xi[:, 2] = -0.2 * torch.arange(K, dtype=torch.float32)
    poses = se3.exp(xi)
    pts = torch.from_numpy(pts_w)
    uvr = torch.cat([project_stereo(cam, pts @ T[:3, :3].T + T[:3, 3])
                     for T in poses])
    O = K * P
    prob = BAProblem(
        kf_pose=poses, kf_fixed=torch.arange(K) == 0,
        kf_valid=torch.ones(K, dtype=torch.bool), pt_pos=pts + 0.01,
        pt_valid=torch.ones(P, dtype=torch.bool),
        obs_kf=torch.arange(K, dtype=torch.int32).repeat_interleave(P),
        obs_pt=torch.arange(P, dtype=torch.int32).repeat(K),
        obs_uvr=uvr, obs_sigma2=torch.ones(O),
        obs_is_stereo=torch.ones(O, dtype=torch.bool),
        obs_valid=torch.ones(O, dtype=torch.bool))
    return BAProblem(*(t.to(device) for t in prob)), cam


def _dryrun_rank(rank: int, device: torch.device, n_ranks: int) -> dict:
    """One rank of the dry run: SegNet with one MC sample per rank
    combined over the group, the entropy-reduction scores of this rank's
    keypoints gathered, and the point-sharded BA."""
    group = dist.group.WORLD
    model = segnet.SegNet(variant="basic")
    model.load_state_dict(segnet.init_params(seed=0))
    model = model.to(device).eval()
    image = torch.zeros((DRY_H, DRY_W, 3), device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(1 + rank)  # this rank's dropout sample
    with torch.no_grad():
        classes, confidence, entropy = segnet.segment_image(
            model, image, generator, mc_samples=1, group=group)

    points = (torch.ones((DRY_KEYPOINTS, 3), device=device)
              * torch.tensor([1.0, 0.5, 10.0], device=device))
    scores = info.entropy_reduction_stereo(
        torch.eye(6, device=device) * 1e-4, points,
        torch.ones(DRY_KEYPOINTS, device=device),
        torch.zeros(DRY_KEYPOINTS, device=device), 100.0, 100.0, 0.5)
    parts = [torch.empty_like(scores) for _ in range(n_ranks)]
    dist.all_gather(parts, scores, group=group)

    prob, cam = dry_ba_problem(n_ranks, device)
    res = sharded_ba.sharded_bundle_adjustment(
        sharded_ba.partition_problem(prob, n_ranks), cam, group=group,
        iterations=DRY_BA_ITERATIONS)
    out = {"classes": classes, "confidence": confidence, "entropy": entropy,
           "scores": torch.cat(parts), **{f"ba_{k}": v for k, v in
                                          res._asdict().items()}}
    return {k: v.cpu() for k, v in out.items()}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of the per-frame pipeline's multi-device paths on tiny
    shapes over ``n_devices`` spawned ranks: SegNet at 32x64 with its MC
    samples split over the ranks (one each), the entropy-reduction
    scores of 64 keypoints per rank gathered to ``(64 * n,)``, and the
    point-sharded BA (4 keyframes, ``16 * n`` points, 3 iterations).

    On the card (``device`` None or a CUDA device) rank ``r`` runs on
    ``cuda:r`` over NCCL, and asking for more ranks than cards raises;
    ``device="cpu"`` runs gloo ranks on the CPU. Checks shapes, finite
    values and that every rank returns the same replicated outputs
    (floats within ``REPLICA_RTOL``/``REPLICA_ATOL``); returns rank 0's
    outputs."""
    if device is None or torch.device(device).type == "cuda":
        _need_card()
        if n_devices > torch.cuda.device_count():
            raise RuntimeError(f"{n_devices} ranks asked for, "
                               f"{torch.cuda.device_count()} cards")
        backend = "nccl"
        devices = [f"cuda:{r}" for r in range(n_devices)]
    elif torch.device(device).type == "cpu":
        backend, devices = "gloo", ["cpu"] * n_devices
    else:
        raise ValueError(f"device {device!r}: the card or 'cpu'")
    outs = ranks.spawn(_dryrun_rank, n_devices, (n_devices,),
                       backend=backend, devices=devices)
    first = outs[0]
    shapes = {"classes": (DRY_H, DRY_W), "scores": (DRY_KEYPOINTS
                                                    * n_devices,),
              "ba_kf_pose": (DRY_KEYFRAMES, 4, 4),
              "ba_pt_pos": (DRY_POINTS * n_devices, 3)}
    for name, shape in shapes.items():
        if tuple(first[name].shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(first[name].shape)}"
                                 f", expected {shape}")
    for name, value in first.items():
        floating = value.is_floating_point()
        if floating and not torch.isfinite(value).all():
            raise AssertionError(f"{name}: not finite")
        for r, other in enumerate(outs[1:], 1):
            # the ranks' CPU kernels may round differently (vectorized
            # loops follow each buffer's alignment)
            same = (torch.allclose(value, other[name], rtol=REPLICA_RTOL,
                                   atol=REPLICA_ATOL) if floating
                    else torch.equal(value, other[name]))
            if not same:
                raise AssertionError(f"{name}: rank {r} differs from rank 0")
    return first


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK:", [tuple(x.shape) for x in out])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK")
