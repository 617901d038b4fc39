"""The sharded BA against the dense global BA on the loop world's global
BA problem: how many LM iterations the sharded solver needs there, and
what the JAX package's own sharded solver does on the same problem.

Two modes, run from the repository root:

``python3 tools/gba190_sharded_study.py card OUT.pt`` (on the card,
~7.5 minutes: the 190-frame render, then ``chip_smoke.py``'s phase 7 loop
session) saves the dense GBA problem the loop closure solves to
``OUT.pt``, then prints, after 10, 20 and 40 iterations each, every
valid keyframe's largest |log(T_dense^-1 T_sharded)| component between
the port's ``sharded_bundle_adjustment`` (world size 1, NCCL) and its
dense ``global_bundle_adjustment``, and both χ².

``JAX_PLATFORMS=cpu python tools/gba190_sharded_study.py cpu OUT.pt``
(the CPU, ~1 minute) reads that file and prints, against the port's
dense solve at 60 iterations (converged), the distance of the initial
poses, of the JAX package's ``sharded_bundle_adjustment`` (one-device
mesh) and of the port's (world size 1, gloo) after 1-20 iterations,
with their χ²; then whether the JAX solver's first iteration meets a
non-finite value, and the point blocks whose damped inverse
``jnp.linalg.inv`` returns non-finite where ``torch.linalg.inv_ex``
does not.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sivo_tpu_torch.geometry import se3  # noqa: E402
from sivo_tpu_torch.geometry.projection import CameraParams  # noqa: E402
from sivo_tpu_torch.optim import local_ba  # noqa: E402
from sivo_tpu_torch.parallel import sharded_ba  # noqa: E402


def pose_gap(a, b, valid) -> torch.Tensor:
    """Each valid keyframe's largest |log(a_k^-1 b_k)| component."""
    a = torch.as_tensor(np.asarray(a))[valid].double()
    b = torch.as_tensor(np.asarray(b))[valid].double()
    return se3.log(torch.linalg.inv(a) @ b).abs().amax(dim=-1)


def card(out: str) -> None:
    import chip_smoke as cs
    from sivo_tpu_torch.config import SystemConfig
    from sivo_tpu_torch.place import vocabulary as voc_mod

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_card()
    cs.phase_build()
    cfg = SystemConfig()
    _, left, right, sems, _ = cs.make_scene(cfg, cs.N_LOOP_FRAMES)
    prob, cam = cs.run_loop_session(cfg, left, right, sems, dev,
                                    voc_mod.load_npz(cs.VOCABULARY))[-1]
    torch.save({"prob": tuple(t.cpu() for t in prob), "cam": tuple(cam)},
               out)
    with tempfile.TemporaryDirectory() as work:
        torch.distributed.init_process_group(
            "nccl", init_method="file://" + os.path.join(work, "rdv"),
            world_size=1, rank=0, device_id=dev)
        try:
            part = sharded_ba.partition_problem(prob, 1)
            for it in (10, 20, 40):
                sh = sharded_ba.sharded_bundle_adjustment(part, cam,
                                                          iterations=it)
                de = local_ba.global_bundle_adjustment(prob, cam,
                                                       iterations=it)
                gap = pose_gap(de.kf_pose.cpu(), sh.kf_pose.cpu(),
                               prob.kf_valid.cpu())
                print(f"{it} iterations: largest pose log component "
                      f"{float(gap.max()):.3g} (keyframe "
                      f"{int(gap.argmax())}); chi2 sharded "
                      f"{float(sh.chi2):.6g}, dense {float(de.chi2):.6g}")
        finally:
            torch.distributed.destroy_process_group()


def cpu(path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from sivo_tpu.geometry.projection import CameraParams as JCam
    from sivo_tpu.optim import local_ba as j_ba
    from sivo_tpu.parallel import sharded_ba as j_sh

    saved = torch.load(path)
    prob = local_ba.BAProblem(*saved["prob"])
    cam = CameraParams(*saved["cam"])
    jprob = j_ba.BAProblem(*(jnp.asarray(t.numpy()) for t in saved["prob"]))
    jcam = JCam(*saved["cam"])
    valid = prob.kf_valid
    print(f"valid keyframes {int(valid.sum())}, points "
          f"{int(prob.pt_valid.sum())}, observations "
          f"{int(prob.obs_valid.sum())}")
    ref = local_ba.global_bundle_adjustment(prob, cam, iterations=60)
    print(f"initial poses: {float(pose_gap(prob.kf_pose, ref.kf_pose, valid).max()):.3g}"
          " from the dense solve at 60 iterations")
    mesh = Mesh(np.array(jax.devices()[:1]), ("ba",))
    jpart = j_sh.partition_problem(jprob, 1)
    tpart = sharded_ba.partition_problem(prob, 1)
    with tempfile.TemporaryDirectory() as work:
        torch.distributed.init_process_group(
            "gloo", init_method="file://" + os.path.join(work, "rdv"),
            world_size=1, rank=0)
        try:
            for it in (1, 2, 5, 10, 20):
                js = j_sh.sharded_bundle_adjustment(jpart, jcam, mesh,
                                                    iterations=it)
                ts = sharded_ba.sharded_bundle_adjustment(tpart, cam,
                                                          iterations=it)
                print(f"{it} iterations: JAX sharded "
                      f"{float(pose_gap(js.kf_pose, ref.kf_pose, valid).max()):.3g}"
                      f" (chi2 {float(js.chi2):.6g}), port sharded "
                      f"{float(pose_gap(ts.kf_pose, ref.kf_pose, valid).max()):.3g}"
                      f" (chi2 {float(ts.chi2):.6g})")
        finally:
            torch.distributed.destroy_process_group()

    # the JAX solver's first iteration, piece by piece
    p = jpart
    K, P = p.kf_pose.shape[0], p.pt_pos.shape[0]
    hi = jax.lax.Precision.HIGHEST
    r, _, Jp, _ = j_ba._residuals(p.kf_pose, p.pt_pos, p, jcam)
    row_mask = jnp.concatenate(
        [jnp.ones((r.shape[0], 2), r.dtype),
         p.obs_is_stereo[:, None].astype(r.dtype)], axis=-1)
    w = (p.obs_valid.astype(r.dtype) / p.obs_sigma2)[:, None] * row_mask
    Hpp = jnp.zeros((P, 3, 3)).at[p.obs_pt].add(
        jnp.einsum("oij,oik->ojk", Jp * w[..., None], Jp, precision=hi))
    has_pt = (jnp.zeros(P).at[p.obs_pt].add(
        p.obs_valid.astype(jnp.float32)) > 0) & p.pt_valid
    Hpp_d = jnp.where(has_pt[:, None, None],
                      Hpp + (1e-4 + 1e-9) * jnp.eye(3)[None],
                      jnp.eye(3)[None])
    j_inv = np.asarray(jnp.linalg.inv(Hpp_d))
    bad = np.where(~np.isfinite(j_inv).all(axis=(1, 2)))[0]
    t_inv = torch.linalg.inv_ex(torch.from_numpy(np.asarray(Hpp_d)[bad]))
    print(f"point blocks whose jnp.linalg.inv is non-finite at lambda 1e-4: "
          f"{bad.tolist()}; torch.linalg.inv_ex on them finite: "
          f"{bool(torch.isfinite(t_inv.inverse).all())} (info "
          f"{t_inv.info.tolist()})")
    for k, blk in zip(bad, np.asarray(Hpp_d)[bad]):
        print(f"  point {k}: eigenvalues {np.linalg.eigvalsh(blk.astype(np.float64))}")


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("card", "cpu"):
        sys.exit("usage: gba190_sharded_study.py card|cpu OUT.pt")
    (card if sys.argv[1] == "card" else cpu)(sys.argv[2])
