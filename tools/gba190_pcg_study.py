"""The PCG global BA (``optim/gba_cg``) against the dense global BA on the
loop world's global BA problem: how far the paced PCG solve lies from
the dense one after 10-60 LM steps, and whether the gap is a step count
or float32's floor.

Two modes, run from the repository root:

``python3 tools/gba190_pcg_study.py card OUT_DIR [RUNS]`` (on the card,
~2.5 minutes of render, then ~75 s for each of ``RUNS`` (default 3) runs
of ``chip_smoke.py``'s phase 7 loop session; the card's atomics make
each run's map, and so its problem, differ) saves each run's dense GBA
problem to ``OUT_DIR/prob<i>.pt`` and prints the table below for it on
the card.

``python3 tools/gba190_pcg_study.py lap OUT_DIR RENDERS`` (the CPU,
~25 minutes) runs the port's session of ``chip_smoke.py``'s phase 11 on
the dumbbell lap's renders (``RENDERS``: the ``dumbbell404.npz`` that
``tools/dumbbell_jax_reference.py`` writes; frame i shows render
i % 404) until the loop closer begins its first PCG global BA, and saves
that problem to ``OUT_DIR/prob_lap.pt``.

``python3 tools/gba190_pcg_study.py cpu OUT_DIR`` (the CPU, a few
minutes a problem) prints the same table for every ``prob*.pt`` in
``OUT_DIR``, then the noise of ``chip_smoke.py``'s PCG solve: the float32
solve's distances to its float64 solve and to itself on 16 orders of
the observations (``chip_smoke.pcg_orders``), and how often the float32
gate would fail with each order after the first S in turn taken as the
card's solve, its noise bound made from float64 and orders 0 to S - 1,
for S of 1, 4 and ``PCG_SHUFFLES`` (8); then the float64 solve's
distances to itself on the same 16 orders. ``tools/pcg_repeat.py``
holds the card's own solves to the same bounds.

The table: every valid keyframe's largest |log(T_a^-1 T_b)| component,
its largest over the keyframes (and which keyframe, with its
observations), between the dense ``global_bundle_adjustment`` after 10
iterations (the loop closer's), after 60, and after 60 in float64, and
between each PCG variant after 10, 20, 30, 40 and 60 steps and each of
those three, with the χ², and float64 PCG run to convergence by
``chip_smoke.py``'s rule against the float64 dense. The variants:
``gba_cg`` as the loop closer runs it (float32, 48 CG iterations per
step); the same with 96 CG iterations; the same with the step's accept
test on a float64 χ²; the whole solve in float64.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from sivo_tpu_torch.optim import gba_cg, local_ba  # noqa: E402

# past ~70 rejected steps float32's lambda overflows (x4 per rejection)
STEPS = (10, 20, 30, 40, 60)


def _step_f64_accept(carry, prob, prob64, cam, cg_iters=48):
    """``gba_cg_step`` with the accept test on a float64 χ²."""
    kp, pp, lam, best = carry
    kp_new, pp_new = gba_cg._solve_step(kp, pp, lam, prob, cam, cg_iters)
    new_chi2 = gba_cg._chi2_total(kp_new.double(), pp_new.double(), prob64,
                                  cam)
    improved = new_chi2 < best
    return (torch.where(improved, kp_new, kp),
            torch.where(improved, pp_new, pp),
            torch.where(improved, lam * 0.5, lam * 4.0),
            torch.minimum(new_chi2, best))


def analyse(name: str, prob, cam) -> None:
    valid = prob.kf_valid
    n_obs = torch.zeros(prob.kf_pose.shape[0], dtype=torch.long).index_add_(
        0, prob.obs_kf.cpu().long(), prob.obs_valid.cpu().long())
    kf_ids = torch.nonzero(valid.cpu())[:, 0]
    print(f"{name}: valid keyframes {int(valid.sum())}, points "
          f"{int(prob.pt_valid.sum())}, observations "
          f"{int(prob.obs_valid.sum())}, fixed keyframes "
          f"{torch.nonzero((prob.kf_fixed & valid).cpu())[:, 0].tolist()}")

    def where(gap):
        k = int(kf_ids[int(gap.argmax())])
        return f"{float(gap.max()):.3g} (keyframe {k}, {int(n_obs[k])} obs)"

    prob64 = cs._f64(prob)
    refs = {"dense 10": local_ba.global_bundle_adjustment(
                prob, cam, iterations=10),
            "dense 60": local_ba.global_bundle_adjustment(
                prob, cam, iterations=60),
            "dense f64 60": local_ba.global_bundle_adjustment(
                prob64, cam, iterations=60)}
    ref64 = refs["dense f64 60"].kf_pose
    for label in ("dense 10", "dense 60"):
        gap = cs._pose_diffs(ref64, refs[label].kf_pose, valid)
        print(f"  {label} against dense f64 60: {where(gap)}; chi2 "
              f"{float(refs[label].chi2):.8g} against "
              f"{float(refs['dense f64 60'].chi2):.8g}")
    variants = {
        "f32 48 CG": (prob, lambda c: gba_cg.gba_cg_step(c, prob, cam)),
        "f32 96 CG": (prob, lambda c: gba_cg.gba_cg_step(c, prob, cam, 96)),
        "f32, f64 accept": (prob, lambda c: _step_f64_accept(
            c, prob, prob64, cam)),
        "f64": (prob64, lambda c: gba_cg.gba_cg_step(c, prob64, cam)),
    }
    res, steps, moved = cs._pcg_converged(prob64, cam)
    print(f"  f64 to convergence (chip_smoke.py's rule), {steps} steps, "
          f"the last {cs.PCG_BLOCK} moving a pose {moved:.3g}: against "
          f"dense f64 60 "
          f"{where(cs._pose_diffs(ref64, res.kf_pose, valid))}; "
          f"chi2 {float(res.chi2):.10g}", flush=True)
    for label, (p, step) in variants.items():
        c = gba_cg.gba_cg_begin(p, cam)
        if label == "f32, f64 accept":
            c = (*c[:3], gba_cg._chi2_total(prob64.kf_pose, prob64.pt_pos,
                                            prob64, cam))
        done = 0
        for n in STEPS:
            for _ in range(n - done):
                c = step(c)
            done = n
            res = gba_cg.gba_cg_finish(c, p, cam)
            gaps = ", ".join(
                f"{r} {where(cs._pose_diffs(ref.kf_pose, res.kf_pose, valid))}"
                for r, ref in refs.items())
            print(f"  {label}, {n} steps: against {gaps}; chi2 "
                  f"{float(res.chi2):.8g}, lambda {float(c[2]):.3g}",
                  flush=True)


def card(out_dir: str, runs: int) -> None:
    from sivo_tpu_torch.config import SystemConfig
    from sivo_tpu_torch.place import vocabulary as voc_mod

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.makedirs(out_dir, exist_ok=True)
    cs.phase_card()
    cs.phase_build()
    cfg = SystemConfig()
    _, left, right, sems, _ = cs.make_scene(cfg, cs.N_LOOP_FRAMES)
    voc = voc_mod.load_npz(cs.VOCABULARY)
    for i in range(runs):
        prob, cam = cs.run_loop_session(cfg, left, right, sems, dev,
                                        voc)[-1]
        cs.save_pcg_problem(os.path.join(out_dir, f"prob{i}.pt"), prob,
                            cam)
        analyse(f"run {i} (card)", prob, cam)


def lap(out_dir: str, renders: str) -> None:
    from sivo_tpu_torch.config import SystemConfig
    from sivo_tpu_torch.io import synthetic
    from sivo_tpu_torch.place import vocabulary as voc_mod
    from sivo_tpu_torch.runtime import frame as frame_mod
    from sivo_tpu_torch.runtime.system import System

    z = np.load(renders)
    left, right, classes = z["left"], z["right"], z["cls"]
    cfg, dev = SystemConfig(), torch.device("cpu")
    statics = frame_mod.make_statics(cfg)
    system = System(cfg=cfg, device=dev, max_keyframes=448,
                    max_points=49152, pipeline_depth=3)
    system.attach_vocabulary(voc_mod.load_npz(cs.VOCABULARY))
    kept, begin = [], gba_cg.gba_cg_begin

    def keep(prob, cam):
        kept.append((tuple(t.clone() for t in prob), tuple(cam)))
        return begin(prob, cam)

    gba_cg.gba_cg_begin = keep
    i = 0
    while not kept and i < cs.DUMBBELL_FRAMES:
        s = i % len(left)
        sem = synthetic.structured_semantics(classes[s], seed=7)
        system.track_frame(frame_mod.build_frame_nosegnet(
            statics, left[s], right[s], *sem, device=dev), i * 0.1,
            pipeline=True)
        i += 1
    if not kept:
        sys.exit(f"no PCG global BA in {i} frames")
    os.makedirs(out_dir, exist_ok=True)
    prob = local_ba.BAProblem(*kept[0][0])
    cs.save_pcg_problem(os.path.join(out_dir, "prob_lap.pt"), prob,
                        kept[0][1])
    print(f"the first PCG global BA began at frame {i - 1}: "
          f"{int(prob.kf_valid.sum())} keyframes, {int(prob.pt_valid.sum())} "
          f"points, {int(prob.obs_valid.sum())} observations", flush=True)


def float_noise(prob, cam, shuffles: int = 2 * cs.PCG_SHUFFLES) -> None:
    """``chip_smoke.py``'s card-against-CPU distances (``_pcg_distance``)
    between the CPU's float32 solve of ``PCG_ITERATIONS`` steps and its
    float64 solve, and the same solve on ``shuffles`` orders of the
    observations (seeds 0 ..): the spread float32's summation order alone
    gives, which the card's atomics draw from."""

    base = cs._pcg_solve(prob, cam)
    prob64 = cs._f64(prob)
    base64 = cs._pcg_solve(prob64, cam)
    pv = prob.pt_valid
    rows = [("float64", cs._pcg_distance(base64, base, pv))] + [
        (f"shuffle {seed}", cs._pcg_distance(sh, base, pv))
        for seed, sh in enumerate(cs.pcg_orders(prob, cam,
                                                range(shuffles)))]
    for label, d in rows:
        print(f"  {cs.PCG_ITERATIONS} steps, {label} against float32: "
              + ", ".join(f"{k} {v:.3g}" for k, v in d.items()), flush=True)

    d = [r[1] for r in rows]  # float64, then the orders
    for n in sorted({1, 4, cs.PCG_SHUFFLES}):
        fails = {k: cs.pcg_misses(d[1 + k], d[:1 + n])
                 for k in range(n, shuffles)}
        print(f"  taking order k as the card's solve: the bound from "
              f"float64 and orders 0-{n - 1} fails for "
              f"{sum(map(bool, fails.values()))} of {len(fails)} "
              f"({fails})", flush=True)
    for seed, sh in enumerate(cs.pcg_orders(prob64, cam, range(shuffles))):
        d = cs._pcg_distance(sh, base64, pv)
        print(f"  {cs.PCG_ITERATIONS} steps in float64, shuffle {seed} "
              f"against float64: " + ", ".join(f"{k} {v:.3g}"
                                                for k, v in d.items()),
              flush=True)


def cpu(out_dir: str) -> None:
    for path in sorted(glob.glob(os.path.join(out_dir, "prob*.pt"))):
        prob, cam, _ = cs.load_pcg_problem(path)
        analyse(f"{os.path.basename(path)} (CPU)", prob, cam)
        float_noise(prob, cam)


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4) or sys.argv[1] not in ("card", "cpu",
                                                           "lap"):
        sys.exit("usage: gba190_pcg_study.py card OUT_DIR [RUNS] | "
                 "cpu OUT_DIR | lap OUT_DIR RENDERS")
    if sys.argv[1] == "card":
        card(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 3)
    elif sys.argv[1] == "lap":
        lap(sys.argv[2], sys.argv[3])
    else:
        cpu(sys.argv[2])
