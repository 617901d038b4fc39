"""``chip_smoke.py``'s float32 PCG gate, card against CPU
(``phase_pcg``), repeated on saved problems: how often it misses with
the CPU's noise measured on 4, 8, ... orders of the observations, and
which point block is behind a miss.

Each problem is a file that ``chip_smoke.save_pcg_problem`` wrote
(``tools/endurance_repeat.py`` keeps phase 11's first PCG problem of
each run, ``tools/endurance_repeat.py --phase loop`` and
``tools/gba190_pcg_study.py card`` phase 7's dense GBA problems,
``phase_pcg`` a problem whose gate failed, in
``chiprun_out/pcg_misses/``). For each:

- the CPU's float32 solve (``PCG_ITERATIONS`` LM steps) and its float64
  solve, and the float32 solve on the largest of ``--shuffles`` orders of
  the observations, each order in a spawned process of one thread
  (``chip_smoke.pcg_orders``), as ``phase_pcg`` has them;
- the card's float32 solve ``--repeats`` times (each repeat sums the
  card's atomics in another order), each held to the CPU's solve with
  exactly ``phase_pcg``'s bound (``chip_smoke.pcg_misses``) made from
  float64 and the first S orders, for each S of ``--shuffles``. The
  misses, the bounds, each repeat's distances and its LM accept
  sequence beside the CPU's.

With ``--trace``, the worst repeat's worst point (the largest point
distance to the CPU's solve, the repeat with the largest distance over
its ``PCG_TOLS``): its valid and stereo observations, the spread of the
camera centres that observe it, its depths; then at each LM step along
the CPU's path (the same inputs on both devices) its damped block
``Hpp_d`` as the card and the CPU build it (``point_blocks``: the lines
of ``gba_cg._solve_step`` that build and invert them), the block's
condition number (float64), and its inverse by the card's ``inv_ex``,
by the CPU's LAPACK and in float64, with the card's inverse of the
CPU's block and the CPU's inverse of the card's block: the first two
split the inverse's cost from the summation order's. Over every valid
block at each step: the largest difference between the card's and the
CPU's inverse of the same (the CPU's) block, in units of cond x
float32's epsilon (above 1: the inverse route is at fault), LAPACK's
against float64 in the same units, and the largest relative difference
between the two devices' blocks, alone and times cond.

A summary goes to ``--out`` (default ``chiprun_out/pcg_repeat.json``).

Run from the repository root on a machine with an NVIDIA card (13
problems of phases 7 and 11 with 20 repeats and 16 orders took 944 s
there while the tool also solved every order in turn in its own
process; not timed without that): ``python3 tools/pcg_repeat.py
[--repeats 20] [--shuffles 4,8] [--trace] [--device cuda] PROBLEM.pt
[...]``; ``--device cpu`` runs the "card" solves on the CPU too (a dry
run).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sivo_tpu_torch.optim import gba_cg, local_ba  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
KEYS = (*cs.PCG_TOLS, "inlier_differ")


def point_blocks(kp, pp, lam, prob, cam) -> tuple:
    """The damped point blocks ``Hpp_d`` of ``gba_cg._solve_step`` at
    (kp, pp, lam), built by its own lines on the inputs' device, their
    inverses by its ``inv_ex``, and which points have a block (the rest
    get the identity): (Hpp_d, Hpp_inv, has_pt)."""
    P = prob.pt_pos.shape[0]
    dev, dt = kp.device, kp.dtype
    opt = prob.obs_pt.long()
    eye3 = torch.eye(3, dtype=dt, device=dev)
    r, _, Jp, _ = local_ba._residuals(kp, pp, prob, cam)
    row_mask = torch.cat([torch.ones((r.shape[0], 2), dtype=dt, device=dev),
                          prob.obs_is_stereo[:, None].to(dt)], dim=-1)
    w = (prob.obs_valid.to(dt) / prob.obs_sigma2)[:, None] * row_mask
    Jp_wT = (Jp * w[..., None]).transpose(-1, -2)
    Hpp = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
        0, opt, Jp_wT @ Jp)
    has_pt = (torch.zeros(P, dtype=dt, device=dev).index_add_(
        0, opt, prob.obs_valid.to(dt)) > 0) & prob.pt_valid
    Hpp_d = torch.where(has_pt[:, None, None], Hpp + (lam + 1e-9) * eye3,
                        eye3)
    return Hpp_d, torch.linalg.inv_ex(Hpp_d)[0], has_pt


def solve_steps(prob, cam):
    """``chip_smoke._pcg_solve`` with the carry before each step and
    after the last kept: (result, carries)."""
    c = gba_cg.gba_cg_begin(prob, cam)
    carries = [c]
    for _ in range(cs.PCG_ITERATIONS):
        c = gba_cg.gba_cg_step(c, prob, cam)
        carries.append(c)
    return gba_cg.gba_cg_finish(c, prob, cam), carries


def accepts(carries) -> list:
    """Each LM step's (accepted, chi2 after, lambda after)."""
    out = []
    for a, b in zip(carries, carries[1:]):
        out.append((bool(float(b[2]) < float(a[2])), float(b[3]),
                    float(b[2])))
    return out


def repeat(label, prob, cam, dev, repeats, counts):
    """The card's solve ``repeats`` times against the CPU's: the CPU's
    floors, and each repeat's misses for each count of orders."""
    pv = prob.pt_valid
    cpu, cpu_carries = solve_steps(prob, cam)
    f64 = cs._pcg_solve(cs._f64(prob), cam)
    t0 = time.perf_counter()
    floors = [cs._pcg_distance(cpu, f64, pv)] + [
        cs._pcg_distance(sh, cpu, pv)
        for sh in cs.pcg_orders(prob, cam, range(max(counts)))]
    orders_s = time.perf_counter() - t0
    card_prob = local_ba_to(prob, dev)
    runs = []
    t0 = time.perf_counter()
    for _ in range(repeats):
        card, carries = solve_steps(card_prob, cam)
        d = cs._pcg_distance(card, cpu, pv)
        runs.append({"dist": d, "accepts": accepts(carries),
                     "misses": {n: cs.pcg_misses(d, floors[:1 + n])
                                for n in counts},
                     "card": card})
    card_s = time.perf_counter() - t0
    cpu_acc = [int(a) for a, _, _ in accepts(cpu_carries)]
    print(f"[pcg-repeat] {label}: CPU float32 accepts {cpu_acc}, chi2 "
          f"{float(cpu.chi2):.8g}; {max(counts)} orders {orders_s:.1f} s; "
          f"{repeats} card solves {card_s:.1f} s", flush=True)
    for i, f in enumerate(floors):
        what = "float64" if i == 0 else f"order {i - 1}"
        print(f"[pcg-repeat] {label}: CPU float32 against {what}: "
              + ", ".join(f"{k} {f[k]:.3g}" for k in KEYS))
    for n in counts:
        _, tol = cs.pcg_bound(floors[:1 + n])
        missed = [i for i, r in enumerate(runs) if r["misses"][n]]
        print(f"[pcg-repeat] {label}: bound from float64 and {n} orders "
              + ", ".join(f"{k} {tol[k]:.3g}" for k in cs.PCG_TOLS)
              + f"; misses {len(missed)} of {repeats} (repeats {missed}: "
              + ", ".join(str(runs[i]["misses"][n]) for i in missed) + ")",
              flush=True)
    for i, r in enumerate(runs):
        acc = [int(a) for a, _, _ in r["accepts"]]
        r["accepts_as_cpu"] = acc == cpu_acc
        print(f"[pcg-repeat] {label}: repeat {i}: "
              + ", ".join(f"{k} {r['dist'][k]:.3g}" for k in KEYS)
              + "; accepts " + ("as the CPU's" if acc == cpu_acc
                                else str(acc)))
    return cpu_carries, floors, runs


def local_ba_to(prob, dev):
    return type(prob)(*(t.to(dev) for t in prob))


def block_text(b: torch.Tensor) -> str:
    return np.array2string(b.double().cpu().numpy(), precision=9,
                           separator=",", max_line_width=200).replace(
                               "\n", "")


def trace(label, prob, cam, dev, cpu_carries, runs) -> dict:
    """The worst repeat's worst point, and every block's inverse on both
    devices along the CPU's path."""
    pv = prob.pt_valid
    ratio = [max(r["dist"][k] / max(v, 1e-30) for k, v in
                 cs.PCG_TOLS.items()) for r in runs]
    worst = int(np.argmax(ratio))
    card = runs[worst]["card"]
    cpu_pt = cpu_carries[-1][1].cpu().double()
    dp = (card.pt_pos.cpu().double() - cpu_pt).abs().amax(-1)
    dp[~pv] = -1
    p = int(dp.argmax())
    obs = prob.obs_valid & (prob.obs_pt.long() == p)
    kfs = prob.obs_kf.long()[obs]
    poses = prob.kf_pose[kfs].double()
    centres = -(poses[:, :3, :3].transpose(-1, -2)
                @ poses[:, :3, 3:])[..., 0]
    spread = float(torch.cdist(centres, centres).max()) if len(kfs) else 0.0
    X = cpu_pt[p]
    depth = [float((pz[:3, :3] @ X + pz[:3, 3])[2]) for pz in poses]
    out = {"repeat": worst, "point": p, "point_m": float(dp[p]),
           "observations": int(obs.sum()),
           "stereo": int((obs & prob.obs_is_stereo).sum()),
           "keyframes": kfs.tolist(), "centre_spread_m": spread,
           "depth_m": [round(z, 3) for z in depth], "steps": []}
    print(f"[pcg-trace] {label}: repeat {worst} (the largest distance over "
          f"its bound, {ratio[worst]:.3g}x), its worst point {p}: "
          f"{float(dp[p]):.4g} m from the CPU's; {out['observations']} "
          f"valid observations ({out['stereo']} stereo) from keyframes "
          f"{out['keyframes']}, camera centres {spread:.4g} m apart at "
          f"most, depth {out['depth_m']} m", flush=True)
    card_prob = local_ba_to(prob, dev)
    for s, c in enumerate(cpu_carries[:-1]):
        kp, pp, lam, _ = c
        B_cpu, inv_cpu, valid = point_blocks(kp, pp, lam, prob, cam)
        B_card, inv_card, _ = point_blocks(kp.to(dev), pp.to(dev),
                                           lam.to(dev), card_prob, cam)
        B_card, inv_card = B_card.cpu(), inv_card.cpu().double()
        cond = torch.linalg.cond(B_cpu.double())
        inv64 = torch.linalg.inv(B_cpu.double())
        inv_cpu = inv_cpu.double()  # LAPACK on the CPU's block
        # the card's inverse of the CPU's block
        inv_card_of_cpu = torch.linalg.inv_ex(B_cpu.to(dev))[0].cpu().double()
        inv_cpu_of_card = torch.linalg.inv_ex(B_card)[0].double()
        norm64 = torch.linalg.matrix_norm(inv64)

        def rel(a, b):
            return torch.linalg.matrix_norm(a - b) / norm64

        route = rel(inv_card_of_cpu, inv_cpu) / (cond * EPS32)
        route_ = torch.where(valid, route, torch.zeros_like(route))
        lapack = rel(inv_cpu, inv64) / (cond * EPS32)
        lapack_ = torch.where(valid, lapack, torch.zeros_like(lapack))
        bdiff = (torch.linalg.matrix_norm((B_card - B_cpu).double())
                 / torch.linalg.matrix_norm(B_cpu.double()))
        bdiff_ = torch.where(valid, bdiff, torch.zeros_like(bdiff))
        amp = bdiff * cond
        amp_ = torch.where(valid, amp, torch.zeros_like(amp))
        step = {"step": s, "cond": float(cond[p]),
                "block_rel_diff": float(bdiff[p]),
                "inverse_route_over_cond_eps": float(route[p]),
                "all_route_max": float(route_.max()),
                "all_route_argmax": int(route_.argmax()),
                "all_lapack_vs_f64_max": float(lapack_.max()),
                "all_block_rel_diff_max": float(bdiff_.max()),
                "all_block_diff_times_cond_max": float(amp_.max()),
                "all_block_diff_times_cond_argmax": int(amp_.argmax()),
                "cond_max": float(torch.where(valid, cond,
                                              torch.zeros_like(cond)).max()),
                "inv_card_vs_cpu_rel": float(rel(inv_card, inv_cpu)[p])}
        out["steps"].append(step)
        print(f"[pcg-trace] {label}: step {s} (lambda {float(lam):.4g}): "
              f"point {p}: cond {step['cond']:.4g}, blocks card/CPU "
              f"differ {step['block_rel_diff']:.3g} (relative), the card's "
              f"inverse of the CPU's block against LAPACK's "
              f"{step['inverse_route_over_cond_eps']:.3g} cond*eps; every "
              f"valid block: route at most {step['all_route_max']:.3g} "
              f"cond*eps (point {step['all_route_argmax']}), LAPACK against "
              f"float64 at most {step['all_lapack_vs_f64_max']:.3g} "
              f"cond*eps, blocks differ at most "
              f"{step['all_block_rel_diff_max']:.3g}, that times cond at "
              f"most {step['all_block_diff_times_cond_max']:.3g} (point "
              f"{step['all_block_diff_times_cond_argmax']}), cond at most "
              f"{step['cond_max']:.4g}", flush=True)
        if s in (0, len(cpu_carries) - 2) or step["block_rel_diff"] * step[
                "cond"] > 1e-3:
            for name, m in (("Hpp_d card", B_card[p]), ("Hpp_d CPU", B_cpu[p]),
                            ("inv card (card's block)", inv_card[p]),
                            ("inv LAPACK (CPU's block)", inv_cpu[p]),
                            ("inv float64 (CPU's block)", inv64[p]),
                            ("inv card of the CPU's block",
                             inv_card_of_cpu[p]),
                            ("inv LAPACK of the card's block",
                             inv_cpu_of_card[p])):
                print(f"[pcg-trace] {label}: step {s}: {name} "
                      f"{block_text(m)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("problems", nargs="+")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--shuffles", default="4,8")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "pcg_repeat.json"))
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        if not torch.cuda.is_available():
            print("pcg_repeat: no CUDA device", file=sys.stderr)
            return 2
        torch.cuda.set_device(dev)
        card = cs.phase_card()
    else:
        card = "cpu"
    counts = sorted({int(x) for x in a.shuffles.split(",")})
    summary = {"card": card, "repeats": a.repeats, "shuffles": counts,
               "problems": {}}
    for path in a.problems:
        prob, cam, saved = cs.load_pcg_problem(path)
        name = Path(path).parent.name + "/" + Path(path).name
        print(f"[pcg-repeat] {name}: valid keyframes "
              f"{int(prob.kf_valid.sum())}, points {int(prob.pt_valid.sum())}"
              f", observations {int(prob.obs_valid.sum())}"
              + ("; saved with the card's solve" if saved is not None
                 else ""), flush=True)
        cpu_carries, floors, runs = repeat(name, prob, cam, dev, a.repeats,
                                           counts)
        row = {"misses": {n: sum(bool(r["misses"][n]) for r in runs)
                          for n in counts},
               "floors": floors, "dist": [r["dist"] for r in runs],
               "accepts_differ": sum(not r["accepts_as_cpu"] for r in runs)}
        if a.trace:
            row["trace"] = trace(name, prob, cam, dev, cpu_carries, runs)
        summary["problems"][name] = row
        del runs
    print(f"[pcg-repeat] misses of {a.repeats} repeats, by the CPU's "
          f"orders ({', '.join(map(str, counts))}): " + "; ".join(
              f"{n} {[r['misses'][k] for k in counts]}"
              for n, r in summary["problems"].items()))
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(summary, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
