"""``chip_smoke.py``'s phase 11 (dumbbell434) or phase 7 (loop190)
alone, several times on the card, each run with its per-frame record.

Builds the kernels, then runs the phase RUNS times. A failed gate does
not stop the runs: each is printed as it fails and counted. The card's
name and power limit are printed first and last; the output is long:
send it to a file under ``chiprun_out/``.

Phase 11 (``python3 tools/endurance_repeat.py [RUNS] [FRESH]``,
defaults 6 and 2): ``chip_smoke.phase_endurance``. The first FRESH runs
each render the lap anew while they track it, as ``chip_smoke.py`` does
(404 frames rendered by a process per core at the lowest priority
beside the run, ~9 minutes a run); the others reuse the last lap,
already rendered, so frames reach the tracker as fast as it takes them:
another timing of the copies against the frames in flight (~3 minutes
a run). Per run: lost frames, keyframes, loops with the frames they
closed at, ATE, relocalizations, crisis frames, the first non-zero
map-health count, the gates failed and the seconds; where a frame was
lost or a gate failed, the record around the first lost frame
(``FrameLog.print_window``). Records go to
``chiprun_out/endurance_runs/run_<i>/endurance_record.npz``, each run's
first PCG global BA problem to ``run_<i>/pcg_problem.pt``
(``chip_smoke.save_pcg_problem``, for ``tools/pcg_repeat.py``).

Phase 7 (``python3 tools/endurance_repeat.py --phase loop [RUNS]``,
default 10; ~2.5 minutes of render, then ~80 s a run): renders the loop
world's 190 frames once (``chip_smoke.make_scene``), then runs
``chip_smoke.phase_loop`` on them (the session with the offline
vocabulary, its gates against ``REF_LOOP``, the kidnap). Per run: lost
frame ids, keyframes, loops and the frames of their corrections, ATE,
relocalizations, syncs per frame, the record's bytes and seconds, the
gates failed; ``phase_loop`` prints the record around the first lost
frame. Records go to ``chiprun_out/loop_runs/run_<i>/loop_record.npz``,
each run's dense global BA problem to ``run_<i>/prob.pt`` (for
``tools/pcg_repeat.py``). The port's phase 7 session on the CPU:
``tools/late_copies.py --cell loop190``.

Each phase's summary goes to ``summary.json`` beside its runs.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ENDURANCE_ROW = ("lap", "lost", "lost_frames", "keyframes", "loops",
                 "events", "ate", "ate_tracked", "relocalizations",
                 "reloc_attempts", "crisis_frames", "frame_ms_median",
                 "syncs_per_frame", "record")
LOOP_ROW = ("lost", "lost_frames", "keyframes", "loops_closed", "closed_at",
            "events", "ate", "relocalizations", "frame_ms",
            "syncs_per_frame", "record", "kidnap_error_m")


class EnduranceRuns:
    """Phase 11's runs: ``run(r, work)`` -> its output; ``close()`` stops
    the lap's render."""

    row, record, out_dir = ENDURANCE_ROW, "endurance_record.npz", (
        ROOT / "chiprun_out" / "endurance_runs")

    def __init__(self, cfg, dev, fresh: int):
        self.cfg, self.dev, self.fresh, self.render = cfg, dev, fresh, None

    def run(self, r: int, work: Path) -> dict:
        if self.render is None or r < self.fresh:
            self.close()
            self.render = cs.dumbbell_render(self.cfg)
        out, kept = cs.phase_endurance(self.cfg, self.dev, self.render,
                                       str(work))
        if "pcg" in kept:
            cs.save_pcg_problem(str(work / "pcg_problem.pt"), *kept["pcg"])
        return {"lap": "rendered beside" if r < self.fresh
                else "rendered before", **out}

    def close(self) -> None:
        if self.render is not None:
            self.render.close()


class LoopRuns:
    """Phase 7's runs on the loop world, rendered once; as
    ``EnduranceRuns`` (``phase_loop`` prints its own window)."""

    row, record, out_dir = LOOP_ROW, None, ROOT / "chiprun_out" / "loop_runs"

    def __init__(self, cfg, dev):
        self.cfg, self.dev = cfg, dev
        self.scene = cs.make_scene(cfg, cs.N_LOOP_FRAMES)[:4]

    def run(self, r: int, work: Path) -> dict:
        out = cs.phase_loop(self.cfg, *self.scene, self.dev, str(work))
        if out.get("gba_case") is not None:
            cs.save_pcg_problem(str(work / "prob.pt"), *out["gba_case"])
        return out

    def close(self) -> None:
        pass


def main() -> int:
    args = sys.argv[1:]
    phase = "endurance"
    if args[:1] == ["--phase"]:
        phase, args = args[1], args[2:]
    nums = [int(a) for a in args]
    if not torch.cuda.is_available():
        print("endurance_repeat: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.phase_card()
    cs.phase_build()
    cfg = cs.SystemConfig()
    if phase == "loop":
        runs, cell = (nums + [10])[0], LoopRuns(cfg, dev)
    else:
        runs, fresh = (nums + [6, 2][len(nums):])[:2]
        cell = EnduranceRuns(cfg, dev, fresh)
    failed: list[str] = []

    def need(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)
            print(f"[repeat] gate failed: {what}", flush=True)

    cs._need = need
    summary = []
    try:
        for r in range(runs):
            work = cell.out_dir / f"run_{r}"
            work.mkdir(parents=True, exist_ok=True)
            failed.clear()
            t0 = time.perf_counter()
            try:
                out = cell.run(r, work)
            except Exception:  # a run that raises is reported, not fatal
                traceback.print_exc()
                out = {}
                failed.append("raised")
            row = {"run": r, "seconds": time.perf_counter() - t0,
                   "failed": list(failed),
                   **{k: out.get(k) for k in cell.row}}
            summary.append(row)
            print("[repeat] " + json.dumps(row, default=str), flush=True)
            record = cell.record and work / cell.record
            if record and (failed or row["lost"]) and record.exists():
                cs.FrameLog.from_npz(str(record)).print_window(
                    f"[repeat {r}]")
            del out
            torch.cuda.empty_cache()
    finally:
        cell.close()
    cell.out_dir.mkdir(parents=True, exist_ok=True)
    (cell.out_dir / "summary.json").write_text(json.dumps(
        {"card": card, "runs": summary}, indent=1, default=str))
    print(f"[repeat] {runs} runs: lost {[r['lost'] for r in summary]} "
          f"(frames {[r['lost_frames'] for r in summary]}), keyframes "
          f"{[r['keyframes'] for r in summary]}, ATE "
          f"{[r['ate'] for r in summary]}, gates failed in "
          f"{sum(bool(r['failed']) for r in summary)}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
