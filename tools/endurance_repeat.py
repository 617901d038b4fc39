"""``chip_smoke.py``'s phase 11 (dumbbell434) alone, several times on the
card, each run with its per-frame record.

Builds the kernels, then runs ``chip_smoke.phase_endurance`` RUNS times.
The first FRESH runs each render the lap anew while they track it, as
``chip_smoke.py`` does (404 frames rendered by a process per core at
the lowest priority beside the run, ~9 minutes a run); the others reuse
the last lap, already rendered, so frames reach the tracker as fast as
it takes them: another timing of the copies against the frames in
flight (~3 minutes a run). A failed gate does not stop the runs: each
is printed as it fails and counted. Per run: lost frames, keyframes,
loops with the frames they closed at, ATE, relocalizations, crisis
frames, the first non-zero map-health count, the gates failed and the
seconds; where a frame was lost or a gate failed, the record around the
first lost frame (``FrameLog.print_window``). Records go to
``chiprun_out/endurance_runs/run_<i>/endurance_record.npz``, the
summary to ``chiprun_out/endurance_runs/summary.json``; the card's name
and power limit are printed first and last.

Run from the repository root on a machine with an NVIDIA card:
``python3 tools/endurance_repeat.py [RUNS] [FRESH]`` (defaults 6 and 2).
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

OUT = ROOT / "chiprun_out" / "endurance_runs"


def main() -> int:
    args = [int(a) for a in sys.argv[1:]]
    runs, fresh = (args + [6, 2][len(args):])[:2]
    if not torch.cuda.is_available():
        print("endurance_repeat: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.phase_card()
    cs.phase_build()
    cfg = cs.SystemConfig()
    failed: list[str] = []

    def need(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)
            print(f"[repeat] gate failed: {what}", flush=True)

    cs._need = need
    render, summary = None, []
    try:
        for r in range(runs):
            if render is None or r < fresh:
                if render is not None:
                    render.close()
                render = cs.dumbbell_render(cfg)
            work = OUT / f"run_{r}"
            work.mkdir(parents=True, exist_ok=True)
            failed.clear()
            t0 = time.perf_counter()
            try:
                out, _ = cs.phase_endurance(cfg, dev, render, str(work))
            except Exception:  # a run that raises is reported, not fatal
                traceback.print_exc()
                out = {}
                failed.append("raised")
            row = {"run": r, "lap": "rendered beside" if r < fresh
                   else "rendered before", "seconds": time.perf_counter() - t0,
                   "failed": list(failed),
                   **{k: out.get(k) for k in (
                       "lost", "lost_frames", "keyframes", "loops", "events",
                       "ate", "ate_tracked", "relocalizations",
                       "reloc_attempts", "crisis_frames", "frame_ms_median",
                       "syncs_per_frame", "record")}}
            summary.append(row)
            print("[repeat] " + json.dumps(row), flush=True)
            record = work / "endurance_record.npz"
            if (failed or row["lost"]) and record.exists():
                cs.FrameLog.from_npz(str(record)).print_window(
                    f"[repeat {r}]")
            del out
            torch.cuda.empty_cache()
    finally:
        if render is not None:
            render.close()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "summary.json").write_text(json.dumps(
        {"card": card, "runs": summary}, indent=1, default=str))
    print(f"[repeat] {runs} runs: lost "
          f"{[row['lost'] for row in summary]}, ATE "
          f"{[row['ate'] for row in summary]}, gates failed in "
          f"{sum(bool(row['failed']) for row in summary)}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
