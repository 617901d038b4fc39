"""Multi-sequence KITTI evaluation (BASELINE configs[4]).

Batched odometry over several sequences is embarrassingly parallel
data parallelism (SURVEY §2.3 item 5: "DCN only if multi-host batch
evaluation"): each sequence is an independent SLAM session. On a single
chip the sessions run round-robin so the device pipeline stays busy
while hosts sides interleave; across hosts, run one process per chip
(each sequence's session is self-contained — no cross-talk exists in
the problem).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SequenceResult:
    name: str
    n_frames: int
    n_lost: int
    n_keyframes: int
    n_points: int
    poses: np.ndarray  # (F, 4, 4) final chained Tcw


def run_sequences(
    make_system,
    sequences: dict,
    settings_for: dict | None = None,
) -> dict[str, SequenceResult]:
    """Run several sequences through independent System sessions.

    Args:
      make_system: (name) -> System — fresh session per sequence.
      sequences: name -> iterable of (left, right, timestamp[, sem_override]).

    Sessions interleave frame-by-frame (round-robin): while one
    session's host bookkeeping runs, the others' device programs are in
    flight, which keeps the single chip busy without any cross-session
    state.
    """
    systems = {name: make_system(name) for name in sequences}
    iters = {name: iter(seq) for name, seq in sequences.items()}
    live = set(sequences)
    while live:
        for name in list(live):
            try:
                item = next(iters[name])
            except StopIteration:
                live.discard(name)
                continue
            left, right, t = item[0], item[1], item[2]
            sem = item[3] if len(item) > 3 else None
            systems[name].track_stereo(
                left, right, t, sem_override=sem
            )
    out = {}
    for name, system in systems.items():
        system.flush()
        out[name] = SequenceResult(
            name=name,
            n_frames=len(system.tracker.trajectory),
            n_lost=system.n_lost(),
            n_keyframes=system.map.n_keyframes,
            n_points=system.map.n_points,
            poses=system.frame_poses(),
        )
    return out
