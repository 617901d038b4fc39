"""Stage-level profiling (port of ``sivo_tpu/utils/profiling.py``).

``StageTimer`` is a copy of the JAX package's (numpy only; importing the
original would load JAX through ``sivo_tpu``'s package ``__init__``):
wall time per named stage, as the reference keeps a per-run median and
mean of TrackStereo wall time (ref: src/sivo.cc:90-113, 130-137). The
JAX device trace (``device_trace``) is not ported.

Device work is asynchronous: a stage clock read without a device sync
measures the enqueue. ``scalar_sync`` waits for a device value by
copying one element to the host.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch


def scalar_sync(x: torch.Tensor) -> float:
    """Synchronize on a device value by fetching ONE element."""
    return float(x.reshape(-1)[0])


@dataclass
class StageTimer:
    """Accumulates wall time per named stage."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    samples: dict = field(default_factory=lambda: defaultdict(list))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def summary(self) -> str:
        lines = ["stage                  calls   mean ms  median ms  total s"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            s = np.array(self.samples[name])
            lines.append(
                f"{name:<22} {self.counts[name]:>5} "
                f"{s.mean() * 1e3:>9.1f} {np.median(s) * 1e3:>10.1f} "
                f"{self.totals[name]:>8.2f}"
            )
        return "\n".join(lines)

    def report_reference_style(self, stage: str = "track") -> str:
        """The reference's exit lines (ref: sivo.cc:130-137)."""
        s = np.sort(np.array(self.samples.get(stage, [0.0])))
        return (
            f"median tracking time: {s[len(s) // 2]:.4f}\n"
            f"mean tracking time: {s.mean():.4f}"
        )
