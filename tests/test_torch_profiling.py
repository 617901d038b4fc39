"""``utils/profiling.device_trace`` (the port's counterpart of the JAX
package's ``jax.profiler`` trace) writes a Chrome trace holding the ops
of the profiled block, and ``kernel_busy`` reads a trace's device
kernels: their count, the union of their intervals and their span."""

import json

import torch

from sivo_tpu_torch.utils import profiling


def test_device_trace_writes_the_ops_of_the_block(tmp_path):
    a = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        b = torch.relu(a @ a)
    assert prof is not None and b.shape == (64, 64)
    path = tmp_path / profiling.TRACE_FILE
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"aten::mm", "aten::relu"} <= names
    # no card here: no kernels, and the reader says so
    assert profiling.kernel_busy(str(path)) == {
        "kernels": 0, "busy_ms": 0.0, "window_ms": 0.0}


def test_kernel_busy_counts_overlaps_once(tmp_path):
    def kernel(ts, dur):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                "dur": dur}

    events = [kernel(1000, 100), kernel(1050, 100), kernel(1400, 200),
              kernel(1420, 10),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
               "dur": 5000}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    # busy: [1000, 1150) and [1400, 1600): 350 us over a 600 us span
    assert profiling.kernel_busy(str(path)) == {
        "kernels": 4, "busy_ms": 0.35, "window_ms": 0.6}
