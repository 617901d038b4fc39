#!/usr/bin/env python3
"""Chip smoke test of sivo_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA card and ``nvcc`` (it builds the kernels from ``sivo_tpu_torch/csrc``
on first use) and imports nothing of JAX or of the JAX package. Phases,
each raising on failure:

0. the card: ``torch.cuda.is_available()``, nvidia-smi name + power limit
   (printed again before the last two lines);
1. build the kernels (K1 orb_describe, K2 hamming_top2), one nvcc each;
2. K1 against its plain PyTorch version on one rendered 352x1024 frame:
   the float canvases and the 2048 keypoints the port selects on it
   (angle atol 1e-4, 0 differing bits); times; bound;
3. SegNet basic forward at 352x1024, MC=3, in cfg.semantic.cnn_dtype
   with seeded weights: probabilities finite and summing to 1;
3b. SegNet standard (the VGG16-style variant, ~29.4 M parameters) at
   its published widths: its seeded state, with the output layer
   ``conv1_1_D`` set so that the posterior is certain and static (kernel
   scaled by 1e-3, a bias of 30 on class 0), written as a ``.caffemodel``
   (``flax_from_params`` + ``caffe_io.save_segnet_params``) and loaded
   back through ``caffe_io.state_dict_from_caffemodel``, which must give
   the state written; then ``segment_image`` at 352x1024, MC=3, in
   cfg.semantic.cnn_dtype: probabilities finite and summing to 1 within
   1e-3, class 0 on every pixel, entropy <= 1e-3 bits; median ms per
   ``segment_image`` against its convolutions' FLOPs (``segnet.
   conv_flops``) over the card's dense bf16 rate. The output layer is
   test scaffolding for want of trained weights: the network runs at
   full cost and tracking sees what ``--no-semantics`` gives it, so
   phase 8 can be held to the JAX package's command line;
3c. SegNet basic trained on the card: ``tools.train_bench_segnet.
   train_on_frames`` (the JAX tool's recipe: every 8th frame of the
   190-frame lap as uint8, half resolution 176x512, gray repeated to
   three channels, 15 classes, dropout 0.5, 150 Adam steps of batch 2 at
   lr 1e-3, float32, cuDNN's deterministic algorithms, from Flax's
   truncated-normal initializer) on ``cuda:0``, once per seed 0-3, on
   the frames the JAX recipe trained on (``tools/data/
   cnn40_training_frames.npz``, written by ``tools/cnn40_jax_reference.
   py``; this machine's OpenCV and numpy render other pixels, and the
   share that differ is printed). Seed 0: the median ms per step (CUDA
   events around ``train.train_step``, steps 10-149) beside its bound
   (3 x the forward convolutions' FLOPs of the batch at 67 TFLOP/s
   float32), the total seconds, and the device busy share of 5 steps of
   a copy after warm-up under ``profiling.device_trace``; its
   ``.caffemodel`` must load back (``state_dict_from_caffemodel``) to
   the state trained, and it drives run C. Every seed: the loss of the
   last 10 steps below that of the first 10, and
   ``segment_image_with_variance`` at 352x1024, MC=3, in cnn_dtype on
   holdout frame 4 with a pixel accuracy above a predictor of the
   frame's majority class, a mean entropy above 1e-3 bits and a
   variance finite and in [0, 1/3]. One seed is one draw of a chaotic
   recipe, so the gates take medians: the seeds' median accuracy no more
   than 0.05 below the median of the JAX recipe's eight seeds
   (``REF_CNN['holdout_acc']``), a floor that must itself be above the
   majority-class predictor, and their median entropy within 0.10 bits
   of the JAX seeds' range (``REF_CNN['holdout_entropy']``); the share
   of the recipe's pixels this machine renders otherwise is printed;
4. K2 against its plain version on the inputs of its searches on the
   main path, each at (2048, 2048): motion, local map and brute force
   kept from their last calls in phase 5's run, the mapper's fusion kept
   from its last call in the warm-up run of phase 6, Sim3 from phase 7
   and the local map on a full candidate list from phase 11 (both
   checked after their runs); distances and both argmins must be equal;
   times; bound per case;
5. the slice through the port's entry points (``build_frame`` ->
   ``Tracker.track``, no mapper) on the bench loop world's first 40
   frames, against the JAX package's CPU run of the same frames (0 lost,
   ATE 0.0145 m, 12 keyframes): 0 lost, ATE <= 0.10 m, keyframes 12 +- 3,
   K1 launched twice per frame and K2 at least once per tracked frame;
   the one run is timed and keeps phase 4's first three cases; the
   run's last pose LM call again, its CUDA graph's replay equal to the
   eager solve bit for bit (host ms of each printed);
6. the SLAM session through the system's entry point:
   ``System(cfg, device=cuda, max_keyframes=256, max_points=32768)``,
   ``track_stereo`` on the same 40 frames (SegNet basic running, the
   renderer's semantics as ``sem_override``), ``flush``, then
   ``save_trajectory_kitti`` and ``shutdown`` into a temporary
   directory. Against the JAX package's CPU ``System`` on the same
   frames with K1's descriptor semantics and its fetches landed, the
   card's timing (``tools/loop40_jax_reference.py --k1 --landed``,
   ``REF_SYSTEM``'s "k1" runs: 0 lost, ATE 0.0088 m, 13 keyframes, 12
   BA solves, 1 point triangulated, both runs alike): lost no more
   than theirs, ATE <= 0.10 m over ``frame_poses()``, keyframes within
   3 of theirs, at least one BA
   solve applied, triangulation run on the keyframes, K1 launched twice
   per frame, the mapper's K2 launches equal to the fusion searches it
   counted, a 40-line trajectory file and the counts file. This cell's
   entropy-reduction gate (4.0, the reference's KITTI setting) lets
   almost no triangulated candidate through, in the JAX package too, so
   a minting run comes first, as the timed run's warm-up: the first 12
   frames with the gate at 0.02 (as in tests/test_compact.py), where
   triangulation must mint points and the host and device maps must hold
   the same ones. It keeps a copy of K2's inputs at the last fusion
   search (phase 4's fusion case, whose calls per frame are the timed
   run's) and of the last local BA problem, which is replayed once under
   the profiler for its device time and launches per solve.
7. the loop session: the same ``System``, with the repository's offline
   vocabulary (``sivo_tpu/place/data/orbvoc_synth.npz``, read as data)
   given through ``attach_vocabulary``, on all 190 frames of the bench
   loop world, then ``flush``, ``frame_poses``, ``save_trajectory_kitti``
   and ``shutdown``. Against the JAX package's CPU ``System`` with the
   same vocabulary on the same frames, with K1's descriptor semantics
   (``tools/loop190_jax_reference.py --k1 [--landed]``, ``REF_LOOP``'s
   "k1" runs: two landed, alike, one loop, 0 lost, ATE 0.0490 m, 47
   keyframes; six as the CPU times them, one loop each, 0 lost in four
   and 1 in two (the frame after the closure), 0.0254-0.0546 m, 46-49
   keyframes): at least one loop closed, the
   global BA applied after it, lost frames no more than the JAX runs',
   keyframes within 5 of theirs, ATE over ``frame_poses()`` <= 0.10 m
   and no worse than twice theirs, a 190-line trajectory; the loop closer's and
   relocalization's K2 launches equal to the searches they counted. Then
   a kidnap on the same ``System``: the believed pose teleported 4 m and
   frame-to-frame continuity severed, an early frame replayed twice; the
   second call must relocalize within 0.5 m of ground truth. The run
   keeps a copy of K2's inputs at the last guided ``search_by_sim3`` call
   (phase 4's ``sim3`` case, checked and timed after the run), counts
   device syncs over all 190 frames and keeps phase 11's per-frame
   record (``FrameLog``), saved as ``loop_record.npz`` in the work
   directory, its frames, bytes and seconds on a line of their own; if
   a frame was lost, the records from 10 frames before the first lost
   frame to 5 after it are printed.

8. the command line, ``sivo_tpu_torch.cli.run`` in this process, on the
   first 40 rendered frames written as a KITTI directory (``image_2/``,
   ``image_3/`` PNGs, ``times.txt`` at the camera's fps, a
   ``settings.yaml``) with the offline vocabulary written as DBoW text.
   Run A: ``VOC SETTINGS bayesian_segnet_kitti.prototxt
   standard.caffemodel DIR`` (SegNet standard from phase 3b's file, the
   native vocabulary parser, loop closing on), its launch counters set
   to 0 just before it and read just after, syncs counted; against the
   JAX package's command line with ``--no-semantics`` and K1's
   descriptor semantics on the same directory
   (``tools/cli40_jax_reference.py --k1 [--landed]``, ``REF_CLI``'s "k1"
   runs: two as it runs on the CPU, and two with its host fetches landed
   by the next frame, as the card's are): the loading lines, the native
   parse, one SegNet standard forward per frame (a forward hook), a 40-row
   trajectory starting at the identity, ATE <= 0.10 m and no worse than
   twice the JAX runs' worst, keyframes within 3 of the landed runs'
   (the pipelined mapper admits a keyframe once its copy has landed, so
   the count follows that timing; the admissions deferred are printed),
   K1 launched twice per frame and K2 at least once per tracked frame.
   Run C: ``VOC SETTINGS bayesian_segnet_basic_kitti.prototxt
   trained.caffemodel DIR``, phase 3c's seed-0 network with semantics on,
   pipelined as run A, its launch counters set to 0 just before it and
   read just after; each built frame adds on the device its pixels whose
   class is the renderer's, its entropy and its semantic and extracted
   keypoints to sums fetched once at the end. Against the JAX command
   line on the JAX recipe's networks with semantics on, K1's descriptor
   semantics and its fetches landed (``tools/cnn40_jax_reference.py
   --k1``, ``REF_CNN``'s "k1" command-line runs, one on each of the
   eight seeds' networks; the ranges below are over them):
   "Loaded weights from", one SegNet basic forward per frame, 40 rows,
   lost no more than theirs, ATE <= 0.10 m and no worse than twice their
   worst, keyframes within 3 of theirs, K1 twice per frame and K2 at
   least once per tracked frame, the share of extracted keypoints that
   pass the semantic gate strictly between 0 and 1 and within 0.10 of
   theirs, the pixel accuracy of the classes within 0.05 of theirs. Run
   B: the first 12 frames with ``basic_prototxt - --no-semantics
   --save-frames DIR`` and no vocabulary: 12 overlays of (352 + 20) x
   1024, ``map_topdown.png``, a 12-row trajectory and no SegNet forward.
9. the offline vocabulary tool on the card at a reduced size:
   ``tools.train_offline_vocab.main(["--frames-per-world", "2",
   "--depth", "3", "--out", ...])``, its launch counters set to 0 just
   before it and read just after: K1 launched twice per rendered frame
   (24), the file read back by ``load_npz``, 1-1,000 words, and one
   loop-world frame's descriptors give a non-empty BoW vector
   (``transform``, ``bow_vector``).
10. the parallel paths. 10a: ``parallel.multi_sequence.run_sequences``
   on two sessions interleaved round-robin, "a" on frames 0-19 of the
   lap and "b" on frames 20-39 (a fresh session), each a ``System`` as
   phase 6's with SegNet basic running and the renderer's semantics as
   ``sem_override``, its launch counters set to 0 just before the run and
   read just after: each session 0 lost, ATE <= 0.10 m on its own
   ground-truth span, at least 2 keyframes, its ms per pair; K1 launched
   twice per frame over the 40 and K2 at least once per tracked frame.
   10b: ``parallel.sharded_ba.sharded_bundle_adjustment`` on phase 7's
   dense GBA problem, 30 iterations at world size 1 over NCCL in this
   process (its λ starts at 1e-4, so 10 do not converge on this problem;
   their gap is printed), against the port's dense
   ``global_bundle_adjustment`` (10 iterations, as the loop closer runs
   it) on the same problem with tests/test_sharded_ba.py's bounds: each
   keyframe's largest ``log(T_dense^-1 T_sharded)`` component <= 2e-3,
   the median point difference < 0.1 m; the solve's wall ms and the
   all-reduce bytes per iteration. 10c: the same problem on 2 gloo ranks
   spawned on this card, given as a ``.pt`` file, its valid points
   spread over the shards round-robin first (the partition drops a
   shard's observations beyond its slots): >= 95% of the valid
   observations kept, 10b's tolerances. 10d: ``entry.dryrun_multichip``
   over this machine's cards (NCCL) and ``entry()``'s forward, whose
   posterior must be finite.
11. the endurance run, dumbbell434: one super-lap of the JAX bench's
   endurance mode (``bench.py``, ``SIVO_BENCH_LAPS``), the dumbbell world
   (``make_dumbbell_world(seed=0)``) along ``figure8_trajectory(434)``
   (404 lap frames and 30 that re-drive the start; frame i shows render
   i % 404, rendered by the process pool at the lowest CPU priority
   while the phase tracks the frames already rendered), ``System(cfg,
   device=cuda, max_keyframes=448, max_points=49152,
   pipeline_depth=3)`` with SegNet basic at full cost, the renderer's
   semantics as ``sem_override`` and the offline vocabulary,
   ``track_frame(pipeline=True)`` on every frame (the next frame built
   between its dispatch and its retire), ``flush``, ``frame_poses``,
   ``save_trajectory_kitti`` and ``shutdown``, the launch counters set
   to 0 just before and read just after. Against CPU runs on the same
   frames (``REF_DUMBBELL``, each naming its descriptor path: the JAX
   package's ``System`` on its CPU XLA path, ``tools/
   dumbbell_jax_reference.py``, a run with its fetches landed by the
   next frame, the card's regime, and two as the CPU times them; and
   like for like, with K1's semantics, ``tools/dumbbell_port_parity.py``:
   the JAX package with K1 interpreted and its fetches landed, and the
   port on the CPU with its own RANSAC draws and with the JAX
   package's): loops closed at least the runs' fewest, every dispatched
   GBA applied, where a run took the PCG branch the same branch and
   bucket at that closure, lost frames no more than theirs + 2,
   keyframes within 15% of theirs, a compaction where they compacted,
   ATE no worse than twice the worst K1-semantics run (and never looser
   than twice the worst XLA-path run), a 434-line trajectory, the loop
   closer's and relocalization's K2 launches equal to the searches they
   counted, K1 twice per frame. Reports the largest aligned centre
   error and its frame, the per-frame median and p90 ms, syncs per
   frame, peak device memory, the ``lc.*`` and ``map.*`` stage rows,
   the essential graph's host ms per closure and each GBA's wall time
   from dispatch to application. The run keeps a record of every frame
   it retires (``FrameLog``: the tracking step's counts for each search,
   the keyframe and crisis rules' inputs, world corrections, mapper
   stages, relocalization attempts, the camera centre's jump and map
   health, whose device counts come home in each frame's summary copy),
   saved as ``endurance_record.npz`` in the work directory, its frames,
   bytes and seconds on a line of their own; if a gate fails, the
   records from 10 frames before the first lost frame to 5 after it and
   the first with a non-zero health count are printed. Then a
   compaction forced on the
   flushed session (``System._compact()``): every live point's
   position, descriptor and observations (host and device mirror) and
   every live keyframe's pose and stored descriptors bit-equal under
   the remap, ``frame_poses()`` unchanged, and 10 more lap frames
   tracked on the compacted map, none lost, K1 twice per frame and K2
   launched (its counters set to 0 just before and read just after).
   Then phase 4's ``local_map_full`` case: K2's inputs at
   the run's last local-map search of tracking on a full candidate list,
   or, where no refresh filled the list (dumbbell434 fills at most ~750
   of its 2048 ids, in the JAX package too), the last frame's local-map
   re-search with the list filled (``local_map_full_case``). And the PCG
   GBA (``gba_cg``: begin, 10 steps, finish) on the card on phase 7's
   GBA problem and on phase 11's first PCG problem, each held to the
   same solve on the CPU copy of the problem: poses, points (99th
   percentile, largest), chi2 (no higher than the CPU's by more) and
   inlier flags within the larger of tests/test_torch_gba.py's PCG
   tolerances (1e-4, 1e-3 m, 2e-2 m, 1e-6 relative, equal flags) and
   twice the CPU float32 solve's own float noise over 8 orders of the
   observations, each solved by a process of its own (``PCG_TOLS``,
   ``PCG_SHUFFLES``), and in float64 within those tolerances; on phase
   7's, PCG to convergence in float64 also to the float64 dense GBA
   within 10b's bounds (the float32 gaps printed). The CPU's solves of
   each problem run in spawned processes at the lowest priority from
   the moment the problem is kept (``PcgNoise``: phase 7's beside
   phases 8-10, phase 11's beside the rest of phase 11). Where a PCG
   gate fails, the problem (on the CPU) and the card's float32 solution
   are first saved to ``chiprun_out/pcg_misses/`` in the checkout, which
   outlives the run (``save_pcg_problem``), the path and size on a line
   of their own.

Phases 2-6 and 8 run on the first 40 of the 190 rendered frames; phase
3c trains on every 8th of the 190; phase 7 keeps its dense GBA problem
for 10b, 10c and 11. Each phase's seconds are printed on a line of
their own (``[time]``).

Kernel times: ``BATCH`` back-to-back calls captured in a CUDA graph,
its replay timed between two CUDA events and divided by ``BATCH``; the
median over ``RUNS`` replays. So a short kernel is timed neither as one
launch's latency nor as its wrapper's host cost. Plain versions: the
same without the graph. Bounds: the larger of the bytes the
function must move over 3.35 TB/s and its float32 operations over 67
TFLOP/s, counted from this run's inputs (``k1_bound``, ``k2_bound``).

The second-to-last line of standard output is a JSON object of the
kernels' launches (``launches_cli``: in phase 8's run A;
``launches_cli_trained``: run C; ``launches_vocab_tool``: phase 9;
``launches_multi_sequence``: phase 10a; ``launches_endurance``: phase
11), errors, times and bounds, phase 10's figures (``parallel``), phase
11's (``endurance``, ``pcg``) and each phase's seconds (``phase_s``);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from concurrent.futures import ProcessPoolExecutor

import cv2
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sivo_tpu_torch import cli, entry, native  # noqa: E402
from sivo_tpu_torch.geometry import se3  # noqa: E402
from sivo_tpu_torch.geometry.projection import (  # noqa: E402
    CameraParams, frustum_check, predict_scale, project_stereo)
from sivo_tpu_torch.config import SystemConfig  # noqa: E402
from sivo_tpu_torch.io import synthetic  # noqa: E402
from sivo_tpu_torch.models import caffe_io, segnet, train  # noqa: E402
from sivo_tpu_torch.ops import (  # noqa: E402
    image, kernel_match, kernel_orb, matching, orb)
from sivo_tpu_torch.optim import (  # noqa: E402
    ba_build, gba_cg, local_ba, pose_lm)
from sivo_tpu_torch.parallel import multi_sequence, sharded_ba  # noqa: E402
from sivo_tpu_torch.place import pnp as pnp_mod  # noqa: E402
from sivo_tpu_torch.place import vocabulary as voc_mod  # noqa: E402
from sivo_tpu_torch.runtime import frame as frame_mod  # noqa: E402
from sivo_tpu_torch.runtime import track_step  # noqa: E402
from sivo_tpu_torch.runtime.loopclosing import LoopCloser  # noqa: E402
from sivo_tpu_torch.runtime.map_state import MapState  # noqa: E402
from sivo_tpu_torch.runtime.mapping import LocalMapper  # noqa: E402
from sivo_tpu_torch.runtime.system import System  # noqa: E402
from sivo_tpu_torch.runtime.tracking import Tracker  # noqa: E402
from sivo_tpu_torch.tools import (  # noqa: E402
    train_bench_segnet, train_offline_vocab)
from sivo_tpu_torch.utils import kernels, profiling  # noqa: E402
from sivo_tpu_torch.utils.transfer import to_device  # noqa: E402

N_FRAMES = 40
N_LOOP_FRAMES = 190  # the bench loop world's full lap (phase 7)
VOCABULARY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "sivo_tpu", "place", "data", "orbvoc_synth.npz")
RUNS, BATCH = 30, 50  # kernel timing: median over RUNS of BATCH calls
PLAIN_RUNS, PLAIN_BATCH = 10, 5
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the frames the JAX recipe trained on (tools/cnn40_jax_reference.py)
TRAINING_FRAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tools", "data", "cnn40_training_frames.npz")
BF16_OPS_PER_S = 989e12  # dense, the H100 SXM data sheet
NO_LIBRARY = "no single PyTorch call computes it: "
# K2's searches on the main path: case name -> function of ops/matching
SEARCHES = {"motion": "search_by_projection_frame",
            "local_map": "search_by_projection_points",
            "brute_force": "search_brute_force"}


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _k1(table: dict, key: str, landed: bool | None = None) -> tuple:
    """``key`` over a reference table's runs made with K1's descriptor
    semantics (in the ``landed`` regime only, if given), the runs the
    phases gate on."""
    return tuple(r[key] for r in table.values()
                 if r["descriptors"] == "k1"
                 and landed in (None, r["landed"]))


def _ref_text(table: dict) -> str:
    """A reference table's runs, for the printout."""
    return "; ".join(
        f"{name} ({r['descriptors']}{', landed' * r['landed']}): "
        + ", ".join(f"{k} {v}" for k, v in r.items()
                    if k not in ("descriptors", "landed"))
        for name, r in table.items())


def _run_times(fn, runs: int = RUNS, batch: int = BATCH,
               warmup: int = 3) -> list[float]:
    """ms per call of ``fn``: for each of ``runs`` runs, ``batch`` calls
    back to back between two CUDA events, divided by ``batch``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return times


def _graph_times(fn, runs: int = RUNS, batch: int = BATCH) -> list[float]:
    """ms per call of ``fn`` on the device: ``batch`` calls back to back
    captured once in a CUDA graph, whose replay is timed between two
    CUDA events, divided by ``batch``, over ``runs`` replays. A kernel
    shorter than the wrapper's host cost (~20 us of Python and ctypes
    per call) would otherwise be timed as that host cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return times


def _kernel_ms(fn) -> float:
    return statistics.median(_graph_times(fn))


def _plain_ms(fn) -> float:
    return statistics.median(_run_times(fn, PLAIN_RUNS, PLAIN_BATCH))


def _bound(nbytes: float, f32_ops: float) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations"): the larger of the byte time
    and the float32 operations' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def phase_card() -> str:
    """Phase 0: the card's name and power limit as nvidia-smi gives them,
    and the versions of the libraries the renderer draws with."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; the renderer's numpy "
          f"{np.__version__} and OpenCV {cv2.__version__}")
    return smi


def phase_build() -> None:
    """Phase 1: build the kernels from csrc/ and load them."""
    path, build_s, report = kernels.build()
    kernels.library()
    print(f"[build] {path.name} in {build_s:.1f} s")
    for line in report.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill")):
            print(f"[build] {line.strip()}")


# host processes that render frames, one per core, at the lowest CPU
# priority: the host of an NVIDIA H100 80GB HBM3 (700.00 W) renders only
# ~1.9x faster so than serially, and a frame renders the same pixels
# only under OpenCV's default thread count (PERF.md §6); phase 11
# tracks its lap while the rest of it renders
RENDER_WORKERS = os.cpu_count() or 1
_RENDER_WORLD = None


def bench_world(kind: str, cam):
    """The JAX bench's worlds: the loop world (``make_loop_world(seed=0,
    outer=16, inner=6)``) or the endurance mode's dumbbell
    (``make_dumbbell_world(seed=0)``)."""
    if kind == "loop":
        return synthetic.make_loop_world(cam, seed=0, outer=16.0, inner=6.0)
    return synthetic.make_dumbbell_world(cam, seed=0)


def _render_init(kind: str, cam) -> None:
    global _RENDER_WORLD
    os.nice(19)
    _RENDER_WORLD = bench_world(kind, cam)


def _render_one(pose: np.ndarray):
    left, right, cls = synthetic.render_sequence(_RENDER_WORLD, pose[None],
                                                 ss=2)
    return left[0], right[0], cls[0]


class PooledRender:
    """``render_sequence(bench_world(kind, cam), poses, ss=2)`` made by
    worker processes, one frame per task in pose order, started at
    construction: ``frame(i)`` waits for one frame, ``result()`` for all
    of them; ``close()`` stops the workers. ``seconds``: from the start
    to the last frame rendered."""

    def __init__(self, kind: str, cam, poses: np.ndarray):
        workers = min(RENDER_WORKERS, len(poses))
        self.t0, self.workers, self.seconds = time.perf_counter(), workers, 0
        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_render_init, initargs=(kind, cam))
        self.futures = [self.pool.submit(_render_one, p) for p in poses]
        for f in self.futures:
            f.add_done_callback(self._done)

    def _done(self, _future) -> None:
        self.seconds = max(self.seconds, time.perf_counter() - self.t0)

    def frame(self, i: int):
        """Frame i's (left, right, classes)."""
        return self.futures[i].result()

    def result(self):
        """(left, right, classes), as ``render_sequence`` returns them."""
        try:
            out = [f.result() for f in self.futures]
        finally:
            self.close()
        return tuple(np.stack(a) for a in zip(*out))

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


def _check_serial(kind: str, cam, pose, left, right, cls) -> None:
    """A pooled frame equals the serial render of the same pose."""
    serial = synthetic.render_sequence(bench_world(kind, cam), pose[None],
                                       ss=2)
    differ = [float(np.mean(a[0] != b)) for a, b in zip(serial,
                                                         (left, right, cls))]
    _need(not any(differ), f"{kind} world: the pooled render differs from "
          f"the serial one at {differ} of the pixels (left, right, classes)")


def make_scene(cfg: SystemConfig, n_frames: int):
    """The bench loop world (bench.py) and its first ``n_frames`` frames,
    rendered on the host by ``RENDER_WORKERS`` processes, with renderer
    semantics (seed 7): (ground truth, left, right, semantics, the
    renderer's class maps)."""
    gt = synthetic.square_loop_trajectory(n_frames=N_LOOP_FRAMES, half=9.5,
                                          corner_r=3.5, jitter=0.03)
    gt = gt[:n_frames]
    pool = PooledRender("loop", cfg.camera, gt)
    left, right, cls_maps = pool.result()
    _check_serial("loop", cfg.camera, gt[0], left[0], right[0], cls_maps[0])
    sems = [synthetic.structured_semantics(c, seed=7) for c in cls_maps]
    print(f"[scene] rendered {n_frames} frames at "
          f"{cfg.camera.height}x{cfg.camera.width} in {pool.seconds:.1f} s "
          f"(host, {pool.workers} processes; frame 0 equal to its serial "
          "render)")
    return gt, left, right, sems, cls_maps


def k1_inputs(statics, left0, dev):
    """One frame's float canvases and the keypoints the port selects:
    (raw, blur, level, xy_level, valid)."""
    spec = statics.spec
    gray = torch.from_numpy(left0.astype(np.float32)).to(dev)
    raw, blur = image.build_pyramid(gray, spec)
    region = image.level_valid_mask(spec, 16, dev)
    xy_level, level, _, valid = orb.extract_select(
        raw, region, spec, statics.budgets, statics.max_keypoints,
        statics.ini_th, statics.min_th,
    )
    return raw, blur, level, xy_level, valid


def k1_bound(raw, level, xy_level) -> tuple[float, str]:
    """K1's bound on these keypoints: it must read once each raw pixel
    under some keypoint's circular mask and each sampled blurred pixel
    (float32), read the keypoints and write the outputs; its arithmetic
    is ~5 ops per masked raw pixel and ~11 per sample."""
    coords = kernel_orb.clamp_coords(raw.shape, level, xy_level)
    _, H, W = raw.shape
    c = coords.long()
    centre = (c[:, 0] * H + c[:, 1]) * W + c[:, 2]
    mask = torch.from_numpy(kernel_orb.ic_angle_mask() > 0).to(raw.device)
    off = torch.arange(-kernel_orb.HALF_PATCH, kernel_orb.HALF_PATCH + 1,
                       device=raw.device)
    raw_off = (off[:, None] * W + off[None, :])[mask]
    raw_px = torch.unique(centre[:, None] + raw_off[None, :]).numel()
    flat = kernel_orb.brief_offsets(*kernel_orb.ic_moments(raw, coords))
    dy = flat // kernel_orb.BRIEF_PATCH - kernel_orb.BRIEF_MARGIN
    dx = flat % kernel_orb.BRIEF_PATCH - kernel_orb.BRIEF_MARGIN
    blur_px = torch.unique(centre[:, None] + dy * W + dx).numel()
    n = coords.shape[0]
    nbytes = 4 * (raw_px + blur_px) + n * (4 + 8) + n * (4 + 32)
    ops = n * (5 * int(mask.sum()) + 11 * 512)
    print(f"[K1] bound counts: {raw_px} raw and {blur_px} blurred pixels, "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops")
    return _bound(nbytes, ops)


def phase_k1(statics, left0, dev) -> dict:
    """Phase 2: K1 against its plain version at the main path's shape:
    one frame's float canvases and the 2048 keypoints the port selects."""
    raw, blur, level, xy_level, valid = k1_inputs(statics, left0, dev)
    n = level.shape[0]
    _need(n == 2048, f"K1 shape {n}")
    ang_k, desc_k = kernel_orb.orb_describe_cuda(raw, blur, level, xy_level)
    ang_p, desc_p = kernel_orb.orient_and_describe_plain(raw, blur, level,
                                                         xy_level)
    torch.cuda.synchronize()
    err = float((ang_k - ang_p).abs().max())
    bits = int((orb.unpack_bits(desc_k) != orb.unpack_bits(desc_p)).sum())
    print(f"[K1] n={n} valid={int(valid.sum())}: angle max err {err:.3g}, "
          f"differing bits {bits}")
    _need(err <= 1e-4, f"K1 angle error {err}")
    _need(bits == 0, f"K1: {bits} differing bits")
    ms = _kernel_ms(
        lambda: kernel_orb.orb_describe_cuda(raw, blur, level, xy_level))
    plain_ms = _plain_ms(lambda: kernel_orb.orient_and_describe_plain(
        raw, blur, level, xy_level))
    bound_ms, bound_by = k1_bound(raw, level, xy_level)
    print(f"[K1] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_segnet(cfg: SystemConfig, left0, dev) -> segnet.SegNet:
    """Phase 3: SegNet basic forward at full geometry, MC samples in
    cnn_dtype, seeded random weights."""
    model = segnet.SegNet(dtype=segnet.dtype_of(cfg.semantic.cnn_dtype))
    model.load_state_dict(segnet.init_params(seed=0))
    model = model.to(dev).eval()
    img = torch.from_numpy(left0.astype(np.float32)).to(dev)
    img = img[:, :, None].expand(-1, -1, 3)
    gen = torch.Generator(device=dev).manual_seed(1)
    s = cfg.semantic.mc_samples
    with torch.no_grad():
        probs = model(img, mc_samples=s, generator=gen)
        torch.cuda.synchronize()
        shape = (s, cfg.camera.height, cfg.camera.width, 15)
        _need(tuple(probs.shape) == shape, f"SegNet shape {probs.shape}")
        _need(bool(torch.isfinite(probs).all()), "SegNet: non-finite")
        sum_err = float((probs.sum(-1) - 1.0).abs().max())
        _need(sum_err <= 1e-3, f"SegNet: probabilities sum off by {sum_err}")
        ms = statistics.median(_run_times(
            lambda: segnet.segment_image(model, img, gen, s), 10, 1))
    print(f"[segnet] basic {cfg.camera.height}x{cfg.camera.width} MC={s} "
          f"{cfg.semantic.cnn_dtype}: sum err {sum_err:.2e}, {ms:.3f} ms "
          "per segment_image")
    return model


# phase 3b: SegNet standard's output layer, set so that the posterior is
# certain and static (class 0 <= STATIC_CLASS_MAX); p(other classes)
# ~ 14 exp(-30) = 1.3e-12
STD_OUT_KERNEL_SCALE, STD_OUT_BIAS = 1e-3, 30.0


def certain_static_standard(num_classes: int) -> dict:
    """SegNet standard's seeded state (``init_params(seed=0)``) with the
    output layer ``conv1_1_D`` scaled down and a large bias on class 0."""
    state = segnet.init_params(seed=0, num_classes=num_classes,
                               variant="standard")
    state["convs.conv1_1_D.weight"] = (state["convs.conv1_1_D.weight"]
                                       * STD_OUT_KERNEL_SCALE)
    bias = torch.zeros(num_classes)
    bias[0] = STD_OUT_BIAS
    state["convs.conv1_1_D.bias"] = bias
    return state


def phase_segnet_standard(cfg: SystemConfig, left0, dev, work: str) -> dict:
    """Phase 3b: SegNet standard through a .caffemodel and back, then
    ``segment_image`` at full geometry, MC samples in cnn_dtype. Returns
    the file's path and the timing."""
    nc = cfg.semantic.num_classes
    state = certain_static_standard(nc)
    path = os.path.join(work, "standard.caffemodel")
    caffe_io.save_segnet_params(path, segnet.flax_from_params(state))
    loaded = caffe_io.state_dict_from_caffemodel(
        path, "standard", segnet.init_params(seed=1, num_classes=nc,
                                             variant="standard"))
    _need(loaded.keys() == state.keys()
          and all(torch.equal(loaded[k], state[k]) for k in state),
          "SegNet standard: the .caffemodel did not load to the state "
          "written")
    model = segnet.SegNet("standard", num_classes=nc,
                          dtype=segnet.dtype_of(cfg.semantic.cnn_dtype))
    model.load_state_dict(loaded)
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    img = torch.from_numpy(left0.astype(np.float32)).to(dev)
    img = img[:, :, None].expand(-1, -1, 3)
    gen = torch.Generator(device=dev).manual_seed(1)
    s, h, w = cfg.semantic.mc_samples, cfg.camera.height, cfg.camera.width
    with torch.no_grad():
        probs = model(img, mc_samples=s, generator=gen)
        _need(tuple(probs.shape) == (s, h, w, nc),
              f"SegNet standard shape {probs.shape}")
        _need(bool(torch.isfinite(probs).all()), "SegNet standard: "
              "non-finite")
        sum_err = float((probs.sum(-1) - 1.0).abs().max())
        cls, _, ent = segnet.posterior(probs.mean(0))
        non_static = int((cls != 0).sum())
        ent_max = float(ent.max())
        ms = statistics.median(_run_times(
            lambda: segnet.segment_image(model, img, gen, s), 10, 1))
    flops = segnet.conv_flops("standard", h, w, s, nc)
    bound_ms = 1e3 * flops / BF16_OPS_PER_S
    print(f"[segnet] standard: {n_params} parameters, .caffemodel of "
          f"{os.path.getsize(path) / 1e6:.1f} MB loaded back equal; "
          f"{h}x{w} MC={s} {cfg.semantic.cnn_dtype}: sum err "
          f"{sum_err:.2e}, pixels not class 0: {non_static}, max entropy "
          f"{ent_max:.3g} bits")
    print(f"[segnet] standard: {ms:.3f} ms per segment_image; its "
          f"convolutions {flops / 1e12:.3f} TFLOP, {bound_ms:.3f} ms at "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16, "
          f"{bound_ms / ms:.3f} of that bound")
    _need(sum_err <= 1e-3, f"SegNet standard: probabilities sum off by "
          f"{sum_err}")
    _need(non_static == 0, f"SegNet standard: {non_static} pixels not "
          "class 0")
    _need(ent_max <= 1e-3, f"SegNet standard: entropy {ent_max} bits")
    return {"caffemodel": path, "parameters": n_params, "ms": ms,
            "tflop": flops / 1e12, "bf16_bound_ms": bound_ms}


# the JAX package's recipe on the CPU with eight seeds (0: the unchanged
# tools/train_bench_segnet.py): holdout accuracy and entropy (phase 3c);
# and its command line on each network with semantics on and its host
# fetches landed on return (the card's regime; phase 8 run C), once on
# each descriptor path ("descriptors", as in REF_SYSTEM; run C gates on
# "k1"): tools/cnn40_jax_reference.py [--k1], one value per seed
REF_CNN = {"holdout_acc": (0.868, 0.817, 0.877, 0.862, 0.789, 0.817, 0.811,
                           0.834),
           "holdout_entropy": (0.8997, 0.564, 0.4824, 0.6366, 0.4649, 0.6855,
                               0.4595, 0.5324),
           "cli": {
               "xla": {"descriptors": "xla", "landed": True,
                       "ate": (0.0112, 0.0112, 0.0097, 0.0126, 0.0149,
                               0.0109, 0.0086, 0.0115),
                       "keyframes": (16, 17, 17, 14, 18, 17, 17, 17),
                       "lost": (0, 0, 0, 0, 0, 0, 0, 0),
                       "pixel_acc": (0.84, 0.8416, 0.8827, 0.8736, 0.8277,
                                     0.8433, 0.8372, 0.8603),
                       "entropy": (0.9255, 0.5625, 0.4723, 0.631, 0.4818,
                                   0.7399, 0.4498, 0.5468),
                       "gate_share": (0.9982, 0.9981, 1.0, 0.9987, 0.9911,
                                      0.9942, 0.9946, 0.9996)},
               "k1": {"descriptors": "k1", "landed": True,
                      "ate": (0.0114, 0.01, 0.0117, 0.0147, 0.0101, 0.0097,
                              0.0105, 0.0095),
                      "keyframes": (15, 17, 17, 16, 15, 16, 17, 17),
                      "lost": (0, 0, 0, 0, 0, 0, 0, 0),
                      "pixel_acc": (0.84, 0.8416, 0.8827, 0.8736, 0.8277,
                                    0.8433, 0.8372, 0.8603),
                      "entropy": (0.9255, 0.5625, 0.4723, 0.631, 0.4818,
                                  0.7399, 0.4498, 0.5468),
                      "gate_share": (0.9982, 0.9981, 1.0, 0.9987, 0.9911,
                                     0.9942, 0.9946, 0.9996)}}}
TRAIN_SEEDS = (0, 1, 2, 3)  # the first seed's network drives run C
HOLDOUT_ACC_TOL = 0.05
HOLDOUT_ENTROPY_TOL = 0.10
TRAIN_TIMED_FROM = 10  # steps before it are warm-up (cuDNN's first calls)
TRACE_STEPS = 5


def _timed_train_step() -> tuple[list, callable]:
    """A ``train.train_step`` that records CUDA events around each step:
    (the (start, end) event pairs, the wrapper)."""
    step, events = train.train_step, []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(*args, **kwargs)
        end.record()
        events.append((start, end))
        return loss

    return events, timed


def train_busy_share(model, left_u8, cls_all, dev, work) -> dict:
    """``TRACE_STEPS`` training steps of a copy of the trained model with
    a fresh Adam (its first step outside the trace), their batches
    uploaded beforehand, under ``profiling.device_trace``: the device
    kernels' busy share from the first kernel's start to the last's end
    (``profiling.kernel_busy``)."""
    imgs, labels = train_bench_segnet.training_set(left_u8, cls_all)
    probe = copy.deepcopy(model)
    opt = torch.optim.Adam(probe.parameters(), lr=train_bench_segnet.LR)
    weights = torch.from_numpy(train.class_balance_weights(
        labels, probe.num_classes)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    b = train_bench_segnet.BATCH
    batches = [(torch.from_numpy(imgs[i:i + b]).to(dev),
                torch.from_numpy(labels[i:i + b].astype(np.int64)).to(dev))
               for i in range(0, b * (TRACE_STEPS + 1), b)]
    train.train_step(probe, opt, *batches[0], weights, gen)
    torch.cuda.synchronize()
    trace_dir = os.path.join(work, "train_trace")
    with profiling.device_trace(trace_dir):
        for img_b, lab_b in batches[1:]:
            train.train_step(probe, opt, img_b, lab_b, weights, gen)
    return profiling.kernel_busy(os.path.join(trace_dir,
                                              profiling.TRACE_FILE))


def reference_frames(shape) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The frames the JAX recipe trained on (``TRAINING_FRAMES``, written
    by ``tools/cnn40_jax_reference.py``) as lap arrays of ``shape``
    (frame i at index i, other rows zero): (indices, left u8, classes)."""
    z = np.load(TRAINING_FRAMES)
    left, cls = np.zeros(shape, np.uint8), np.zeros(shape, np.uint8)
    left[z["index"]], cls[z["index"]] = z["left"], z["cls"]
    return z["index"], left, cls


def train_seeds(name, left_u8, cls_all, dev, cnn_dtype, first=None):
    """SegNet basic trained on ``left_u8`` / ``cls_all`` once per seed of
    ``TRAIN_SEEDS`` (``first``: the first seed's (model, losses), already
    trained), each network's ``train_bench_segnet.holdout`` in
    ``cnn_dtype``; every seed's loss must fall and its posterior beat a
    predictor of the holdout frame's majority class, with an entropy
    above 1e-3 bits and an MC variance in [0, 1/3]."""
    i = train_bench_segnet.HOLDOUT
    majority = float(np.bincount(cls_all[i].ravel()).max() / cls_all[i].size)
    seeds = []
    for seed in TRAIN_SEEDS:
        if seed == TRAIN_SEEDS[0] and first is not None:
            model, losses = first
        else:
            model, losses = train_bench_segnet.train_on_frames(
                left_u8, cls_all, seed=seed, device=dev)
        losses = losses.cpu().numpy()
        got = train_bench_segnet.holdout(model, left_u8[i], cls_all[i],
                                         cnn_dtype)
        got.update(seed=seed, loss_first10=float(losses[:10].mean()),
                   loss_last10=float(losses[-10:].mean()))
        seeds.append(got)
        print(f"[train] {name}, seed {seed}: loss of the first 10 steps "
              f"{got['loss_first10']:.4f}, of the last 10 "
              f"{got['loss_last10']:.4f}; holdout frame {i} at full size, "
              f"MC={train_bench_segnet.MC_SAMPLES}, {cnn_dtype}: pixel "
              f"accuracy {got['acc']:.4f}, mean entropy "
              f"{got['entropy']:.4f} bits, variance in "
              f"[{got['var_min']:.3g}, {got['var_max']:.3g}]")
        _need(bool(np.isfinite(losses).all()),
              f"{name}, seed {seed}: training loss not finite")
        _need(got["loss_last10"] < got["loss_first10"],
              f"{name}, seed {seed}: loss did not fall")
        _need(got["acc"] > majority, f"{name}, seed {seed}: accuracy "
              f"{got['acc']:.4f}, a majority-class predictor {majority:.4f}")
        _need(got["entropy"] > 1e-3, f"{name}, seed {seed}: mean entropy "
              f"{got['entropy']} bits: certain-static")
        _need(got["var_finite"] and got["var_min"] >= 0.0
              and got["var_max"] <= 1.0 / 3.0 + 1e-6,
              f"{name}, seed {seed}: variance in [{got['var_min']}, "
              f"{got['var_max']}]")
    acc = statistics.median(g["acc"] for g in seeds)
    ent = statistics.median(g["entropy"] for g in seeds)
    print(f"[train] {name}, {len(seeds)} seeds: median holdout accuracy "
          f"{acc:.4f}, median mean entropy {ent:.4f} bits; a predictor of "
          f"the holdout frame's majority class scores {majority:.4f}")
    return {"majority": majority, "acc_median": acc, "entropy_median": ent,
            "seeds": seeds}


def phase_train(cfg: SystemConfig, left_all, cls_all, dev,
                work: str) -> dict:
    """Phase 3c: SegNet basic trained on the card by
    ``train_bench_segnet.train_on_frames`` (the JAX tool's recipe) once
    per seed of ``TRAIN_SEEDS`` on the frames the JAX recipe trained on,
    the first seed's run timed per step and its ``.caffemodel`` written
    and read back; their holdout medians held to the JAX recipe's seeds.
    The share of those frames' pixels this machine renders otherwise is
    printed. Returns the file's path and the numbers."""
    index, ref_left, ref_cls = reference_frames(np.shape(left_all))
    card_left = np.asarray(left_all).astype(np.uint8)  # the recipe's type
    card_cls = np.asarray(cls_all)
    differ = float(np.mean(card_left[index] != ref_left[index]))
    cls_differ = float(np.mean(card_cls[index] != ref_cls[index]))
    print(f"[train] this machine's render of the recipe's {len(index)} "
          f"frames against the JAX recipe's: gray levels differ at "
          f"{differ:.4f} of the pixels, classes at {cls_differ:.4f}")
    cnn_dtype = segnet.dtype_of(cfg.semantic.cnn_dtype)
    events, timed = _timed_train_step()
    step = train.train_step
    train.train_step = timed
    t0 = time.perf_counter()
    try:
        model, losses = train_bench_segnet.train_on_frames(
            ref_left, ref_cls, seed=TRAIN_SEEDS[0], device=dev)
        torch.cuda.synchronize()
    finally:
        train.train_step = step
    total_s = time.perf_counter() - t0
    step_ms = statistics.median([a.elapsed_time(z)
                                 for a, z in events[TRAIN_TIMED_FROM:]])
    b = train_bench_segnet.BATCH
    h, w = ref_left.shape[1] // 2, ref_left.shape[2] // 2
    flops = 3 * b * segnet.conv_flops("basic", h, w, 1)
    bound_ms = 1e3 * flops / F32_OPS_PER_S
    busy = train_busy_share(model, ref_left, ref_cls, dev, work)
    share = busy["busy_ms"] / busy["window_ms"] if busy["kernels"] else None
    print(f"[train] SegNet basic, {len(losses)} steps of batch {b} at "
          f"{h}x{w} float32, seed {TRAIN_SEEDS[0]}: {total_s:.1f} s in "
          f"all, median {step_ms:.3f} ms per step (CUDA events, steps "
          f"{TRAIN_TIMED_FROM}-{len(losses) - 1})")
    print(f"[train] bound: 3 x forward convolutions {flops / 1e12:.3f} TFLOP "
          f"per step at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s float32 = "
          f"{bound_ms:.3f} ms, {bound_ms / step_ms:.3f} of it")
    print(f"[train] profiler over {TRACE_STEPS} steps after warm-up: "
          f"{busy['kernels']} kernels, device busy {busy['busy_ms']:.3f} ms "
          f"of a {busy['window_ms']:.3f} ms span"
          + (f", busy share {share:.3f}" if share is not None else
             " (no kernel events: busy share not measured)"))

    path = os.path.join(work, "trained.caffemodel")
    train_bench_segnet.save(model, path)
    nc = model.num_classes
    loaded = caffe_io.state_dict_from_caffemodel(
        path, "basic", segnet.init_params(seed=1, num_classes=nc))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    _need(loaded.keys() == state.keys()
          and all(torch.equal(loaded[k], state[k]) for k in state),
          "trained SegNet: the .caffemodel did not load to the state "
          "trained")
    i = train_bench_segnet.HOLDOUT
    acc_f32 = train_bench_segnet.holdout(model, ref_left[i], ref_cls[i])["acc"]
    print(f"[train] .caffemodel of {os.path.getsize(path) / 1e6:.1f} MB "
          f"loaded back equal; seed {TRAIN_SEEDS[0]}'s holdout accuracy in "
          f"float32 {acc_f32:.4f}")

    ref = train_seeds("the JAX recipe's frames", ref_left, ref_cls, dev,
                      cnn_dtype, first=(model, losses))
    ref_acc = statistics.median(REF_CNN["holdout_acc"])
    ref_ent = REF_CNN["holdout_entropy"]
    floor = ref_acc - HOLDOUT_ACC_TOL
    print(f"[train] JAX recipe, seeds 0-{len(REF_CNN['holdout_acc']) - 1}: "
          f"holdout accuracy {REF_CNN['holdout_acc']} (median "
          f"{ref_acc:.4f}), mean entropy {ref_ent}; the gates: median "
          f"accuracy >= {floor:.4f}, median entropy in "
          f"[{min(ref_ent) - HOLDOUT_ENTROPY_TOL:.4f}, "
          f"{max(ref_ent) + HOLDOUT_ENTROPY_TOL:.4f}]")
    _need(floor > ref["majority"], f"the holdout gate {floor:.4f} passes a "
          f"majority-class predictor ({ref['majority']:.4f})")
    _need(ref["acc_median"] >= floor, f"median holdout accuracy "
          f"{ref['acc_median']:.4f} below {floor:.4f}")
    _need(min(ref_ent) - HOLDOUT_ENTROPY_TOL <= ref["entropy_median"]
          <= max(ref_ent) + HOLDOUT_ENTROPY_TOL,
          f"median holdout entropy {ref['entropy_median']:.4f} bits, "
          f"expected within {HOLDOUT_ENTROPY_TOL} of the JAX recipe's "
          f"{ref_ent}")
    return {"caffemodel": path, "steps": len(losses), "total_s": total_s,
            "step_ms": step_ms, "step_bound_ms": bound_ms,
            "busy_share": share, "holdout_acc_f32": acc_f32,
            "render_differs": differ, "render_classes_differ": cls_differ,
            "reference_frames": ref}


def run_slice(cfg, statics, model, left, right, sems, dev,
              count_syncs: bool = False):
    """The port's main path: build_frame -> Tracker.track, no mapper.
    Returns (tracker, poses, frontend ms, tracking ms, device syncs)."""
    frame_gen = torch.Generator(device=dev).manual_seed(2)
    tracker = Tracker(cfg=cfg, map=MapState(
        max_keyframes=256, max_points=32768,
        kp_capacity=cfg.orb.max_keypoints), device=dev, seed=0)
    est, t_front, t_track = [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(len(left)):
                cls, conf, ent = sems[i]
                torch.cuda.synchronize()
                t_a = time.perf_counter()
                f = frame_mod.build_frame(
                    model, statics, left[i], right[i], frame_gen,
                    sem_override=(cls, conf, ent, False), device=dev)
                torch.cuda.synchronize()
                t_b = time.perf_counter()
                est.append(tracker.track(f, timestamp=i * 0.1))
                torch.cuda.synchronize()
                t_c = time.perf_counter()
                t_front.append(1e3 * (t_b - t_a))
                t_track.append(1e3 * (t_c - t_b))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return tracker, est, t_front, t_track, syncs


@contextlib.contextmanager
def k2_recorder(n_frames: int):
    """Keep a copy of K2's inputs at the last call of each of its three
    searches of the slice while the block runs. Yields ({name: (a, b,
    row, col, use_ur)}, each checked to be (2048, 2048) at the end;
    {name: calls per frame}, filled at the end)."""
    top2 = kernel_match.masked_hamming_top2
    searches = {name: getattr(matching, fn) for name, fn in SEARCHES.items()}
    cases, per_frame, current = {}, {}, [None]
    calls = dict.fromkeys(SEARCHES, 0)

    def record(a_u8, b_u8, row, col, use_ur=True):
        cases[current[0]] = (*(t.clone() for t in (a_u8, b_u8, row, col)),
                             use_ur)
        calls[current[0]] += 1
        return top2(a_u8, b_u8, row, col, use_ur)

    def tagged(name):
        def search(*args, **kwargs):
            current[0] = name
            return searches[name](*args, **kwargs)
        return search

    kernel_match.masked_hamming_top2 = record
    for name, fn in SEARCHES.items():
        setattr(matching, fn, tagged(name))
    try:
        yield cases, per_frame
    finally:
        kernel_match.masked_hamming_top2 = top2
        for name, fn in SEARCHES.items():
            setattr(matching, fn, searches[name])
    _need(set(cases) == set(SEARCHES), f"K2 searches seen: {sorted(cases)}")
    for name, (a_u8, b_u8, *_) in cases.items():
        shape = (a_u8.shape[0], b_u8.shape[0])
        _need(shape == (2048, 2048), f"K2 {name} shape {shape}")
    per_frame.update({name: c / n_frames for name, c in calls.items()})


def k2_bound(a_u8, b_u8, row, col, use_ur) -> tuple[float, str, float]:
    """K2's bound on these inputs: the bytes of inputs and outputs, and
    the window tests (10 float ops with the right-u test, 7 without) of
    every valid row against every column. The distances of the pairs
    that pass are 256-bit AND + popcount on the tensor cores (b1 mma);
    NVIDIA publishes no b1 rate for the H100, so they are left out and
    the bound holds whatever that rate is. Returns (bound ms, bound_by,
    share of pairs passing)."""
    n, m = a_u8.shape[0], b_u8.shape[0]
    passing = int(kernel_match.pair_mask(row, col, use_ur).sum())
    valid_rows = int((row[:, 6] > 0.5).sum())
    nbytes = 32 * n + 32 * m + 4 * row.numel() + 4 * col.numel() + 16 * n
    bound_ms, bound_by = _bound(nbytes, valid_rows * m * (10 if use_ur else 7))
    return bound_ms, bound_by, passing / (n * m)


def phase_k2(cases: dict, calls_per_frame: dict) -> dict:
    """Phase 4: K2 against its plain version in each case."""
    per_case, err = {}, 0.0
    for name, args in cases.items():
        out_k = kernel_match.masked_hamming_top2_cuda(*args)
        out_p = kernel_match.masked_hamming_top2_plain(*args)
        torch.cuda.synchronize()
        for label, k, p in zip(("best_d", "second_d", "best_j", "second_j"),
                               out_k, out_p):
            _need(torch.equal(k, p), f"K2 {name}: {label} differs in "
                  f"{int((k != p).sum())} rows")
        fin = torch.isfinite(out_p[0])
        if bool(fin.any()):
            err = max(err, float((out_k[0] - out_p[0])[fin].abs().max()))
        t_k = _kernel_ms(lambda: kernel_match.masked_hamming_top2_cuda(*args))
        t_p = _plain_ms(lambda: kernel_match.masked_hamming_top2_plain(*args))
        bound_ms, bound_by, share = k2_bound(*args)
        per_case[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms,
                          "bound_by": bound_by,
                          "calls_per_frame": calls_per_frame[name]}
        valid = float((args[2][:, 6] > 0.5).float().mean())
        print(f"[K2] {name} ({calls_per_frame[name]:.3f} calls per frame): "
              f"equal ({valid:.3f} of rows valid, finite best in "
              f"{float(fin.float().mean()):.3f}, {share:.4f} of pairs "
              f"pass); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / t_k:.3f} of bound")
    # the headline numbers are those of the case with the median time
    order = sorted(per_case, key=lambda c: per_case[c]["ms"])
    mid = order[len(order) // 2]
    return {"max_abs_err": err, **per_case[mid], "case": mid,
            "cases": per_case}


def phase_slice(cfg, statics, model, gt, left, right, sems, dev):
    """Phase 5: the slice, timed with torch's sync debug mode on (a
    warning per sync costs the host microseconds against a frame's
    hundreds of milliseconds) and the launch counters read around it,
    then checked against the JAX package's CPU run. The run keeps phase
    4's motion, local map and brute force cases (``k2_recorder``).
    Returns (launches, K2 cases, their calls per frame)."""
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    solve, pose_case = pose_lm.optimize_pose, {}

    def kept_solve(T, obs, cam, rounds=4, iterations=10):
        pose_case["args"] = (T.clone(), pose_lm.PoseObservations(
            *(t.clone() for t in obs)), cam, rounds, iterations)
        return solve(T, obs, cam, rounds, iterations)

    pose_lm.optimize_pose = kept_solve
    try:
        with k2_recorder(len(left)) as (cases, calls):
            tracker, est, t_front, t_track, syncs = run_slice(
                cfg, statics, model, left, right, sems, dev,
                count_syncs=True)
    finally:
        pose_lm.optimize_pose = solve
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20

    n = len(left)
    lost = sum(p is None for p in est)
    tracked = [i for i, p in enumerate(est) if p is not None]
    poses = np.stack([est[i] for i in tracked])
    _need(np.isfinite(poses).all(), "non-finite pose")
    ate = synthetic.ate_rmse(poses, gt[tracked])
    n_kf, n_pts = tracker.map.n_keyframes, tracker.map.n_points
    frame_ms = [a + b for a, b in zip(t_front, t_track)]
    print(f"[slice] {n} frames: lost {lost}, ATE {ate:.4f} m, keyframes "
          f"{n_kf}, map points {n_pts} (JAX CPU reference: 0 lost, ATE "
          "0.0145 m, 12 keyframes, 875 points)")
    print(f"[slice] per-frame median {statistics.median(frame_ms):.2f} ms "
          f"(frontend {statistics.median(t_front):.2f} ms, tracking "
          f"{statistics.median(t_track[1:]):.2f} ms over tracked frames)")
    print(f"[slice] device syncs per frame {syncs / n:.2f} ({syncs} over "
          f"{n} frames, torch sync-debug count); peak device memory "
          f"{peak_mb:.1f} MiB")
    print(f"[slice] launches: K1 {launches['k1']} (2 x {n} frames), K2 "
          f"{launches['k2']} over {len(tracked) - 1} tracked frames")
    _need(lost == 0, f"{lost} frames lost")
    _need(ate <= 0.10, f"ATE {ate:.4f} m > 0.10 m")
    _need(abs(n_kf - 12) <= 3, f"{n_kf} keyframes, expected 12 +- 3")
    _need(launches["k1"] == 2 * n, f"K1 launched {launches['k1']} times")
    _need(launches["k2"] >= len(tracked) - 1,
          f"K2 launched {launches['k2']} times")
    pose_graph_check(pose_case["args"])
    return launches, cases, calls


def pose_graph_check(args) -> None:
    """The slice's last pose LM call again: its CUDA graph's replay
    (``optimize_pose``) must equal the eager solve bit for bit; host ms
    of each (wall, median of 5 calls ended by a sync)."""
    out = {}
    for name, fn in (("graph", pose_lm.optimize_pose),
                     ("eager", pose_lm.optimize_pose_eager)):
        fn(*args)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = (res, statistics.median(times))
    (g, g_ms), (e, e_ms) = out["graph"], out["eager"]
    print(f"[slice] pose LM ({args[1].points.shape[0]} observations, "
          f"{args[3]} rounds x {args[4]} iterations): CUDA graph replay "
          f"{g_ms:.2f} ms, eager {e_ms:.2f} ms per call (wall)")
    for name, a, b in zip(g._fields, g, e):
        _need(torch.equal(a, b), f"pose LM graph: {name} differs from the "
              "eager solve")



# The reference tables hold the JAX package's CPU runs on the same
# frames, one entry per run. "descriptors" names its descriptor path:
# "xla" its CPU XLA path (float canvases), "k1" its kernel K1's
# semantics (u8 canvases), as the port's kernel computes them (the
# tools' --k1); "landed" its timing: every host fetch landed when it
# returns, the card's regime (--landed), or as the CPU times it. The
# phases gate on the "k1" runs; the "xla" ones are printed beside them.
# loop40 (phase 6): tools/loop40_jax_reference.py
REF_SYSTEM = {
    "xla_a": {"descriptors": "xla", "landed": False, "lost": 0,
              "ate": 0.0150, "keyframes": 12, "ba_solves": 8,
              "triangulated": 0},
    "xla_b": {"descriptors": "xla", "landed": False, "lost": 0,
              "ate": 0.0080, "keyframes": 13, "ba_solves": 8,
              "triangulated": 1},
    "k1_landed_a": {"descriptors": "k1", "landed": True, "lost": 0,
                    "ate": 0.0088, "keyframes": 13, "ba_solves": 12,
                    "triangulated": 1},
    "k1_landed_b": {"descriptors": "k1", "landed": True, "lost": 0,
                    "ate": 0.0088, "keyframes": 13, "ba_solves": 12,
                    "triangulated": 1},
}
# the minting run: its frames and its entropy-reduction gate, the one
# tests/test_compact.py and the port's session tests use
MINT_FRAMES, MINT_TH_ENTROPY = 12, 0.02


def session_stats(system, gt) -> dict:
    """Lost frames, ATE over ``frame_poses()``, keyframes, BA solves and
    points minted by triangulation of a flushed session."""
    poses = system.frame_poses()
    _need(poses.shape == (len(gt), 4, 4) and np.isfinite(poses).all(),
          f"frame_poses {poses.shape}")
    return {"lost": system.n_lost(), "ate": synthetic.ate_rmse(poses, gt),
            "keyframes": system.map.n_keyframes,
            "ba_solves": system.mapper.ba_solves,
            "triangulated": system.mapper.points_triangulated}


def _stats_text(s: dict) -> str:
    return (f"lost {s['lost']}, ATE {s['ate']:.4f} m, keyframes "
            f"{s['keyframes']}, BA solves {s['ba_solves']}, triangulated "
            f"{s['triangulated']}")


def loop_system(cfg, dev, vocabulary=None) -> System:
    """Phases 6-7's ``System``; with a ``vocabulary``, attached after
    construction (loop closing and relocalization)."""
    system = System(cfg=cfg, device=dev, max_keyframes=256,
                    max_points=32768)
    if vocabulary is not None:
        system.attach_vocabulary(vocabulary)
    return system


def run_system(cfg, left, right, sems, dev, count_syncs: bool = False,
               vocabulary=None, system=None):
    """The port's SLAM session: ``System.track_stereo`` on each frame
    (host clock between device syncs), then ``flush``, on ``system`` or
    a new ``loop_system(cfg, dev, vocabulary)``. With ``count_syncs``
    torch's sync debug mode is on and the syncs raised inside the
    mapper's ``advance`` are counted apart. Returns (system, per-frame
    ms, sync warnings, syncs inside the mapper)."""
    if system is None:
        system = loop_system(cfg, dev, vocabulary)
    frame_ms, in_mapper, depth = [], [0], [0]
    advance = LocalMapper.advance

    def is_sync(w):
        return "synchroniz" in str(w.message)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted_advance(self, tracker, block=False):
            before = len(caught)
            depth[0] += 1  # advance(block=True) calls itself
            try:
                return advance(self, tracker, block)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    in_mapper[0] += sum(map(is_sync, caught[before:]))

        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
            LocalMapper.advance = counted_advance
        try:
            for i in range(len(left)):
                cls, conf, ent = sems[i]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                system.track_stereo(left[i], right[i], i * 0.1,
                                    sem_override=(cls, conf, ent, False))
                torch.cuda.synchronize()
                frame_ms.append(1e3 * (time.perf_counter() - t0))
            system.flush()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            LocalMapper.advance = advance
    return system, frame_ms, [w for w in caught if is_sync(w)], in_mapper[0]


def capture_system_cases(cfg, gt, left, right, sems, dev):
    """Phase 6's warm-up, the minting run: the session on the first
    ``MINT_FRAMES`` frames with the entropy-reduction gate at
    ``MINT_TH_ENTROPY``, so that triangulation mints points at full
    width; it keeps a copy of K2's inputs at the last fusion search and
    of the last local BA problem, and the host map and the device map
    must then hold the same points (the id lockstep). Returns (K2 fusion
    case, BA problem)."""
    top2 = kernel_match.masked_hamming_top2
    fuse_search = LocalMapper._fuse_search
    solve = local_ba.local_bundle_adjustment
    kept, in_fusion = {}, [False]

    def record(a_u8, b_u8, row, col, use_ur=True):
        if in_fusion[0]:
            kept["k2"] = (*(t.clone() for t in (a_u8, b_u8, row, col)),
                          use_ur)
        return top2(a_u8, b_u8, row, col, use_ur)

    def tagged_fuse_search(self, *args, **kwargs):
        in_fusion[0] = True
        try:
            return fuse_search(self, *args, **kwargs)
        finally:
            in_fusion[0] = False

    def kept_solve(prob, newest, cam):
        kept["ba"] = (local_ba.BAProblem(*(t.clone() for t in prob)),
                      newest, cam)
        return solve(prob, newest, cam)

    mint_cfg = dataclasses.replace(cfg, semantic=dataclasses.replace(
        cfg.semantic, th_entropy_reduction=MINT_TH_ENTROPY))
    k = MINT_FRAMES
    kernel_match.masked_hamming_top2 = record
    LocalMapper._fuse_search = tagged_fuse_search
    local_ba.local_bundle_adjustment = kept_solve
    try:
        system = run_system(mint_cfg, left[:k], right[:k], sems[:k], dev)[0]
    finally:
        kernel_match.masked_hamming_top2 = top2
        LocalMapper._fuse_search = fuse_search
        local_ba.local_bundle_adjustment = solve
    _need("k2" in kept and "ba" in kept,
          f"phase 6 warm-up ran fusion/BA: {sorted(kept)}")
    shape = (kept["k2"][0].shape[0], kept["k2"][1].shape[0])
    _need(shape == (2048, 2048), f"K2 fusion shape {shape}")
    stats = session_stats(system, gt[:k])
    m, dm = system.map, system.tracker.dmap
    n_pts = m.n_points
    dev_valid = dm.pt_valid[:n_pts].cpu().numpy()
    pos_err = float(np.abs(dm.pt_pos[:n_pts].cpu().numpy()
                           - m.pt_pos[:n_pts]).max()) if n_pts else 0.0
    print(f"[system] minting run ({k} frames, entropy gate "
          f"{MINT_TH_ENTROPY}; the warm-up): {_stats_text(stats)}; map "
          f"points host {n_pts}, device {int(dm.n_points)}, position max "
          f"diff {pos_err:.3g} m")
    _need(stats["lost"] == 0, f"minting run: {stats['lost']} frames lost")
    _need(stats["triangulated"] > 0, "minting run: triangulation minted "
          "no point")
    _need(int(dm.n_points) == n_pts
          and np.array_equal(dev_valid, m.pt_valid[:n_pts]),
          "minting run: host and device maps differ")
    _need(pos_err <= 1e-6, f"minting run: positions differ by {pos_err}")
    return kept["k2"], kept["ba"]


def ba_cost(ba_case) -> dict:
    """One local BA solve replayed on the kept problem: stream ms per
    solve (CUDA events around the eager call, host launch gaps included,
    median of 5), and under torch.profiler the device activities it
    launches and their summed device time."""
    prob, newest, cam = ba_case

    def solve():
        return local_ba.local_bundle_adjustment(prob, newest, cam)

    stream_ms = statistics.median(_run_times(solve, runs=5, batch=1,
                                             warmup=1))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    n_obs = int(prob.obs_valid.sum())
    n_kf = int(prob.kf_valid.sum())
    print(f"[system] BA replay ({n_kf} keyframes, {n_obs} observations): "
          f"{stream_ms:.2f} ms per solve on the stream, "
          + (f"{len(device)} device launches, {busy_ms:.3f} ms device busy "
             "(profiler)" if device else
             "launches and device busy: not measured (no profiler events)"))
    return {"stream_ms": stream_ms, "launches": len(device) or None,
            "busy_ms": busy_ms if device else None}


def phase_system(cfg, gt, left, right, sems, dev, ba_case) -> dict:
    """Phase 6: the session, timed with torch's sync debug mode on and
    the launch counters set to 0 just before it and read just after,
    then its outputs and gates (its warm-up, the minting run, is
    ``capture_system_cases``)."""
    n = len(left)
    mapper_k2 = [0]
    fuse_dispatch = LocalMapper._fuse_dispatch

    def counted_fuse_dispatch(self, *args, **kwargs):
        before = kernel_match.LAUNCHES
        try:
            return fuse_dispatch(self, *args, **kwargs)
        finally:
            mapper_k2[0] += kernel_match.LAUNCHES - before

    torch.cuda.reset_peak_memory_stats(dev)
    LocalMapper._fuse_dispatch = counted_fuse_dispatch
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    try:
        system, frame_ms, syncs, mapper_syncs = run_system(
            cfg, left, right, sems, dev, count_syncs=True)
    finally:
        LocalMapper._fuse_dispatch = fuse_dispatch
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES,
                "k2_mapper": mapper_k2[0]}
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20

    m, mapper = system.map, system.mapper
    stats = session_stats(system, gt)
    ate, lost, n_kf = stats["ate"], stats["lost"], stats["keyframes"]
    live = int(m.pt_valid[: m.n_points].sum())
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "CameraTrajectory.txt")
        counts = os.path.join(tmp, "keyframes_points.txt")
        system.save_trajectory_kitti(traj)
        system.shutdown(counts)
        with open(traj) as f:
            traj_lines = f.read().splitlines()
        with open(counts) as f:
            counts_text = f.read()
    timer = system.timer
    print(f"[system] {n} frames: {_stats_text(stats)} (ATE over "
          f"frame_poses), map points {m.n_points} ({live} live); JAX CPU "
          "reference runs: " + _ref_text(REF_SYSTEM))
    print(f"[system] track_stereo per-frame median "
          f"{statistics.median(frame_ms):.2f} ms (mean "
          f"{statistics.mean(frame_ms):.2f}, max {max(frame_ms):.2f}); peak "
          f"device memory {peak_mb:.1f} MiB; cap binds {mapper.cap_binds}")
    print("\n".join("[system] " + row for row in timer.summary().splitlines()))
    print(f"[system] launches: K1 {launches['k1']} (2 x {n} frames), K2 "
          f"{launches['k2']} ({launches['k2_mapper']} from the mapper's "
          f"fusion, which counted {mapper.fuse_searches} searches)")
    ba = ba_cost(ba_case)
    print(f"[system] device syncs: {len(syncs) / n:.2f} per frame "
          f"({len(syncs)} over {n} frames); inside the mapper "
          f"{mapper_syncs} over {n_kf} keyframes "
          f"({mapper_syncs / max(n_kf, 1):.2f} per keyframe)")
    for (path, line), c in Counter((os.path.basename(w.filename), w.lineno)
                                   for w in syncs).most_common():
        print(f"[system] syncs at {path}:{line}: {c}")

    _need(lost <= max(_k1(REF_SYSTEM, "lost")), f"{lost} frames lost")
    _need(ate <= 0.10, f"ATE {ate:.4f} m > 0.10 m")
    ref_kf = _k1(REF_SYSTEM, "keyframes")
    _need(min(ref_kf) - 3 <= n_kf <= max(ref_kf) + 3,
          f"{n_kf} keyframes, expected within 3 of {ref_kf}")
    _need(mapper.ba_solves >= 1, "no BA solve applied")
    _need(timer.counts.get("map.triangulate", 0) >= 1,
          "triangulation never ran")
    _need(launches["k1"] == 2 * n, f"K1 launched {launches['k1']} times")
    _need(launches["k2_mapper"] == mapper.fuse_searches > 0,
          f"mapper K2 launches {launches['k2_mapper']} vs fusion searches "
          f"{mapper.fuse_searches}")
    _need(len(traj_lines) == n, f"{len(traj_lines)} trajectory lines")
    _need(all(len(line.split()) == 12 for line in traj_lines),
          "trajectory line format")
    _need(counts_text.startswith(f"Final number of keyframes: {n_kf}\n"),
          f"counts file: {counts_text!r}")
    return {"launches": launches, "frame_ms": statistics.median(frame_ms),
            "syncs_per_frame": len(syncs) / n,
            "mapper_syncs_per_keyframe": mapper_syncs / max(n_kf, 1),
            "peak_mb": peak_mb, "ba": ba}


# loop190 (phase 7), the JAX package's CPU System with the offline
# vocabulary on the 190 frames: tools/loop190_jax_reference.py; the
# "k1" runs as the CPU times them, every one in the order run (k1_e and
# k1_f lost the frame after their loop closure, at the tracking
# policy's margin, as the card's runs do now and then)
REF_LOOP = {
    "xla_a": {"descriptors": "xla", "landed": False, "loops": 1, "lost": 0,
              "ate": 0.0361, "keyframes": 49},
    "xla_b": {"descriptors": "xla", "landed": False, "loops": 1, "lost": 1,
              "ate": 0.0530, "keyframes": 46},
    "k1_landed_a": {"descriptors": "k1", "landed": True, "loops": 1,
                    "lost": 0, "ate": 0.0490, "keyframes": 47},
    "k1_landed_b": {"descriptors": "k1", "landed": True, "loops": 1,
                    "lost": 0, "ate": 0.0490, "keyframes": 47},
    "k1_a": {"descriptors": "k1", "landed": False, "loops": 1, "lost": 0,
             "ate": 0.0354, "keyframes": 46},
    "k1_b": {"descriptors": "k1", "landed": False, "loops": 1, "lost": 0,
             "ate": 0.0264, "keyframes": 49},
    "k1_c": {"descriptors": "k1", "landed": False, "loops": 1, "lost": 0,
             "ate": 0.0254, "keyframes": 47},
    "k1_d": {"descriptors": "k1", "landed": False, "loops": 1, "lost": 0,
             "ate": 0.0282, "keyframes": 48},
    "k1_e": {"descriptors": "k1", "landed": False, "loops": 1, "lost": 1,
             "ate": 0.054, "keyframes": 46},
    "k1_f": {"descriptors": "k1", "landed": False, "loops": 1, "lost": 1,
             "ate": 0.0546, "keyframes": 47},
}
KIDNAP_FRAME = 2


def _center(T: np.ndarray) -> np.ndarray:
    T = T.astype(np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def run_loop_session(cfg, left, right, sems, dev, voc):
    """Phase 7's run, with the launch counters set to 0 just before it
    and read just after, and torch's sync debug mode on (a warning per
    sync costs the host microseconds against a frame's hundreds of
    milliseconds); keeps a copy of K2's inputs at the last call of the
    loop closer's guided ``search_by_sim3`` and a record of every frame
    retired (``FrameLog``; its window is printed if the run raises).
    Returns (system, per-frame ms, launches, sync warnings, K2 sim3
    case, sim3 searches per frame, the record, the dense global BA's
    problem and camera)."""
    top2 = kernel_match.masked_hamming_top2
    by_sim3 = matching.search_by_sim3
    gba = local_ba.global_bundle_adjustment
    kept, in_sim3 = {}, [False]

    def record(a_u8, b_u8, row, col, use_ur=True):
        if in_sim3[0]:
            kept["k2"] = (*(t.clone() for t in (a_u8, b_u8, row, col)),
                          use_ur)
            kept["calls"] = kept.get("calls", 0) + 1
        return top2(a_u8, b_u8, row, col, use_ur)

    def tagged_by_sim3(*args, **kwargs):
        in_sim3[0] = True
        try:
            return by_sim3(*args, **kwargs)
        finally:
            in_sim3[0] = False

    def kept_gba(prob, cam, iterations=10):
        kept["gba"] = (local_ba.BAProblem(*(t.clone() for t in prob)), cam)
        return gba(prob, cam, iterations=iterations)

    system = loop_system(cfg, dev, voc)
    log = FrameLog(system)
    kernel_match.masked_hamming_top2 = record
    matching.search_by_sim3 = tagged_by_sim3
    local_ba.global_bundle_adjustment = kept_gba
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    try:
        with log:
            system, frame_ms, syncs, _ = run_system(
                cfg, left, right, sems, dev, count_syncs=True,
                system=system)
    except BaseException:
        log.finish()
        log.print_window("[loop]")
        raise
    finally:
        kernel_match.masked_hamming_top2 = top2
        matching.search_by_sim3 = by_sim3
        local_ba.global_bundle_adjustment = gba
    log.finish()
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    _need("k2" in kept, "phase 7 ran no guided search_by_sim3")
    _need("gba" in kept, "phase 7 ran no dense global BA")
    return (system, frame_ms, launches, syncs, kept.get("k2"),
            kept.get("calls", 0) / len(left), log, kept.get("gba"))


def kidnap(system, gt, left, right, sems) -> dict:
    """Teleport the believed pose 4 m along z and sever frame-to-frame
    continuity (tests/test_system_modes.py's kidnap), then replay frame
    ``KIDNAP_FRAME`` twice: the first call is lost, the second must
    relocalize through the keyframe database."""
    tr, dev = system.tracker, system.device
    bogus = tr.last_pose.copy()
    bogus[2, 3] += 4.0
    tr.carry = tr.carry._replace(
        pose=to_device(bogus, dev),
        has_velocity=torch.zeros((), dtype=torch.bool, device=dev),
        pt_idx=torch.full_like(tr.carry.pt_idx, -1))
    tr.last_pose = bogus
    tr._ref_pt_idx = torch.full_like(tr._ref_pt_idx, -1)
    tr._local_ids_dev = torch.full_like(tr._local_ids_dev, -1)
    k = KIDNAP_FRAME
    cls, conf, ent = sems[k]
    before = system.reloc_successes
    t = N_LOOP_FRAMES * 0.1
    p1 = system.track_stereo(left[k], right[k], t,
                             sem_override=(cls, conf, ent, False))
    lost = system.state.name
    p2 = system.track_stereo(left[k], right[k], t + 0.1,
                             sem_override=(cls, conf, ent, False))
    # the session's world is the first camera's frame
    want = _center(gt[k] @ np.linalg.inv(gt[0]))
    err = (float(np.linalg.norm(_center(p2) - want)) if p2 is not None
           else float("inf"))
    print(f"[loop] kidnap: frame {k} replayed twice: first call "
          f"{'lost' if p1 is None else 'tracked'} ({lost}), second "
          f"{'relocalized' if p2 is not None else 'lost'}, "
          f"{err:.4f} m from ground truth; relocalizations "
          f"{system.reloc_successes} of {system.reloc_attempts} attempts, "
          f"candidates {system.reloc_candidates[-1:]}")
    _need(p1 is None and lost == "LOST", "kidnap: first call not lost")
    _need(p2 is not None and err <= 0.5, f"kidnap: relocalization off "
          f"by {err:.4f} m")
    _need(system.reloc_successes > before, "kidnap: no relocalization")
    return {"error_m": err}


def loop_closed_at(log: "FrameLog") -> list[int]:
    """The frames during whose call a loop correction reached the
    tracker (an unpipelined session's closures)."""
    return [r["fid"] for r in log.records
            if any(c[0] == "loop" for c in json.loads(r["reanchor"]))]


def phase_loop(cfg, gt, left, right, sems, dev, work: str) -> dict:
    """Phase 7: the loop session on all 190 frames, its gates against the
    JAX package's CPU runs, the kidnap check and the K2 sim3 case's
    inputs; the run counts its syncs. Its per-frame record is saved as
    ``work/loop_record.npz``; if a frame was lost, its window around
    the first lost frame is printed."""
    voc = voc_mod.load_npz(VOCABULARY)
    n = len(left)
    torch.cuda.reset_peak_memory_stats(dev)
    (system, frame_ms, launches, syncs, sim3_case, sim3_calls, log,
     gba_case) = run_loop_session(cfg, left, right, sems, dev, voc)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    record = os.path.join(work, "loop_record.npz")
    nbytes = log.save(record)
    lost_at = [r["fid"] for r in log.records if r["lost"]]
    closed_at = loop_closed_at(log)
    print(f"[loop] record: {len(log.records)} frames retired, {nbytes} "
          f"bytes in {record}, {log.seconds:.2f} s; lost frames {lost_at}, "
          f"loop corrections at frames {closed_at}")
    if lost_at:
        log.print_window("[loop]")
    lc, m = system.loop_closer, system.map
    raw = np.stack([r.pose for r in system.tracker.trajectory])
    ate_before = synthetic.ate_rmse(raw, gt)
    stats = session_stats(system, gt)
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_kitti(traj)
        system.shutdown(os.path.join(tmp, "keyframes_points.txt"))
        with open(traj) as f:
            traj_lines = f.read().splitlines()
    launches.update(loop_closer=lc.k2_launches,
                    loop_closer_searches=lc.k2_searches,
                    relocalization=system.reloc_k2_launches,
                    relocalization_searches=system.reloc_k2_searches)
    events = [{k: e[k] for k in ("kf", "cand", "correction_m")}
              for e in lc.loop_events]
    live = int(m.pt_valid[: m.n_points].sum())
    print(f"[loop] {n} frames: loops closed {lc.loops_closed}, events "
          f"{json.dumps(events)}; GBA dispatched {lc.gba_dispatched}, "
          f"applied {lc.gba_applied}")
    print(f"[loop] ATE before correction {ate_before:.4f} m (poses at "
          f"track time), after {stats['ate']:.4f} m (frame_poses); lost "
          f"{stats['lost']}, keyframes {stats['keyframes']}, map points "
          f"{m.n_points} ({live} live), relocalizations "
          f"{system.reloc_successes} of {system.reloc_attempts} attempts; "
          "JAX CPU reference runs: " + _ref_text(REF_LOOP))
    print(f"[loop] track_stereo per-frame median "
          f"{statistics.median(frame_ms):.2f} ms (mean "
          f"{statistics.mean(frame_ms):.2f}, max {max(frame_ms):.2f}); peak "
          f"device memory {peak_mb:.1f} MiB; loop closer cap binds "
          f"{lc.cap_binds}")
    for row in system.timer.summary().splitlines():
        if "lc." in row or "loop_closing" in row or "stage" in row:
            print(f"[loop] {row}")
    print(f"[loop] launches: K1 {launches['k1']} (2 x {n} frames), K2 "
          f"{launches['k2']}: loop closer {launches['loop_closer']} (it "
          f"counted {launches['loop_closer_searches']} searches), "
          f"relocalization {launches['relocalization']} (counted "
          f"{launches['relocalization_searches']})")
    _need(lc.loops_closed >= max(1, min(_k1(REF_LOOP, "loops"))),
          f"{lc.loops_closed} loops closed")
    _need(lc.gba_applied >= 1, "no global BA applied after the closure")
    _need(stats["lost"] <= max(_k1(REF_LOOP, "lost")),
          f"{stats['lost']} frames lost")
    ref_kf = _k1(REF_LOOP, "keyframes")
    _need(min(ref_kf) - 5 <= stats["keyframes"] <= max(ref_kf) + 5,
          f"{stats['keyframes']} keyframes, expected within 5 of {ref_kf}")
    _need(stats["ate"] <= min(0.10, 2 * max(_k1(REF_LOOP, "ate"))),
          f"ATE {stats['ate']:.4f} m")
    _need(len(traj_lines) == n, f"{len(traj_lines)} trajectory lines")
    _need(launches["k1"] == 2 * n, f"K1 launched {launches['k1']} times")
    _need(launches["loop_closer"] == lc.k2_searches > 0,
          f"loop closer K2 launches {launches['loop_closer']} vs searches "
          f"{lc.k2_searches}")
    _need(launches["relocalization"] == system.reloc_k2_searches,
          f"relocalization K2 launches {launches['relocalization']} vs "
          f"searches {system.reloc_k2_searches}")
    searches0 = system.reloc_k2_searches
    launches0 = system.reloc_k2_launches
    kid = kidnap(system, gt, left, right, sems)
    launches["relocalization_kidnap"] = system.reloc_k2_launches - launches0
    print(f"[loop] kidnap launches: K2 {launches['relocalization_kidnap']} "
          f"(relocalization counted {system.reloc_k2_searches - searches0} "
          "searches)")
    _need(launches["relocalization_kidnap"]
          == system.reloc_k2_searches - searches0 > 0,
          "kidnap: relocalization K2 launches differ from its searches")
    in_lc = sum("loopclosing" in w.filename for w in syncs)
    print(f"[loop] device syncs: {len(syncs) / n:.2f} per frame "
          f"({len(syncs)} over all {n} frames of the run; {in_lc} raised "
          "in runtime/loopclosing.py)")
    for (path, line), c in Counter((os.path.basename(w.filename), w.lineno)
                                   for w in syncs).most_common(12):
        print(f"[loop] syncs at {path}:{line}: {c}")
    return {"launches": launches, "frame_ms": statistics.median(frame_ms),
            "syncs_per_frame": len(syncs) / n, "peak_mb": peak_mb,
            "loops_closed": lc.loops_closed, "events": events,
            "gba_dispatched": lc.gba_dispatched,
            "gba_applied": lc.gba_applied, "ate_before": ate_before,
            "ate": stats["ate"], "lost": stats["lost"],
            "keyframes": stats["keyframes"], "lost_frames": lost_at,
            "closed_at": closed_at,
            "relocalizations": system.reloc_successes,
            "record": {"frames": len(log.records), "bytes": nbytes,
                       "seconds": log.seconds},
            "kidnap_error_m": kid["error_m"],
            "sim3_case": sim3_case, "sim3_calls_per_frame": sim3_calls,
            "gba_case": gba_case}


# cli40 (phase 8 run A), the JAX package's command line with
# --no-semantics on the same 40-frame KITTI directory
# (tools/cli40_jax_reference.py): runs as the CPU times them, where the
# mapper admits keyframes late, and runs in the card's regime (landed);
# ATE is held to both, keyframes to the landed runs
REF_CLI = {
    "xla_a": {"descriptors": "xla", "landed": False, "ate": 0.0145,
              "keyframes": 12},
    "xla_b": {"descriptors": "xla", "landed": False, "ate": 0.0116,
              "keyframes": 13},
    "xla_landed_a": {"descriptors": "xla", "landed": True, "ate": 0.0102,
                     "keyframes": 17},
    "xla_landed_b": {"descriptors": "xla", "landed": True, "ate": 0.0102,
                     "keyframes": 17},
    "k1_a": {"descriptors": "k1", "landed": False, "ate": 0.0194,
             "keyframes": 13},
    "k1_b": {"descriptors": "k1", "landed": False, "ate": 0.0194,
             "keyframes": 13},
    "k1_landed_a": {"descriptors": "k1", "landed": True, "ate": 0.0086,
                    "keyframes": 17},
    "k1_landed_b": {"descriptors": "k1", "landed": True, "ate": 0.0086,
                    "keyframes": 17},
}
N_CLI_SHORT = 12  # run B's frames


def write_settings(path: str, cam, orb, sem, trk) -> None:
    """KITTI03-style OpenCV YAML (ref: config/kitti/KITTI03.yaml)."""
    with open(path, "w") as f:
        f.write("%YAML:1.0\n\n")
        for k, v in [
            ("Camera.fx", cam.fx), ("Camera.fy", cam.fy),
            ("Camera.cx", cam.cx), ("Camera.cy", cam.cy),
            ("Camera.k1", cam.k1), ("Camera.k2", cam.k2),
            ("Camera.p1", cam.p1), ("Camera.p2", cam.p2),
            ("Camera.width", cam.width), ("Camera.height", cam.height),
            ("Camera.fps", cam.fps), ("Camera.bf", cam.bf),
            ("Camera.RGB", cam.rgb),
            ("ThDepth", trk.th_depth),
            ("ThConfidence", sem.th_confidence),
            ("ThEntropyReduction", sem.th_entropy_reduction),
            ("ORBextractor.nFeatures", orb.n_features),
            ("ORBextractor.scaleFactor", orb.scale_factor),
            ("ORBextractor.nLevels", orb.n_levels),
            ("ORBextractor.iniThFAST", orb.ini_th_fast),
            ("ORBextractor.minThFAST", orb.min_th_fast),
        ]:
            f.write(f"{k}: {v}\n")


def write_kitti(out_dir: str, cfg: SystemConfig, left, right) -> str:
    """Frames as a KITTI sequence directory (src/sivo.cc:145-177's
    layout) with its settings file."""
    for side, images in (("image_2", left), ("image_3", right)):
        os.makedirs(os.path.join(out_dir, side), exist_ok=True)
        for i, img in enumerate(images):
            cv2.imwrite(os.path.join(out_dir, side, f"{i:06d}.png"),
                        img.astype(np.uint8))
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        for i in range(len(left)):
            f.write(f"{i / cfg.camera.fps:.6e}\n")
    write_settings(os.path.join(out_dir, "settings.yaml"), cfg.camera,
                   cfg.orb, cfg.semantic, cfg.tracking)
    return out_dir


def read_trajectory(path: str) -> np.ndarray:
    """A KITTI trajectory file (rows Rwc | twc) as world-to-camera
    poses."""
    rows = np.loadtxt(path, ndmin=2).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :] = rows
    return np.linalg.inv(poses)


def run_cli(argv: list[str], cwd: str, count_syncs: bool = False):
    """``cli.run(argv)`` in ``cwd``, its standard output captured and
    echoed, SegNet forwards counted per model by a global forward hook.
    Returns (return code, system, output, {id(model): forwards}, sync
    warnings)."""
    forwards = Counter()

    def hook(module, args, output):
        if isinstance(module, segnet.SegNet):
            forwards[id(module)] += 1

    out = io.StringIO()
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with contextlib.chdir(cwd), contextlib.redirect_stdout(out):
                rc, system = cli.run(argv)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            handle.remove()
    text = out.getvalue()
    for line in text.splitlines():
        print(f"[cli]   | {line}")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    return rc, system, text, forwards, syncs


def run_cli_trained(cfg: SystemConfig, gt, cls_maps, dev, seq: str,
                    voc_txt: str, caffemodel: str, work: str) -> dict:
    """Phase 8's run C: the command line on phase 3c's trained SegNet
    basic with semantics on, its launch counters set to 0 just before it
    and read just after. Each frame ``build_frame`` returns adds, on the
    device, its pixels whose class is the renderer's, its entropy and
    its semantic and extracted keypoints to sums read once at the end."""
    n = len(gt)
    cls_dev = torch.from_numpy(np.stack(cls_maps[:n]).astype(np.uint8)).to(
        dev)
    sums = {k: torch.zeros((), dtype=torch.float64, device=dev)
            for k in ("correct", "entropy", "semantic", "valid")}
    built = [0]
    build = frame_mod.build_frame

    def summed_build(*args, **kwargs):
        f = build(*args, **kwargs)
        i = built[0]
        built[0] += 1
        sums["correct"] += (f.classes_raster == cls_dev[i]).sum()
        sums["entropy"] += f.entropy_raster.sum(dtype=torch.float64)
        sums["semantic"] += f.semantic.sum()
        sums["valid"] += f.valid.sum()
        return f

    run_c = os.path.join(work, "run_c")
    os.makedirs(run_c)
    torch.cuda.reset_peak_memory_stats(dev)
    frame_mod.build_frame = summed_build
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    try:
        rc, system, text, forwards, syncs = run_cli(
            [voc_txt, os.path.join(seq, "settings.yaml"),
             "bayesian_segnet_basic_kitti.prototxt", caffemodel, seq],
            run_c, count_syncs=True)
    finally:
        frame_mod.build_frame = build
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    _need(rc == 0 and system is not None, f"CLI run C returned {rc}")
    _need(f"Loaded weights from {caffemodel}" in text,
          "CLI run C printed no 'Loaded weights from'")
    got = {k: float(v) for k, v in sums.items()}
    pixels = n * cfg.camera.height * cfg.camera.width
    stats = {"pixel_acc": got["correct"] / pixels,
             "entropy": got["entropy"] / pixels,
             "gate_share": got["semantic"] / max(got["valid"], 1.0)}
    median_s = float(text.split("median tracking time:")[1].split()[0])
    poses = read_trajectory(os.path.join(run_c, "CameraTrajectory.txt"))
    with open(os.path.join(run_c, "keyframes_points.txt")) as f:
        n_kf = int(f.read().split("Final number of keyframes:")[1].split()[0])
    lost = system.n_lost()
    ate = synthetic.ate_rmse(poses, gt) if len(poses) == n else float("inf")
    seg = forwards[id(system.model)]
    print(f"[cli] run C ({n} frames, trained SegNet {system.segnet_variant} "
          f"with semantics on, vocabulary): lost {lost}, ATE {ate:.4f} m, "
          f"keyframes {n_kf}, SegNet forwards {seg}; posterior against the "
          f"renderer's classes: pixel accuracy {stats['pixel_acc']:.4f}, "
          f"mean entropy {stats['entropy']:.4f} bits, semantic-gate pass "
          f"share {stats['gate_share']:.4f} ({got['semantic']:.0f} of "
          f"{got['valid']:.0f} keypoints); JAX CLI reference runs "
          "(trained, landed): " + _ref_text(REF_CNN["cli"]))
    print(f"[cli] run C: per-frame median {1e3 * median_s:.2f} ms (the "
          f"CLI's median tracking time); device syncs {len(syncs) / n:.2f} "
          f"per frame; peak device memory {peak_mb:.1f} MiB; keyframe "
          f"admissions deferred {system.mapper.admit_waits}")
    print(f"[cli] run C launches: K1 {launches['k1']} (2 x {n} frames), K2 "
          f"{launches['k2']}")
    _need(built[0] == n, f"run C built {built[0]} frames")
    _need(system.segnet_variant == "basic" and seg == n,
          f"SegNet {system.segnet_variant} ran {seg} times on {n} frames")
    _need(len(poses) == n, f"run C: {len(poses)} trajectory rows")
    ref_c = REF_CNN["cli"]["k1"]
    _need(lost <= max(ref_c["lost"]), f"run C: {lost} frames lost")
    _need(ate <= min(0.10, 2 * max(ref_c["ate"])),
          f"run C ATE {ate:.4f} m")
    ref_kf = ref_c["keyframes"]
    _need(min(ref_kf) - 3 <= n_kf <= max(ref_kf) + 3,
          f"run C: {n_kf} keyframes, expected within 3 of {ref_kf}")
    _need(launches["k1"] == 2 * n, f"run C: K1 launched {launches['k1']} "
          "times")
    _need(launches["k2"] >= n - 1 - lost,
          f"run C: K2 launched {launches['k2']} times")
    for key, tol in (("gate_share", 0.10), ("pixel_acc", 0.05)):
        ref = ref_c[key]
        _need(min(ref) - tol <= stats[key] <= max(ref) + tol,
              f"run C {key} {stats[key]:.4f}, expected within {tol} of "
              f"{ref}")
    _need(0.0 < stats["gate_share"] < 1.0,
          f"run C gate share {stats['gate_share']}")
    return {"launches": launches, "frame_ms": 1e3 * median_s,
            "syncs_per_frame": len(syncs) / n, "peak_mb": peak_mb,
            "ate": ate, "keyframes": n_kf, "lost": lost, **stats}


def phase_cli(cfg: SystemConfig, gt, left, right, cls_maps, dev,
              caffemodel: str, trained: str, work: str) -> dict:
    """Phase 8: the command line, runs A, C and B."""
    n = len(left)
    seq = write_kitti(os.path.join(work, "seq"), cfg, left, right)
    voc_txt = os.path.join(work, "voc.txt")
    voc = voc_mod.load_npz(VOCABULARY)
    voc_mod.save_text(voc, voc_txt)
    settings = os.path.join(seq, "settings.yaml")
    run_a = os.path.join(work, "run_a")
    os.makedirs(run_a)
    parses = native.PARSES
    torch.cuda.reset_peak_memory_stats(dev)
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    rc, system, text, forwards, syncs = run_cli(
        [voc_txt, settings, "bayesian_segnet_kitti.prototxt", caffemodel,
         seq], run_a, count_syncs=True)
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    _need(rc == 0 and system is not None, f"CLI run A returned {rc}")
    for want in (f"Loaded weights from {caffemodel}",
                 f"Vocabulary loaded: {voc.n_words} words",
                 f"Images in the sequence: {n}"):
        _need(want in text, f"CLI run A printed no {want!r}")
    median_s = float(text.split("median tracking time:")[1].split()[0])
    poses = read_trajectory(os.path.join(run_a, "CameraTrajectory.txt"))
    with open(os.path.join(run_a, "keyframes_points.txt")) as f:
        n_kf = int(f.read().split("Final number of keyframes:")[1].split()[0])
    lost = system.n_lost()
    ate = synthetic.ate_rmse(poses, gt) if len(poses) == n else float("inf")
    seg_a = forwards[id(system.model)]
    first = float(np.abs(np.linalg.inv(poses[0]) - np.eye(4)).max())
    print(f"[cli] run A ({n} frames, SegNet {system.segnet_variant} from "
          f"the .caffemodel, vocabulary of {voc.n_words} words): lost "
          f"{lost}, ATE {ate:.4f} m, keyframes {n_kf}, SegNet forwards "
          f"{seg_a}, native vocabulary parses {native.PARSES - parses}; "
          "JAX CLI reference runs (--no-semantics): "
          + _ref_text(REF_CLI))
    print(f"[cli] run A: keyframe admissions deferred for a copy not yet "
          f"landed: {system.mapper.admit_waits}")
    print(f"[cli] run A: per-frame median {1e3 * median_s:.2f} ms (the "
          f"CLI's median tracking time); device syncs {len(syncs) / n:.2f} "
          f"per frame ({len(syncs)} over {n} frames); peak device memory "
          f"{peak_mb:.1f} MiB")
    print(f"[cli] run A launches: K1 {launches['k1']} (2 x {n} frames), K2 "
          f"{launches['k2']}")
    _need(native.PARSES > parses, "the native vocabulary parser was not "
          "used")
    _need(system.segnet_variant == "standard" and seg_a == n,
          f"SegNet {system.segnet_variant} ran {seg_a} times on {n} frames")
    _need(len(poses) == n, f"{len(poses)} trajectory rows")
    _need(first <= 1e-5, f"first trajectory row off the identity by {first}")
    _need(ate <= min(0.10, 2 * max(_k1(REF_CLI, "ate"))),
          f"CLI ATE {ate:.4f} m")
    ref_kf = _k1(REF_CLI, "keyframes", landed=True)
    _need(min(ref_kf) - 3 <= n_kf <= max(ref_kf) + 3,
          f"{n_kf} keyframes, expected within 3 of {ref_kf}")
    _need(launches["k1"] == 2 * n, f"K1 launched {launches['k1']} times")
    _need(launches["k2"] >= n - 1 - lost,
          f"K2 launched {launches['k2']} times")

    run_c = run_cli_trained(cfg, gt, cls_maps, dev, seq, voc_txt, trained,
                            work)

    k = N_CLI_SHORT
    seq_b = write_kitti(os.path.join(work, "seq_b"), cfg, left[:k],
                        right[:k])
    run_b = os.path.join(work, "run_b")
    frames = os.path.join(run_b, "frames")
    os.makedirs(run_b)
    rc, _, _, forwards_b, _ = run_cli(
        ["-", os.path.join(seq_b, "settings.yaml"), "basic_prototxt", "-",
         seq_b, "--no-semantics", "--save-frames", frames], run_b)
    _need(rc == 0, f"CLI run B returned {rc}")
    shapes = [getattr(cv2.imread(os.path.join(frames, f"frame_{i:06d}.png")),
                      "shape", None) for i in range(k)]
    top = cv2.imread(os.path.join(frames, "map_topdown.png"))
    rows_b = len(read_trajectory(os.path.join(run_b, "CameraTrajectory.txt")))
    want = (cfg.camera.height + 20, cfg.camera.width, 3)
    print(f"[cli] run B ({k} frames, --no-semantics --save-frames): "
          f"overlays {sum(sh == want for sh in shapes)} of {want}, map "
          f"render {None if top is None else top.shape}, trajectory rows "
          f"{rows_b}, SegNet forwards {sum(forwards_b.values())}")
    _need(all(sh == want for sh in shapes), f"overlays {shapes}")
    _need(top is not None, "no map_topdown.png")
    _need(rows_b == k, f"run B: {rows_b} trajectory rows")
    _need(sum(forwards_b.values()) == 0, "run B ran SegNet")
    return {"launches": launches, "frame_ms": 1e3 * median_s,
            "syncs_per_frame": len(syncs) / n, "peak_mb": peak_mb,
            "ate": ate, "keyframes": n_kf, "lost": lost, "run_c": run_c}


def phase_vocab_tool(statics, left0, right0, sem0, dev, work: str) -> dict:
    """Phase 9: the offline vocabulary tool on the card at a reduced size
    (2 frames per world, depth 3), its launch counters set to 0 just
    before it and read just after; its file read back, and one loop-world
    frame's descriptors turned into a BoW vector with it."""
    out = os.path.join(work, "voc_tool.npz")
    frames = 2
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    t0 = time.perf_counter()
    train_offline_vocab.main(["--frames-per-world", str(frames), "--depth",
                              "3", "--out", out])
    seconds = time.perf_counter() - t0
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    voc = voc_mod.load_npz(out)
    cls, conf, ent = sem0
    f = frame_mod.build_frame_nosegnet(statics, left0, right0, cls, conf,
                                       ent, device=dev)
    words, _ = voc_mod.transform(voc, f.desc_u8, f.semantic)
    bow = voc_mod.bow_vector(voc, words.cpu().numpy())
    n_frames = 6 * frames
    print(f"[vocab] tool on {n_frames} rendered frames in {seconds:.1f} s: "
          f"{voc.n_words} words (k={voc.k}, depth {voc.depth}); launches K1 "
          f"{launches['k1']} (2 x {n_frames} frames), K2 {launches['k2']}; "
          f"loop-world frame 0: BoW vector of {len(bow)} words")
    _need(launches["k1"] == 2 * n_frames,
          f"vocabulary tool: K1 launched {launches['k1']} times")
    _need(0 < voc.n_words <= 10**3, f"vocabulary of {voc.n_words} words")
    _need(len(bow) > 0, "empty BoW vector")
    return {"launches": launches, "seconds": seconds,
            "words": voc.n_words, "bow_words": len(bow)}


# phase 10: two sessions of the lap interleaved (frames of each)
MULTI_SEQUENCES = {"a": (0, 20), "b": (20, 40)}
# The sharded solver's LM iterations, gated against the dense GBA's 10:
# its λ starts at 1e-4 whatever the Hessian's scale (the JAX package's
# solver), which on phase 7's problem (diagonal ~3e8) takes ~10
# rejected steps before one lands, so 10 iterations leave it 3e-3-8e-2
# from the dense solution (PERF.md §6) and ~20 converge. The gap
# after the loop closer's 10 is printed too.
SHARDED_ITERATIONS = 30
GBA_ITERATIONS = 10  # the loop closer's dense GBA
# tests/test_sharded_ba.py's bounds between the sharded and the
# single-device solvers: each keyframe's largest |log(T_dense^-1
# T_sharded)| component, the median point difference (m)
SHARDED_POSE_TOL, SHARDED_POINT_TOL = 2e-3, 0.1
SHARDED_RANKS = 2  # 10c: gloo ranks on one card
SHARDED_KEPT_MIN = 0.95  # share of the valid observations partitioned


def phase_multi_sequence(cfg, gt_all, left_all, right_all, sems_all,
                         dev) -> dict:
    """Phase 10a: ``run_sequences`` on two sessions of the lap, "a" on
    frames 0-19 and "b" on frames 20-39 (a fresh session), interleaved
    round-robin, each ``System`` as phase 6's; the launch counters set to
    0 just before and read just after. Each ``track_stereo`` is timed on
    the host clock between device syncs, as phase 6 times it."""
    frame_ms = {name: [] for name in MULTI_SEQUENCES}

    def make_system(name):
        system = System(cfg=cfg, device=dev, max_keyframes=256,
                        max_points=32768)
        track = system.track_stereo

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return track(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                frame_ms[name].append(1e3 * (time.perf_counter() - t0))

        system.track_stereo = timed
        return system

    seqs = {name: [(left_all[i], right_all[i], (i - a) * 0.1,
                    (*sems_all[i], False)) for i in range(a, b)]
            for name, (a, b) in MULTI_SEQUENCES.items()}
    n = sum(len(seq) for seq in seqs.values())
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    t0 = time.perf_counter()
    results = multi_sequence.run_sequences(make_system, seqs)
    wall_s = time.perf_counter() - t0
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    sessions = {}
    for name, (a, b) in MULTI_SEQUENCES.items():
        r = results[name]
        _need(r.poses.shape == (b - a, 4, 4) and np.isfinite(r.poses).all(),
              f"session {name}: poses {r.poses.shape}")
        sessions[name] = {
            "frames": r.n_frames, "lost": r.n_lost,
            "ate": synthetic.ate_rmse(r.poses, gt_all[a:b]),
            "keyframes": r.n_keyframes, "points": r.n_points,
            "ms_per_pair": statistics.median(frame_ms[name])}
        s = sessions[name]
        print(f"[multi] session {name} (frames {a}-{b - 1}): lost "
              f"{s['lost']}, ATE {s['ate']:.4f} m, keyframes "
              f"{s['keyframes']}, map points {s['points']}; track_stereo "
              f"median {s['ms_per_pair']:.2f} ms per pair")
    print(f"[multi] {n} frames of two interleaved sessions in {wall_s:.1f} "
          f"s; launches: K1 {launches['k1']} (2 x {n} frames), K2 "
          f"{launches['k2']}")
    for name, s in sessions.items():
        _need(s["frames"] == len(seqs[name]), f"session {name}: "
              f"{s['frames']} frames")
        _need(s["lost"] == 0, f"session {name}: {s['lost']} frames lost")
        _need(s["ate"] <= 0.10, f"session {name}: ATE {s['ate']:.4f} m")
        _need(s["keyframes"] >= 2, f"session {name}: {s['keyframes']} "
              "keyframes")
    _need(launches["k1"] == 2 * n, f"K1 launched {launches['k1']} times")
    tracked = n - len(seqs)  # each session's first frame initializes
    _need(launches["k2"] >= tracked, f"K2 launched {launches['k2']} times "
          f"over {tracked} tracked frames")
    return {"launches": launches, "wall_s": wall_s, "sessions": sessions}


def _pose_diffs(a: torch.Tensor, b: torch.Tensor,
                valid: torch.Tensor) -> np.ndarray:
    """Each valid keyframe's largest |log(a_k^-1 b_k)| component."""
    a, b = a[valid].double().cpu(), b[valid].double().cpu()
    return se3.log(torch.linalg.inv(a) @ b).abs().amax(dim=-1).numpy()


def _point_diff(a: torch.Tensor, b: torch.Tensor,
                valid: torch.Tensor) -> float:
    """Median distance between the valid points of a and b (m)."""
    return float(torch.linalg.norm((a - b)[valid].double().cpu(),
                                   dim=-1).median())


def _held_to_dense(name: str, res, dense, prob) -> dict:
    pose = _pose_diffs(dense.kf_pose, res.kf_pose.to(dense.kf_pose.device),
                       prob.kf_valid)
    point = _point_diff(dense.pt_pos, res.pt_pos.to(dense.pt_pos.device),
                        prob.pt_valid)
    print(f"[sharded] {name} against the dense GBA: largest pose log "
          f"component {pose.max():.3g} (<= {SHARDED_POSE_TOL}), median "
          f"point difference {point:.3g} m (< {SHARDED_POINT_TOL}); chi2 "
          f"{float(res.chi2):.6g} against {float(dense.chi2):.6g}")
    _need(pose.max() <= SHARDED_POSE_TOL, f"{name}: pose differs from the "
          f"dense GBA by {pose.max():.3g}")
    _need(point < SHARDED_POINT_TOL, f"{name}: points differ from the dense "
          f"GBA by {point:.3g} m (median)")
    return {"pose_max": float(pose.max()), "point_median_m": point,
            "chi2": float(res.chi2)}


def phase_sharded_ba(gba_case, work: str) -> dict:
    """Phases 10b and 10c on phase 7's dense GBA problem, each held to
    the port's dense ``global_bundle_adjustment`` on the same problem.
    10b: ``sharded_bundle_adjustment`` at world size 1 over NCCL in this
    process (wall ms of the solve, median of 3 after one warm-up; the
    all-reduce calls and bytes counted). 10c: two gloo ranks on this
    card, spawned with the problem as a ``.pt`` file in ``work``, its
    valid points first spread over the shards round-robin (the partition
    drops a shard's observations beyond its share of the slots) and the
    spread undone on the result; in float64, held to the dense GBA in
    float64 (``DENSE_F64_ITERATIONS``): in float32 the ranks' partial
    sums can move the solve along the problem's flat directions past the
    bound at an equal chi2 (PERF.md §6). The sharded solves take
    ``SHARDED_ITERATIONS``, the dense float32 one the loop closer's
    10."""
    prob, cam = gba_case
    dev = prob.kf_pose.device
    n_obs = int(prob.obs_valid.sum())
    dense = local_ba.global_bundle_adjustment(prob, cam,
                                              iterations=GBA_ITERATIONS)
    print(f"[sharded] phase 7's GBA problem: caps (keyframes, points, "
          f"observations) {tuple(prob.kf_pose.shape[:1])} "
          f"{tuple(prob.pt_pos.shape[:1])} {tuple(prob.obs_kf.shape)}, "
          f"valid {int(prob.kf_valid.sum())}, {int(prob.pt_valid.sum())}, "
          f"{n_obs}")

    # 10b: world size 1, NCCL
    reduce_bytes = []
    all_reduce = torch.distributed.all_reduce

    def counted(tensor, *args, **kwargs):
        reduce_bytes.append(tensor.numel() * tensor.element_size())
        return all_reduce(tensor, *args, **kwargs)

    torch.distributed.init_process_group(
        "nccl", init_method="file://" + os.path.join(work, "nccl_rdv"),
        world_size=1, rank=0, device_id=dev)
    try:
        part = sharded_ba.partition_problem(prob, 1)

        def solve(iterations=SHARDED_ITERATIONS):
            return sharded_ba.sharded_bundle_adjustment(
                part, cam, iterations=iterations)

        res = solve(GBA_ITERATIONS)
        gap = _pose_diffs(dense.kf_pose, res.kf_pose, prob.kf_valid).max()
        print(f"[sharded] 10b after {GBA_ITERATIONS} iterations (reported, "
              f"not gated): largest pose log component {gap:.3g} from the "
              "dense GBA")
        solve()
        torch.distributed.all_reduce = counted
        try:
            res = solve()
        finally:
            torch.distributed.all_reduce = all_reduce
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    finally:
        torch.distributed.destroy_process_group()
    # chi2 at the start and the end, then per iteration the system and
    # the new chi2
    per_iter = reduce_bytes[1:-1]
    _need(len(per_iter) == 2 * SHARDED_ITERATIONS,
          f"{len(reduce_bytes)} all-reduce calls")
    iter_bytes = sum(per_iter) / SHARDED_ITERATIONS
    one = {"iterations": SHARDED_ITERATIONS,
           "solve_ms": statistics.median(times),
           "pose_max_after_10": float(gap),
           "allreduce_calls": len(reduce_bytes),
           "allreduce_bytes_per_iteration": iter_bytes,
           **_held_to_dense("10b world size 1 (NCCL)", res, dense, prob)}
    print(f"[sharded] 10b: {SHARDED_ITERATIONS} iterations in "
          f"{one['solve_ms']:.2f} ms (median of 3, wall); "
          f"{len(reduce_bytes)} all-reduce calls, {iter_bytes:.0f} bytes "
          "per iteration")

    # 10c: two gloo ranks on this card, in float64
    prob64 = _f64(prob)
    dense64 = local_ba.global_bundle_adjustment(
        prob64, cam, iterations=DENSE_F64_ITERATIONS)
    n = SHARDED_RANKS
    P = prob.pt_pos.shape[0]
    j = torch.arange(P, device=dev)
    dest = (j % n) * (P // n) + j // n  # point j's slot after spreading
    spread = prob64._replace(
        pt_pos=torch.empty_like(prob64.pt_pos).index_copy_(0, dest,
                                                           prob64.pt_pos),
        pt_valid=torch.empty_like(prob.pt_valid).index_copy_(
            0, dest, prob.pt_valid),
        obs_pt=dest[prob.obs_pt.long()].to(prob.obs_pt.dtype))
    part = sharded_ba.partition_problem(spread, n)
    kept = int(part.obs_valid.sum()) / n_obs
    t0 = time.perf_counter()
    outs = sharded_ba.solve_on_ranks(part, cam, n, work, backend="gloo",
                                     devices=[str(dev)] * n,
                                     iterations=SHARDED_ITERATIONS)
    spawn_s = time.perf_counter() - t0
    res = outs[0]._replace(pt_pos=outs[0].pt_pos.to(dev)[dest])
    two = {"ranks": n, "kept": kept, "spawn_and_solve_s": spawn_s,
           **_held_to_dense(f"10c {n} gloo ranks in float64", res, dense64,
                            prob)}
    print(f"[sharded] 10c: {n} gloo ranks on {dev}: {kept:.4f} of the "
          f"{n_obs} valid observations kept; spawn and solve {spawn_s:.1f} "
          "s (wall)")
    _need(kept >= SHARDED_KEPT_MIN, f"10c kept {kept:.4f} of the "
          "observations")
    for r, other in enumerate(outs[1:], 1):
        _need(torch.allclose(other.kf_pose, outs[0].kf_pose, rtol=1e-5,
                             atol=1e-6), f"10c rank {r}'s poses differ")
    return {"world_size_1": one, "gloo_ranks": two,
            "dense_chi2": float(dense.chi2),
            "dense_f64_chi2": float(dense64.chi2)}


def phase_entry() -> dict:
    """Phase 10d: ``entry.dryrun_multichip`` over this machine's cards
    (NCCL ranks), and ``entry()``'s forward at 352x1024 on the card."""
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    entry.dryrun_multichip(n)
    dry_s = time.perf_counter() - t0
    fn, args = entry.entry()
    classes, confidence, ent = fn(*args)
    torch.cuda.synchronize()
    _need(classes.shape == (entry.HEIGHT, entry.WIDTH),
          f"entry classes {tuple(classes.shape)}")
    _need(bool(torch.isfinite(confidence).all() & torch.isfinite(ent).all()),
          "entry posterior not finite")
    print(f"[entry] dryrun_multichip({n}) in {dry_s:.1f} s; entry() "
          f"posterior finite, classes {tuple(classes.shape)}, mean entropy "
          f"{float(ent.mean()):.4f} bits")
    return {"dryrun_ranks": n, "dryrun_s": dry_s}


# phase 11: one super-lap of the JAX bench's endurance mode (bench.py,
# SIVO_BENCH_LAPS > 1): the dumbbell world driven as a figure-8 whose
# lap revisits two zones; the trajectory is exactly periodic, so the
# lap's renders serve every frame (frame i shows render i % lap)
DUMBBELL_FRAMES = 434  # figure8_lap_frames() (404) + 30 re-driving the start
# CPU runs on the same frames; events are (frame, keyframe, candidate,
# correction m); ATE over frame_poses() and over the frames not lost.
# "descriptors" names the descriptor path: "xla" is the JAX package's
# CPU XLA path (float canvases; tools/dumbbell_jax_reference.py: runs
# with its fetches landed by the next frame, the card's regime, and two
# as the CPU times them), "k1" K1's semantics (u8 canvases), as the
# port's kernel computes them (tools/dumbbell_port_parity.py: the JAX
# package with K1 interpreted and its fetches landed, and the port on
# the CPU, with its own RANSAC draws and with the JAX package's). The
# ATE gate is twice the worst "k1" run (ATE_LIKE_FOR_LIKE), never looser
# than twice the worst "xla" run
REF_DUMBBELL = {
    "k1_jax": {
        "descriptors": "k1", "draws": "jax.random",
        "loops": 2, "events": [(250, 73, 28, 0.742), (409, 113, 0, 0.521)],
        "gba": [{"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 250, "applied_frame": 260},
                {"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 409, "applied_frame": 419}],
        "gba_applied": 2, "compactions": 0, "relocalizations": 1,
        "crisis_frames": 35, "lost": 1, "keyframes": 120, "ate": 0.0855,
        "ate_tracked": 0.0847, "err_max": 0.2643, "err_max_frame": 263,
        "local_cap_binds": 0},
    "k1_port": {
        "descriptors": "k1", "draws": "torch.Generator",
        "loops": 2, "events": [(246, 75, 30, 0.351), (421, 119, 2, 0.203)],
        "gba": [{"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 246, "applied_frame": 256},
                {"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 421, "applied_frame": 429}],
        "gba_applied": 2, "compactions": 0, "relocalizations": 1,
        "crisis_frames": 40, "lost": 1, "keyframes": 125, "ate": 0.1869,
        "ate_tracked": 0.1866, "err_max": 1.1264, "err_max_frame": 398,
        "local_cap_binds": 0},
    "k1_port_jax_draws": {
        "descriptors": "k1", "draws": "jax.random",
        "loops": 2, "events": [(249, 78, 34, 0.291), (407, 125, 0, 1.373)],
        "gba": [{"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 249, "applied_frame": 257},
                {"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 407, "applied_frame": 417}],
        "gba_applied": 2, "compactions": 0, "relocalizations": 0,
        "crisis_frames": 44, "lost": 0, "keyframes": 135, "ate": 0.3007,
        "ate_tracked": 0.3007, "err_max": 1.3001, "err_max_frame": 248,
        "local_cap_binds": 0},
    # two runs made the same decisions frame for frame
    "landed": {
        "descriptors": "xla",
        "loops": 2, "events": [(249, 81, 31, 0.338), (408, 126, 0, 1.418)],
        "gba": [{"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 249, "applied_frame": 258},
                {"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 408, "applied_frame": 417}],
        "gba_applied": 2, "compactions": 0, "relocalizations": 1,
        "crisis_frames": 30, "lost": 2, "keyframes": 137, "ate": 0.4521,
        "ate_tracked": 0.4506, "local_cap_binds": 0},
    "cpu": {
        "descriptors": "xla",
        "loops": 2, "events": [(286, 69, 26, 0.409), (420, 105, 0, 0.596)],
        "gba": [{"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 286, "applied_frame": 322},
                {"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 420, "applied_frame": 434}],
        "gba_applied": 2, "compactions": 0, "relocalizations": 2,
        "crisis_frames": 103, "lost": 5, "keyframes": 116, "ate": 0.5046,
        "ate_tracked": None, "local_cap_binds": 0},
    "cpu2": {
        "descriptors": "xla",
        "loops": 2, "events": [(286, 69, 26, 0.409), (423, 106, 0, 0.312)],
        "gba": [{"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 286, "applied_frame": 322},
                {"path": "pcg", "bucket": [256, 32768, 98304],
                 "frame": 423, "applied_frame": 434}],
        "gba_applied": 2, "compactions": 0, "relocalizations": 1,
        "crisis_frames": 103, "lost": 3, "keyframes": 115, "ate": 0.5225,
        "ate_tracked": 0.5186, "local_cap_binds": 0},
}
ATE_LIKE_FOR_LIKE = min(
    2 * max(r["ate"] for r in REF_DUMBBELL.values()
            if r["descriptors"] == "k1"),
    2 * max(r["ate"] for r in REF_DUMBBELL.values()
            if r["descriptors"] == "xla"))
PCG_ITERATIONS = 10  # the loop closer's
# compaction forced after phase 11's lap: lap frames tracked after it,
# and how far a frame's pose may move where its record is re-expressed
# through the nearest live ancestor of its culled reference keyframe
# (float32 rounding of rel @ Tk @ inv(Ta); bit-equal otherwise)
COMPACT_NEXT_FRAMES = 10
COMPACT_POSE_ATOL = 1e-4
# The PCG GBA held to the dense GBA: both in float64 on the card, each
# to its optimum: the dense for 60 iterations (the same poses as 120 on
# phase 7's problems), PCG until a block of PCG_BLOCK steps moves no
# pose log component by more than PCG_CONVERGED (70-160 steps there), at
# most PCG_MAX_STEPS. In float32 neither solver reaches the optimum on
# every phase 7 problem: on one the dense GBA itself lay 1.2e-2 from it
# after 10 iterations and 9.8e-3 after 60, and float32 PCG stalls 1.9e-3
# from it on another (tools/gba190_pcg_study.py, PERF.md §6), so the
# float32 gaps are printed, not gated
DENSE_F64_ITERATIONS = 60
PCG_BLOCK, PCG_CONVERGED, PCG_MAX_STEPS = 10, 1e-6, 400
# the CPU float32 solve's own float noise: its distance to its float64
# solve and to itself on PCG_SHUFFLES orders of the observations, each
# solved in a process of its own (``PcgNoise``). Few orders
# underestimate it: a float32 solve lands in one of a few far-apart
# places, and with 4 orders the card's solve missed the bound in 14 of
# 260 repeats on 13 saved problems (3 of phase 11, 10 of phase 7), with
# 8 in none (tools/pcg_repeat.py, PERF.md §6)
PCG_SHUFFLES = 8
# where phase_pcg saves a problem whose gate failed: in the checkout and
# not in the run's temporary work directory, so that the file outlives
# the exception that ends the run (for tools/pcg_repeat.py)
PCG_MISS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "chiprun_out", "pcg_misses")
# tests/test_torch_gba.py's PCG tolerances (the port against the JAX
# package, float32, on a 6-keyframe problem): poses (matrix entries), the
# 99th percentile and the largest point difference (m), the final chi2
# (relative); inlier masks equal. On a map-sized problem the summation
# order alone moves a 10-step solve farther, in float32 and in float64
# alike (on the first PCG problem of a CPU run of dumbbell434, float64
# solves on 8 orders of the observations lie up to 5.3e-4 from the
# original order's in a pose entry: tools/gba190_pcg_study.py), so the
# card's solve in each precision is held to the CPU's within the larger
# of these and twice the CPU's own noise in that precision (in float64
# measured only where these are missed); the chi2 bound is one-sided
# (the card's final chi2 no higher than the CPU's by more)
PCG_TOLS = {"pose": 1e-4, "point_p99": 1e-3, "point_max": 2e-2,
            "chi2_rel": 1e-6}


# -- phase 11's per-frame record -------------------------------------------

# the tracking step's summary counts kept for each retired frame, under
# the names of tools/dumbbell_port_parity.py's records
RECORD_SUMMARY = ("OK", "N_TRACKED", "N_REF", "N_CLOSE_TRACKED",
                  "N_CLOSE_FREE", "N_MATCHES_MOTION", "N_INLIERS1",
                  "N_INLIERS2", "N_SELECTED", "N_SEMANTIC", "USED_FALLBACK",
                  "MOT_N", "MOT_INL", "SEL_LAST_ACCEPT", "N_CANDIDATES")
# appended on the device to each frame's summary by the record, and so
# copied home with it: the anchor's brute-force matches, its EPnP
# inliers and verdict, its pose LM's inliers (-1: no anchor ran), the
# local map's matches and pose LM inliers, the re-search's matches and
# the final pose LM's inliers; map health: live points whose position
# is not finite, and live points no keyframe observed
RECORD_EXTRAS = ("bf_n", "pnp_inl", "pnp_ok", "anchor_inl", "local_n",
                 "local_inl", "research_n", "final_inl", "pt_nonfinite",
                 "pt_unobserved")
# frames printed around the first lost frame when a phase 11 gate fails
RECORD_BEFORE, RECORD_AFTER = 10, 5
# the columns of those lines
RECORD_PRINTED = ("call", "fid", "state", "lost", "ref_kf", "kf", "mot_n",
                  "mot_inl", "bf_n", "pnp_inl", "anchor_inl", "local_n",
                  "local_inl", "research_n", "final_inl", "n_tracked",
                  "s_n_tracked", "crisis", "depth", "correction_t", "jump",
                  "reloc_cands", "reloc_best_inl", "reloc_ok",
                  "kf_nonfinite", "pt_nonfinite", "pt_nonfinite_host",
                  "pt_unobserved", "stages", "reanchor")


class FrameLog:
    """A record of every frame a ``System`` retires, kept while the
    context is open (phase 11's, and the CPU tests'), at no device sync.

    Per retired frame: the ``track_frame`` (or ``flush``) call that
    retired it, its frame id, lost flag, tracking state, reference
    keyframe and the keyframe it made (-1: none); the tracking step's
    counts (``RECORD_SUMMARY``, lowercased, and ``RECORD_EXTRAS``); the
    keyframe rule's host inputs (frames since the last keyframe, the
    mapper's queue and busy flag, keyframes before); the crisis rule's
    input ``S_N_TRACKED``, whether the call was a crisis and the retire
    depth it used (``System.track_frame``); whether the frame's ticket
    carried a world correction and its translation norm; the mapper and
    loop-closer stages applied during the call and each world
    correction applied to the tracker there (source "ba", "gba" or
    "loop", translation norm, rotation angle); each relocalization
    attempt's candidates, best pose-LM inliers and verdict; the jump of
    the camera centre from the previous record's; and map health: live
    keyframe poses that are not finite (the poses live on the host),
    live point positions that are not finite on the device and on the
    host, and live points the device map counts no observation for.
    The device's counts are reduced on the device and come home in the
    frame's summary copy.
    """

    def __init__(self, system):
        self.system = system
        self.records: list[dict] = []
        self.seconds = 0.0
        self._calls = 0
        self._call: dict | None = None
        self._step: list | None = None
        self._in_pnp = False
        self._reloc: list | None = None
        self._reloc_out: tuple | None = None
        self._source: list[str] = []
        self._logged = 0
        self._saved: dict = {}

    # -- hooks ---------------------------------------------------------------

    def __enter__(self):
        log = self
        saved = {"step": (track_step, "track_step"),
                 "frame": (matching, "search_by_projection_frame"),
                 "bf": (matching, "search_brute_force"),
                 "points": (matching, "search_by_projection_points"),
                 "pnp": (pnp_mod, "ransac_pnp"),
                 "lm": (pose_lm, "optimize_pose"),
                 "track_frame": (System, "track_frame"),
                 "flush": (System, "flush"),
                 "retire": (System, "_retire_one"),
                 "reloc": (System, "_relocalize"),
                 "correct": (Tracker, "apply_world_correction"),
                 "ba_apply": (LocalMapper, "_ba_apply"),
                 "gba_apply": (LoopCloser, "_gba_apply")}
        orig = {k: getattr(o, a) for k, (o, a) in saved.items()}

        def step(*args, **kwargs):
            log._step = []
            try:
                res = orig["step"](*args, **kwargs)
                t0 = time.perf_counter()
                res = res._replace(summary=torch.cat(
                    [res.summary, log._extras(res)]))
                log.seconds += time.perf_counter() - t0
                return res
            finally:
                log._step = None

        def searched(kind):
            def search(*args, **kwargs):
                res = orig[kind](*args, **kwargs)
                if log._step is not None and not log._in_pnp:
                    log._step.append((kind, res.n_matches))
                return res
            return search

        def pnp(*args, **kwargs):
            log._in_pnp = True
            try:
                res = orig["pnp"](*args, **kwargs)
            finally:
                log._in_pnp = False
            if log._step is not None:
                log._step.append(("pnp", (res.n_inliers, res.ok)))
            return res

        def lm(*args, **kwargs):
            res = orig["lm"](*args, **kwargs)
            if log._in_pnp:
                return res
            if log._step is not None:
                log._step.append(("lm", res.n_inliers))
            elif log._reloc is not None:
                log._reloc.append(res.n_inliers)
            return res

        def call(kind):
            def run(system, *args, **kwargs):
                outer = log._call is None
                if outer:
                    log._begin_call(kind)
                try:
                    return orig[kind](system, *args, **kwargs)
                finally:
                    if outer:
                        log._end_call()
            return run

        def retire(system):
            t0 = time.perf_counter()
            tr = system.tracker
            tk = tr._inflight[0] if tr._inflight else None
            pre = None if tk is None else {
                "since_kf": tk.frame_id - tr.last_kf_frame_id,
                "queue": 0 if tr.mapper is None else tr.mapper.queue_len,
                "busy": tr.mapper is not None and bool(tr.mapper.busy),
                "n_kf_before": system.map.n_keyframes,
                "correction_t": -1.0 if tk.correction is None else float(
                    np.linalg.norm(tk.correction[:3, 3]))}
            log.seconds += time.perf_counter() - t0
            log._reloc_out = None
            out = orig["retire"](system)
            if pre is not None:
                log._add(pre)
            return out

        def reloc(system, *args, **kwargs):
            attempts = system.reloc_attempts
            log._reloc = []
            try:
                out = orig["reloc"](system, *args, **kwargs)
            finally:
                lms, log._reloc = log._reloc, None
            if system.reloc_attempts > attempts:
                log._reloc_out = (len(system.reloc_candidates[-1]), lms,
                                  int(out is not None))
            return out

        def correct(tracker, ref_old, ref_new):
            delta = (np.linalg.inv(ref_old.astype(np.float64))
                     @ ref_new.astype(np.float64))
            if log._call is not None:
                c = np.clip((np.trace(delta[:3, :3]) - 1.0) / 2.0, -1, 1)
                log._call["reanchor"].append(
                    (log._source[-1] if log._source else "loop",
                     float(np.linalg.norm(delta[:3, 3])),
                     float(np.arccos(c))))
            return orig["correct"](tracker, ref_old, ref_new)

        def sourced(kind, name):
            def apply(self, *args, **kwargs):
                log._source.append(name)
                try:
                    return orig[kind](self, *args, **kwargs)
                finally:
                    log._source.pop()
            return apply

        wrappers = {"step": step, "frame": searched("frame"),
                    "bf": searched("bf"), "points": searched("points"),
                    "pnp": pnp, "lm": lm, "track_frame": call("track_frame"),
                    "flush": call("flush"), "retire": retire, "reloc": reloc,
                    "correct": correct,
                    "ba_apply": sourced("ba_apply", "ba"),
                    "gba_apply": sourced("gba_apply", "gba")}
        for k, (o, a) in saved.items():
            setattr(o, a, wrappers[k])
        self._saved = {k: (o, a, orig[k]) for k, (o, a) in saved.items()}
        return self

    def __exit__(self, *exc):
        for o, a, f in self._saved.values():
            setattr(o, a, f)
        self._saved = {}

    # -- the record --------------------------------------------------------

    def _extras(self, res) -> torch.Tensor:
        """``RECORD_EXTRAS`` of the step just run, as device floats."""
        dev = res.summary.device
        none = torch.full((), -1.0, device=dev)
        got = dict.fromkeys(RECORD_EXTRAS[:8], none)
        after, n_points = None, 0
        for kind, val in self._step:
            if kind == "bf":
                got["bf_n"] = val
            elif kind == "pnp":
                got["pnp_inl"], got["pnp_ok"] = val
                after = "anchor_inl"
            elif kind == "frame":
                after = None
            elif kind == "points":
                n_points += 1
                got["local_n" if n_points == 1 else "research_n"] = val
                after = "local_inl" if n_points == 1 else "final_inl"
            elif kind == "lm" and after is not None:
                got[after] = val
                after = None
        dm = res.dmap
        got["pt_nonfinite"] = (dm.pt_valid & ~torch.isfinite(
            dm.pt_pos).all(dim=1)).sum()
        got["pt_unobserved"] = (dm.pt_valid & (dm.pt_obs_count <= 0)).sum()
        return torch.stack([got[k].reshape(()).float()
                            for k in RECORD_EXTRAS])

    def _begin_call(self, kind: str) -> None:
        s = self.system.tracker.last_summary
        self._call = {
            "call": self._calls, "kind": kind, "records": [],
            "s_n_tracked": -1.0 if s is None
            else float(s[track_step.S_N_TRACKED]),
            "crisis_before": self.system.crisis_frames,
            "counts": dict(self.system.timer.counts), "reanchor": []}

    def _end_call(self) -> None:
        t0 = time.perf_counter()
        c, self._call = self._call, None
        system = self.system
        crisis = (c["kind"] == "track_frame"
                  and system.crisis_frames > c["crisis_before"])
        counts = system.timer.counts
        stages = ",".join(sorted(
            k for k, v in counts.items() if v > c["counts"].get(k, 0)
            and k.startswith(("map.", "lc.", "compact"))))
        traj = system.tracker.trajectory
        self._logged = min(self._logged, len(traj))
        while self._logged < len(traj):  # frames retired outside a ticket
            self._add(None, call=c)
        for rec in c["records"]:
            rec.update(crisis=crisis, depth=0 if crisis or c["kind"] == (
                "flush") else system.pipeline_depth,
                       s_n_tracked=c["s_n_tracked"], stages=stages,
                       reanchor=json.dumps(c["reanchor"]))
        self._calls += 1
        self.seconds += time.perf_counter() - t0

    def _add(self, pre: dict | None, call: dict | None = None) -> None:
        t0 = time.perf_counter()
        system = self.system
        tr, m = system.tracker, system.map
        call = self._call if call is None else call
        if self._logged >= len(tr.trajectory):  # a reset cleared it
            self._logged = len(tr.trajectory)
            return
        r = tr.trajectory[self._logged]
        self._logged += 1
        s = tr.last_summary if pre is not None else None
        pose = np.asarray(r.pose, np.float64)
        centre = -pose[:3, :3].T @ pose[:3, 3]
        prev = self.records[-1]["pose"] if self.records else None
        jump = 0.0 if prev is None else float(np.linalg.norm(
            centre - (-prev[:3, :3].T @ prev[:3, 3])))
        n_kf, n_pt = m.n_keyframes, m.n_points
        kf_live = m.kf_pose[:n_kf][m.kf_valid[:n_kf]]
        pt_live = m.pt_pos[:n_pt][m.pt_valid[:n_pt]]
        rec = {"call": -1 if call is None else call["call"],
               "fid": int(r.frame_id), "lost": bool(r.lost),
               "state": tr.state.name, "ref_kf": int(r.ref_kf),
               "kf": -1 if tr.kf_created is None else int(tr.kf_created),
               "since_kf": -1, "queue": -1, "busy": False,
               "n_kf_before": -1, "correction_t": -1.0,
               "rot_rate": float(tr._rot_rate), "pose": pose,
               "rot_dev": -1.0 if s is None
               else float(s[track_step.S_ROT_DEV]),
               "s_n_tracked": -1.0, "crisis": False, "depth": -1,
               "stages": "", "reanchor": "[]", "reloc_cands": -1,
               "reloc_lm": [], "reloc_ok": -1, "jump": jump,
               "kf_nonfinite": int((~np.isfinite(kf_live)).any(
                   axis=(1, 2)).sum()),
               "pt_nonfinite_host": int((~np.isfinite(pt_live)).any(
                   axis=1).sum())}
        if pre is not None:
            rec.update(pre)
            if self._reloc_out is not None:
                (rec["reloc_cands"], rec["reloc_lm"],
                 rec["reloc_ok"]) = self._reloc_out
        for f in RECORD_SUMMARY:
            rec[f.lower()] = -1 if s is None else int(round(float(
                s[getattr(track_step, "S_" + f)])))
        for i, f in enumerate(RECORD_EXTRAS):
            rec[f] = -1 if s is None else int(round(float(
                s[track_step.SUMMARY_LEN + i])))
        self.records.append(rec)
        if call is not None:
            call["records"].append(rec)
        self.seconds += time.perf_counter() - t0

    def finish(self) -> None:
        """Resolve the relocalization attempts' inlier counts (after the
        run: reading them earlier would wait for the device)."""
        for rec in self.records:
            if "reloc_lm" in rec:
                rec["reloc_best_inl"] = max(
                    (int(x) for x in rec.pop("reloc_lm")), default=-1)

    def save(self, path: str) -> int:
        """The record as ``.npz`` columns (``pose`` (F, 4, 4)); its
        bytes."""
        self.finish()
        t0 = time.perf_counter()
        cols = {k: np.asarray([r[k] for r in self.records])
                for k in self.records[0]} if self.records else {}
        np.savez_compressed(path, **cols)
        self.seconds += time.perf_counter() - t0
        return os.path.getsize(path)

    @classmethod
    def from_npz(cls, path: str) -> "FrameLog":
        """A saved record, for ``print_window``."""
        log = cls(None)
        with np.load(path) as z:
            cols = {k: z[k] for k in z.files}
        n = len(next(iter(cols.values()))) if cols else 0
        log.records = [{k: v[i].item() if v[i].ndim == 0 else v[i]
                        for k, v in cols.items()} for i in range(n)]
        return log

    def first_lost(self) -> int | None:
        return next((i for i, r in enumerate(self.records) if r["lost"]),
                    None)

    def first_unhealthy(self) -> int | None:
        return next((i for i, r in enumerate(self.records) if any(
            r[k] > 0 for k in ("kf_nonfinite", "pt_nonfinite",
                               "pt_nonfinite_host", "pt_unobserved"))),
            None)

    def print_window(self, tag: str = "[endurance]") -> None:
        """The records from ``RECORD_BEFORE`` frames before the first
        lost frame to ``RECORD_AFTER`` after it, and the first record
        with a non-zero health count."""
        lost, sick = self.first_lost(), self.first_unhealthy()
        print(f"{tag} record: first lost frame at record {lost}, first "
              f"non-zero health count at record {sick}; columns "
              + " ".join(RECORD_PRINTED))
        rows = [] if lost is None else list(range(
            max(0, lost - RECORD_BEFORE),
            min(len(self.records), lost + RECORD_AFTER + 1)))
        if sick is not None and sick not in rows:
            rows.append(sick)
        for i in rows:
            r = self.records[i]
            print(f"{tag} record {i}: " + " ".join(
                f"{r[k]:.4f}" if isinstance(r[k], float) else str(r[k])
                for k in RECORD_PRINTED))


def dumbbell_render(cfg: SystemConfig) -> PooledRender:
    """Phase 11's lap, rendered by ``RENDER_WORKERS`` processes."""
    lap = synthetic.figure8_lap_frames()
    return PooledRender("dumbbell", cfg.camera,
                        synthetic.figure8_trajectory(lap))


def run_endurance(cfg, dev, voc, render: PooledRender, lap: int,
                  n_frames: int):
    """Phase 11's run: ``System(max_keyframes=448, max_points=49152,
    pipeline_depth=3)`` with the vocabulary attached, SegNet basic at
    full cost and the renderer's semantics as ``sem_override``,
    ``track_frame(pipeline=True)`` on each frame with the next frame
    built between its dispatch and its retire (as the command line
    does), then ``flush``; frame i shows ``render.frame(i % lap)``, and
    each frame's timing starts once the next frame has rendered. The
    launch counters are set to 0 just before
    and read just after; torch's sync debug mode counts the syncs. Keeps
    a copy of K2's inputs at the last local-map search of tracking made
    while the uploaded candidate list was full (the refresh before it
    bound ``LOCAL_CAND``), and of the first PCG GBA problem; records
    each global BA's frame, path, bucket and wall time from dispatch to
    application, the frame of each closure, and every frame retired
    (``FrameLog``; its window is printed if the run raises)."""
    saved = {"top2": (kernel_match, "masked_hamming_top2"),
             "points": (matching, "search_by_projection_points"),
             "dispatch": (Tracker, "dispatch"),
             "refresh": (Tracker, "refresh_local_map"),
             "build": (ba_build, "build_problem"),
             "dense": (local_ba, "global_bundle_adjustment"),
             "begin": (gba_cg, "gba_cg_begin"),
             "apply": (LoopCloser, "_gba_apply")}
    orig = {k: getattr(o, a) for k, (o, a) in saved.items()}
    kept, frame, gbas = {"k2_calls": 0}, [0], []
    state = {"track": False, "local": False, "full": False}

    def record(a_u8, b_u8, row, col, use_ur=True):
        if state["track"] and state["local"] and state["full"]:
            kept["k2"] = (*(t.clone() for t in (a_u8, b_u8, row, col)),
                          use_ur)
            kept["k2_calls"] += 1
        return orig["top2"](a_u8, b_u8, row, col, use_ur)

    def tagged_points(*args, **kwargs):
        state["local"] = True
        try:
            return orig["points"](*args, **kwargs)
        finally:
            state["local"] = False

    def tagged_dispatch(self, *args, **kwargs):
        state["track"] = True
        try:
            return orig["dispatch"](self, *args, **kwargs)
        finally:
            state["track"] = False

    def counted_refresh(self, kf_idx):
        before = self.local_cap_binds
        orig["refresh"](self, kf_idx)
        state["full"] = self.local_cap_binds > before
        kept["list_max"] = max(kept.get("list_max", 0), len(
            self.map.local_point_ids(kf_idx, track_step.LOCAL_CAND)))

    def counted_build(m, kfs, fixed, kf_cap, pt_cap, obs_cap, *args):
        gbas.append({"frame": frame[0], "bucket": [kf_cap, pt_cap, obs_cap],
                     "n_kfs": len(kfs), "n_keyframes": m.n_keyframes,
                     "path": None, "applied_frame": None, "wall_ms": None,
                     "t0": time.perf_counter()})
        built = orig["build"](m, kfs, fixed, kf_cap, pt_cap, obs_cap, *args)
        if built is not None:
            built[1]["smoke_gba"] = len(gbas) - 1
        return built

    def counted_dense(*args, **kwargs):
        gbas[-1]["path"] = "dense"
        return orig["dense"](*args, **kwargs)

    def kept_begin(prob, cam):
        gbas[-1]["path"] = "pcg"
        if "pcg" not in kept:
            kept["pcg"] = (local_ba.BAProblem(*(t.clone() for t in prob)),
                           cam)
        return orig["begin"](prob, cam)

    def timed_apply(self, tracker):
        g = gbas[self._gba["ctx"]["smoke_gba"]]
        out = orig["apply"](self, tracker)
        g["applied_frame"] = frame[0]
        g["wall_ms"] = 1e3 * (time.perf_counter() - g.pop("t0"))
        return out

    wrappers = {"top2": record, "points": tagged_points,
                "dispatch": tagged_dispatch, "refresh": counted_refresh,
                "build": counted_build, "dense": counted_dense,
                "begin": kept_begin, "apply": timed_apply}
    system = System(cfg=cfg, device=dev, max_keyframes=448,
                    max_points=49152, pipeline_depth=3)
    system.attach_vocabulary(voc)
    lc = system.loop_closer
    built, frame_ms, closed_at = {}, [], []

    def build(i):
        if i in built or i >= n_frames:
            return
        left, right, classes = render.frame(i % lap)
        cls, conf, ent = synthetic.structured_semantics(classes, seed=7)
        built[i] = frame_mod.build_frame(
            system.model, system.statics, left, right, system.generator,
            sem_override=(cls, conf, ent, False), device=dev)

    for k, (o, a) in saved.items():
        setattr(o, a, wrappers[k])
    log = FrameLog(system)
    torch.cuda.reset_peak_memory_stats(dev)
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    t_run = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with log:
                for i in range(n_frames):
                    frame[0] = i
                    render.frame(min(i + 1, n_frames - 1) % lap)
                    t0 = time.perf_counter()
                    before = lc.loops_closed
                    build(i)
                    kept["frame"] = built.pop(i)
                    system.track_frame(kept["frame"], i * 0.1,
                                       pipeline=True,
                                       pre_retire=lambda: build(i + 1))
                    frame_ms.append(1e3 * (time.perf_counter() - t0))
                    closed_at += [i] * (lc.loops_closed - before)
                frame[0] = n_frames
                before = lc.loops_closed
                system.flush()
                closed_at += [n_frames] * (lc.loops_closed - before)
            torch.cuda.synchronize()
        except BaseException:
            torch.cuda.set_sync_debug_mode(0)
            log.finish()
            log.print_window()
            raise
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for k, (o, a) in saved.items():
                setattr(o, a, orig[k])
    run_s = time.perf_counter() - t_run
    log.finish()
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    return (system, frame_ms, run_s, launches, syncs, closed_at, gbas,
            kept, log)


def local_map_full_case(system, frame) -> tuple:
    """K2's inputs at tracking's local-map re-search (``track_step``'s
    second ``search_by_projection_points``: threshold 1, every semantic
    keypoint free) on the run's last frame at its final pose, with the
    candidate list filled to its ``LOCAL_CAND`` ids: the reference
    keyframe's covisible neighbourhood (``local_point_ids``, the list
    tracking uploads), then the other live points nearest the camera,
    then unused slots in id order. Returns (the case, ids the
    neighbourhood listed, live ids in the list)."""
    tr, m, dmap = system.tracker, system.map, system.tracker.dmap
    n = track_step.LOCAL_CAND
    listed = m.local_point_ids(tr.last_kf_id, n).astype(np.int64)
    pose = tr.last_pose.astype(np.float64)
    centre = -pose[:3, :3].T @ pose[:3, 3]
    live = np.setdiff1d(np.where(m.pt_valid[: m.n_points])[0], listed)
    live = live[np.argsort(np.linalg.norm(m.pt_pos[live] - centre, axis=1),
                           kind="stable")]
    unused = np.setdiff1d(np.arange(dmap.capacity),
                          np.concatenate([listed, live]))
    ids = np.concatenate([listed, live, unused])[:n]
    cand = to_device(ids, tr.device)
    T = to_device(pose.astype(np.float32), tr.device)
    visible, _, dist, view_cos = frustum_check(
        tr.cam, T, dmap.pt_pos[cand], dmap.pt_normal[cand],
        dmap.pt_min_dist[cand], dmap.pt_max_dist[cand])
    xc = dmap.pt_pos[cand] @ T[:3, :3].T + T[:3, 3]
    sf, levels = system.cfg.orb.scale_factor, system.cfg.orb.n_levels
    scales = sf ** torch.arange(levels, dtype=torch.float32,
                                device=tr.device)
    top2, kept = kernel_match.masked_hamming_top2, {}

    def record(a_u8, b_u8, row, col, use_ur=True):
        kept["k2"] = (*(t.clone() for t in (a_u8, b_u8, row, col)), use_ur)
        return top2(a_u8, b_u8, row, col, use_ur)

    kernel_match.masked_hamming_top2 = record
    try:
        matching.search_by_projection_points(
            dmap.pt_desc_u8[cand], visible & dmap.pt_valid[cand],
            project_stereo(tr.cam, xc),
            predict_scale(dist, dmap.pt_max_dist[cand] / 1.2, sf, levels),
            view_cos, frame.xy, frame.level, frame.desc_u8, frame.u_right,
            frame.semantic, scales, th=1.0, nn_ratio=0.8)
    finally:
        kernel_match.masked_hamming_top2 = top2
    n_live = min(n, len(listed) + len(live))
    return kept["k2"], len(listed), n_live


def _ref_range(key: str) -> tuple:
    return tuple(r[key] for r in REF_DUMBBELL.values())


def phase_endurance(cfg, dev, render: PooledRender, work: str,
                    kept_pcg=None) -> dict:
    """Phase 11: the dumbbell434 run on the lap as ``render`` hands it
    out, its gates against the JAX package's CPU runs
    (``REF_DUMBBELL``) and its report; returns the kept K2 case and PCG
    problem for the checks after it, and hands that problem to
    ``kept_pcg`` as soon as the run ends. The run's per-frame record is
    saved as ``work/endurance_record.npz``; if a gate fails, its
    window around the first lost frame is printed."""
    lap = synthetic.figure8_lap_frames()
    _need(len(render.futures) == lap, f"{len(render.futures)} lap renders")
    _check_serial("dumbbell", cfg.camera, synthetic.figure8_trajectory(1)[0],
                  *render.frame(0))
    n = DUMBBELL_FRAMES
    gt = synthetic.figure8_trajectory(n)
    voc = voc_mod.load_npz(VOCABULARY)
    (system, frame_ms, run_s, launches, syncs, closed_at, gbas,
     kept, log) = run_endurance(cfg, dev, voc, render, lap, n)
    if kept_pcg is not None and "pcg" in kept:
        kept_pcg(kept["pcg"])
    record = os.path.join(work, "endurance_record.npz")
    nbytes = log.save(record)
    print(f"[endurance] record: {len(log.records)} frames retired, "
          f"{nbytes} bytes in {record}, {log.seconds:.2f} s")
    print(f"[endurance] {lap} lap frames rendered in {render.seconds:.1f} s "
          f"({render.workers} processes at the lowest priority, beside the "
          "run; frame 0 equal to its serial render)")
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    lc, m, timer = system.loop_closer, system.map, system.timer
    stats = session_stats(system, gt)
    lost_at = [i for i, r in enumerate(system.tracker.trajectory)
               if r.lost]
    tracked = np.setdiff1d(np.arange(n), lost_at)
    ate_tracked = synthetic.ate_rmse(system.frame_poses()[tracked],
                                     gt[tracked])
    err = centre_errors(system.frame_poses(), gt)
    full_list = {"searches": kept["k2_calls"],
                 "longest_refresh": kept.get("list_max", 0)}
    if not kept["k2_calls"]:
        # no refresh filled the list in the run: phase 4's case is built
        # from the run's final map and last frame instead
        kept["k2"], full_list["listed"], full_list["live"] = (
            local_map_full_case(system, kept["frame"]))
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_kitti(traj)
        system.shutdown(os.path.join(tmp, "keyframes_points.txt"))
        with open(traj) as f:
            traj_lines = f.read().splitlines()
    launches.update(loop_closer=lc.k2_launches,
                    loop_closer_searches=lc.k2_searches,
                    relocalization=system.reloc_k2_launches,
                    relocalization_searches=system.reloc_k2_searches,
                    local_map_full=kept["k2_calls"])
    events = [{"frame": fr, **{k: e[k] for k in ("kf", "cand",
                                                 "correction_m")}}
              for fr, e in zip(closed_at, lc.loop_events)]
    graph_ms = [1e3 * t for t in timer.samples.get("lc.correct.graph", [])]
    pcg_ms = [g["wall_ms"] for g in gbas if g["path"] == "pcg"]
    out = {"frames": n, "loops": lc.loops_closed, "events": events,
           "gba": [{k: v for k, v in g.items() if k != "t0"} for g in gbas],
           "gba_applied": lc.gba_applied,
           "compactions": system.compactions,
           "relocalizations": system.reloc_successes,
           "reloc_attempts": system.reloc_attempts,
           "crisis_frames": system.crisis_frames, "lost": stats["lost"],
           "keyframes": stats["keyframes"],
           "keyframes_live": int(m.kf_valid[: m.n_keyframes].sum()),
           "points": m.n_points,
           "points_live": int(m.pt_valid[: m.n_points].sum()),
           "ate": stats["ate"], "ate_tracked": ate_tracked,
           "err_max": float(err.max()), "err_max_frame": int(err.argmax()),
           "lost_frames": lost_at,
           "local_cap_binds": system.tracker.local_cap_binds,
           "frame_ms_median": statistics.median(frame_ms),
           "frame_ms_p90": float(np.percentile(frame_ms, 90)),
           "run_s": run_s, "render_s": render.seconds,
           "syncs_per_frame": len(syncs) / n,
           "peak_mb": peak_mb, "graph_ms": graph_ms,
           "pcg_dispatch_to_apply_ms": pcg_ms,
           "local_map_full_list": full_list, "launches": launches,
           "record": {"frames": len(log.records), "bytes": nbytes,
                      "seconds": log.seconds,
                      "first_lost": log.first_lost(),
                      "first_unhealthy": log.first_unhealthy()}}
    print(f"[endurance] {n} frames: loops closed {lc.loops_closed}, events "
          f"{json.dumps(events)}")
    for g in gbas:
        print(f"[endurance] GBA at frame {g['frame']}: {g['path']}, bucket "
              f"{g['bucket']}, {g['n_kfs']} of {g['n_keyframes']} "
              f"keyframes, applied at frame {g['applied_frame']}, "
              + (f"{g['wall_ms']:.1f} ms from dispatch to application"
                 if g["wall_ms"] is not None else "not applied"))
    print(f"[endurance] GBA applied {lc.gba_applied} of "
          f"{lc.gba_dispatched}; compactions {system.compactions}, "
          f"relocalizations {system.reloc_successes} of "
          f"{system.reloc_attempts}, crisis frames {system.crisis_frames}, "
          f"lost {stats['lost']}, keyframes {stats['keyframes']} "
          f"({out['keyframes_live']} live), map points {m.n_points} "
          f"({out['points_live']} live), ATE {stats['ate']:.4f} m "
          f"({ate_tracked:.4f} m over the frames not lost; lost frames "
          f"{lost_at}; the largest aligned centre error "
          f"{out['err_max']:.4f} m at frame {out['err_max_frame']}), local "
          f"cap binds {out['local_cap_binds']}, loop "
          f"closer cap binds {lc.cap_binds}")
    print("[endurance] CPU references: " + "; ".join(
        f"{name} ({r['descriptors']}): loops {r['loops']}, GBA "
        f"{[(g['path'], g['bucket'][0]) for g in r['gba']]}, "
        f"compactions {r['compactions']}, relocalizations "
        f"{r['relocalizations']}, crisis frames {r['crisis_frames']}, "
        f"lost {r['lost']}, keyframes {r['keyframes']}, ATE {r['ate']}"
        for name, r in REF_DUMBBELL.items())
        + f"; ATE bound {ATE_LIKE_FOR_LIKE:.4f} m")
    print(f"[endurance] per frame (host clock, build_frame + track_frame, "
          f"pipelined): median {out['frame_ms_median']:.2f} ms, p90 "
          f"{out['frame_ms_p90']:.2f} ms; {run_s:.1f} s in all; syncs "
          f"{out['syncs_per_frame']:.2f} per frame; peak device memory "
          f"{peak_mb:.1f} MiB")
    print("[endurance] essential graph host ms per closure: "
          + ", ".join(f"{t:.1f}" for t in graph_ms)
          + "; PCG GBA dispatch to application ms: "
          + ", ".join(f"{t:.1f}" for t in pcg_ms))
    for row in timer.summary().splitlines():
        if "lc." in row or "map." in row or "stage" in row or (
                "compact" in row):
            print(f"[endurance] {row}")
    print(f"[endurance] launches: K1 {launches['k1']} (2 x {n} frames), K2 "
          f"{launches['k2']}: loop closer {launches['loop_closer']} (it "
          f"counted {launches['loop_closer_searches']} searches), "
          f"relocalization {launches['relocalization']} (counted "
          f"{launches['relocalization_searches']}); local-map searches on "
          f"a full list {kept['k2_calls']} (the longest list refreshed "
          f"{full_list['longest_refresh']} of {track_step.LOCAL_CAND} ids)")
    if "listed" in full_list:
        print(f"[endurance] phase 4's local_map_full case: the last frame's "
              f"local-map re-search at its pose with the list filled to "
              f"{track_step.LOCAL_CAND} ids: {full_list['listed']} from the "
              f"reference keyframe's neighbourhood, then the nearest other "
              f"live points ({full_list['live']} live in all), then unused "
              "slots")
    for (path, line), c in Counter((os.path.basename(w.filename), w.lineno)
                                   for w in syncs).most_common(8):
        print(f"[endurance] syncs at {path}:{line}: {c}")

    try:
        _need(len(traj_lines) == n, f"{len(traj_lines)} trajectory lines")
        _need(launches["k1"] == 2 * n, f"K1 launched {launches['k1']} times")
        _need(launches["loop_closer"] == lc.k2_searches,
              f"loop closer K2 launches {launches['loop_closer']} vs searches "
              f"{lc.k2_searches}")
        _need(launches["relocalization"] == system.reloc_k2_searches,
              f"relocalization K2 launches {launches['relocalization']} vs "
              f"searches {system.reloc_k2_searches}")
        _need(lc.gba_applied == sum(lc.gba_dispatched.values()),
              f"GBA applied {lc.gba_applied} of {lc.gba_dispatched}")
        _need(lc.loops_closed >= min(_ref_range("loops")),
              f"{lc.loops_closed} loops closed")
        ref_paths = [[(g["path"], g["bucket"]) for g in r["gba"]]
                     for r in REF_DUMBBELL.values()]
        port_paths = [(g["path"], g["bucket"]) for g in gbas]
        for i, (path, bucket) in enumerate(port_paths):
            for ref in ref_paths:
                if i < len(ref) and ref[i][0] == "pcg":
                    _need((path, bucket) == ref[i], f"closure {i}: GBA "
                          f"{path} {bucket}, the JAX run {ref[i]}")
        _need(stats["lost"] <= max(_ref_range("lost")) + 2,
              f"{stats['lost']} frames lost")
        ref_kf = _ref_range("keyframes")
        _need(0.85 * min(ref_kf) <= stats["keyframes"] <= 1.15 * max(ref_kf),
              f"{stats['keyframes']} keyframes, expected within 15% of "
              f"{ref_kf}")
        if max(_ref_range("compactions")) > 0:
            _need(system.compactions >= 1, "no compaction")
        _need(stats["ate"] <= ATE_LIKE_FOR_LIKE,
              f"ATE {stats['ate']:.4f} m, bound {ATE_LIKE_FOR_LIKE:.4f} m")
        t0 = time.perf_counter()
        out["compaction"] = phase_compaction(cfg, dev, system, render)
        print(f"[time] phase 11 (compaction and {COMPACT_NEXT_FRAMES} frames "
              f"after it) in {time.perf_counter() - t0:.1f} s")
    except AssertionError:
        log.print_window()
        raise
    return out, kept


def centre_errors(est_cw: np.ndarray, gt_cw: np.ndarray) -> np.ndarray:
    """Each frame's camera-centre distance (m) after the alignment of
    ``synthetic.ate_rmse`` (Umeyama, no scale)."""
    def centres(T):
        T = np.asarray(T, np.float64)
        return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])

    ce, cg = centres(est_cw), centres(gt_cw)
    mu_e, mu_g = ce.mean(0), cg.mean(0)
    U, _, Vt = np.linalg.svd((ce - mu_e).T @ (cg - mu_g))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    return np.linalg.norm(ce @ R.T + (mu_g - R @ mu_e) - cg, axis=-1)


def _map_snapshot(system) -> dict:
    """The live points (position, descriptor and observations on the host
    and in the device mirror) and keyframes (pose and stored keypoints)
    of a flushed session, by their slot ids."""
    m, tr = system.map, system.tracker
    n_pt, n_kf = m.n_points, m.n_keyframes
    obs = m._obs[: m._obs_n]
    alive = (m._obs_alive[: m._obs_n]
             & m.kf_valid[np.clip(obs[:, 0], 0, m.max_keyframes - 1)]
             & m.pt_valid[np.clip(obs[:, 1], 0, m.max_points - 1)])
    pts = np.where(m.pt_valid[:n_pt])[0]
    kfs = np.where(m.kf_valid[:n_kf])[0]
    d_pts = torch.from_numpy(pts).to(tr.device)
    d_kfs = torch.from_numpy(kfs).to(tr.device)
    return {
        "pts": pts, "kfs": kfs, "obs": obs[alive].copy(),
        "pt_pos": m.pt_pos[pts].copy(), "pt_desc": m.pt_desc_u8[pts].copy(),
        "kf_pose": m.kf_pose[kfs].copy(),
        "dev_pt_pos": tr.dmap.pt_pos[d_pts].cpu().numpy(),
        "dev_pt_desc": tr.dmap.pt_desc_u8[d_pts].cpu().numpy(),
        "dev_pt_obs": tr.dmap.pt_obs_count[d_pts].cpu().numpy(),
        "dev_kf_desc": tr.kf_store.desc_u8[d_kfs].cpu().numpy(),
        "poses": system.frame_poses().copy()}


def phase_compaction(cfg, dev, system, render: PooledRender) -> dict:
    """Compaction on the card, forced on phase 11's flushed session:
    ``System._compact()`` once, then every live point's position,
    descriptor and observations (host and device mirror) and every live
    keyframe's pose and stored descriptors bit-equal under the remap
    (live entries slide down in slot order), ``frame_poses()`` unchanged
    (bit for bit where a frame's reference keyframe lived; within
    ``COMPACT_POSE_ATOL`` where its record was re-expressed through a
    live ancestor), and ``COMPACT_NEXT_FRAMES`` more lap frames tracked
    on the compacted map, none lost."""
    lap = synthetic.figure8_lap_frames()
    before = _map_snapshot(system)
    n_slots = system.map.n_points
    refs = np.array([r.ref_kf for r in system.tracker.trajectory], int)
    re_expressed = ~system.map.kf_valid[np.clip(refs, 0, None)] | (refs < 0)
    t0 = time.perf_counter()
    system._compact()
    torch.cuda.synchronize()
    compact_ms = 1e3 * (time.perf_counter() - t0)
    after = _map_snapshot(system)
    n_pt, n_kf = len(before["pts"]), len(before["kfs"])
    m = system.map
    _need(system.compactions == 1 and m.n_points == n_pt
          and m.n_keyframes == n_kf, f"compaction left {m.n_points} "
          f"points and {m.n_keyframes} keyframes, {n_pt} and {n_kf} live")
    _need(np.array_equal(after["pts"], np.arange(n_pt))
          and np.array_equal(after["kfs"], np.arange(n_kf)),
          "live slots not contiguous after compaction")
    lut_pt = {int(o): i for i, o in enumerate(before["pts"])}
    lut_kf = {int(o): i for i, o in enumerate(before["kfs"])}
    for key in ("pt_pos", "pt_desc", "kf_pose", "dev_pt_pos", "dev_pt_desc",
                "dev_pt_obs", "dev_kf_desc"):
        _need(np.array_equal(before[key], after[key]),
              f"compaction changed {key}")
    obs_before = sorted((lut_kf[int(k)], lut_pt[int(p)], int(i))
                        for k, p, i in before["obs"])
    obs_after = sorted(map(tuple, after["obs"].tolist()))
    _need(obs_before == obs_after, f"observations {len(obs_before)} live "
          f"before, {len(obs_after)} after, or remapped wrongly")
    dp = np.abs(before["poses"].astype(np.float64)
                - after["poses"].astype(np.float64)).reshape(
                    len(refs), -1).max(-1)
    exact = int((dp[~re_expressed] == 0).sum())
    _need(exact == int((~re_expressed).sum()),
          f"frame_poses changed for {int((~re_expressed).sum()) - exact} "
          "frames whose reference keyframe lived")
    _need(float(dp.max(initial=0.0)) <= COMPACT_POSE_ATOL,
          f"frame_poses moved by {dp.max():.3g}")
    # track on: the lap's next frames (frame i shows render i % lap)
    n0 = len(system.tracker.trajectory)
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    t1 = time.perf_counter()
    for i in range(n0, n0 + COMPACT_NEXT_FRAMES):
        left, right, classes = render.frame(i % lap)
        cls, conf, ent = synthetic.structured_semantics(classes, seed=7)
        f = frame_mod.build_frame(
            system.model, system.statics, left, right, system.generator,
            sem_override=(cls, conf, ent, False), device=dev)
        system.track_frame(f, i * 0.1, pipeline=True)
    system.flush()
    track_s = time.perf_counter() - t1
    recs = system.tracker.trajectory[n0:]
    lost = [n0 + j for j, r in enumerate(recs) if r.lost]
    out = {"points": n_pt, "keyframes": n_kf,
           "points_freed": n_slots - n_pt, "observations": len(obs_after),
           "frames_re_expressed": int(re_expressed.sum()),
           "pose_max_diff": float(dp.max(initial=0.0)),
           "compact_ms": compact_ms, "next_frames": len(recs),
           "next_lost": lost, "next_s": track_s,
           "launches": {"k1": kernel_orb.LAUNCHES,
                        "k2": kernel_match.LAUNCHES}}
    print(f"[compaction] forced after the lap: {n_pt} live points and "
          f"{n_kf} live keyframes slid to slots 0.., {out['points_freed']} "
          f"point slots freed, {len(obs_after)} observations; positions, "
          "descriptors, observations (host and device) and keyframe poses "
          f"bit-equal under the remap; frame_poses bit-equal for "
          f"{exact} frames, {out['frames_re_expressed']} re-expressed "
          f"through a live ancestor (largest change {dp.max():.3g}); "
          f"{compact_ms:.1f} ms")
    print(f"[compaction] then {len(recs)} lap frames tracked on the "
          f"compacted map in {track_s:.1f} s, lost {lost}; K1 "
          f"{kernel_orb.LAUNCHES}, K2 {kernel_match.LAUNCHES} launches")
    _need(len(recs) == COMPACT_NEXT_FRAMES and not lost,
          f"after compaction {len(recs)} frames tracked, lost {lost}")
    _need(kernel_orb.LAUNCHES == 2 * COMPACT_NEXT_FRAMES
          and kernel_match.LAUNCHES > 0,
          f"after compaction K1 {kernel_orb.LAUNCHES}, K2 "
          f"{kernel_match.LAUNCHES} launches")
    return out


def save_pcg_problem(path: str, prob, cam, card=None) -> int:
    """A PCG problem (on the CPU) and its camera, with the card's
    solution (a ``BAResult``) where given, as ``torch.save`` of
    ``{"prob", "cam"[, "card"]}`` (``tools/gba190_pcg_study.py``'s
    format); its bytes."""
    saved = {"prob": tuple(t.detach().cpu() for t in prob),
             "cam": tuple(cam)}
    if card is not None:
        saved["card"] = tuple(t.detach().cpu() for t in card)
    torch.save(saved, path)
    return os.path.getsize(path)


def load_pcg_problem(path: str) -> tuple:
    """(problem, camera, the card's ``BAResult`` or None) as
    ``save_pcg_problem`` wrote them."""
    saved = torch.load(path)
    card = saved.get("card")
    return (local_ba.BAProblem(*saved["prob"]), CameraParams(*saved["cam"]),
            None if card is None else local_ba.BAResult(*card))


def _pcg_solve(prob, cam, iterations: int = PCG_ITERATIONS):
    c = gba_cg.gba_cg_begin(prob, cam)
    for _ in range(iterations):
        c = gba_cg.gba_cg_step(c, prob, cam)
    return gba_cg.gba_cg_finish(c, prob, cam)


def _pcg_converged(prob, cam):
    """PCG steps in blocks of ``PCG_BLOCK`` until a block moves no pose
    log component by more than ``PCG_CONVERGED``, at most
    ``PCG_MAX_STEPS``: (result, steps, the last block's largest move)."""
    c = gba_cg.gba_cg_begin(prob, cam)
    steps, moved = 0, float("inf")
    while steps < PCG_MAX_STEPS and moved > PCG_CONVERGED:
        before = c[0]
        for _ in range(PCG_BLOCK):
            c = gba_cg.gba_cg_step(c, prob, cam)
        steps += PCG_BLOCK
        moved = float(_pose_diffs(before, c[0], prob.kf_valid).max())
    return gba_cg.gba_cg_finish(c, prob, cam), steps, moved


def _f64(prob):
    return local_ba.BAProblem(*(t.double() if t.dtype == torch.float32
                                else t for t in prob))


def _pcg_shuffled(prob, cam, seed: int):
    """The solve with the observations in another order (the sums of
    the CG products change order, as the card's atomics do),
    its inlier flags put back in the problem's order."""
    perm = torch.randperm(prob.obs_kf.shape[0],
                          generator=torch.Generator().manual_seed(seed))
    sh = _pcg_solve(prob._replace(**{
        f: getattr(prob, f)[perm] for f in prob._fields
        if f.startswith("obs_")}), cam)
    return sh._replace(obs_inlier=torch.empty_like(
        sh.obs_inlier).index_copy_(0, perm, sh.obs_inlier))


def _lowest_priority() -> None:
    """A CPU worker's set-up: the lowest priority."""
    os.nice(19)


def _cpu_pool(workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_lowest_priority)


def _pcg_order(args):
    """A worker's ``_pcg_shuffled``, on one thread."""
    torch.set_num_threads(1)
    return _pcg_shuffled(*args)


def _pcg_reference(args):
    """A worker's CPU float32 solve of ``prob``, its ms, and its float64
    solve, on ``threads`` threads: the parent's count, so that they
    round as the parent's own solves would."""
    prob, cam, threads = args
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    cpu = _pcg_solve(prob, cam)
    return cpu, 1e3 * (time.perf_counter() - t0), _pcg_solve(_f64(prob),
                                                             cam)


def pcg_orders(prob, cam, seeds) -> list:
    """``_pcg_shuffled`` on the CPU problem ``prob`` for each of
    ``seeds``, one spawned process per order (one thread each,
    ``RENDER_WORKERS`` at a time): the CPU's float noise at about the
    wall time of one solve."""
    seeds = list(seeds)
    with _cpu_pool(min(len(seeds), RENDER_WORKERS)) as pool:
        return list(pool.map(_pcg_order, [(prob, cam, s) for s in seeds]))


class PcgNoise:
    """``phase_pcg``'s CPU side of a problem, started at construction in
    spawned processes at the lowest priority, so that it runs beside the
    card's work until ``phase_pcg`` asks for it: the CPU float32 solve
    (timed) and the float64 solve on this process's thread count, and
    ``_pcg_shuffled`` on ``PCG_SHUFFLES`` orders, one thread each.
    ``prob``: the problem's CPU copy. ``result()`` waits for them and
    stops the workers: (float32 solve, its ms, float64 solve, the
    shuffled solves); ``close()``, or leaving a ``with`` block, stops
    them."""

    def __init__(self, prob, cam):
        self.prob = local_ba.BAProblem(*(t.cpu() for t in prob))
        self.pool = _cpu_pool(min(RENDER_WORKERS, PCG_SHUFFLES + 1))
        self.reference = self.pool.submit(
            _pcg_reference, (self.prob, cam, torch.get_num_threads()))
        self.orders = [self.pool.submit(_pcg_order, (self.prob, cam, s))
                       for s in range(PCG_SHUFFLES)]

    def result(self) -> tuple:
        try:
            return (*self.reference.result(),
                    [f.result() for f in self.orders])
        finally:
            self.close()

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)

    def __enter__(self) -> "PcgNoise":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _pcg_distance(a, b, pt_valid) -> dict:
    """Two PCG solves' largest pose entry difference, 99th percentile
    and largest point difference (m) over the valid points, chi2 of a
    above that of b relative to b's, and inlier flags that differ."""
    dp = (a.pt_pos.cpu().double() - b.pt_pos.cpu().double()).abs().amax(
        -1)[pt_valid]
    ca, cb = float(a.chi2), float(b.chi2)
    return {"pose": float((a.kf_pose.cpu().double()
                           - b.kf_pose.cpu().double()).abs().max()),
            "point_p99": float(torch.quantile(dp, 0.99)) if len(dp) else 0.0,
            "point_max": float(dp.max()) if len(dp) else 0.0,
            "chi2_rel": (ca - cb) / max(abs(cb), 1e-30),
            "inlier_differ": int((a.obs_inlier.cpu()
                                  != b.obs_inlier.cpu()).sum())}


def pcg_bound(floors: list[dict]) -> tuple[dict, dict]:
    """The CPU's noise, the largest of each of ``floors``' distances
    (``_pcg_distance``), and the card-against-CPU tolerance it gives:
    the larger of ``PCG_TOLS`` and twice that noise."""
    most = {k: max(abs(f[k]) for f in floors) for k in floors[0]}
    return most, {k: max(v, 2 * most[k]) for k, v in PCG_TOLS.items()}


def pcg_misses(got: dict, floors: list[dict]) -> list[str]:
    """The card-against-CPU gates of ``phase_pcg`` that the distances
    ``got`` fail with the noise measured by ``floors``: keys of
    ``PCG_TOLS``, and "inlier" where more inlier flags differ than
    twice the noise's most."""
    most, tol = pcg_bound(floors)
    return [k for k in PCG_TOLS if got[k] > tol[k]] + (
        ["inlier"] if got["inlier_differ"] > 2 * most["inlier_differ"]
        else [])


def _pcg_against_dense(name: str, prob, cam, card) -> tuple[dict, list]:
    """``phase_pcg``'s check against the dense GBA on the card: its
    numbers and its gates, the lines printed."""
    dense = local_ba.global_bundle_adjustment(prob, cam,
                                              iterations=GBA_ITERATIONS)
    gap10 = float(_pose_diffs(dense.kf_pose, card.kf_pose,
                              prob.kf_valid).max())
    gap20 = float(_pose_diffs(dense.kf_pose, _pcg_solve(
        prob, cam, 2 * PCG_ITERATIONS).kf_pose, prob.kf_valid).max())
    prob64 = _f64(prob)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense64 = local_ba.global_bundle_adjustment(
        prob64, cam, iterations=DENSE_F64_ITERATIONS)
    pcg64, steps, moved = _pcg_converged(prob64, cam)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    dpose = float(_pose_diffs(dense64.kf_pose, pcg64.kf_pose,
                              prob.kf_valid).max())
    dpt = _point_diff(dense64.pt_pos, pcg64.pt_pos, prob.pt_valid)
    dense_gap = float(_pose_diffs(dense64.kf_pose, dense.kf_pose,
                                  prob.kf_valid).max())
    print(f"[pcg] {name}: float32 on the card (reported, not gated): "
          f"{PCG_ITERATIONS} and {2 * PCG_ITERATIONS} PCG steps lie "
          f"{gap10:.3g} and {gap20:.3g} (largest pose log component) "
          f"from the dense GBA's {GBA_ITERATIONS} iterations, which lie "
          f"{dense_gap:.3g} from the float64 dense GBA")
    print(f"[pcg] {name}: float64 on the card, PCG to convergence "
          f"({steps} steps, the last {PCG_BLOCK} moving a pose "
          f"{moved:.3g}) against the dense GBA ({DENSE_F64_ITERATIONS} "
          f"iterations): largest pose log component {dpose:.3g} (<= "
          f"{SHARDED_POSE_TOL}), median point difference {dpt:.3g} m "
          f"(< {SHARDED_POINT_TOL}); chi2 {float(pcg64.chi2):.10g} "
          f"against {float(dense64.chi2):.10g}; both in {f64_s:.1f} s")
    return (dict(dense_pose_max=dpose, dense_point_median_m=dpt,
                 pcg_f64_steps=steps, pcg_f64_last_block_move=moved,
                 f64_s=f64_s, f32_pcg10_vs_dense=gap10,
                 f32_pcg20_vs_dense=gap20, f32_dense_vs_f64=dense_gap),
            [(dpose <= SHARDED_POSE_TOL, f"{name}: float64 PCG poses "
              f"differ from the float64 dense GBA by {dpose:.3g}"),
             (dpt < SHARDED_POINT_TOL, f"{name}: float64 PCG points "
              f"differ from the float64 dense GBA by {dpt:.3g} m "
              "(median)")])


def _need_pcg(name: str, gates: list, prob, cam, card,
              miss_dir: str) -> None:
    """``_need`` on each of ``gates`` ((ok, what) pairs); where one
    fails, the problem and the card's float32 solve are first saved to
    ``miss_dir`` (``save_pcg_problem``), the path and bytes on a line of
    their own."""
    if not all(ok for ok, _ in gates):
        os.makedirs(miss_dir, exist_ok=True)
        path = os.path.join(miss_dir, "pcg_" + "".join(
            c if c.isalnum() else "_" for c in name) + ".pt")
        nbytes = save_pcg_problem(path, prob, cam, card)
        print(f"[pcg] {name}: a gate failed; the problem and the card's "
              f"float32 solve saved to {path} ({nbytes} bytes)", flush=True)
    for ok, what in gates:
        _need(ok, what)


def phase_pcg(name: str, case, against_dense: bool, noise: PcgNoise,
              miss_dir: str = PCG_MISS_DIR) -> dict:
    """The PCG GBA (``gba_cg``: begin, ``PCG_ITERATIONS`` steps, finish)
    on a kept problem on the card, held to the same solve on the CPU
    copy of the problem (``noise``, started when the problem was kept),
    in float64 and in float32: each distance within the larger of
    ``PCG_TOLS`` (the chi2's one-sided) and twice the CPU solve's own
    noise in that precision (its largest distance to itself on
    ``PCG_SHUFFLES`` orders of the observations; in float32 also to its
    float64 solve; in float64 measured only where ``PCG_TOLS`` is not
    met), the inlier flags differing no more than twice as often as
    that noise makes them. With ``against_dense``, PCG to convergence
    in float64 on the card is also held to the dense
    ``global_bundle_adjustment`` in float64 on the card within 10b's
    bounds. Where a gate fails, the problem and the card's float32
    solve are first saved to ``miss_dir`` (``_need_pcg``)."""
    prob, cam = case
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = _pcg_solve(prob, cam)
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    card64 = _pcg_solve(_f64(prob), cam)
    out, gates = (_pcg_against_dense(name, prob, cam, card)
                  if against_dense else ({}, []))
    cpu_prob = noise.prob
    cpu, cpu_ms, f64, shuffled = noise.result()
    pv = cpu_prob.pt_valid
    got = _pcg_distance(card, cpu, pv)
    got64 = _pcg_distance(card64, f64, pv)
    floors = [_pcg_distance(cpu, f64, pv)] + [
        _pcg_distance(sh, cpu, pv) for sh in shuffled]
    # the float64 noise costs PCG_SHUFFLES more CPU solves: measured only
    # where the card's float64 solve is not within PCG_TOLS of the CPU's
    floors64 = [] if got64["inlier_differ"] == 0 and all(
        got64[k] <= v for k, v in PCG_TOLS.items()) else [
        _pcg_distance(sh, f64, pv)
        for sh in pcg_orders(_f64(cpu_prob), cam, range(PCG_SHUFFLES))]

    floor, tol = pcg_bound(floors)
    floor64, tol64 = (pcg_bound(floors64) if floors64
                      else ({"inlier_differ": 0}, PCG_TOLS))
    out.update({"caps": [prob.kf_pose.shape[0], prob.pt_pos.shape[0],
                         prob.obs_kf.shape[0]],
                "valid": [int(prob.kf_valid.sum()), int(pv.sum()),
                          int(prob.obs_valid.sum())],
                "card_ms": card_ms, "cpu_ms": cpu_ms, "card_vs_cpu": got,
                "card_vs_cpu_f64": got64, "cpu_f32_vs_f64": floors[0],
                "cpu_vs_shuffled": floors[1:], "tolerance": tol,
                "cpu_f64_vs_shuffled": floors64, "tolerance_f64": tol64})
    print(f"[pcg] {name}: caps {out['caps']}, valid {out['valid']}; "
          f"begin + {PCG_ITERATIONS} steps + finish on the card "
          f"{card_ms:.1f} ms (wall), on the CPU {cpu_ms:.1f} ms (in a "
          f"worker beside the card's work); chi2 card "
          f"{float(card.chi2):.8g}, CPU {float(cpu.chi2):.8g}, float64 card "
          f"{float(card64.chi2):.10g}, CPU {float(f64.chi2):.10g}")
    for k in PCG_TOLS:
        def orders(fl, k=k):
            return ", ".join(f"{f[k]:.3g}" for f in fl)

        noise64 = (f", CPU float64 against itself on {PCG_SHUFFLES} "
                   f"shuffled orders {orders(floors64)}" if floors64 else "")
        print(f"[pcg] {name}: {k} float64 card against CPU {got64[k]:.3g} "
              f"(<= {tol64[k]:.3g}){noise64}; float32 "
              f"card against CPU {got[k]:.3g} (<= {tol[k]:.3g}); CPU float32 "
              f"against float64 {floors[0][k]:.3g}, against itself on "
              f"{PCG_SHUFFLES} shuffled orders {orders(floors[1:])}")
    inliers64 = (" (CPU float64 on shuffled orders " + ", ".join(
        str(f["inlier_differ"]) for f in floors64) + ")") if floors64 else ""
    print(f"[pcg] {name}: inlier flags differing, float64 card against CPU "
          f"{got64['inlier_differ']}{inliers64}, float32 card against CPU "
          f"{got['inlier_differ']}, CPU float32 against float64 "
          f"{floors[0]['inlier_differ']}, against itself on shuffled "
          f"orders " + ", ".join(str(f["inlier_differ"])
                                 for f in floors[1:]))
    for k in PCG_TOLS:
        gates += [(got64[k] <= tol64[k], f"{name}: float64 PCG {k} card "
                   f"against CPU {got64[k]:.3g} > {tol64[k]:.3g}"),
                  (got[k] <= tol[k], f"{name}: PCG {k} card against CPU "
                   f"{got[k]:.3g} > {tol[k]:.3g}")]
    gates += [(got64["inlier_differ"] <= 2 * floor64["inlier_differ"],
               f"{name}: {got64['inlier_differ']} float64 PCG inlier flags "
               f"differ card against CPU (the CPU's float64 floor "
               f"{floor64['inlier_differ']})"),
              (got["inlier_differ"] <= 2 * floor["inlier_differ"],
               f"{name}: {got['inlier_differ']} PCG inlier flags differ "
               f"card against CPU (the CPU's float32 floor "
               f"{floor['inlier_differ']})")]
    _need_pcg(name, gates, prob, cam, card, miss_dir)
    return out


@contextlib.contextmanager
def _timed_phase(name: str, seconds: dict):
    """Print the block's seconds on a line of its own."""
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0
    print(f"[time] phase {name}: {seconds[name]:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    sec = {}
    card = phase_card()
    with _timed_phase("1 (build)", sec):
        phase_build()
    cfg = SystemConfig()
    statics = frame_mod.make_statics(cfg)
    with _timed_phase("render (loop world)", sec):
        gt_all, left_all, right_all, sems_all, cls_all = make_scene(
            cfg, N_LOOP_FRAMES)
    gt, left, right = gt_all[:N_FRAMES], left_all[:N_FRAMES], right_all[
        :N_FRAMES]
    sems = sems_all[:N_FRAMES]
    noise: dict[str, PcgNoise] = {}
    with (tempfile.TemporaryDirectory(prefix="chip_smoke_") as work,
          contextlib.ExitStack() as stack):
        with _timed_phase("2 (K1)", sec):
            k1 = phase_k1(statics, left[0], dev)
        with _timed_phase("3 (SegNet basic)", sec):
            model = phase_segnet(cfg, left[0], dev)
        with _timed_phase("3b (SegNet standard)", sec):
            standard = phase_segnet_standard(cfg, left[0], dev, work)
        with _timed_phase("3c (training)", sec):
            trained = phase_train(cfg, left_all, cls_all, dev, work)
        with _timed_phase("5 (slice)", sec):
            slice_launches, cases, calls = phase_slice(
                cfg, statics, model, gt, left, right, sems, dev)
        with _timed_phase("6 (minting run, the warm-up)", sec):
            cases["fusion"], ba_case = capture_system_cases(
                cfg, gt, left, right, sems, dev)
        with _timed_phase("6 (session)", sec):
            system = phase_system(cfg, gt, left, right, sems, dev,
                                  ba_case)
        calls["fusion"] = system["launches"]["k2_mapper"] / N_FRAMES
        with _timed_phase("4 (K2)", sec):
            k2 = phase_k2(cases, calls)
        with _timed_phase("7 (loop session)", sec):
            loop = phase_loop(cfg, gt_all, left_all, right_all,
                              sems_all, dev, work)
            k2_sim3 = phase_k2({"sim3": loop.pop("sim3_case")},
                               {"sim3": loop.pop("sim3_calls_per_frame")})
        gba_case = loop.pop("gba_case")
        # the CPU's side of the PCG checks, beside phases 8-10
        noise["gba190"] = stack.enter_context(PcgNoise(*gba_case))
        k2["cases"]["sim3"] = k2_sim3["cases"]["sim3"]
        k2["max_abs_err"] = max(k2["max_abs_err"],
                                k2_sim3["max_abs_err"])
        with _timed_phase("8 (command line)", sec):
            cli_run = phase_cli(cfg, gt, left, right, cls_all, dev,
                                standard.pop("caffemodel"),
                                trained.pop("caffemodel"), work)
        with _timed_phase("9 (vocabulary tool)", sec):
            vocab_tool = phase_vocab_tool(statics, left[0], right[0],
                                          sems[0], dev, work)
        with _timed_phase("10 (parallel)", sec):
            multi = phase_multi_sequence(cfg, gt_all, left_all,
                                         right_all, sems_all, dev)
            sharded = phase_sharded_ba(gba_case, work)
            parallel = {"multi_sequence": multi.pop("sessions"),
                        "multi_sequence_wall_s": multi["wall_s"],
                        "sharded_ba": sharded, "entry": phase_entry()}
        with _timed_phase("11 (endurance, beside its lap's render)", sec):
            dumbbell = dumbbell_render(cfg)
            try:
                endurance, kept = phase_endurance(
                    cfg, dev, dumbbell, work, kept_pcg=lambda case:
                    noise.setdefault("dumbbell434", stack.enter_context(
                        PcgNoise(*case))))
            finally:
                dumbbell.close()
        with _timed_phase("11 (PCG GBA; K2 local map, full list)", sec):
            pcg = {"gba190": phase_pcg("phase 7's GBA problem",
                                       gba_case, True, noise["gba190"])}
            if "pcg" in kept:
                pcg["dumbbell434"] = phase_pcg(
                    "phase 11's first PCG problem", kept["pcg"], False,
                    noise["dumbbell434"])
            k2_full = phase_k2(
                {"local_map_full": kept["k2"]},
                {"local_map_full": kept["k2_calls"] / DUMBBELL_FRAMES})
            k2["cases"]["local_map_full"] = k2_full["cases"][
                "local_map_full"]
            k2["max_abs_err"] = max(k2["max_abs_err"],
                                    k2_full["max_abs_err"])
    sec["total"] = time.perf_counter() - t_start
    print(f"[time] chip_smoke.py in {sec['total']:.1f} s")
    print(card)  # again, beside the totals at the end of a long output
    launches = loop["launches"]
    run_c = cli_run.pop("run_c")
    print(json.dumps({"kernels": [
        {"name": "orb_describe", "route": "cuda",
         "source": "sivo_tpu_torch/csrc/orb_describe.cu",
         "replaces": "sivo_tpu/ops/pallas_orb.py:218",
         "launches": launches["k1"],
         "launches_per_frame": launches["k1"] / N_LOOP_FRAMES,
         "launches_cli": cli_run["launches"]["k1"],
         "launches_cli_trained": run_c["launches"]["k1"],
         "launches_vocab_tool": vocab_tool["launches"]["k1"],
         "launches_session_no_loop": system["launches"]["k1"],
         "launches_tracker_slice": slice_launches["k1"],
         "launches_multi_sequence": multi["launches"]["k1"],
         "launches_endurance": endurance["launches"]["k1"],
         "launches_endurance_per_frame":
         endurance["launches"]["k1"] / DUMBBELL_FRAMES, **k1,
         "library_ms": None,
         "library_note": NO_LIBRARY + "PyTorch has no oriented BRIEF"},
        {"name": "hamming_top2", "route": "cuda",
         "source": "sivo_tpu_torch/csrc/hamming_top2.cu",
         "replaces": "sivo_tpu/ops/pallas_match.py:166",
         "launches": launches["k2"],
         "launches_per_frame": launches["k2"] / N_LOOP_FRAMES,
         "launches_cli": cli_run["launches"]["k2"],
         "launches_cli_trained": run_c["launches"]["k2"],
         "launches_vocab_tool": vocab_tool["launches"]["k2"],
         "launches_loop_closer": launches["loop_closer"],
         "launches_relocalization": launches["relocalization"],
         "launches_relocalization_kidnap": launches["relocalization_kidnap"],
         "launches_session_no_loop": system["launches"]["k2"],
         "launches_mapper_fusion": system["launches"]["k2_mapper"],
         "launches_tracker_slice": slice_launches["k2"],
         "launches_multi_sequence": multi["launches"]["k2"],
         "launches_endurance": endurance["launches"]["k2"],
         "launches_endurance_per_frame":
         endurance["launches"]["k2"] / DUMBBELL_FRAMES,
         "launches_endurance_loop_closer":
         endurance["launches"]["loop_closer"],
         "launches_endurance_relocalization":
         endurance["launches"]["relocalization"], **k2,
         "library_ms": None,
         "library_note": NO_LIBRARY + "PyTorch has no masked top-2 with "
         "first-index ties"},
    ], "system": {k: v for k, v in system.items() if k != "launches"},
        "loop": {k: v for k, v in loop.items() if k != "launches"},
        "segnet_standard": standard, "train": trained,
        "cli": {k: v for k, v in cli_run.items() if k != "launches"},
        "cli_trained": {k: v for k, v in run_c.items() if k != "launches"},
        "vocab_tool": {k: v for k, v in vocab_tool.items()
                       if k != "launches"},
        "parallel": parallel,
        "endurance": {k: v for k, v in endurance.items() if k != "launches"},
        "pcg": pcg, "phase_s": sec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
