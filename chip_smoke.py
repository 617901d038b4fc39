#!/usr/bin/env python3
"""Chip smoke test of sivo_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA card and ``nvcc`` (it builds the kernels from ``sivo_tpu_torch/csrc``
on first use) and imports nothing of JAX or of the JAX package. Phases,
each raising on failure:

0. the card: ``torch.cuda.is_available()``, nvidia-smi name + power limit;
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
   of the JAX seeds' range (``REF_CNN['holdout_entropy']``). Then the
   same four seeds on this machine's render of the lap, reported beside
   them with the per-seed gates only;
4. K2 against its plain version on the inputs of its four searches on
   the main path, each at (2048, 2048): motion, local map and brute
   force kept from their last calls in one run of the slice (the
   slice's warm-up), and the mapper's fusion kept from its last call in
   the warm-up run of phase 6; distances and both argmins must be equal;
   times; bound per case;
5. the slice through the port's entry points (``build_frame`` ->
   ``Tracker.track``, no mapper) on the bench loop world's first 40
   frames, against the JAX package's CPU run of the same frames (0 lost,
   ATE 0.0145 m, 12 keyframes): 0 lost, ATE <= 0.10 m, keyframes 12 +- 3,
   K1 launched twice per frame and K2 at least once per tracked frame;
6. the SLAM session through the system's entry point:
   ``System(cfg, device=cuda, max_keyframes=256, max_points=32768)``,
   ``track_stereo`` on the same 40 frames (SegNet basic running, the
   renderer's semantics as ``sem_override``), ``flush``, then
   ``save_trajectory_kitti`` and ``shutdown`` into a temporary
   directory. Against the JAX package's CPU ``System`` on the same
   frames (``tools/loop40_jax_reference.py``, two runs, whose mapper
   timing differs: 0 lost, ATE 0.0150 / 0.0080 m, 12 / 13 keyframes, 8
   BA solves, 0 / 1 points triangulated): 0 lost, ATE <= 0.10 m over
   ``frame_poses()``, keyframes within 3 of 12-13, at least one BA
   solve applied, triangulation run on the keyframes, K1 launched twice
   per frame, the mapper's K2 launches equal to the fusion searches it
   counted, a 40-line trajectory file and the counts file. This cell's
   entropy-reduction gate (4.0, the reference's KITTI setting) lets
   almost no triangulated candidate through, in the JAX package too, so
   a minting run follows: the first 12 frames with the gate at 0.02 (as
   in tests/test_compact.py), where triangulation must mint points and
   the host and device maps must hold the same ones. Phase 6's warm-up
   run keeps a copy of K2's inputs at the last fusion search (phase 4's
   fusion case) and of the last local BA problem, which is replayed once
   under the profiler for its device time and launches per solve.
7. the loop session: the same ``System``, with the repository's offline
   vocabulary (``sivo_tpu/place/data/orbvoc_synth.npz``, read as data)
   given through ``attach_vocabulary``, on all 190 frames of the bench
   loop world, then ``flush``, ``frame_poses``, ``save_trajectory_kitti``
   and ``shutdown``. Against the JAX package's CPU ``System`` with the
   same vocabulary on the same frames (``tools/loop190_jax_reference.py``,
   two runs, ``REF_LOOP``): at least one loop closed, the global BA
   applied after it, lost frames no more than the JAX runs', keyframes
   within 5 of theirs, ATE over ``frame_poses()`` <= 0.10 m and no worse
   than twice theirs, a 190-line trajectory; the loop closer's and
   relocalization's K2 launches equal to the searches they counted. Then
   a kidnap on the same ``System``: the believed pose teleported 4 m and
   frame-to-frame continuity severed, an early frame replayed twice; the
   second call must relocalize within 0.5 m of ground truth. The run
   keeps a copy of K2's inputs at the last guided ``search_by_sim3`` call
   (phase 4's ``sim3`` case, checked and timed after the run), and counts
   device syncs over all 190 frames.

8. the command line, ``sivo_tpu_torch.cli.run`` in this process, on the
   first 40 rendered frames written as a KITTI directory (``image_2/``,
   ``image_3/`` PNGs, ``times.txt`` at the camera's fps, a
   ``settings.yaml``) with the offline vocabulary written as DBoW text.
   Run A: ``VOC SETTINGS bayesian_segnet_kitti.prototxt
   standard.caffemodel DIR`` (SegNet standard from phase 3b's file, the
   native vocabulary parser, loop closing on), its launch counters set
   to 0 just before it and read just after, syncs counted; against the
   JAX package's command line with ``--no-semantics`` on the same
   directory (``tools/cli40_jax_reference.py``, ``REF_CLI``: two runs as
   it runs on the CPU, and two with its host fetches landed by the next
   frame, as the card's are): the loading lines, the native parse, one
   SegNet standard forward per frame (a forward hook), a 40-row
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
   line on the JAX recipe's networks with semantics on and its fetches
   landed (``tools/cnn40_jax_reference.py``, ``REF_CNN``, one run on
   each of the eight seeds' networks; the ranges below are over them):
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

Phases 2-6 and 8 run on the first 40 of the 190 rendered frames; phase
3c trains on every 8th of the 190.

Kernel times: ``BATCH`` back-to-back calls captured in a CUDA graph,
its replay timed between two CUDA events and divided by ``BATCH``; the
median over ``RUNS`` replays. So a short kernel is timed neither as one
launch's latency nor as its wrapper's host cost. Plain versions: the
same without the graph. Bounds: the larger of the bytes the
function must move over 3.35 TB/s and its float32 operations over 67
TFLOP/s, counted from this run's inputs (``k1_bound``, ``k2_bound``).

The second-to-last line of standard output is a JSON object of the
kernels' launches (``launches_cli``: in phase 8's run A;
``launches_cli_trained``: run C; ``launches_vocab_tool``: phase 9),
errors, times and bounds; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import cv2
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sivo_tpu_torch import cli, native  # noqa: E402
from sivo_tpu_torch.config import SystemConfig  # noqa: E402
from sivo_tpu_torch.io import synthetic  # noqa: E402
from sivo_tpu_torch.models import caffe_io, segnet, train  # noqa: E402
from sivo_tpu_torch.ops import (  # noqa: E402
    image, kernel_match, kernel_orb, matching, orb)
from sivo_tpu_torch.optim import local_ba  # noqa: E402
from sivo_tpu_torch.place import vocabulary as voc_mod  # noqa: E402
from sivo_tpu_torch.runtime import frame as frame_mod  # noqa: E402
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


def phase_card() -> None:
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


def phase_build() -> None:
    """Phase 1: build the kernels from csrc/ and load them."""
    path, build_s, report = kernels.build()
    kernels.library()
    print(f"[build] {path.name} in {build_s:.1f} s")
    for line in report.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill")):
            print(f"[build] {line.strip()}")


def make_scene(cfg: SystemConfig, n_frames: int):
    """The bench loop world (bench.py) and its first ``n_frames`` frames,
    rendered on the host, with renderer semantics (seed 7): (ground
    truth, left, right, semantics, the renderer's class maps)."""
    t0 = time.perf_counter()
    world = synthetic.make_loop_world(cfg.camera, seed=0, outer=16.0,
                                      inner=6.0)
    gt = synthetic.square_loop_trajectory(n_frames=N_LOOP_FRAMES, half=9.5,
                                          corner_r=3.5, jitter=0.03)
    gt = gt[:n_frames]
    left, right, cls_maps = synthetic.render_sequence(world, gt, ss=2)
    sems = [synthetic.structured_semantics(c, seed=7) for c in cls_maps]
    print(f"[scene] rendered {n_frames} frames at "
          f"{cfg.camera.height}x{cfg.camera.width} in "
          f"{time.perf_counter() - t0:.1f} s (host)")
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
# tools/train_bench_segnet.py) and its command line on each network with
# semantics on and its host fetches landed on return (the card's regime):
# tools/cnn40_jax_reference.py, one entry per seed
REF_CNN = {"holdout_acc": (0.868, 0.817, 0.877, 0.862, 0.789, 0.817, 0.811,
                           0.834),
           "holdout_entropy": (0.8997, 0.564, 0.4824, 0.6366, 0.4649, 0.6855,
                               0.4595, 0.5324),
           "ate": (0.0112, 0.0112, 0.0097, 0.0126, 0.0149, 0.0109, 0.0086,
                   0.0115),
           "keyframes": (16, 17, 17, 14, 18, 17, 17, 17),
           "lost": (0, 0, 0, 0, 0, 0, 0, 0),
           "pixel_acc": (0.84, 0.8416, 0.8827, 0.8736, 0.8277, 0.8433, 0.8372,
                         0.8603),
           "entropy": (0.9255, 0.5625, 0.4723, 0.631, 0.4818, 0.7399, 0.4498,
                       0.5468),
           "gate_share": (0.9982, 0.9981, 1.0, 0.9987, 0.9911, 0.9942, 0.9946,
                          0.9996)}
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
    Then once per seed on this machine's render of the same frames,
    reported beside them. Returns the file's path and the numbers."""
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
    card = train_seeds("this machine's render", card_left, card_cls, dev,
                       cnn_dtype)
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
            "reference_frames": ref, "card_render": card}


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


def capture_k2_cases(cfg, statics, model, left, right, sems, dev):
    """One run of the slice (the warm-up of phase 5) that keeps a copy of
    K2's inputs at the last call of each of its three searches. Returns
    ({name: (a, b, row, col, use_ur)}, each at (2048, 2048); {name:
    calls per frame})."""
    top2 = kernel_match.masked_hamming_top2
    searches = {name: getattr(matching, fn) for name, fn in SEARCHES.items()}
    cases, calls, current = {}, dict.fromkeys(SEARCHES, 0), [None]

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
        run_slice(cfg, statics, model, left, right, sems, dev)
    finally:
        kernel_match.masked_hamming_top2 = top2
        for name, fn in SEARCHES.items():
            setattr(matching, fn, searches[name])
    _need(set(cases) == set(SEARCHES), f"K2 searches seen: {sorted(cases)}")
    for name, (a_u8, b_u8, *_) in cases.items():
        shape = (a_u8.shape[0], b_u8.shape[0])
        _need(shape == (2048, 2048), f"K2 {name} shape {shape}")
    return cases, {name: c / len(left) for name, c in calls.items()}


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


def phase_slice(cfg, statics, model, gt, left, right, sems, dev) -> dict:
    """Phase 5: the slice, timed with torch's sync debug mode on (a
    warning per sync costs the host microseconds against a frame's
    hundreds of milliseconds) and the launch counters read around it,
    then checked against the JAX package's CPU run. Its warm-up is
    ``capture_k2_cases``."""
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    tracker, est, t_front, t_track, syncs = run_slice(
        cfg, statics, model, left, right, sems, dev, count_syncs=True)
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
    return launches



# the JAX package's CPU System on the same 40 frames, two runs
# (tools/loop40_jax_reference.py); its mapper's timing differs by run
REF_SYSTEM = {"lost": (0, 0), "ate": (0.0150, 0.0080), "keyframes": (12, 13),
              "ba_solves": (8, 8), "triangulated": (0, 1)}
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


def run_system(cfg, left, right, sems, dev, count_syncs: bool = False,
               vocabulary=None):
    """The port's SLAM session: ``System.track_stereo`` on each frame
    (host clock between device syncs), then ``flush``; with a
    ``vocabulary``, attached after construction (loop closing and
    relocalization). With ``count_syncs`` torch's sync debug mode is on
    and the syncs raised inside the mapper's ``advance`` are counted
    apart. Returns (system, per-frame ms, sync warnings, syncs inside the
    mapper)."""
    system = System(cfg=cfg, device=dev, max_keyframes=256,
                    max_points=32768)
    if vocabulary is not None:
        system.attach_vocabulary(vocabulary)
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
    """One run of the session (the warm-up of phase 6) that keeps a copy
    of K2's inputs at the last fusion search and of the last local BA
    problem. Returns (K2 fusion case, fusion searches per frame, BA
    problem, the run's ``session_stats``)."""
    top2 = kernel_match.masked_hamming_top2
    fuse_search = LocalMapper._fuse_search
    solve = local_ba.local_bundle_adjustment
    kept, in_fusion = {}, [False]

    def record(a_u8, b_u8, row, col, use_ur=True):
        if in_fusion[0]:
            kept["k2"] = (*(t.clone() for t in (a_u8, b_u8, row, col)),
                          use_ur)
            kept["calls"] = kept.get("calls", 0) + 1
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

    kernel_match.masked_hamming_top2 = record
    LocalMapper._fuse_search = tagged_fuse_search
    local_ba.local_bundle_adjustment = kept_solve
    try:
        system = run_system(cfg, left, right, sems, dev)[0]
    finally:
        kernel_match.masked_hamming_top2 = top2
        LocalMapper._fuse_search = fuse_search
        local_ba.local_bundle_adjustment = solve
    _need("k2" in kept and "ba" in kept,
          f"phase 6 warm-up ran fusion/BA: {sorted(kept)}")
    shape = (kept["k2"][0].shape[0], kept["k2"][1].shape[0])
    _need(shape == (2048, 2048), f"K2 fusion shape {shape}")
    return (kept["k2"], kept["calls"] / len(left), kept["ba"],
            session_stats(system, gt))


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


def phase_minting(cfg, gt, left, right, sems, dev) -> None:
    """Phase 6's minting run: the session on the first ``MINT_FRAMES``
    frames with the entropy-reduction gate at ``MINT_TH_ENTROPY``, so
    that triangulation mints points at full width; the host map and the
    device map must then hold the same points (the id lockstep)."""
    mint_cfg = dataclasses.replace(cfg, semantic=dataclasses.replace(
        cfg.semantic, th_entropy_reduction=MINT_TH_ENTROPY))
    k = MINT_FRAMES
    system = run_system(mint_cfg, left[:k], right[:k], sems[:k], dev)[0]
    stats = session_stats(system, gt[:k])
    m, dm = system.map, system.tracker.dmap
    n_pts = m.n_points
    dev_valid = dm.pt_valid[:n_pts].cpu().numpy()
    pos_err = float(np.abs(dm.pt_pos[:n_pts].cpu().numpy()
                           - m.pt_pos[:n_pts]).max()) if n_pts else 0.0
    print(f"[system] minting run ({k} frames, entropy gate "
          f"{MINT_TH_ENTROPY}): {_stats_text(stats)}; map points host "
          f"{n_pts}, device {int(dm.n_points)}, position max diff "
          f"{pos_err:.3g} m")
    _need(stats["lost"] == 0, f"minting run: {stats['lost']} frames lost")
    _need(stats["triangulated"] > 0, "minting run: triangulation minted "
          "no point")
    _need(int(dm.n_points) == n_pts
          and np.array_equal(dev_valid, m.pt_valid[:n_pts]),
          "minting run: host and device maps differ")
    _need(pos_err <= 1e-6, f"minting run: positions differ by {pos_err}")


def phase_system(cfg, gt, left, right, sems, dev, ba_case,
                 warmup_stats) -> dict:
    """Phase 6: the session, timed with torch's sync debug mode on and
    the launch counters set to 0 just before it and read just after,
    then its outputs and gates; the minting run follows."""
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
          "reference, two runs: "
          + ", ".join(f"{k} {v}" for k, v in REF_SYSTEM.items()))
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
    print("[system] run to run: warm-up " + _stats_text(warmup_stats)
          + "; timed " + _stats_text(stats))
    for (path, line), c in Counter((os.path.basename(w.filename), w.lineno)
                                   for w in syncs).most_common():
        print(f"[system] syncs at {path}:{line}: {c}")

    _need(lost == 0, f"{lost} frames lost")
    _need(ate <= 0.10, f"ATE {ate:.4f} m > 0.10 m")
    ref_kf = REF_SYSTEM["keyframes"]
    _need(min(ref_kf) - 3 <= n_kf <= max(ref_kf) + 3,
          f"{n_kf} keyframes, expected within 3 of {ref_kf}")
    _need(mapper.ba_solves >= 1, "no BA solve applied")
    _need(timer.counts.get("map.triangulate", 0) >= 1,
          "triangulation never ran")
    phase_minting(cfg, gt, left, right, sems, dev)
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


# the JAX package's CPU System with the offline vocabulary on the 190
# frames (tools/loop190_jax_reference.py), two runs
REF_LOOP = {"loops": (1, 1), "lost": (0, 1), "ate": (0.0361, 0.0530),
            "keyframes": (49, 46)}
KIDNAP_FRAME = 2


def _center(T: np.ndarray) -> np.ndarray:
    T = T.astype(np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def run_loop_session(cfg, left, right, sems, dev, voc):
    """Phase 7's run, with the launch counters set to 0 just before it
    and read just after, and torch's sync debug mode on (a warning per
    sync costs the host microseconds against a frame's hundreds of
    milliseconds); keeps a copy of K2's inputs at the last call of the
    loop closer's guided ``search_by_sim3``. Returns (system, per-frame
    ms, launches, sync warnings, K2 sim3 case, sim3 searches per
    frame)."""
    top2 = kernel_match.masked_hamming_top2
    by_sim3 = matching.search_by_sim3
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

    kernel_match.masked_hamming_top2 = record
    matching.search_by_sim3 = tagged_by_sim3
    kernel_orb.LAUNCHES = 0
    kernel_match.LAUNCHES = 0
    try:
        system, frame_ms, syncs, _ = run_system(
            cfg, left, right, sems, dev, count_syncs=True, vocabulary=voc)
    finally:
        kernel_match.masked_hamming_top2 = top2
        matching.search_by_sim3 = by_sim3
    launches = {"k1": kernel_orb.LAUNCHES, "k2": kernel_match.LAUNCHES}
    _need("k2" in kept, "phase 7 ran no guided search_by_sim3")
    return (system, frame_ms, launches, syncs, kept["k2"],
            kept["calls"] / len(left))


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


def phase_loop(cfg, gt, left, right, sems, dev) -> dict:
    """Phase 7: the loop session on all 190 frames, its gates against the
    JAX package's CPU runs, the kidnap check and the K2 sim3 case's
    inputs; the run counts its syncs."""
    voc = voc_mod.load_npz(VOCABULARY)
    n = len(left)
    torch.cuda.reset_peak_memory_stats(dev)
    (system, frame_ms, launches, syncs, sim3_case,
     sim3_calls) = run_loop_session(cfg, left, right, sems, dev, voc)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
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
          "JAX CPU reference, two runs: "
          + ", ".join(f"{k} {v}" for k, v in REF_LOOP.items()))
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
    _need(lc.loops_closed >= max(1, min(REF_LOOP["loops"])),
          f"{lc.loops_closed} loops closed")
    _need(lc.gba_applied >= 1, "no global BA applied after the closure")
    _need(stats["lost"] <= max(REF_LOOP["lost"]),
          f"{stats['lost']} frames lost")
    ref_kf = REF_LOOP["keyframes"]
    _need(min(ref_kf) - 5 <= stats["keyframes"] <= max(ref_kf) + 5,
          f"{stats['keyframes']} keyframes, expected within 5 of {ref_kf}")
    _need(stats["ate"] <= min(0.10, 2 * max(REF_LOOP["ate"])),
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
            "keyframes": stats["keyframes"],
            "relocalizations": system.reloc_successes,
            "kidnap_error_m": kid["error_m"],
            "sim3_case": sim3_case, "sim3_calls_per_frame": sim3_calls}


# the JAX package's command line with --no-semantics on the same 40-frame
# KITTI directory (tools/cli40_jax_reference.py): two runs as it runs on
# the CPU, where the mapper admits keyframes late, and two with its host
# fetches landed by the next frame (--landed), the card's regime
REF_CLI = {"ate": (0.0145, 0.0116), "keyframes": (12, 13),
           "ate_landed": (0.0102, 0.0102), "keyframes_landed": (17, 17)}
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
          f"{got['valid']:.0f} keypoints); JAX CLI reference (trained, "
          "landed): " + ", ".join(f"{k} {v}" for k, v in REF_CNN.items()))
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
    _need(lost <= max(REF_CNN["lost"]), f"run C: {lost} frames lost")
    _need(ate <= min(0.10, 2 * max(REF_CNN["ate"])),
          f"run C ATE {ate:.4f} m")
    ref_kf = REF_CNN["keyframes"]
    _need(min(ref_kf) - 3 <= n_kf <= max(ref_kf) + 3,
          f"run C: {n_kf} keyframes, expected within 3 of {ref_kf}")
    _need(launches["k1"] == 2 * n, f"run C: K1 launched {launches['k1']} "
          "times")
    _need(launches["k2"] >= n - 1 - lost,
          f"run C: K2 launched {launches['k2']} times")
    for key, tol in (("gate_share", 0.10), ("pixel_acc", 0.05)):
        ref = REF_CNN[key]
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
          "JAX CLI reference (--no-semantics): "
          + ", ".join(f"{k} {v}" for k, v in REF_CLI.items()))
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
    _need(ate <= min(0.10, 2 * max(REF_CLI["ate"] + REF_CLI["ate_landed"])),
          f"CLI ATE {ate:.4f} m")
    ref_kf = REF_CLI["keyframes_landed"]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_card()
    phase_build()
    cfg = SystemConfig()
    statics = frame_mod.make_statics(cfg)
    gt_all, left_all, right_all, sems_all, cls_all = make_scene(
        cfg, N_LOOP_FRAMES)
    gt, left, right = gt_all[:N_FRAMES], left_all[:N_FRAMES], right_all[
        :N_FRAMES]
    sems = sems_all[:N_FRAMES]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        k1 = phase_k1(statics, left[0], dev)
        model = phase_segnet(cfg, left[0], dev)
        standard = phase_segnet_standard(cfg, left[0], dev, work)
        trained = phase_train(cfg, left_all, cls_all, dev, work)
        cases, calls = capture_k2_cases(cfg, statics, model, left, right,
                                        sems, dev)
        (cases["fusion"], calls["fusion"], ba_case,
         warmup_stats) = capture_system_cases(cfg, gt, left, right, sems,
                                              dev)
        k2 = phase_k2(cases, calls)
        slice_launches = phase_slice(cfg, statics, model, gt, left, right,
                                     sems, dev)
        system = phase_system(cfg, gt, left, right, sems, dev, ba_case,
                              warmup_stats)
        loop = phase_loop(cfg, gt_all, left_all, right_all, sems_all, dev)
        k2_sim3 = phase_k2({"sim3": loop.pop("sim3_case")},
                           {"sim3": loop.pop("sim3_calls_per_frame")})
        k2["cases"]["sim3"] = k2_sim3["cases"]["sim3"]
        k2["max_abs_err"] = max(k2["max_abs_err"], k2_sim3["max_abs_err"])
        cli_run = phase_cli(cfg, gt, left, right, cls_all, dev,
                            standard.pop("caffemodel"),
                            trained.pop("caffemodel"), work)
        vocab_tool = phase_vocab_tool(statics, left[0], right[0], sems[0],
                                      dev, work)
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
         "launches_tracker_slice": slice_launches["k1"], **k1,
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
         "launches_tracker_slice": slice_launches["k2"], **k2,
         "library_ms": None,
         "library_note": NO_LIBRARY + "PyTorch has no masked top-2 with "
         "first-index ties"},
    ], "system": {k: v for k, v in system.items() if k != "launches"},
        "loop": {k: v for k, v in loop.items() if k != "launches"},
        "segnet_standard": standard, "train": trained,
        "cli": {k: v for k, v in cli_run.items() if k != "launches"},
        "cli_trained": {k: v for k, v in run_c.items() if k != "launches"},
        "vocab_tool": {k: v for k, v in vocab_tool.items()
                       if k != "launches"}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
