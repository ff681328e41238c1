#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``velocity_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source; a K1 instantiation that spills fails),
holds each kernel against its plain PyTorch version at the shapes of the
main paths (K1 also at its edge cases and, with points up to and past the
image's edges, at every pyramid level of a 4032x3024 still; K2 and K3 with
corners past every side, K2 also on a still, K2 and K3 also on a stack of
three frames, one launch for all, beside three 2-D launches; each beside
its launch floor, the same call at size 1; K4, ``corner_subpix``'s loop,
on the 1,020 corners frame-0 init refines on the clip's first frame; K5,
stage 3's warped windows, bit for bit on the clip's first frame with a
shared map, the backward leg's transposed centres and per-point maps on a
stack of three frames; K6, each level's LK source window, on the clip's
first frame at the three shapes of a lanes step and on a stack of three
frames: windows bit for bit, the structure tensor's sums within 1e-5 of
its trace, the gate equal away from its thresholds), then
drives the paths below on a 1920x1080, 20-frame synthetic clip with the default
widths (1024 features, 1024 RANSAC trials) and the f32 solver:

- ``ScanSpeedRunner.run`` with the default lanes LK engine (kernels K1 and
  K2) and with ``lk_backend="fast"`` (kernel K3, with K2 at init), each
  followed by a profiled warm run of the clip's first ``PROFILE_FRAMES``
  frames (device busy share, top kernels and the hand kernels');
- phase ``graph``: on a card ``scan_segment`` replays one captured CUDA
  graph of the frame step per frame (``pipeline/scan.py``); one eager step
  under ``torch.cuda.set_sync_debug_mode("error")``, then the captured
  segments of the scan runner (lanes and fast), of ``run_batch``'s
  three-lane batch (lanes and fast) and of the long-video runner against
  the eager step called directly on the card, bit for bit, with the
  launches the replays counted equal to those the eager steps made; a
  replayed segment under the sync debug mode; each graph's node count,
  capture time, pool memory and per-replay launches, and one replayed
  step's stream time, device activities and busy share beside one eager
  step's;
- phase ``driver``: ``SpeedEstimator.run``, the per-frame driver, which
  replays the scan runner's capture of the step once a frame (no new
  capture, N_FRAMES - 1 replays a run, K1 and K2 launches beside the scan
  runner's), beside the scan runner in turns, then with the feature-match
  rescue forced on every frame (``min_affine_inliers`` huge) through a
  matcher built from the clip's known motion (the card's machine has no
  cv2), directly and through the scan runner's own rescue; the plain and
  the forced run each bit-equal to the eager driver (the step put back to
  the eager ``fused_frame_step_pyr``);
- phase ``ba``: ``ScanSpeedRunner.run`` with ``anchor="ba"``, then (with no
  clip) ``ba_schur`` (f32 and f64, dense and CG camera solver) at 20 cameras
  x 1024 tracks and ``ba_dense`` at 256 tracks on the card, each held against
  the same function on the CPU in f64 and timed per iteration, with the
  share of the reduced camera solve;
- phase ``stills``: ``StillsSpeedEstimator.run`` on a synthetic burst of 12
  stills of 4032x3024 through the stills camera (``render_burst`` of
  ``velocity_tpu_torch/testing/synthetic_clip.py``), with a
  GPS fix and a capture time per still: its kernels, speed, residual,
  the frames replenished and the lanes promoted, and the georegistration;
  the 12 MP step's capture (seconds, pool), cold and warm walls, the warm
  run bit-equal to the eager stills driver;
- phase ``multivideo``: ``run_batch`` over three 1080p clips of 20 frames
  (``render_lanes``; lane 0 is the clip above), one batched frame step per
  frame for the three lanes, then the three single scan runner runs of the
  same clips, with the lanes LK engine and then with ``lk_backend="fast"``
  (K3 on the frame stack): each lane and each single run against its truth
  and the JAX CPU lane, lane 0's track history against its single run's,
  the batch's K1 and K2 (fast: K3) launches against the largest single
  run's (at most ``BATCH_LAUNCH_RATIO`` times), each MSV's iterations, and
  the batch's warm wall beside the single runs' summed walls, whole and
  less the host MSV; between the two, ``run_batch`` with
  ``shard_features=2`` over segment A, bit-equal to the unsharded batch;
  then the gather LK engine on two lanes, bit-equal to per-lane calls;
- phase ``parallel`` (in-process shards on the one card, axis sizes 1 and
  2): ``ba_schur_sharded`` against ``ba_schur`` at 20 cameras x 1024
  tracks, ``windowed_ba`` at 4 windows x 16 cameras x 1024 tracks with
  ``fix_rotations`` and ``pin_tracks=4`` against the same call on the CPU
  in f64 and beside a Python loop of ``ba_schur`` over its windows, and
  ``lk_forward_backward_sharded`` at N 1024 on the clip's first frame
  pair, 2 shards bit-equal to 1, its K1 and K2 launches counted;
- phase ``longvideo``: ``LongVideoRunner.run`` on the seed-0 clip rendered
  to 48 frames (window 16, overlap 3, BA refinement): speed against the
  truth and JAX's CPU run, residual, windows, BA windows accepted, frames
  replenished, lanes promoted and refreshed, decode time and decode wait;
  then a run cut at 40 frames with a checkpoint and resumed (without BA
  refinement, as JAX's test) and a run whose second segment fails once and
  is retried, each held to the uninterrupted run;
- phase ``cli``: the port's command line (``velocity_tpu_torch/cli.py``)
  parsed by ``build_parser`` and run by its ``cmd_speed`` (with an HTML
  report where matplotlib exists) and ``cmd_longvideo`` (window 16,
  overlap 3, polyfit degree 3) on the clip's reader, each JSON held bit for
  bit to ``SpeedEstimator.run`` and ``LongVideoRunner.run`` of the same
  clip and config; ``graft_entry_torch.entry()`` (K1 and K2 launched,
  outputs finite) and ``dryrun_multichip(4)`` (2 x 2 in-process shards on
  the card) against a 1 x 1 mesh; ``native_loader.available()``; the
  steps ``speed`` replayed and captured (seconds, pool);
- phase ``bench``: ``bench_torch.run_bench`` (the port's bench, lean runs)
  on the clip in ``scan`` and ``frames`` modes (both replay the captured
  step; each mode's captures printed), each held to the truth and
  the JAX CPU value; the scan runner lean and full in turns, the lean
  trajectory bit-equal to the full one; ``bench_ba_torch.py`` written to a
  temporary directory, every row's value finite.

It checks that each path went through its kernels (the counts are set to 0
just before a path's run and read just after; a captured step's wrappers
count at its capture, and each replay adds the capture's counts) and
recovered the clip's
speed, and prints each kernel's launches by shape with launches x (time -
bound). The ``kernels`` line gives K1's and K2's launches on the bench's
scan-mode run (warm-up and timed runs) and each kernel's launches on every
counted path. Any failure exits non-zero; there is no CPU fallback. The
last line is a JSON object with ``"ok": true``.

Each kernel's bound is the larger of its bytes over the card's memory rate
and its f32 operations over the card's f32 rate (H100 SXM published peaks,
``utils/profiling.py:bound_ms``), counted from this run's
inputs: a gather reads only the pixels its windows cover, once each; K1
reads the per-point tensors of the points still active on entry.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench_ba_torch import ba_scene as _ba_scene
from velocity_tpu_torch.utils.profiling import bound_ms, card_line, cuda_ms, k1_bound_ms
from velocity_tpu_torch.utils.profiling import gather_bound_ms as _gather_bound
from velocity_tpu_torch.utils.profiling import window_index as _window_index

ROOT = Path(__file__).resolve().parent

# Speeds the JAX package (f32 solver, default widths) recovers on the same
# synthetic clip (seed 0, 1920x1080, 20 frames), run on the CPU: its
# ScanSpeedRunner with each LK backend, its SpeedEstimator ("driver"), its
# ScanSpeedRunner with anchor="ba", its StillsSpeedEstimator on the stills
# burst ("stills") and its run_batch over the three clips of the multivideo
# phase ("batch", one per lane) (scripts/jax_reference_speeds.py).
JAX_CPU_SPEED_KMH = {"lanes": 39.9964228614167, "fast": 39.996056468425444,
                     "driver": 39.97982552569373, "ba": 40.00776387593297,
                     "stills": 40.003800868446476,
                     "batch": (39.996420154372416, 29.970769718057525, 49.89378033906219),
                     "batch_fast": (39.99605917543492, 29.98080208303771, 49.88280843919886)}
# mean residuals (px) of JAX's run_batch lanes (the same runs). Lanes 1 and
# 2 are clips on which the MSV solve stops at its iteration cap, in both
# packages (phase multivideo prints the counts), and the structure it leaves
# puts lane 1 above MAX_RESIDUAL_PX in JAX too: every run of the phase, batch
# lane or single run, is held to JAX's residual on its lane within this margin
JAX_CPU_BATCH_RESIDUAL_PX = (0.06572684273123741, 1.3208546148318994, 0.9673360944970658)
BATCH_RESIDUAL_VS_JAX_PX = 0.1
# the same for JAX's run_batch with lk_backend="fast" over the same clips
# (scripts/jax_reference_speeds.py batch_fast; speeds in JAX_CPU_SPEED_KMH)
JAX_CPU_BATCH_FAST_RESIDUAL_PX = (0.0661481854162718, 1.2221809983939718, 0.9195013864848175)
# JAX's LongVideoRunner on the first LONG_FRAMES frames of the clip (window 16,
# overlap 3, BA refinement; scripts/jax_reference_speeds.py longvideo)
JAX_CPU_LONGVIDEO_KMH = 39.57521730613294
JAX_CPU_LONGVIDEO_RESIDUAL_PX = 0.2090957446405065
# phase longvideo: the run cut at LONG_CUT frames with a checkpoint (row
# LONG_CUT - 1 is off the 16-row grid) and resumed, and the run whose second
# segment fails once, against the uninterrupted run (JAX's test tolerances:
# the boundary state crosses f32 -> f64 -> f32 at a resume)
LONG_CUT = 40
RESUME_TOL_M, RESUME_TOL_KMH = 2.5e-2, 0.3
# phase parallel: the windowed BA's windows x cameras (tracks: BA_TRACKS)
PAR_WINDOWS, PAR_CAMERAS = 4, 16
# phase cli: dryrun_multichip(4) on its 2 x 2 mesh against a 1 x 1 mesh
# (relative; f32, the in-process sum over point shards in another order)
DRYRUN_RTOL = 1e-5
SPEED_VS_TRUTH = 0.05
SPEED_VS_JAX = 0.02
MAX_RESIDUAL_PX = 1.0
N_POINTS = 1024
N_FRAMES = 20
PROFILE_FRAMES = 3  # the profiled runs: reading a 5-frame fast trace takes 42 s
BENCH_REPS = 3  # phase bench: timed runs after the warm-up (bench_torch.REPS is 5)
ALWAYS_RESCUE = 10**6  # min_affine_inliers that sends every frame through the rescue
# bundle adjustment on the card: the windowed size (cameras, tracks), the
# track count of the dense-Jacobian solver, and the relative tolerances
# against the same function on the CPU in f64 (points and cameras in the
# reference's scale gauge, residual; the gauge factor itself 10 x looser)
BA_CAMERAS, BA_TRACKS, BA_DENSE_TRACKS = 20, 1024, 256
BA_RTOL = {"float64": 1e-8, "float32": 1e-3}
# CG stops on its residual, and what is left of it lies along the nearly free
# scale direction: with the CG camera solver the gauge factor is held to this
BA_CG_GAUGE_TOL = 1e-2
# (S, N) of every slab extraction on the lanes path: stages 1-2, stage-3
# source, stage-3 backward destination, corner_subpix (K5 takes the warped
# windows' slabs itself)
SLAB_SHAPES = ((24, 1024), (56, 1024), (64, 1024), (27, 1020))
# K2 on a stack (run_batch's batched step): lanes, sizes, points per lane
SLAB_LANES, SLAB_BATCHED_SIZES = 3, (24, 64)
# phase multivideo: the batch's K1 and K2 launches at most this many times
# the largest single run's (one batched step per frame for all lanes)
BATCH_LAUNCH_RATIO = 1.1
K1_CONFIGS = ((15, 24, 8, False), (51, 64, 10, True), (51, 64, 8, False))
# K4 against its plain version: every valid corner within this many px (the
# five sums run in another order; a stop that flips moves a point by under
# eps), the per-point iteration counts equal on at least this share
K4_ATOL_PX, K4_SAME_ITERS = 2e-3, 0.99
# K5 (stage 3's warped windows) at win 51: P 64 (Q 72), anchor offset 29
K5_P, K5_OO = 64, 29
# K6 (the LK source window of a level): (label, level of the frame's
# pyramid, win, cubic) of a lanes step's shapes, stages 1-2 at the frame and
# at its top level, stage 3's two legs; N_POINTS points, the step's min-eig
# threshold. The sums (a11, a12, a22) against the plain version's within
# K6_RTOL of the trace: their order differs, the windows are bit-equal.
K6_CASES = (("win 15 level 0", 0, 15, False), ("win 15 level 4", 4, 15, False),
            ("win 51 level 0", 0, 51, False), ("win 51 cubic level 0", 0, 51, True))
K6_THRESH, K6_RTOL = 1e-4, 1e-5
K1_RTOL, K1_ATOL = 1e-5, 1e-4  # summation order and FMA contraction differ
# Functions (module of velocity_tpu_torch.ops, name) whose device time each
# path's profiled run reports: where JAX leaves the work to XLA, K5 (the
# whole of _extract_warped_lanes on a card; K6, the source windows, is read
# by its kernels' name, since its wrapper carries its counters)
ANNOTATED = {"lanes": ("lk_lanes._extract_warped_lanes",),
             "fast": ("lk_fast._extract_warped",)}
# K1 edge cases (kind, win, P, n_taps, cubic, N): point counts that leave a
# block's warps part-filled, every point done, windows outside the two
# kernel shapes (win 21; win 61, more gradient strips than threads),
# offsets on integers and on both clamp ends
K1_EDGES = (("n", 15, 24, 8, False, 1), ("n", 15, 24, 8, False, 1020),
            ("n", 51, 64, 10, True, 1), ("n", 51, 64, 10, True, 1020),
            ("all_done", 15, 24, 8, False, 1024), ("all_done", 51, 64, 10, True, 1024),
            ("n", 21, 32, 8, False, 1024), ("n", 21, 32, 10, True, 1024),
            ("n", 61, 72, 8, False, 256), ("n", 61, 72, 10, True, 256),
            *((kind, *cfg, 1024) for kind in ("integer", "ends") for cfg in K1_CONFIGS))
# (label, H, W, size) of every patch extraction on the fast path: stages
# 1-2 (P 34) at the levels of the full-size frame and at the top level of
# the quarter-scale pyramid (17x30, edge-padded to the patch first), stage 3
# (P 70) on the frame, the warped slabs (Q 82) on the frame padded by 82
K3_CASES = (("P34 frame", 1080, 1920, 34), ("P34 top level", 17, 30, 34),
            ("P70 frame", 1080, 1920, 70), ("Q82 padded frame", 1244, 2084, 82))
# K3 on a stack (run_batch's fast engine): the K3_CASES labels it runs at,
# SLAB_LANES frames of N_POINTS points each
K3_BATCHED_CASES = ("P34 frame", "Q82 padded frame")
# the gather engine's check on the card: lk_forward_backward on a stack of
# the first two lanes' frame pairs (stage 2's window, levels and gate)
GATHER_LK = dict(win=15, max_level=4, iters=10, eps=0.03, fb_threshold=1.0)


def phase_device():
    smi = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def _kernel_name(mangled: str) -> str:
    """``lk_block_point<cubic, cached>`` for the mangled name of a K1
    instantiation, ``source_window_warp<linear>`` for one of K6's,
    ``gather_windows<128, 4, split>`` for the window gather
    of K2 and K3 (threads per block, words per thread and step, whether a
    thread's words may run into the next row); other kernels keep their
    mangled name."""
    if m := re.search(r"(lk_block_[a-z]+)I((?:Lb[01]E)+)E", mangled):
        flags = re.findall(r"Lb([01])E", m[2])
        args = ["cubic" if flags[0] == "1" else "linear"]
        args += ["cached" if f == "1" else "uncached" for f in flags[1:]]
        return f"{m[1]}<{', '.join(args)}>"
    if m := re.search(r"(source_window_[a-z]+)ILb([01])E", mangled):
        return f"{m[1]}<{'cubic' if m[2] == '1' else 'linear'}>"
    if m := re.search(r"gather_windowsILi(\d+)ELi(\d+)ELb([01])E", mangled):
        return f"gather_windows<{m[1]}, {m[2]}{', split' if m[3] == '1' else ''}>"
    return mangled


def ptxas_report(log: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] from
    ``nvcc -Xptxas -v`` output, one row per compiled entry function."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spill = _kernel_name(m[1]), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m[1]), int(m[2]))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append((name, int(m[1]), *spill))
            name = None
    return rows


def phase_build():
    """Build the kernels; print each entry function's registers and spills.
    Fails unless the six K1 instantiations (the warp kernel, the block
    kernel with cached and with uncached gradients, each linear and cubic)
    compiled without spills, or if a window gather instantiation, K5 or
    one of K6's four (warp or block, linear or cubic) spills."""
    from velocity_tpu_torch import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.relative_to(ROOT)}")
    for line in cuda_build.build_log.splitlines():
        if "error" in line.lower():
            print("  nvcc:", line.strip())
    rows = ptxas_report(cuda_build.build_log)
    for name, regs, st, ld in rows:
        print(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads")
    k1 = [r for r in rows if r[0].startswith("lk_block")]
    if len(k1) != 6 or any(st or ld for _, _, st, ld in k1):
        raise AssertionError(f"K1 instantiations with spills, or not six: {k1}")
    spilled = [r for r in rows if (r[0].startswith("gather_windows") or "warp_window" in r[0]
                                   or "source_window" in r[0]) and (r[2] or r[3])]
    if spilled:
        raise AssertionError(f"window gather, K5 or K6 instantiations with spills: {spilled}")
    k6 = [r for r in rows if "source_window" in r[0]]
    if len(k6) != 4:
        raise AssertionError(f"K6 instantiations: {k6}, not four")


def _gather_check(label, fn, ref, img, corners, size):
    """One window gather (K2 or K3) against its plain version: windows and
    clamped corners bit-equal. Returns the plain version's clamped corners."""
    got, got_cl = fn(img, corners, size)
    want, want_cl = ref(img, corners, size)
    torch.cuda.synchronize()
    if not torch.equal(got_cl, want_cl):
        raise AssertionError(f"{label}: clamped corners differ from the plain version")
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: windows differ from the plain version")
    return want_cl


def _gather_case(label, fn, ref, img, corners, size):
    """``_gather_check``, then the gather's time, its launch floor (the same
    entry point, N and corners at size 1), the plain version's and one
    advanced-index gather's; the bound counts the pixels the windows cover,
    the output, and the corners read and the clamped ones written."""
    want_cl = _gather_check(label, fn, ref, img, corners, size)
    N = corners.shape[0]
    r_idx, c_idx = _window_index(want_cl[:, 0], want_cl[:, 1], size)
    ms = cuda_ms(lambda: fn(img, corners, size))
    floor_ms = cuda_ms(lambda: fn(img, corners, 1))
    plain_ms = cuda_ms(lambda: ref(img, corners, size))
    library_ms = cuda_ms(lambda: img[r_idx, c_idx])
    bound_ms, bound_by = _gather_bound(img, r_idx, c_idx, extra_bytes=16 * N)
    Hp, Wp = img.shape
    print(f"{label} ({Hp}x{Wp}, size {size}, N={N}): bit-equal, corners equal; kernel "
          f"{ms:.4f} ms, floor (size 1) {floor_ms:.4f} ms, plain {plain_ms:.4f} ms, one "
          f"gather call {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{bound_ms / ms:.0%} of the bound's rate, {ms / floor_ms:.2f}x the floor")
    return dict(label=label, size=size, N=N, max_abs_err=0.0, ms=ms, floor_ms=floor_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _corners_with_outsiders(g, H, W, size, N, lo):
    """(N, 2) int32 corners drawn in [lo, W-size] x [lo, H-size] (lo < 0
    reaches past the near sides), the first four past every side."""
    corners = torch.stack([
        torch.randint(lo, W - size + 1 - lo, (N,), generator=g, device=g.device),
        torch.randint(lo, H - size + 1 - lo, (N,), generator=g, device=g.device),
    ], dim=1).to(torch.int32)
    corners[:4] = torch.tensor([[-3 * size, 5], [W + 7, -size], [4, H + 2 * size], [W, H]],
                               dtype=torch.int32, device=g.device)
    return corners


def phase_k2(dev):
    """K2 against its plain version on a padded 1080p frame at the lanes
    path's shapes (timed), then untimed on a still of the stills phase's
    size, padded as the backward leg's destination pads it and as
    corner_subpix reads it (unpadded, corners reaching past the near sides
    too); corners past every side included: bit-equal."""
    from velocity_tpu_torch.ops import slab_pallas as k2
    from velocity_tpu_torch.ops.lk import _pad_edge
    from velocity_tpu_torch.testing.synthetic_clip import STILLS_SIZE

    g = torch.Generator(device=dev).manual_seed(2)
    img = _pad_edge(torch.rand((1080, 1920), generator=g, device=dev) * 255, 72)
    H, W = img.shape
    rows = []
    for S, N in SLAB_SHAPES:
        corners = _corners_with_outsiders(g, H, W, S, N, lo=0)
        rows.append(_gather_case(f"K2 S={S}", k2.extract_slabs, k2.extract_slabs_ref, img,
                                 corners, S))
    rows += _gather_batched(dev, g, "K2", k2.extract_slabs, k2.extract_slabs_ref,
                            [(H, W, S) for S in SLAB_BATCHED_SIZES], img=img)
    still = torch.rand(STILLS_SIZE[::-1], generator=g, device=dev) * 255
    for label, im, lo in (("still padded by 64", _pad_edge(still, 64), 0),
                          ("unpadded still", still, None)):
        H, W = im.shape
        for S, N in SLAB_SHAPES:
            corners = _corners_with_outsiders(g, H, W, S, N, lo=-(S // 2) if lo is None else lo)
            _gather_check(f"K2 S={S} on the {label}", k2.extract_slabs, k2.extract_slabs_ref,
                          im, corners, S)
        print(f"K2 on the {label} ({H}x{W}), (S, N) {SLAB_SHAPES}: bit-equal, corners equal")
    return rows


def _gather_batched(dev, g, name, fn, ref, shapes, img=None):
    """A window gather (K2 or K3) on a stack of SLAB_LANES frames (``img``,
    where given, and fresh ones), N_POINTS points per frame, at each
    (H, W, size) of ``shapes``: one launch against the plain version,
    bit-equal; its time beside the bound over the frames' windows and
    beside one 2-D launch per frame."""
    n = N_POINTS
    lane = torch.arange(SLAB_LANES * n, device=dev) // n
    rows = []
    for H, W, S in shapes:
        imgs = torch.stack(([img] if img is not None else [])
                           + [torch.rand((H, W), generator=g, device=dev) * 255
                              for _ in range(SLAB_LANES - (img is not None))])
        lo = 0 if name == "K2" else -(S // 2)
        corners = torch.cat([_corners_with_outsiders(g, H, W, S, n, lo=lo)
                             for _ in range(SLAB_LANES)])
        label = f"{name} batched V={SLAB_LANES} S={S}"
        want_cl = _gather_check(label, fn, ref, imgs, corners, S)
        per_lane = [corners[v * n:(v + 1) * n].contiguous() for v in range(SLAB_LANES)]
        r_idx, c_idx = _window_index(want_cl[:, 0], want_cl[:, 1], S)
        ms = cuda_ms(lambda: fn(imgs, corners, S))
        lanes_ms = cuda_ms(lambda: [fn(imgs[v], per_lane[v], S) for v in range(SLAB_LANES)])
        plain_ms = cuda_ms(lambda: ref(imgs, corners, S))
        library_ms = cuda_ms(lambda: imgs[lane[:, None, None], r_idx, c_idx])
        bound_ms, bound_by = _gather_bound(imgs, r_idx, c_idx, extra_bytes=16 * len(lane),
                                           lane=lane)
        print(f"{label} ({SLAB_LANES}x{H}x{W}, N={len(lane)}): bit-equal, corners equal; "
              f"kernel {ms:.4f} ms, {SLAB_LANES} 2-D launches {lanes_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, one gather call {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); {bound_ms / ms:.0%} of the bound's rate, "
              f"{ms / lanes_ms:.2f}x the 2-D launches")
        rows.append(dict(label=label, size=S, N=len(lane), lanes=SLAB_LANES, max_abs_err=0.0,
                         ms=ms, lanes_2d_ms=lanes_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
    return rows


def phase_k3(dev):
    """K3 against its plain version at the fast path's shapes, corners past
    every side included: patches and clamped corners bit-equal."""
    import torch.nn.functional as F

    from velocity_tpu_torch.ops import patch_pallas as k3

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for label, H, W, size in K3_CASES:
        img = torch.rand((H, W), generator=g, device=dev) * 255
        if H < size or W < size:  # as interp.extract_patches pads a top level
            img = F.pad(img[None, None], (0, max(0, size - W), 0, max(0, size - H)),
                        mode="replicate")[0, 0].contiguous()
        Hp, Wp = img.shape
        corners = _corners_with_outsiders(g, Hp, Wp, size, N_POINTS, lo=-(size // 2))
        rows.append(_gather_case(f"K3 {label}", k3.extract_patches, k3.extract_patches_ref,
                                 img, corners, size))
    return rows + _gather_batched(dev, g, "K3", k3.extract_patches, k3.extract_patches_ref,
                                  [(H, W, size) for label, H, W, size in K3_CASES
                                   if label in K3_BATCHED_CASES])


def _k4_bound_ms(N: int, Q: int, half_win: int, point_iters: int):
    """Bound of one K4 call: N slabs (Q, Q) read, seeds and clamped corners
    read, points and counts written, once each; per point and iteration
    run (``point_iters`` in all) the resample (2 x-pass rows and the y-pass,
    9 operations a patch element), the differences (4 an element of the
    window) and the five weighted sums (20 an element), and the solve."""
    W = 2 * half_win + 1
    G = W + 2
    per_iter = 9 * G * G + 24 * W * W + 20
    return bound_ms(4 * N * Q * Q + 28 * N, point_iters * per_iter)


def phase_k4(dev, clip):
    """K4 (``corner_subpix``'s loop, ``csrc/subpix.cu``) against its plain
    version on the card at the main-path shape: the 1,020 corners frame-0
    init refines on the clip's first frame, on K2's slabs. Every valid
    corner within K4_ATOL_PX, the iteration counts equal on K4_SAME_ITERS
    of the points, one K2 and one K4 launch a call; then K4's time on the
    slabs, the whole call's (K2, K4 and their small ops), the plain loop's
    (its ~350 kernels and one host read an iteration) and the bound."""
    from velocity_tpu_torch.config import PipelineConfig
    from velocity_tpu_torch.ops import harris, launches
    from velocity_tpu_torch.pipeline.roi import bounding_rect

    tc = PipelineConfig().tracker
    gray = torch.as_tensor(clip.reader.grays[0]).to(dev)
    x0, x1, y0, y1 = (int(v) for v in bounding_rect(
        clip.annotation.q * PipelineConfig().native_scale, tuple(gray.shape),
        border=tc.roi_border))
    corners = harris.good_features(gray[y0:y1, x0:x1], max_corners=tc.max_features - 4,
                                   quality_level=tc.harris_quality, block=tc.harris_block,
                                   k=tc.harris_k)
    seeds = corners.points + torch.tensor([x0, y0], dtype=torch.float32, device=dev)
    img = gray.float()
    hw, its, eps = tc.subpix_window, tc.subpix_iters, tc.subpix_eps
    before = launches.read()
    got, iters = harris._corner_subpix(img, seeds, hw, its, eps)
    torch.cuda.synchronize()
    counted = {k: n for k, (n, _) in launches.since(before).items() if n}
    if counted != {"corner_subpix": 1, "extract_slabs": 1}:
        raise AssertionError(f"K4: a call launched {counted}, not one K2 and one K4")
    slabs, cl = harris._subpix_slabs(img, seeds, hw)
    Q = slabs.shape[1]
    want, want_iters = harris.subpix_loop_ref(slabs, cl, seeds, hw, its, eps)
    valid = corners.valid
    err = float((got - want).abs().amax(dim=1)[valid].max())
    same = float((iters == want_iters).float().mean())
    if not (err <= K4_ATOL_PX and same >= K4_SAME_ITERS):
        raise AssertionError(f"K4 against the plain loop: max err {err} px (limit "
                             f"{K4_ATOL_PX}), iteration counts equal on {same:.2%}")
    N = seeds.shape[0]
    ms = cuda_ms(lambda: harris._subpix_k4(slabs, cl, seeds, hw, its, eps))
    call_ms = cuda_ms(lambda: harris._corner_subpix(img, seeds, hw, its, eps))
    plain_ms = cuda_ms(lambda: harris.subpix_loop_ref(slabs, cl, seeds, hw, its, eps),
                       calls=2, rounds=3)
    b_ms, b_by = _k4_bound_ms(N, Q, hw, int(iters.sum()))
    print(f"K4 (N={N}, {int(valid.sum())} valid, Q {Q}, half_win {hw}, max_iters {its}): "
          f"max err {err:.2e} px over the valid corners, iteration counts equal on "
          f"{same:.2%}, trip count {int(iters.max())} (plain {int(want_iters.max())}), "
          f"{int(iters.sum())} point-iterations; kernel {ms:.4f} ms, K2 + K4 call "
          f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"{b_ms / ms:.0%} of the bound's rate")
    return [dict(label="K4", size=Q, N=N, max_abs_err=err, ms=ms, call_ms=call_ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)]


def _k1_case(dev, win, P, n_taps, cubic, it0, seed=0, N=N_POINTS, size=(1920, 1080),
             edges=False):
    """Random K1 inputs at a main-path shape, points-major, on the card, for
    an image of ``size`` (W, H). ``edges``: the points spread over the whole
    in-bounds gate (floor(p - half) in [-win, W) x [-win, H)) and 4 px past
    it, half of each coordinate within 4 px of one of the gate's limits, on
    quarter pixels; otherwise in [50, 400]."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def nrm(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dpatch = rnd(N, P, P) * 255
    Ip = rnd(N, win, win) * 255
    gxp = nrm(N, win, win) * 20
    gyp = nrm(N, win, win) * 20
    a11 = (gxp * gxp).sum((1, 2))
    a12 = (gxp * gyp).sum((1, 2))
    a22 = (gyp * gyp).sum((1, 2))
    det = a11 * a22 - a12 * a12
    inv_det = torch.where(det != 0, 1.0 / det, torch.zeros_like(det))
    pts = rnd(2, N) * 350 + 50
    half = (win - 1) / 2
    if edges:
        lo = torch.full((2, 1), half - win, device=dev)  # p >= lo <=> floor(p - half) >= -win
        hi = torch.tensor([[size[0]], [size[1]]], device=dev) + half  # p < hi
        near = torch.where(rnd(2, N) < 0.5, lo, hi) + torch.round((rnd(2, N) * 8 - 4) * 4) / 4
        pts = torch.where(rnd(2, N) < 0.5, near, lo - 4 + rnd(2, N) * (hi - lo + 8))
    c = (n_taps - 1) / 2 + half
    bx = (rnd(N) * 2 - 1) - pts[0] + c
    by = (rnd(N) * 2 - 1) - pts[1] + c
    trackable = rnd(N) > 0.1
    done = rnd(N) > 0.7 if it0 > 0 else torch.zeros(N, dtype=torch.bool, device=dev)
    pd = nrm(2, N) * 0.2
    kw = dict(win=win, n_taps=n_taps, cubic=cubic, eps=0.01, Wd=size[0], Hd=size[1])
    return (dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx.contiguous(), by.contiguous(),
            trackable, pts.contiguous(), done, pd.contiguous(), it0), kw


def _k1_edge(dev, kind, win, P, n_taps, cubic, N):
    """K1 inputs at an edge: "n" (N points), "integer" (first offsets on
    exact integers of the clamp range), "ends" (on both clamp ends, the
    float below the upper one, and past them), "all_done"."""
    args, kw = _k1_case(dev, win, P, n_taps, cubic, 5 if kind == "all_done" else 0,
                        seed=N + 1, N=N)
    args = list(args)
    if kind in ("integer", "ends"):
        g = torch.Generator(device=dev).manual_seed(7)
        lo, hi = (1.0, n_taps - 2.0) if cubic else (0.0, n_taps - 1.0)
        below = float(np.nextafter(np.float32(hi), np.float32(-np.inf)))
        vals = (torch.arange(lo, hi + 1, device=dev) if kind == "integer" else
                torch.tensor([lo, hi, below, lo - 0.25, hi + 0.25], device=dev))
        o = vals[torch.randint(0, len(vals), (2, N), generator=g, device=dev)]
        pts = torch.round(args[11] * 4) / 4  # quarter pixels: pts - half + b == o exactly
        half = (win - 1) * 0.5
        args[11] = pts.contiguous()
        args[8] = (o[0] - (pts[0] - half)).contiguous()
        args[9] = (o[1] - (pts[1] - half)).contiguous()
    if kind == "all_done":
        args[12] = torch.ones(N, dtype=torch.bool, device=dev)
    return tuple(args), kw


def _k1_check(k1, args, kw, label, atol=None):
    """K1 against its plain version on ``args``: points and last steps
    within K1_RTOL/K1_ATOL (or within ``atol`` absolute, where given), done
    flags equal; returns max |dp| (px)."""
    before = k1.lk_block.launches
    got_p, got_d, got_pd = k1.lk_block(*args, **kw)
    ref_p, ref_d, ref_pd = k1.block_iters_ref(*args, **kw)
    torch.cuda.synchronize()
    if k1.lk_block.launches != before + 1:
        raise AssertionError(f"K1 did not launch ({label})")
    tol = dict(rtol=K1_RTOL, atol=K1_ATOL) if atol is None else dict(rtol=0.0, atol=atol)
    for name, got, want in (("points", got_p, ref_p), ("last steps", got_pd, ref_pd)):
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"K1 {name} ({label}): {m}")
    if not torch.equal(got_d, ref_d):
        raise AssertionError(f"K1 done flags differ ({label}): "
                             f"{int((got_d != ref_d).sum())} points")
    return float(torch.max(torch.abs(got_p - ref_p)))


def phase_k1(dev):
    """K1 against its plain version: points within K1_RTOL/K1_ATOL, equal
    done flags, at the main-path shapes (timed) and at the edge cases."""
    from velocity_tpu_torch.ops import lk_block_pallas as k1

    rows = []
    for win, P, n_taps, cubic in K1_CONFIGS:
        for it0 in (0, 5):
            args, kw = _k1_case(dev, win, P, n_taps, cubic, it0)
            err = _k1_check(k1, args, kw, f"{win},{P},{n_taps},{cubic},it0={it0}")
            ms = cuda_ms(lambda: k1.lk_block(*args, **kw))
            plain_ms = cuda_ms(lambda: k1.block_iters_ref(*args, **kw))
            n_active = int((args[10] & ~args[12]).sum())
            bound_ms, bound_by = k1_bound_ms(win, P, n_taps, n_active, N_POINTS)
            rows.append(dict(win=win, P=P, n_taps=n_taps, cubic=cubic, it0=it0,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            print(f"K1 win={win} P={P} taps={n_taps} cubic={cubic} it0={it0} N={N_POINTS}: "
                  f"max|dp|={err:.3g} px, done equal; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                  f"{n_active} active)")
    for kind, win, P, n_taps, cubic, N in K1_EDGES:
        args, kw = _k1_edge(dev, kind, win, P, n_taps, cubic, N)
        label = f"{kind} win={win} P={P} taps={n_taps} cubic={cubic} N={N}"
        err = _k1_check(k1, args, kw, label)
        rows.append(dict(win=win, P=P, n_taps=n_taps, cubic=cubic, edge=kind,
                         max_abs_err=err))
        print(f"K1 edge {label}: max|dp|={err:.3g} px, done equal")
    # on a still, positions reach 4061 px, where an f32 coordinate rounds to
    # 2.4e-4 px: the kernel and its plain version may round a point's
    # position an ulp apart at any update, and the next step makes up the
    # gap. So points and last steps are held, absolutely, to K1_ATOL plus
    # one ulp of the largest coordinate per update (1.3e-3 px at 4032 wide,
    # where K1_RTOL alone would let the points differ by 0.04 px)
    for W, H in _still_levels(dev):
        errs, gated = [], 0
        for win, P, n_taps, cubic in K1_CONFIGS:
            for it0 in (0, 5):
                args, kw = _k1_case(dev, win, P, n_taps, cubic, it0, seed=W + it0,
                                    size=(W, H), edges=True)
                label = f"still level {W}x{H} win={win} cubic={cubic} it0={it0}"
                ulp = float(np.spacing(np.float32(args[11].abs().max().item())))
                errs.append(_k1_check(k1, args, kw, label,
                                      atol=K1_ATOL + k1.BLOCK_ITERS * ulp))
                inx, iny = torch.floor(args[11] - (win - 1) / 2)
                gated += int(((inx < -win) | (iny < -win) | (inx >= W) | (iny >= H)).sum())
        rows.append(dict(edge=f"still {W}x{H}", max_abs_err=max(errs)))
        print(f"K1 at still level {W}x{H} ({len(errs)} cases: win 15, 51 cubic, 51 linear; it0 "
              f"0, 5; N={N_POINTS}, points up to 4 px past the edges, {gated} outside the "
              f"gate on entry): max|dp|={max(errs):.3g} px (limit {K1_ATOL} + "
              f"{k1.BLOCK_ITERS} x {ulp:.3g}), done equal")
    return rows


def _k5_case(dev, img, kind, N=N_POINTS, seed=0):
    """(imgp, pad, centers (2, N), P, M, oo) of a stage-3 call on ``img``
    (H, W) or a stack (V, H, W), edge-padded by Q as ``_level_loop`` pads
    it: N points inside the frame, a shared near-identity map ("forward"),
    the same with the centres as the transposed view the backward leg
    hands over ("backward"), or one map per lane, lane-major ("lanes")."""
    from velocity_tpu_torch.ops.lk import _pad_edge
    from velocity_tpu_torch.ops.lk_lanes import WARP_TAPS, _round8

    g = np.random.default_rng(seed)
    H, W = img.shape[-2:]
    V = img.shape[0] if img.dim() == 3 else 1
    N -= N % V
    Q = _round8(K5_P + WARP_TAPS)
    pts = torch.as_tensor(np.stack([g.uniform(0, W, N), g.uniform(0, H, N)], 1)
                          .astype(np.float32), device=dev)
    M = torch.tensor([[1.012, 0.021, 3.4], [-0.017, 0.991, -1.2]], device=dev)
    if kind == "lanes":
        maps = np.eye(2, 3) + g.normal(0, [[0.02, 0.02, 2.0]] * 2, (V, 2, 3))
        M = torch.as_tensor(maps.astype(np.float32), device=dev).repeat_interleave(N // V, 0)
    centers = pts.T if kind == "backward" else pts.T.contiguous()
    return _pad_edge(img, Q), Q, centers, K5_P, M, K5_OO


def _k5_bound_ms(N: int, P: int):
    """Bound of one K5 call: the N (P, P) float32 patches and the (2, N)
    corner written once (the windows it reads overlap and sit in L2; like
    ``k5_roofline`` the bound leaves them out)."""
    return bound_ms(4 * N * P * P + 8 * N, 0)


def phase_k5(dev, clip):
    """K5 (stage 3's warped windows, ``csrc/warp_window.cu``) against its
    plain version on the card at the main-path shapes: the forward leg's
    windows on the clip's first frame, N 1024, a shared map (the step's
    T23); the backward leg's (transposed centres); one map per lane on a
    stack of SLAB_LANES frames (``run_batch``'s lanes). Each bit-equal
    (patches and corners), one K5 launch and no K2 a call; then K5's time,
    the plain version's (its ~110 kernels and K2) and the bound."""
    from velocity_tpu_torch.ops import launches, lk_lanes

    frame = torch.as_tensor(clip.reader.grays[0]).to(dev).float()
    stack = torch.stack([torch.as_tensor(clip.reader.grays[i]).to(dev).float()
                         for i in range(SLAB_LANES)])
    rows = []
    for kind, img in (("forward", frame), ("backward", frame), ("lanes", stack)):
        args = _k5_case(dev, img, kind)
        N, Q = args[2].shape[1], args[1]
        before = launches.read()
        got, got_c = lk_lanes._extract_warped_lanes(*args)
        torch.cuda.synchronize()
        counted = {k: n for k, (n, _) in launches.since(before).items() if n}
        if counted != {"extract_warped": 1}:
            raise AssertionError(f"K5 {kind}: a call launched {counted}, not one K5")
        want, want_c = lk_lanes._extract_warped_lanes_ref(*args)
        err = float((got - want).abs().max())
        same = torch.equal(got.view(torch.int32), want.view(torch.int32)) and torch.equal(
            got_c, want_c)
        if not same:
            raise AssertionError(f"K5 {kind} against the plain version: not bit-equal, max "
                                 f"abs err {err}")
        ms = cuda_ms(lambda: lk_lanes._extract_warped_lanes(*args))
        plain_ms = cuda_ms(lambda: lk_lanes._extract_warped_lanes_ref(*args), calls=5)
        b_ms, b_by = _k5_bound_ms(N, K5_P)
        print(f"K5 {kind} (N={N}, P {K5_P}, Q {Q}, image {tuple(args[0].shape)}, map "
              f"{tuple(args[4].shape)}): bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}); {b_ms / ms:.0%} of the bound's rate")
        rows.append(dict(label=f"K5 {kind}", P=K5_P, Q=Q, N=N, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


def _k6_bound_ms(N: int, win: int, cubic: bool):
    """Bound of one K6 call: Ip, gx and gy (3 N win^2 float32), four floats
    and a flag a point written once (``k6_roofline``'s bytes; the slabs it
    reads overlap and sit in L2), or its operations: a product and a sum a
    tap of the three x-passes (S rows) and y-passes, S = win + taps - 1, and
    the gradients' smoothings and differences."""
    K = 7 if cubic else 4
    S = win + K - 1
    ops = 2 * K * 3 * (S * win + win * win) + 5 * 2 * S * (S + 1) + 2 * 2 * S * S
    return bound_ms(4 * N * (3 * win * win + 4) + N, N * ops)


def _kernel_ms(fn, name: str, calls: int = 10) -> float:
    """Device milliseconds a call of the kernels whose name holds ``name``,
    from a ``torch.profiler`` trace of ``calls`` calls of ``fn`` (warm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    return us / 1e3 / calls


def _k6_check(label, got, want, win):
    """K6's results against the plain version's: Ip, gx and gy bit-equal;
    a11, a12, a22 within K6_RTOL of the trace; trackable equal but on the
    points whose min_eig or det lies within that margin of its threshold.
    Returns (largest sum error over the trace, points near a gate)."""
    for name, g, w in zip(("Ip", "gx", "gy"), got[:3], want[:3]):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"K6 {label}: {name} not bit-equal to the plain version, max "
                                 f"abs err {float((g - w).abs().nan_to_num().max())}")
    g11, g12, g22 = (t.double() for t in got[3:6])
    w11, w12, w22 = (t.double() for t in want[3:6])
    tr = w11.abs() + w22.abs()
    err = max(float(((g - w).abs() / tr.clamp_min(1e-30)).max())
              for g, w in ((g11, w11), (g12, w12), (g22, w22)))
    if not err <= K6_RTOL:
        raise AssertionError(f"K6 {label}: a sum off by {err:.3g} of the trace")
    det = w11 * w22 - w12 * w12
    size = (w11 * w22).abs() + w12 * w12
    min_eig = (tr - torch.sqrt((w11 - w22) ** 2 + 4 * w12 * w12)) * 0.5 / win ** 2
    near = (((min_eig - K6_THRESH * 1024.0).abs() <= 2 * K6_RTOL * tr / win ** 2)
            | ((det - 16 * torch.finfo(torch.float32).tiny).abs() <= 4 * K6_RTOL * size))
    if not torch.equal(got[7][~near], want[7][~near]):
        raise AssertionError(f"K6 {label}: trackable differs away from the gates' thresholds")
    return err, int(near.sum())


def phase_k6(dev, clip):
    """K6 (the LK source window of a level, ``csrc/source_window.cu``)
    against its plain version on the card: on the clip's first frame at the
    shapes of a lanes step (``K6_CASES``: win 15 at the frame and its top
    level, win 51 at the frame, linear and, on K5's patch through a shared
    map, cubic), then on a stack of SLAB_LANES frames (``run_batch``'s
    lanes: win 15, and win 51 cubic with a map a lane). Each call one K6
    launch (and one K5 where cubic), no K2; Ip, gx and gy bit-equal, the
    sums within K6_RTOL (``_k6_check``). Then K6's kernel time (a profiled
    trace, its kernels alone), the call's (the level's edge pad, K5 where
    cubic, K6), the plain version's and the bound."""
    from velocity_tpu_torch.ops import launches, lk_lanes
    from velocity_tpu_torch.ops.pyramid import build_pyramid

    frame = torch.as_tensor(clip.reader.grays[0]).to(dev).float()
    stack = torch.stack([torch.as_tensor(clip.reader.grays[i]).to(dev).float()
                         for i in range(SLAB_LANES)])
    g = np.random.default_rng(6)
    H, W = frame.shape
    M = torch.tensor([[1.012, 0.021, 3.4], [-0.017, 0.991, -1.2]], device=dev)
    cases = []
    for label, level, win, cubic in K6_CASES:
        pts = np.stack([g.uniform(0, W, N_POINTS), g.uniform(0, H, N_POINTS)], 1)
        p_l = torch.as_tensor(pts.astype(np.float32), device=dev).T * (1.0 / (1 << level))
        cases.append((label, build_pyramid(frame, level)[level], p_l, win, M if cubic else None))
    n = N_POINTS - N_POINTS % SLAB_LANES
    for label, win, cubic in (("stack win 15", 15, False), ("stack win 51 cubic", 51, True)):
        pts = np.stack([g.uniform(0, W, n), g.uniform(0, H, n)], 1)
        maps = np.eye(2, 3) + g.normal(0, [[0.02, 0.02, 2.0]] * 2, (SLAB_LANES, 2, 3))
        Ms = torch.as_tensor(maps.astype(np.float32), device=dev).repeat_interleave(
            n // SLAB_LANES, 0) if cubic else None
        cases.append((label, stack, torch.as_tensor(pts.astype(np.float32), device=dev).T, win,
                      Ms))
    rows = []
    for label, img, p_l, win, Ms in cases:
        args = (img, p_l, win, K6_THRESH, Ms)
        before = launches.read()
        got = lk_lanes.source_window(*args)
        torch.cuda.synchronize()
        counted = {k: m for k, (m, _) in launches.since(before).items() if m}
        want_counts = {"source_window": 1, **({"extract_warped": 1} if Ms is not None else {})}
        if counted != want_counts:
            raise AssertionError(f"K6 {label}: a call launched {counted}, not {want_counts}")
        want = lk_lanes._source_window_ref(*args)
        err, near = _k6_check(label, got, want, win)
        N = p_l.shape[1]
        ms = _kernel_ms(lambda: lk_lanes.source_window(*args), "source_window")
        call_ms = cuda_ms(lambda: lk_lanes.source_window(*args))
        plain_ms = cuda_ms(lambda: lk_lanes._source_window_ref(*args), calls=5)
        b_ms, b_by = _k6_bound_ms(N, win, Ms is not None)
        P = lk_lanes._round8(win + 9) if Ms is not None else lk_lanes._round8(win + 5)
        print(f"K6 {label} (N={N}, win {win}, P {P}, {'cubic' if Ms is not None else 'linear'}"
              f", level {tuple(img.shape)}): windows bit-equal, sums within {err:.3g} of the "
              f"trace, {near} points near a gate, {int(want[7].sum())} trackable; kernel "
              f"{ms:.4f} ms, call {call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); {b_ms / ms:.0%} of the bound's rate")
        rows.append(dict(label=f"K6 {label}", win=win, P=P, cubic=Ms is not None, N=N,
                         max_abs_err=0.0, sum_err=err, near_gate=near, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


def _still_levels(dev):
    """(W, H) of every level of a still's two pyramids, largest first: the
    images whose size K1's in-bounds gate reads on the stills path."""
    from velocity_tpu_torch.config import TrackerConfig
    from velocity_tpu_torch.pipeline.tracker import frame_pyramids
    from velocity_tpu_torch.testing.synthetic_clip import STILLS_SIZE

    full, small = frame_pyramids(
        torch.zeros(STILLS_SIZE[::-1], dtype=torch.uint8, device=dev), TrackerConfig())
    return sorted({(lv.shape[1], lv.shape[0]) for lv in full + small}, reverse=True)


def _reset_counts():
    from velocity_tpu_torch.ops import launches

    launches.set_counts()


def _read_counts():
    """({kernel: launches}, {kernel: {shape: launches}}) since the last reset."""
    from velocity_tpu_torch.ops import launches

    counts = launches.read()
    return ({name: n for name, (n, _) in counts.items()},
            {name: by_shape for name, (_, by_shape) in counts.items()})


def _launches_since(before):
    """[K1, K2, K3, K4, K5 launches] since ``launches.read()`` gave ``before``."""
    from velocity_tpu_torch.ops import launches

    return [n for n, _ in launches.since(before).values()]


def _check_run(label, res, clip, launches, path_kernels, jax_kmh,
               max_residual=MAX_RESIDUAL_PX):
    """The checks every driven path passes: its kernels launched, finite
    translations, speed against the truth and the JAX CPU value, residual."""
    missing = [k for k in path_kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the {label} path did not launch {missing}: {launches}")
    if not np.isfinite(res.B[:, 3:6]).all():
        raise AssertionError(f"{label}: non-finite per-frame translation")
    if abs(res.speed_kmh - clip.speed_kmh) > SPEED_VS_TRUTH * clip.speed_kmh:
        raise AssertionError(f"{label}: speed {res.speed_kmh} vs true {clip.speed_kmh}")
    if jax_kmh is not None and abs(res.speed_kmh - jax_kmh) > SPEED_VS_JAX * jax_kmh:
        raise AssertionError(f"{label}: speed {res.speed_kmh} vs JAX CPU {jax_kmh}")
    if not res.residual_px <= max_residual:
        raise AssertionError(f"{label}: mean residual {res.residual_px} px > {max_residual}")


def _annotated(name, fn):
    from torch.profiler import record_function

    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def _annotating(lk_backend):
    """Each function of ``ANNOTATED[lk_backend]`` wrapped in a profiler range
    while the context lasts; yields their names. Only an eager step calls
    them: a replayed graph runs no Python."""
    import importlib

    patched = []
    for path in ANNOTATED[lk_backend]:
        mod_name, attr = path.rsplit(".", 1)
        mod = importlib.import_module(f"velocity_tpu_torch.ops.{mod_name}")
        patched.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _annotated(attr, getattr(mod, attr)))
    try:
        yield {attr for _, attr, _ in patched}
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)


def _shares(events, names, total_us) -> str:
    """"; name x ms = y% of kernel time" for each annotated function."""
    from torch.autograd import DeviceType

    out = ""
    for name in sorted(names):
        us = sum(e.device_time_total for e in events
                 if e.name == name and e.device_type == DeviceType.CPU)
        out += f"; {name} {us / 1e3:.1f} ms = {us / max(total_us, 1e-9):.1%} of kernel time"
    return out


def _profile(run, lk_backend):
    """One profiled warm run (of ``PROFILE_FRAMES`` frames): device busy
    share (union of device activity over the run's wall time) and top
    kernels by device time (and the three hand kernels' wherever they
    rank). The shares of ``ANNOTATED``'s functions are read on an eager
    step (phase ``graph``): the run replays captured steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_kernel = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            n, t = by_kernel.get(e.name, (0, 0.0))
            by_kernel[e.name] = (n + 1, t + e.time_range.elapsed_us())
    total_us = sum(t for _, t in by_kernel.values())
    print(f"profile {lk_backend}, {PROFILE_FRAMES} frames: wall {wall:.3f} s (profiled), "
          f"device busy {busy / 1e6:.3f} s = {busy / 1e6 / wall:.1%}, kernel time "
          f"{total_us / 1e3:.1f} ms in {len(spans)} device activities (trace read "
          f"in {time.perf_counter() - t0:.1f} s)")
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    for rank, (name, (n, t)) in enumerate(ranked):
        if rank < 12 or "lk_block" in name or "gather_windows" in name:
            print(f"  {t / 1e3:9.2f} ms {t / max(total_us, 1e-9):6.1%} {n:7d} x  "
                  f"#{rank + 1} {_kernel_name(name)[:110]}")


def _print_gaps(lk_backend, name, by_shape, rows):
    """Each K2 or K3 size's warm-run launches x (time - bound), from the
    rows of its phase (at P 34, K3's frame-level row)."""
    for size, n in sorted(by_shape.items()):
        r = next((r for r in rows if r["size"] == size), None)
        gap = ("no row for this size" if r is None else
               f"x ({r['ms']:.4f} - {r['bound_ms']:.4f} ms) = "
               f"{n * (r['ms'] - r['bound_ms']):.2f} ms above the bound")
        print(f"slice {lk_backend}: {name} size {size}: {n} launches {gap}")


def phase_slice(dev, clip, lk_backend, path_kernels, rows):
    """One path end to end on the full-size synthetic clip; every kernel in
    ``path_kernels`` must launch in the warm run. Each kernel's launches are
    printed by shape, each with its launches x (time - bound) from ``rows``
    (each kernel's phase rows). A profiled run follows."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    runner = ScanSpeedRunner(PipelineConfig(solver=SolverConfig(dtype="float32"),
                                            tracker=TrackerConfig(lk_backend=lk_backend)),
                             device=dev)

    def run(n_frames=N_FRAMES):
        return runner.run(clip.reader, annotation=clip.annotation, n_frames=n_frames,
                          verbose=False)

    t0 = time.perf_counter()
    run()  # first run: library load, allocator and cuBLAS/cuSOLVER warm-up
    print(f"slice {lk_backend} cold run: {time.perf_counter() - t0:.2f} s")
    _reset_counts()
    res = run()
    launches, by_shape = _read_counts()
    wall = res.timings["wall_s"]
    jax_kmh = JAX_CPU_SPEED_KMH[lk_backend]
    print(f"slice {lk_backend} warm run: wall {wall:.3f} s, {N_FRAMES / wall:.3f} frames/s "
          f"(decode {res.timings['decode_s']:.3f} s, init {res.timings['init_s']:.3f} s, "
          f"msv {res.timings.get('msv_s', float('nan')):.3f} s)")
    print(f"slice {lk_backend}: speed {res.speed_kmh:.4f} km/h (true {clip.speed_kmh:.4f}, "
          f"JAX CPU {jax_kmh:.4f}), residual {res.residual_px:.4f} px, launches {launches}")
    for (win, cubic), n in sorted(by_shape["lk_block"].items()):
        # the shape's time and bound at it0 0 (phase_k1's random inputs)
        r = next(r for r in rows["lk_block"] if r.get("win") == win and r.get("cubic") == cubic
                 and r.get("it0") == 0)
        print(f"slice {lk_backend}: K1 win {win} {'cubic' if cubic else 'linear'}: {n} "
              f"launches x ({r['ms']:.4f} - {r['bound_ms']:.4f} ms) = "
              f"{n * (r['ms'] - r['bound_ms']):.2f} ms above the bound")
    for name in ("extract_slabs", "extract_patches"):
        _print_gaps(lk_backend, name, by_shape[name], rows[name])
    for (P, Q), n in sorted(by_shape["extract_warped"].items()):
        r = next(r for r in rows["extract_warped"] if r["P"] == P and r["Q"] == Q)
        print(f"slice {lk_backend}: K5 P {P} Q {Q}: {n} launches x ({r['ms']:.4f} - "
              f"{r['bound_ms']:.4f} ms) = {n * (r['ms'] - r['bound_ms']):.2f} ms above the bound")
    for (win, P, cubic), n in sorted(by_shape["source_window"].items()):
        r = next(r for r in rows["source_window"] if (r["win"], r["P"], r["cubic"]) == (win, P, cubic))
        print(f"slice {lk_backend}: K6 win {win} P {P} {'cubic' if cubic else 'linear'}: {n} "
              f"launches x ({r['ms']:.4f} - {r['bound_ms']:.4f} ms) = "
              f"{n * (r['ms'] - r['bound_ms']):.2f} ms above the bound")
    _check_run(lk_backend, res, clip, launches, path_kernels, jax_kmh)
    _profile(lambda: run(PROFILE_FRAMES), lk_backend)
    return launches


def _recording_segments_of(module, store, first: int):
    """Patch ``module.scan_segment`` so that each of its first ``first``
    calls appends (args, kwargs, the states of its generators at the call,
    its result, the launches it counted) to ``store``; returns the undo."""
    from velocity_tpu_torch.ops import launches

    real = module.scan_segment

    def recording(*args, **kwargs):
        if len(store) >= first:
            return real(*args, **kwargs)
        gens = args[9] if isinstance(args[9], list) else [args[9]]
        states = [g.get_state() for g in gens]
        before = launches.read()
        out = real(*args, **kwargs)
        store.append((args, kwargs, states, out, _launches_since(before)))
        return out

    module.scan_segment = recording

    def undo():
        module.scan_segment = real

    return undo


def _eager_segment(dev, args, kwargs, states):
    """A recorded ``scan_segment`` call again, frame by frame through the
    eager step called directly on the card (``step_graph._frame``, the body the
    graph captured, in the captured form of its loops, so that it makes the
    graph's launches), from generators set to the recorded states: (carry,
    outs stacked as the segment stacks them, launches counted)."""
    from velocity_tpu_torch.ops import launches
    from velocity_tpu_torch.pipeline import step_graph
    from velocity_tpu_torch.utils.loops import fixed_trip_loops

    frames, pyr, spyr, pts, vg, vp, t0, p3, intr, gen, tcfg, scfg, sdt = args[:13]
    lean = kwargs.get("lean", args[13] if len(args) > 13 else False)
    gens = []
    for st in states:
        g = torch.Generator(device=dev)
        g.set_state(st)
        gens.append(g)
    lanes = pts.dim() == 3
    k = frames.shape[1] if lanes else len(frames)
    per_frame = [gens] * k if lanes else (gens if isinstance(gen, list) else gens * k)
    carry, recs = (pyr, spyr, pts, vg, vp, t0), []
    before = launches.read()
    with fixed_trip_loops():
        for j in range(k):
            carry, rec = step_graph._frame(frames[:, j] if lanes else frames[j], carry, p3, intr,
                                     per_frame[j], tcfg, scfg, sdt, lean)
            recs.append(rec)
    torch.cuda.synchronize()
    counted = _launches_since(before)
    outs = tuple(torch.stack(o, dim=1 if lanes else 0) for o in zip(*recs))
    return carry, (outs[0] if lean else outs), counted


def _graph_matches_eager(dev, label, store):
    """Each recorded segment (captured graph, one replay a frame) against
    the eager step on the same inputs: every output and the carry bit for
    bit, and the launches the replays counted equal to those the eager
    steps made. Returns the frames compared."""
    from velocity_tpu_torch.pipeline import step_graph

    frames = 0
    for n, (args, kwargs, states, (carry, outs), counted) in enumerate(store):
        e_carry, e_outs, e_counted = _eager_segment(dev, args, kwargs, states)
        got = step_graph._flat((carry, outs))
        want = step_graph._flat((e_carry, e_outs))
        same = len(got) == len(want) and all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want))
        k = args[0].shape[1] if args[3].dim() == 3 else len(args[0])
        frames += k
        print(f"graph {label} segment {n} ({k} frames, pts {tuple(args[3].shape)}): captured "
              f"segment bit-equal to the eager step: {same}; launches K1-K6 counted by "
              f"the replays {counted}, made by the eager steps {e_counted}")
        if not same or counted != e_counted:
            raise AssertionError(f"graph {label} segment {n}: the captured segment differs "
                                 f"from the eager step ({same}) or its counted launches "
                                 f"{counted} from the eager steps' {e_counted}")
    return frames


def _replay_profile(dev, graph, inputs, names=()):
    """One step ``graph(*inputs)`` (a replay: inputs copied in, noise drawn,
    the replay; or an eager step): stream ms between CUDA events (median of
    5), and the device activities of one step under ``torch.profiler``:
    their count, their summed ms, that sum's share of the stream time, and
    the shares of the annotated functions ``names`` and of K6's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        graph(*inputs)

    ms = []
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    event_ms = statistics.median(ms[1:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    acts = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in names]
    kernel_ms = sum(e.time_range.elapsed_us() for e in acts) / 1e3
    k6_ms = sum(e.time_range.elapsed_us() for e in acts if "source_window" in e.name) / 1e3
    shares = _shares(events, names, kernel_ms * 1e3)
    if k6_ms:
        shares += f"; K6 (source_window) {k6_ms:.2f} ms = {k6_ms / kernel_ms:.1%} of kernel time"
    return dict(event_ms=event_ms, kernel_ms=kernel_ms, activities=len(acts),
                busy=kernel_ms / event_ms, k6_ms=k6_ms, shares=shares)


def _node_count(raw_graph) -> int | None:
    """Nodes of a ``cudaGraph_t`` (``cuGraphGetNodes``), or None where the
    driver library does not load or the call fails."""
    import ctypes

    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None, ctypes.byref(n))
    return int(n.value) if rc == 0 else None


def phase_graph(dev, clip):
    """The scan form on the card: each segment of ``scan_segment`` replays
    one captured CUDA graph per frame. First one eager step (frame 0 -> 1)
    in the captured form of its loops (``utils/loops.py``) under
    ``torch.cuda.set_sync_debug_mode("error")``: no host read, no
    synchronising copy. Then the captured segments of the scan runner with
    the lanes and the fast engine (both segments of a 20-frame run), of
    run_batch's three-lane batch with each (segment A), and of the
    long-video runner (its first two segments, window 8) against the eager
    step called directly on the card on the same inputs, bit for bit, with
    the launches each counted; a replayed segment under the sync debug
    mode; then each graph's node count, capture time, pool memory and
    replays, and one replayed step's stream and kernel ms beside the eager
    step's (its loops stopping early, as every eager caller runs it), all
    also as one JSON line."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
    from velocity_tpu_torch.pipeline import longvideo, multivideo, scan, step_graph
    from velocity_tpu_torch.pipeline.multivideo import run_batch
    from velocity_tpu_torch.testing.synthetic_clip import render_lanes
    from velocity_tpu_torch.utils.loops import fixed_trip_loops

    solver = SolverConfig(dtype="float32")
    compared = {}
    singles = {}
    seen = {}  # every graph the phase used, whether or not it is still kept
    for backend in ("lanes", "fast"):
        cfg = PipelineConfig(solver=solver, tracker=TrackerConfig(lk_backend=backend))
        store = []
        undo = _recording_segments_of(scan, store, 2)
        try:
            scan.ScanSpeedRunner(cfg, device=dev).run(clip.reader, annotation=clip.annotation,
                                                      n_frames=N_FRAMES, verbose=False)
        finally:
            undo()
        seen.update(step_graph.step_graphs())
        singles[backend] = store[0]
        if backend == "lanes":
            args = store[0][0]
            g = torch.Generator(device=dev)
            g.set_state(store[0][2][0])
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with fixed_trip_loops():
                    step_graph._frame(args[0][0], tuple(args[1:7]), args[7], args[8], g, args[10],
                                args[11], args[12], False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            print("graph: one eager frame step on the card under set_sync_debug_mode('error'): "
                  "no synchronising call")
        compared[backend] = _graph_matches_eager(dev, backend, store)

    lanes = render_lanes(clip)
    for backend in ("lanes", "fast"):
        cfg = PipelineConfig(solver=solver, tracker=TrackerConfig(lk_backend=backend))
        store = []
        undo = _recording_segments_of(multivideo, store, 1)
        try:
            run_batch([c.reader for c in lanes], annotations=[c.annotation for c in lanes],
                      n_frames=cfg.msv_frame, config=cfg, device=dev, verbose=False)
        finally:
            undo()
        seen.update(step_graph.step_graphs())
        compared[f"batch {backend}"] = _graph_matches_eager(dev, f"batch {backend}", store)

    store = []
    undo = _recording_segments_of(longvideo, store, 2)
    try:
        longvideo.LongVideoRunner(PipelineConfig(solver=solver), device=dev).run(
            clip.reader, annotation=clip.annotation, verbose=False, window=8, overlap=3,
            ba_refine=False)
    finally:
        undo()
    seen.update(step_graph.step_graphs())
    compared["longvideo"] = _graph_matches_eager(dev, "longvideo", store)

    # a replayed segment under the sync debug mode, against its recorded run
    args, kwargs, _states, (carry, outs), _ = singles["lanes"]
    g = torch.Generator(device=dev)
    g.set_state(singles["lanes"][2][0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = scan.scan_segment(*args[:9], g, *args[10:], **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = all(torch.equal(a, b)
               for a, b in zip(step_graph._flat(again), step_graph._flat((carry, outs))))
    print(f"graph: a replayed segment of {len(args[0])} frames under "
          f"set_sync_debug_mode('error'): no synchronising call, bit-equal to its first run: "
          f"{same}")
    if not same:
        raise AssertionError("graph: a replayed segment differs from its first run")

    rows = []
    for key, gr in seen.items():
        shapes = key[1]
        k1, k2, k3, k5, k6 = (gr.launches[k][0] for k in ("lk_block", "extract_slabs",
                                                          "extract_patches", "extract_warped",
                                                          "source_window"))
        nodes = _node_count(gr.graph.raw_cuda_graph())
        rows.append(dict(frame=list(shapes[0][0]), points=gr.n, backend=key[2].lk_backend,
                         shard_features=key[2].shard_features,
                         lean=key[5], nodes=nodes, capture_s=gr.capture_s,
                         pool_mb=gr.pool_bytes / 2**20, inputs_mb=gr.input_bytes / 2**20,
                         replays=gr.replays,
                         launches_per_replay=dict(lk_block=k1, extract_slabs=k2,
                                                  extract_patches=k3, extract_warped=k5,
                                                  source_window=k6)))
        print(f"graph: frame {shapes[0][0]} {key[2].lk_backend} shard_features "
              f"{key[2].shard_features} lean {key[5]}: {nodes} nodes, captured in "
              f"{gr.capture_s:.2f} s (warm-up included), pool {gr.pool_bytes / 2**20:.1f} MiB "
              f"and inputs {gr.input_bytes / 2**20:.1f} MiB, "
              f"{gr.replays} replays so far, per replay K1 {k1} K2 {k2} K3 {k3} K5 {k5} K6 {k6}")
    print(f"graph: {len(rows)} graphs ({len(step_graph.step_graphs())} kept), frames compared "
          f"{compared}; device memory peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved now")

    # one replayed step beside one eager step, each engine on one lane
    for label, rec in singles.items():
        args = rec[0]
        inputs = (args[0][0], tuple(args[1:7]), args[7], args[8], torch.Generator(device=dev))
        gr = step_graph._graph_step(*inputs[:4], args[10], args[11], args[12], False)
        prof = _replay_profile(dev, gr, inputs)
        with _annotating(label) as names:
            eager = _replay_profile(dev, lambda *a: step_graph._frame(*a, args[10], args[11],
                                                               args[12], False), inputs, names)
        print(f"graph {label}: one replayed step {prof['event_ms']:.3f} ms of stream time, "
              f"{prof['activities']} device activities in {prof['kernel_ms']:.3f} ms, busy "
              f"{prof['busy']:.1%}; one eager step {eager['event_ms']:.3f} ms, "
              f"{eager['activities']} activities in {eager['kernel_ms']:.3f} ms, busy "
              f"{eager['busy']:.1%}{eager['shares']}")
        rows.append(dict(profile=label, replay=prof, eager=eager))
    print(json.dumps({"graphs": rows}))
    del gr
    seen.clear()
    reserved = torch.cuda.memory_reserved()
    step_graph.release_step_graphs()
    print(f"graph: release_step_graphs(): {reserved / 2**30:.2f} -> "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def _replays():
    """{key: replays so far} of the captured steps kept now."""
    from velocity_tpu_torch.pipeline import step_graph

    return {k: g.replays for k, g in step_graph.step_graphs().items()}


def _graphs_line(label, before) -> str:
    """Each captured step kept now that ``before`` ({key: replays}) lacked,
    or whose replays rose since: its frame, capture seconds, pool MiB and
    the replays it added."""
    from velocity_tpu_torch.pipeline import step_graph

    out = []
    for key, gr in step_graph.step_graphs().items():
        added = gr.replays - before.get(key, 0)
        if added or key not in before:
            kind = "new capture" if key not in before else "kept"
            out.append(f"frame {list(key[1][0][0])} {kind} ({gr.capture_s:.2f} s, pool "
                       f"{gr.pool_bytes / 2**20:.1f} MiB), "
                       f"{added} replays")
    return f"{label}: captured steps: " + ("; ".join(out) or "none replayed")


@contextlib.contextmanager
def _eager_drivers():
    """The per-frame drivers' step put back to the eager
    ``fused_frame_step_pyr`` while the context lasts (the reference the
    replaying drivers are held to)."""
    from velocity_tpu_torch.pipeline import speedest

    real = speedest._captured_step
    speedest._captured_step = lambda *args: None
    try:
        yield
    finally:
        speedest._captured_step = real


def _same_run(a, b) -> bool:
    """B, S[:, 2:], the track and reprojection history and the validity of
    two runs equal bit for bit."""
    return all(np.array_equal(x, y, equal_nan=True) for x, y in (
        (a.B, b.B), (a.S[:, 2:], b.S[:, 2:]), (a.track_px, b.track_px),
        (a.proj_px, b.proj_px), (a.valid, b.valid)))


def _held_to_eager(label, res, launches, run):
    """``run()`` again with the drivers' step eager: the replayed run
    ``res`` must equal it bit for bit. Prints both walls and launches."""
    _reset_counts()
    with _eager_drivers():
        eager = run()
    counts, _ = _read_counts()
    same = _same_run(res, eager)
    print(f"{label}: replayed run bit-equal to the eager driver's: {same}; wall replayed "
          f"{res.timings['wall_s']:.3f} s, eager {eager.timings['wall_s']:.3f} s; launches "
          f"K1/K2 replayed {launches['lk_block']}/{launches['extract_slabs']}, eager "
          f"{counts['lk_block']}/{counts['extract_slabs']}")
    if not same:
        raise AssertionError(f"{label}: the replaying driver differs from the eager driver")


def phase_driver(dev, clip):
    """The per-frame driver on the full-size clip, which replays the frame
    step's captured graph: beside the scan runner in turns (scan, driver,
    driver, scan; warm), reusing the scan runner's capture (no new key,
    N_FRAMES - 1 replays a run), its K1 and K2 launches beside the scan
    runner's, its speed within the limits, bit-equal to the eager driver;
    then with the rescue forced on every frame through the clip's known
    motion, bit-equal to the eager driver, directly and through the scan
    runner's rescue branch: every frame's T23 must be the matcher's.
    Returns {path: launches} of the plain ("driver") and the forced
    ("rescue") replayed runs."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
    from velocity_tpu_torch.pipeline import SpeedEstimator
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    solver = SolverConfig(dtype="float32")
    run_kw = dict(annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    scan = ScanSpeedRunner(PipelineConfig(solver=solver), device=dev)
    est = SpeedEstimator(PipelineConfig(solver=solver), device=dev)

    walls = {"scan": [], "driver": []}
    _reset_counts()
    scan_res = scan.run(clip.reader, **run_kw)
    scan_counts, _ = _read_counts()
    walls["scan"].append(scan_res.timings["wall_s"])
    before = _replays()
    _reset_counts()
    res = est.run(clip.reader, **run_kw)
    launches, by_shape = _read_counts()
    after = _replays()
    added = [n - before[k] for k, n in after.items() if k in before and n != before[k]]
    print(_graphs_line("driver", before))
    if set(after) != set(before) or added != [N_FRAMES - 1]:
        raise AssertionError(f"driver: not one replay of the scan runner's capture a frame: "
                             f"{len(set(after) - set(before))} new captures, replays added "
                             f"{added}")
    walls["driver"].append(res.timings["wall_s"])
    walls["driver"].append(est.run(clip.reader, **run_kw).timings["wall_s"])
    walls["scan"].append(scan.run(clip.reader, **run_kw).timings["wall_s"])
    fps = {k: [N_FRAMES / w for w in v] for k, v in walls.items()}
    print(f"driver warm runs: wall {walls['driver'][0]:.3f} s and {walls['driver'][1]:.3f} s, "
          f"{fps['driver'][0]:.3f} and {fps['driver'][1]:.3f} frames/s; the scan runner "
          f"before and after: {walls['scan'][0]:.3f} s and {walls['scan'][1]:.3f} s, "
          f"{fps['scan'][0]:.3f} and {fps['scan'][1]:.3f} frames/s")
    same = np.array_equal(res.B, scan_res.B)
    print(f"driver: speed {res.speed_kmh:.4f} km/h (true {clip.speed_kmh:.4f}, scan runner "
          f"{scan_res.speed_kmh:.4f}, JAX CPU driver {JAX_CPU_SPEED_KMH['driver']}), residual "
          f"{res.residual_px:.4f} px, trajectory bit-equal to the scan runner's: {same}; "
          f"launches K1 {launches['lk_block']} K2 {launches['extract_slabs']} "
          f"{by_shape['lk_block']} {by_shape['extract_slabs']}, the scan runner's K1 "
          f"{scan_counts['lk_block']} K2 {scan_counts['extract_slabs']}")
    _check_run("driver", res, clip, launches, ("lk_block", "extract_slabs"),
               JAX_CPU_SPEED_KMH["driver"])
    if abs(res.speed_kmh - scan_res.speed_kmh) > 1e-3 * scan_res.speed_kmh:
        raise AssertionError(f"driver speed {res.speed_kmh} vs scan runner "
                             f"{scan_res.speed_kmh}: one generator order, no frame rescued")
    _held_to_eager("driver", res, launches, lambda: est.run(clip.reader, **run_kw))

    # ---- the rescue forced on every frame ----
    asked = []

    def matcher(im_prev, im_cur, pts, valid):
        M = clip.motion_affine(clip.frame_index(im_prev), clip.frame_index(im_cur))
        asked.append(M)
        return M

    forced_cfg = PipelineConfig(solver=solver,
                                tracker=TrackerConfig(min_affine_inliers=ALWAYS_RESCUE))
    forced = SpeedEstimator(forced_cfg, device=dev, fallback_matcher=matcher)
    step, used = forced._frame_step_with_fallback, []

    def recording_step(*args):
        out = step(*args)
        used.append(out[9].cpu().numpy())
        return out

    forced._frame_step_with_fallback = recording_step
    before = _replays()
    _reset_counts()
    fres = forced.run(clip.reader, **run_kw)
    flaunches, _ = _read_counts()
    if len(asked) != N_FRAMES - 1 or len(used) != N_FRAMES - 1 or not all(
            np.array_equal(a, u) for a, u in zip(asked, used)):
        raise AssertionError(f"forced rescue: {len(asked)} matcher calls, {len(used)} steps, "
                             "or a frame's T23 is not the matcher's")
    print(_graphs_line("driver, rescue forced (cold)", before))
    print(f"driver, rescue forced on {len(asked)} frames: wall {fres.timings['wall_s']:.3f} s "
          f"(its capture included), speed {fres.speed_kmh:.4f} km/h, residual "
          f"{fres.residual_px:.4f} px, every T23 the matcher's; launches K1 "
          f"{flaunches['lk_block']} K2 {flaunches['extract_slabs']}")
    _check_run("forced rescue", fres, clip, flaunches, ("lk_block", "extract_slabs"), None)
    del asked[:], used[:]
    _reset_counts()
    fres = forced.run(clip.reader, **run_kw)
    flaunches, _ = _read_counts()
    _held_to_eager("driver, rescue forced", fres, flaunches,
                   lambda: forced.run(clip.reader, **run_kw))

    n_before = len(asked)
    before = _replays()
    sres = ScanSpeedRunner(forced_cfg, device=dev, fallback_matcher=matcher).run(
        clip.reader, **run_kw)
    if len(asked) - n_before != N_FRAMES - 1 or sres.first_gray is not None:
        raise AssertionError("the scan runner did not hand the collapsed clip to the driver")
    if not np.allclose(sres.B, fres.B, rtol=1e-6, atol=1e-9):
        raise AssertionError("the scan runner's rescue and the driver disagree")
    print(_graphs_line("scan runner, rescue forced", before))
    print(f"scan runner, rescue forced: re-ran through the driver, speed {sres.speed_kmh:.4f} "
          f"km/h, trajectory bit-equal to the driver's: {np.array_equal(sres.B, fres.B)}")
    return {"driver": launches, "rescue": flaunches}


def _events_ms(fn, rounds: int = 5) -> float:
    """Milliseconds of one ``fn()`` call between two CUDA events, host reads
    inside it included; median over ``rounds`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _ba_case(label, solver, nt, dtype_name, cfg, dev, references):
    """One BA solver on the card against itself on the CPU in f64: points,
    cameras and residual within ``BA_RTOL``; ms per iteration; the share of
    an iteration spent in the reduced camera solve (Schur solvers)."""
    from velocity_tpu_torch.solvers import schur

    dtype = getattr(torch, dtype_name)
    key = (solver.__name__, nt, cfg.camera_solver)
    if key not in references:
        t0 = time.perf_counter()
        references[key] = solver(_ba_scene(BA_CAMERAS, nt, torch.float64, "cpu"), cfg)
        print(f"  CPU f64 reference {label}: {time.perf_counter() - t0:.2f} s, "
              f"{references[key].iterations} iterations")
    want = references[key]
    prob = _ba_scene(BA_CAMERAS, nt, dtype, dev)
    got = solver(prob, cfg)
    rtol = BA_RTOL[dtype_name]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # monocular BA leaves the global scale to the damping alone, and rounding
    # lets it drift: compare in the reference's scale gauge (the last
    # camera's baseline), and hold the gauge factor itself to 10 x rtol
    points, cams = got.points.double().cpu(), got.cams.double().cpu()
    gauge = float(want.cams[-1, 0:3].norm() / cams[-1, 0:3].norm())
    cams = torch.cat([cams[:, 0:3] * gauge, cams[:, 3:6]], dim=1)
    errs = (rel(points * gauge, want.points), rel(cams, want.cams),
            abs(float(got.residual_rms) - float(want.residual_rms)) / float(want.residual_rms))
    ms = _events_ms(lambda: solver(prob, cfg)) / got.iterations
    line = (f"BA {label} {dtype_name} nc {BA_CAMERAS} nt {nt}: {got.iterations} iterations "
            f"(CPU f64 {want.iterations}), residual {float(got.residual_rms):.4f} px, vs CPU "
            f"f64 points {errs[0]:.2e} cams {errs[1]:.2e} residual {errs[2]:.2e} (limit "
            f"{rtol:g}) at scale gauge 1{gauge - 1:+.2e}; {ms:.3f} ms per iteration")
    if solver is schur.ba_schur:
        lam = cfg.damping / prob.intr.fx ** 2
        blocks = schur.compute_blocks(prob.intr, prob, prob.points0, prob.cams0)
        S, rhs, Vinv, gp, W = schur.schur_reduce(blocks, lam, dtype)
        cg_iters = cfg.cg_max_iters if cfg.camera_solver == "cg" else 0
        solve_ms = _events_ms(lambda: schur._solve_cameras(S, rhs, cfg.cg_tol, cg_iters))
        dc = schur._solve_cameras(S, rhs, cfg.cg_tol, cg_iters)
        parts = {
            "blocks": lambda: schur.compute_blocks(prob.intr, prob, prob.points0, prob.cams0),
            "reduce": lambda: schur.schur_reduce(blocks, lam, dtype),
            "backsub": lambda: schur.schur_backsub(Vinv, gp, W, dc),
            "rms read": lambda: float(torch.sqrt(torch.sum(dc * dc))),
        }
        line += (f"; on the first iteration's system the {S.shape[0]}x{S.shape[0]} camera "
                 f"solve {solve_ms:.3f} ms = {solve_ms / ms:.0%} of a mean iteration, "
                 + ", ".join(
                     f"{name} {_events_ms(fn):.3f} ms" for name, fn in parts.items()))
    print(line)
    if got.iterations != want.iterations and dtype_name == "float64":
        raise AssertionError(f"BA {label} {dtype_name}: {got.iterations} iterations on the "
                             f"card, {want.iterations} on the CPU")
    gauge_tol = BA_CG_GAUGE_TOL if cfg.camera_solver == "cg" else 10 * rtol
    if not (max(errs) <= rtol and abs(gauge - 1) <= gauge_tol):
        raise AssertionError(f"BA {label} {dtype_name}: {errs} above {rtol}, or the scale "
                             f"gauge {gauge} off by more than {gauge_tol}")
    return ms


def phase_ba(dev, clip):
    """The scan runner with the bundle-adjustment re-anchor on the clip."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    runner = ScanSpeedRunner(PipelineConfig(solver=SolverConfig(dtype="float32"), anchor="ba"),
                             device=dev)
    run_kw = dict(annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    runner.run(clip.reader, **run_kw)
    _reset_counts()
    res = runner.run(clip.reader, **run_kw)
    launches, _ = _read_counts()
    wall = res.timings["wall_s"]
    print(f"anchor=ba warm run: wall {wall:.3f} s, {N_FRAMES / wall:.3f} frames/s, the BA "
          f"re-anchor (host f64, {PipelineConfig().msv_frame + 1} cameras x {N_POINTS} "
          f"tracks) {res.timings['msv_s']:.3f} s; speed {res.speed_kmh:.4f} km/h (true "
          f"{clip.speed_kmh:.4f}, JAX CPU {JAX_CPU_SPEED_KMH['ba']}), residual "
          f"{res.residual_px:.4f} px, launches K1 {launches['lk_block']} K2 "
          f"{launches['extract_slabs']}")
    _check_run("anchor=ba", res, clip, launches, ("lk_block", "extract_slabs"),
               JAX_CPU_SPEED_KMH["ba"])


def phase_ba_solvers(dev):
    """The BA solvers on the card at the windowed size, each against itself
    on the CPU in f64."""
    from velocity_tpu_torch.config import BAConfig
    from velocity_tpu_torch.solvers.ba import ba_dense
    from velocity_tpu_torch.solvers.schur import ba_schur

    references = {}
    dense_cfg = BAConfig(max_iters=10)
    cg_cfg = BAConfig(max_iters=10, camera_solver="cg")
    for dtype_name in ("float32", "float64"):
        _ba_case("schur, dense camera solve", ba_schur, BA_TRACKS, dtype_name, dense_cfg, dev,
                 references)
        _ba_case("schur, CG camera solve", ba_schur, BA_TRACKS, dtype_name, cg_cfg, dev,
                 references)
        _ba_case("dense Jacobian", ba_dense, BA_DENSE_TRACKS, dtype_name, dense_cfg, dev,
                 references)


def phase_stills(dev):
    """The stills driver on the full-size burst: cold run, then the warm run
    with the counts; its kernels, speed, residual, replenished frames,
    promoted lanes and georegistration checked."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig
    from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator
    from velocity_tpu_torch.testing.synthetic_clip import (
        STILLS_BURST, STILLS_N, STILLS_SIZE, render_burst)

    t0 = time.perf_counter()
    burst = render_burst()
    w, h = STILLS_SIZE
    print(f"stills: {STILLS_N} x {h}x{w} rendered in {time.perf_counter() - t0:.1f} s, true "
          f"speed {burst.speed_kmh:.3f} km/h")
    est = StillsSpeedEstimator(PipelineConfig(native_scale=STILLS_BURST["native_scale"],
                                              solver=SolverConfig(dtype="float32")), device=dev)
    replenish, promote, seen = est._replenish, est._promote_pending, {}

    def counting_replenish(*args, **kwargs):
        out = replenish(*args, **kwargs)
        seen["replenished"] = seen.get("replenished", 0) + (out[3] > 0)
        seen["seeded"] = seen.get("seeded", 0) + out[3]
        return out

    def counting_promote(*args, **kwargs):
        out = promote(*args, **kwargs)
        seen["promoted"] = seen.get("promoted", 0) + out[3]
        return out

    est._replenish, est._promote_pending = counting_replenish, counting_promote
    before = _replays()
    t0 = time.perf_counter()
    est.run(burst.stills(), annotation=burst.annotation, verbose=False)
    print(f"stills cold run: {time.perf_counter() - t0:.2f} s, its capture included")
    print(_graphs_line("stills", before))
    seen.clear()
    _reset_counts()
    res = est.run(burst.stills(), annotation=burst.annotation, verbose=False)
    launches, by_shape = _read_counts()
    wall = res.timings["wall_s"]
    jax_kmh = JAX_CPU_SPEED_KMH["stills"]
    print(f"stills warm run: wall {wall:.3f} s, {STILLS_N / wall:.3f} stills/s; speed "
          f"{res.speed_kmh:.4f} km/h (true {burst.speed_kmh:.4f}, JAX CPU {jax_kmh}), residual "
          f"{res.residual_px:.4f} px; frames replenished {seen.get('replenished', 0)} "
          f"({seen.get('seeded', 0)} lanes seeded), lanes promoted {seen.get('promoted', 0)}; "
          f"live lanes per still {res.S[:, 2].astype(int).tolist()}; launches K1 "
          f"{launches['lk_block']} K2 {launches['extract_slabs']} {by_shape['lk_block']} "
          f"{by_shape['extract_slabs']}")
    _check_run("stills", res, burst, launches, ("lk_block", "extract_slabs"), jax_kmh)
    if not (seen.get("replenished", 0) > 0 and seen.get("promoted", 0) > 0):
        raise AssertionError(f"stills: no frame replenished or no lane promoted: {seen}")
    if not (np.isfinite(res.B[:, 6:12]).all() and np.all(res.B[:, 6:9] != 0)):
        raise AssertionError("stills: georegistration left B[:, 6:9] empty or non-finite")
    _held_to_eager("stills", res, launches,
                   lambda: est.run(burst.stills(), annotation=burst.annotation, verbose=False))
    return launches


def _recording_msv(calls):
    """Patch ``msv_refine_translation`` where the scan runner's re-anchor and
    run_batch call it, so that each call appends (iterations, residual rms
    in px) to ``calls``; returns a function that undoes the patch."""
    from velocity_tpu_torch.pipeline import anchor, multivideo

    real = anchor.msv_refine_translation

    def recording(intr, *args, **kwargs):
        out = real(intr, *args, **kwargs)
        calls.append((out.iterations, float(out.residual_rms * intr.fx)))
        return out

    anchor.msv_refine_translation = multivideo.msv_refine_translation = recording

    def undo():
        anchor.msv_refine_translation = multivideo.msv_refine_translation = real

    return undo


def _recording_segments(calls):
    """Patch run_batch's ``scan_segment`` so that each call appends the
    number of lanes it stepped (0 for a call without a lane axis) to
    ``calls``; returns a function that undoes the patch."""
    from velocity_tpu_torch.pipeline import multivideo

    real = multivideo.scan_segment

    def recording(*args, **kwargs):
        pts0 = args[3]
        calls.append(pts0.shape[0] if pts0.dim() == 3 else 0)
        return real(*args, **kwargs)

    multivideo.scan_segment = recording

    def undo():
        multivideo.scan_segment = real

    return undo


def _batch_and_singles(dev, name, lanes, cfg, path_kernels):
    """run_batch of ``cfg`` over ``lanes``, counted, then the single
    scan-runner runs of the same clips, counted each: the walls in turns
    (batch, then singles), whole and less each run's host MSV (the batch's
    MSV, the single runs' re-anchor), and each MSV's iterations and
    residual. A warm-up run_batch of segment A alone (no host MSV) runs
    first, counted, as the single runs come warm from the earlier phases.
    Each run within the speed limits and within BATCH_RESIDUAL_VS_JAX_PX of
    JAX's residual on its lane (JAX_CPU_SPEED_KMH[name]); run_batch steps
    each segment of all lanes as one call, so each of ``path_kernels`` but
    K2 (which each lane's frame-0 init launches once) launches at most
    BATCH_LAUNCH_RATIO times the largest single run's, not their sum; lane
    0's track history is bit-equal to its single run's. Lanes v > 0 draw
    from seed v (JAX's run_batch draws lane v from PRNGKey(v)), so their
    RANSAC hypotheses, and with them a few LK blocks, differ from their
    single runs'. Returns (the batch's launches, the warm-up's results and
    launches)."""
    from velocity_tpu_torch.pipeline.multivideo import run_batch
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    jax_kmh = JAX_CPU_SPEED_KMH[name]
    jax_res = JAX_CPU_BATCH_RESIDUAL_PX if name == "batch" else JAX_CPU_BATCH_FAST_RESIDUAL_PX
    runner = ScanSpeedRunner(cfg, device=dev)
    msv_batch, msv_single, segments = [], [], []
    kw = dict(annotations=[c.annotation for c in lanes], config=cfg, device=dev, verbose=False)
    _reset_counts()
    t = time.perf_counter()
    warm = run_batch([c.reader for c in lanes], n_frames=cfg.msv_frame, **kw)  # no MSV
    warm_counts, _ = _read_counts()
    print(f"multivideo {name}: warm-up run_batch of frames 0..{cfg.msv_frame - 1} "
          f"{time.perf_counter() - t:.3f} s, launches {warm_counts}")

    undo = _recording_msv(msv_batch)
    undo_seg = _recording_segments(segments)
    try:
        _reset_counts()
        t = time.perf_counter()
        res = run_batch([c.reader for c in lanes], n_frames=N_FRAMES, **kw)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t
        launches, _ = _read_counts()
    finally:
        undo_seg()
        undo()
    single, single_counts = [], []
    undo = _recording_msv(msv_single)
    try:
        for c in lanes:
            _reset_counts()
            single.append(runner.run(c.reader, annotation=c.annotation, n_frames=N_FRAMES,
                                     verbose=False))
            single_counts.append(_read_counts()[0])
    finally:
        undo()
    wall_s = sum(r.timings["wall_s"] for r in single)
    msv_b = sum(r.timings["msv_s"] for r in res)
    msv_s = sum(r.timings["msv_s"] for r in single)
    most = {k: max(c[k] for c in single_counts) for k in launches}
    cap = cfg.solver.max_iters_msv
    shown = " ".join(f"{k} {launches[k]}" for k in path_kernels)
    shown_single = " ".join(f"{k} {[c[k] for c in single_counts]}" for k in path_kernels)
    print(f"multivideo {name}: run_batch of {len(lanes)} lanes x {N_FRAMES} frames warm wall "
          f"{wall_b:.3f} s, of it host MSV {msv_b:.3f} s, the rest {wall_b - msv_b:.3f} s; the "
          f"three single scan-runner runs {wall_s:.3f} s, of it re-anchor {msv_s:.3f} s, the "
          f"rest {wall_s - msv_s:.3f} s (in turns: batch, then singles); the rest's ratio "
          f"{(wall_b - msv_b) / (wall_s - msv_s):.3f}; segment calls (lanes each) {segments}; "
          f"launches {shown}; the single runs' {shown_single}")
    if len(msv_batch) != len(lanes) or len(msv_single) != len(lanes):
        raise AssertionError(f"multivideo {name}: {len(msv_batch)} batch and {len(msv_single)} "
                             f"single MSV solves for {len(lanes)} lanes")
    if segments != [len(lanes)] * 2:
        raise AssertionError(f"multivideo {name}: segment calls {segments}, not one call of "
                             f"all {len(lanes)} lanes per segment")
    for v, (r, c, s, jkmh, jres, mb, ms) in enumerate(zip(
            res, lanes, single, jax_kmh, jax_res, msv_batch, msv_single)):
        print(f"multivideo {name} lane {v}: speed {r.speed_kmh:.4f} km/h (true "
              f"{c.speed_kmh:.4f}, JAX CPU run_batch {jkmh}, single scan runner "
              f"{s.speed_kmh:.4f}), residual {r.residual_px:.4f} px (JAX CPU {jres:.4f}, single "
              f"{s.residual_px:.4f}); host MSV {r.timings['msv_s']:.3f} s, {mb[0]} iterations of "
              f"{cap}, rms {mb[1]:.4f} px (single run's re-anchor {s.timings['msv_s']:.3f} s, its "
              f"MSV {ms[0]} iterations, rms {ms[1]:.4f} px)")
        limit = jres + BATCH_RESIDUAL_VS_JAX_PX
        _check_run(f"multivideo {name} lane {v}", r, c, launches, path_kernels, jkmh, limit)
        _check_run(f"multivideo {name} single run {v}", s, c, single_counts[v], path_kernels,
                   jkmh, limit)
    held = [k for k in path_kernels if k != "extract_slabs" or name == "batch"]
    over = {k: (launches[k], most[k]) for k in held if launches[k] > BATCH_LAUNCH_RATIO * most[k]}
    if over:
        raise AssertionError(f"multivideo {name}: batch launches above {BATCH_LAUNCH_RATIO} x "
                             f"the largest single run's (batch, single): {over}")
    same = (np.array_equal(res[0].track_px, single[0].track_px, equal_nan=True)
            and np.array_equal(res[0].valid, single[0].valid))
    print(f"multivideo {name}: lane 0's track history bit-equal to the single run's: {same}")
    if name == "batch_fast":
        _sample_patches_lanes(dev)
    if not same:
        raise AssertionError(f"multivideo {name}: lane 0's tracks differ from the single "
                             f"scan runner's")
    return launches, warm, warm_counts


def _sample_patches_lanes(dev):
    """Whether ``interp.sample_patches`` over SLAB_LANES x N_POINTS patches
    (one cuBLAS bmm, as the fast batch runs it) gives each lane's per-lane
    call, at the fast engine's shapes (P 34 -> win 15 linear, P 70 -> win
    51 cubic): where it does not, the fast batch's lanes may leave their
    single runs' bits; printed."""
    from velocity_tpu_torch.ops.interp import sample_patches

    g = torch.Generator(device=dev).manual_seed(11)
    n = N_POINTS
    for P, win, cubic in ((34, 15, False), (70, 51, True)):
        patches = torch.rand((SLAB_LANES * n, P, P), generator=g, device=dev) * 255
        dy, dx = (torch.rand(SLAB_LANES * n, generator=g, device=dev) * (P - win) for _ in "yx")
        got = sample_patches(patches, dy, dx, win, cubic=cubic)
        want = torch.cat([sample_patches(patches[v * n:(v + 1) * n], dy[v * n:(v + 1) * n],
                                         dx[v * n:(v + 1) * n], win, cubic=cubic)
                          for v in range(SLAB_LANES)])
        print(f"multivideo: sample_patches P {P} -> {win} over {SLAB_LANES} x {n} patches "
              f"bit-equal to per-lane calls: {torch.equal(got, want)}, max |diff| "
              f"{float((got - want).abs().max()):.3e}")


def _gather_lanes(dev, lanes):
    """The gather LK engine (``ops/lk.py:lk_forward_backward``) on the card,
    its first run there: the first two lanes' frames 0 -> 1 stacked, N_POINTS
    features per lane at GATHER_LK, without a warp and with each clip's
    motion as one warp per lane; bit-equal to per-lane calls."""
    from velocity_tpu_torch.config import PipelineConfig
    from velocity_tpu_torch.ops.lk import lk_forward_backward
    from velocity_tpu_torch.pipeline.speedest import _init_features

    pcfg = PipelineConfig()
    two = lanes[:2]
    frames = [torch.as_tensor(c.reader.grays[:2]).to(dev) for c in two]
    src = torch.stack([f[0] for f in frames]).float()
    dst = torch.stack([f[1] for f in frames]).float()
    pts = torch.stack([torch.as_tensor(_init_features(pcfg, f[0], c.annotation.q
                                                      * pcfg.native_scale)[0], device=dev)
                       for f, c in zip(frames, two)])
    warp = torch.stack([torch.as_tensor(c.motion_affine(0, 1), dtype=torch.float32, device=dev)
                        for c in two])
    n = pts.shape[1]
    for form, M in (("no warp", None), ("one warp per lane", warp)):
        t = time.perf_counter()
        got = lk_forward_backward(src, dst, pts.reshape(-1, 2), warp_dst=M, **GATHER_LK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        same = True
        for v in range(len(two)):
            one = lk_forward_backward(src[v], dst[v], pts[v], **GATHER_LK,
                                      warp_dst=None if M is None else M[v])
            same &= (torch.equal(got.points[v * n:(v + 1) * n], one.points)
                     and torch.equal(got.status[v * n:(v + 1) * n], one.status))
        print(f"multivideo: gather LK engine, {len(two)} lanes x {n} points, 1080p, {form}: "
              f"bit-equal to per-lane calls: {same}, {int(got.status.sum())} tracked, "
              f"{wall:.3f} s")
        if not same:
            raise AssertionError(f"gather LK engine ({form}): lanes differ from per-lane calls")


def phase_multivideo(dev, clip):
    """run_batch over the three clips of render_lanes (lane 0 is ``clip``)
    beside the three single scan-runner runs (``_batch_and_singles``), with
    the lanes LK engine and then with the fast one (K3 on the frame stack);
    between the two, run_batch with shard_features=2 (in-process shards on
    the card) over segment A, bit-equal lane by lane to the lanes batch's
    warm-up over the same frames, its K1 and K2 launches beside the
    warm-up's; then the gather engine on two lanes (``_gather_lanes``).
    Returns the launches of each counted batch by path."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
    from velocity_tpu_torch.pipeline.multivideo import run_batch
    from velocity_tpu_torch.testing.synthetic_clip import render_lanes

    t0 = time.perf_counter()
    lanes = render_lanes(clip)
    print(f"multivideo: lanes 1..{len(lanes) - 1} rendered in {time.perf_counter() - t0:.1f} s, "
          f"true speeds {[round(c.speed_kmh, 4) for c in lanes]} km/h")
    solver = SolverConfig(dtype="float32")
    cfg = PipelineConfig(solver=solver)
    launches, warm, warm_counts = _batch_and_singles(dev, "batch", lanes, cfg,
                                                     ("lk_block", "extract_slabs"))

    scfg = PipelineConfig(solver=solver, tracker=TrackerConfig(shard_features=2))
    segments = []
    undo = _recording_segments(segments)
    try:
        _reset_counts()
        t = time.perf_counter()
        sharded = run_batch([c.reader for c in lanes], annotations=[c.annotation for c in lanes],
                            n_frames=cfg.msv_frame, config=scfg, device=dev, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        sharded_counts, _ = _read_counts()
    finally:
        undo()
    same = all(np.array_equal(g.track_px, w.track_px, equal_nan=True)
               and np.array_equal(g.valid, w.valid) for g, w in zip(sharded, warm))
    print(f"multivideo: run_batch shard_features=2 of frames 0..{cfg.msv_frame - 1}: "
          f"{wall:.3f} s, segment calls (lanes each) {segments}, launches K1 "
          f"{sharded_counts['lk_block']} K2 {sharded_counts['extract_slabs']} (unsharded "
          f"warm-up K1 {warm_counts['lk_block']} K2 {warm_counts['extract_slabs']}); tracks "
          f"and validity bit-equal to the unsharded batch, lane by lane: {same}")
    if not same or segments != [len(lanes)]:
        raise AssertionError(f"multivideo: the sharded batch differs from the unsharded one "
                             f"({same}) or was not one call of all lanes ({segments})")

    fcfg = PipelineConfig(solver=solver, tracker=TrackerConfig(lk_backend="fast"))
    fast, _, _ = _batch_and_singles(dev, "batch_fast", lanes, fcfg,
                                    ("extract_patches", "extract_slabs"))
    _gather_lanes(dev, lanes)
    return {"multivideo": launches, "multivideo_sharded": sharded_counts,
            "multivideo_fast": fast}


def _rel(a, b) -> float:
    """max |a - b| / max |b| of two tensors, on the CPU in f64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _par_mesh(dev, **sizes):
    """An in-process mesh of ``sizes`` whose every shard runs on ``dev``."""
    from velocity_tpu_torch.parallel import make_mesh

    return make_mesh(sizes, devices=[dev] * int(np.prod(list(sizes.values()))))


def _windowed_scene(dtype, dev):
    """PAR_WINDOWS windows of ``_ba_scene`` (window w from seed w), stacked
    as windowed_ba takes them, and their intrinsics."""
    probs = [_ba_scene(PAR_CAMERAS, BA_TRACKS, dtype, dev, seed=w) for w in range(PAR_WINDOWS)]
    return (tuple(torch.stack([getattr(p, f) for p in probs])
                  for f in ("pixels", "mask", "points0", "cams0")), probs[0].intr)


def phase_parallel(dev, clip):
    """The sharded paths on the one card with the in-process back end, at
    axis sizes 1 and 2: ba_schur_sharded against ba_schur at BA_CAMERAS x
    BA_TRACKS (f64 to 1e-8 with equal iterations, f32 to BA_RTOL in the
    scale gauge); windowed_ba at PAR_WINDOWS x PAR_CAMERAS x BA_TRACKS with
    fix_rotations and pin_tracks=4 (the pinned plate lanes fix the gauge),
    point axis 2 and window axis 2 against 1 (f64 to 1e-8, equal
    iterations), each layout against the same call on the CPU in f64, and
    its time beside a Python loop of ba_schur over the same windows;
    lk_forward_backward_sharded at N 1024 on the clip's first frame pair in
    its stage-2 and stage-3 forms, 2 shards against 1, bit-equal, its K1
    and K2 launches counted. Returns the sharded LK's launches."""
    from velocity_tpu_torch.config import BAConfig, PipelineConfig
    from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes
    from velocity_tpu_torch.parallel import ba_schur_sharded, windowed_ba
    from velocity_tpu_torch.parallel.track_shard import lk_forward_backward_sharded
    from velocity_tpu_torch.pipeline.speedest import _init_features
    from velocity_tpu_torch.solvers.schur import ba_schur

    cfg = BAConfig(max_iters=10)
    for dtype_name in ("float64", "float32"):
        prob = _ba_scene(BA_CAMERAS, BA_TRACKS, getattr(torch, dtype_name), dev)
        want = ba_schur(prob, cfg)
        for shards in (1, 2):
            got = ba_schur_sharded(prob, _par_mesh(dev, point=shards), "point", cfg)
            gauge = float(want.cams[-1, 0:3].norm() / got.cams[-1, 0:3].norm())
            cams = torch.cat([got.cams[:, 0:3] * gauge, got.cams[:, 3:6]], dim=1)
            errs = (_rel(got.points * gauge, want.points), _rel(cams, want.cams))
            rtol = BA_RTOL[dtype_name]
            print(f"parallel: ba_schur_sharded {dtype_name} {BA_CAMERAS} x {BA_TRACKS}, "
                  f"point axis {shards}: {got.iterations} iterations (ba_schur "
                  f"{want.iterations}), points {errs[0]:.2e} cams {errs[1]:.2e} from ba_schur "
                  f"on the card (limit {rtol:g}) at scale gauge 1{gauge - 1:+.2e}")
            if max(errs) > rtol or abs(gauge - 1) > 10 * rtol or (
                    dtype_name == "float64" and got.iterations != want.iterations):
                raise AssertionError(f"ba_schur_sharded {dtype_name} x{shards}: {errs}, gauge "
                                     f"{gauge}, {got.iterations} vs {want.iterations} iterations")

    kw = dict(config=cfg, fix_rotations=True, pin_tracks=4)
    (cpu_arrays, cpu_intr) = _windowed_scene(torch.float64, "cpu")
    t0 = time.perf_counter()
    ref = windowed_ba(*cpu_arrays, cpu_intr, _par_mesh("cpu", window=1, point=1), **kw)
    print(f"parallel: windowed_ba CPU f64 reference {PAR_WINDOWS} x {PAR_CAMERAS} x {BA_TRACKS}: "
          f"{time.perf_counter() - t0:.2f} s, iterations {ref[2].tolist()}")
    layouts = ({"window": 1, "point": 1}, {"window": 1, "point": 2}, {"window": 2, "point": 1})
    for dtype_name in ("float64", "float32"):
        arrays, intr = _windowed_scene(getattr(torch, dtype_name), dev)
        rtol = BA_RTOL[dtype_name]
        base = None
        for layout in layouts:
            got = windowed_ba(*arrays, intr, _par_mesh(dev, **layout), **kw)
            errs = (_rel(got[0], ref[0]), _rel(got[1], ref[1]))
            vs_base = ("" if base is None else
                       f"; against window 1 x point 1 on the card points "
                       f"{_rel(got[0], base[0]):.2e} cams {_rel(got[1], base[1]):.2e}")
            print(f"parallel: windowed_ba {dtype_name} window {layout['window']} x point "
                  f"{layout['point']}: iterations {got[2].tolist()}, against the CPU f64 call "
                  f"points {errs[0]:.2e} cams {errs[1]:.2e} (limit {rtol:g}){vs_base}")
            if max(errs) > rtol:
                raise AssertionError(f"windowed_ba {dtype_name} {layout}: {errs} above {rtol}")
            if dtype_name == "float64" and not torch.equal(got[2].cpu(), ref[2]):
                raise AssertionError(f"windowed_ba {layout}: iterations {got[2].tolist()}, "
                                     f"CPU {ref[2].tolist()}")
            if base is not None and dtype_name == "float64" and max(
                    _rel(got[0], base[0]), _rel(got[1], base[1])) > BA_RTOL["float64"]:
                raise AssertionError(f"windowed_ba {layout} differs from window 1 x point 1")
            base = got if base is None else base
        mesh = _par_mesh(dev, window=1, point=1)
        batched_ms = _events_ms(lambda: windowed_ba(*arrays, intr, mesh, **kw))
        probs = [_ba_scene(PAR_CAMERAS, BA_TRACKS, getattr(torch, dtype_name), dev, seed=w)
                 for w in range(PAR_WINDOWS)]
        loop_iters = [ba_schur(p, cfg, fix_rotations=True).iterations for p in probs]
        loop_ms = _events_ms(lambda: [ba_schur(p, cfg, fix_rotations=True) for p in probs])
        n_it = int(base[2].max())
        print(f"parallel: windowed_ba {dtype_name} batched, window 1 x point 1: "
              f"{batched_ms:.3f} ms = {batched_ms / n_it:.3f} ms per batched iteration "
              f"({n_it}); a Python loop of ba_schur (fix_rotations) over the same windows "
              f"{loop_ms:.3f} ms = {loop_ms / sum(loop_iters):.3f} ms per window iteration "
              f"({loop_iters}); batched / loop {batched_ms / loop_ms:.3f}")

    pcfg = PipelineConfig()
    frames = torch.as_tensor(clip.reader.grays[:2]).to(dev)
    pts = torch.as_tensor(_init_features(pcfg, frames[0], clip.annotation.q * pcfg.native_scale)[0],
                          device=dev)
    im0, im1 = frames[0].float(), frames[1].float()
    M = torch.as_tensor(clip.motion_affine(0, 1), dtype=torch.float32, device=dev)
    lk1, lk3 = pcfg.tracker.lk_coarse, pcfg.tracker.lk_fine
    forms = {"stage 2": dict(fb_threshold=1.0, win=lk1.window, max_level=lk1.max_level,
                             iters=lk1.max_iters, eps=lk1.eps),
             "stage 3": dict(fb_threshold=0.3, warp_dst=M, win=lk3.window,
                             max_level=lk3.max_level, iters=lk3.max_iters, eps=lk3.eps)}
    total = {}
    for form, lk_kw in forms.items():
        _reset_counts()
        single = lk_forward_backward_lanes(im0, im1, pts, **lk_kw)
        one, _ = _read_counts()
        _reset_counts()
        got = lk_forward_backward_sharded(im0, im1, pts, _par_mesh(dev, feature=2), "feature",
                                          **lk_kw)
        torch.cuda.synchronize()
        launches, _ = _read_counts()
        same = torch.equal(got.points, single.points) and torch.equal(got.status, single.status)
        print(f"parallel: lk_forward_backward_sharded {form}, N {pts.shape[0]}, 2 shards: "
              f"bit-equal to the single call: {same}, {int(got.status.sum())} tracked; "
              f"launches K1 {launches['lk_block']} K2 {launches['extract_slabs']} (the single "
              f"call K1 {one['lk_block']} K2 {one['extract_slabs']})")
        if not same:
            raise AssertionError(f"sharded LK ({form}) differs from the single call")
        if launches["lk_block"] <= 0 or launches["extract_slabs"] <= 0:
            raise AssertionError(f"sharded LK ({form}) did not launch K1 and K2: {launches}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total


def phase_longvideo(dev):
    """LongVideoRunner on the seed-0 clip rendered to LONG_FRAMES frames
    (1920x1080, default widths, f32 solver, lanes, msv_frame 5;
    window 16, overlap 3, BA refinement): a cold run, then the warm run
    with the counts, its speed against the truth and JAX's CPU value, its
    residual, windows, BA windows accepted and their iterations, frames
    replenished, lanes promoted and refreshed, decode time and decode wait;
    then, without BA refinement, a run cut at LONG_CUT frames with a
    checkpoint and resumed against the uninterrupted run, and a run whose
    second segment fails once against the warm run."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig
    from velocity_tpu_torch.pipeline import longvideo as lv
    from velocity_tpu_torch.testing.synthetic_clip import LONG_FRAMES, LONG_RUN, render_clip

    t0 = time.perf_counter()
    clip = render_clip(n_frames=LONG_FRAMES, width=1920, height=1080, seed=0)
    print(f"longvideo: {LONG_FRAMES} x 1080x1920 rendered in {time.perf_counter() - t0:.1f} s, "
          f"true speed {clip.speed_kmh:.3f} km/h; run {LONG_RUN}")
    runner = lv.LongVideoRunner(PipelineConfig(solver=SolverConfig(dtype="float32")),
                                device=dev)
    kw = dict(annotation=clip.annotation, verbose=False, **LONG_RUN)
    t0 = time.perf_counter()
    runner.run(clip.reader, **kw)
    print(f"longvideo cold run: {time.perf_counter() - t0:.2f} s")
    _reset_counts()
    res = runner.run(clip.reader, **kw)
    launches, by_shape = _read_counts()
    tm = res.timings
    live = res.S[:, 2].astype(int)
    print(f"longvideo warm run: wall {tm['wall_s']:.3f} s, {LONG_FRAMES / tm['wall_s']:.3f} "
          f"frames/s, decode thread {tm['decode_s']:.3f} s, tracker waited on decode "
          f"{tm['decode_wait_s']:.3f} s; speed {res.speed_kmh:.4f} km/h (true "
          f"{clip.speed_kmh:.4f}, JAX CPU {JAX_CPU_LONGVIDEO_KMH}), residual "
          f"{res.residual_px:.4f} px (JAX CPU {JAX_CPU_LONGVIDEO_RESIDUAL_PX}); windows "
          f"{tm['windows']}, BA windows accepted {tm['ba_accepted']} of {tm['ba_windows']} "
          f"(iterations {tm['ba_iterations']}); frames replenished "
          f"{tm['replenished_frames']} ({tm['replenished_lanes']} lanes), lanes promoted "
          f"{tm['promoted']}, refreshed {tm['refreshed']}; live lanes min {live.min()} "
          f"(replenishment below {runner.config.tracker.max_features // 2}), per row "
          f"{live.tolist()}; launches K1 {launches['lk_block']} K2 "
          f"{launches['extract_slabs']} {by_shape['lk_block']} {by_shape['extract_slabs']}")
    limit = (MAX_RESIDUAL_PX if JAX_CPU_LONGVIDEO_RESIDUAL_PX <= MAX_RESIDUAL_PX
             else JAX_CPU_LONGVIDEO_RESIDUAL_PX + BATCH_RESIDUAL_VS_JAX_PX)
    _check_run("longvideo", res, clip, launches, ("lk_block", "extract_slabs"),
               JAX_CPU_LONGVIDEO_KMH, limit)

    def against(label, other, want):
        err = float(np.abs(other.B[:, 0:3] - want.B[:, 0:3]).max())
        dkmh = other.speed_kmh - want.speed_kmh
        print(f"longvideo {label}: speed {other.speed_kmh:.4f} km/h, max trajectory "
              f"difference {err:.3e} m (limit {RESUME_TOL_M}), speed {dkmh:+.3e} km/h (limit "
              f"{RESUME_TOL_KMH}), retries {other.timings['retries']}")
        if not (err <= RESUME_TOL_M and abs(dkmh) < RESUME_TOL_KMH):
            raise AssertionError(f"longvideo {label}: {err} m, {dkmh} km/h")

    # resume, without BA refinement as JAX's test: a resumed run's refinement
    # windows are its segments, which the cut splits
    ck = ROOT / "build" / "longvideo_state.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    ck.unlink(missing_ok=True)
    no_ba = dict(kw, ba_refine=False)
    whole = runner.run(clip.reader, **no_ba)
    runner.run(clip.reader, n_frames=LONG_CUT, checkpoint=ck, **no_ba)
    against(f"without BA refinement, resumed at row {LONG_CUT - 1}",
            runner.run(clip.reader, checkpoint=ck, resume=True, **no_ba), whole)
    ck.unlink()

    real, calls = lv.scan_segment, []

    def flaky(*args, **kwargs):
        calls.append(len(args[0]))
        if len(calls) == 2:
            raise RuntimeError("injected transient device failure")
        return real(*args, **kwargs)

    lv.scan_segment = flaky
    try:
        retried = runner.run(clip.reader, **kw)
    finally:
        lv.scan_segment = real
    against(f"with its second segment failed once (segment rows {calls})", retried, res)
    if retried.timings["retries"] != 1:
        raise AssertionError(f"longvideo: {retried.timings['retries']} retries, not 1")
    return launches


def _run_command(argv, clip):
    """Parse ``argv`` with the port's CLI parser, put the clip's reader and
    annotation in ``args.video`` and ``args.annotation``, run the command
    with its standard output captured; returns (args, the JSON object of
    its last line, wall seconds)."""
    import io

    from velocity_tpu_torch import cli

    args = cli.build_parser().parse_args(argv)
    args.video, args.annotation = clip.reader, clip.annotation
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = args.fn(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv[0]}: exit code {rc}")
    return args, json.loads(out.getvalue().strip().splitlines()[-1]), wall


def phase_cli(dev, clip):
    """The command-line surface and the entry-point twin on the card:
    ``speed`` (with ``--plot`` where matplotlib exists) and ``longvideo``
    (window 16, overlap 3, polyfit degree 3) parsed by ``build_parser`` and
    run by their ``cmd_*`` on the clip's reader, each held bit for bit to
    the library call (``SpeedEstimator.run``, ``LongVideoRunner.run``) of
    the same clip and config read in the same call, walls beside each other;
    ``graft_entry_torch.entry()`` run once (K1 and K2 launched, outputs
    finite); ``dryrun_multichip(4)`` (a 2 x 2 mesh of in-process shards on
    the card) against the same call on a 1 x 1 mesh, within DRYRUN_RTOL;
    ``native_loader.available()``. Returns {path: launches} for the
    commands ("cli") and ``entry()`` ("entry")."""
    import importlib.util

    import graft_entry_torch
    from velocity_tpu_torch import cli
    from velocity_tpu_torch.config import BAConfig
    from velocity_tpu_torch.ingest import native_loader
    from velocity_tpu_torch.parallel import make_mesh, windowed_ba
    from velocity_tpu_torch.pipeline.longvideo import LongVideoRunner
    from velocity_tpu_torch.pipeline.speedest import SpeedEstimator

    report = ROOT / "build" / "cli_report.html"
    argv = ["speed", "--video", "clip.MOV", "--frames", str(N_FRAMES), "--json", "--quiet"]
    if importlib.util.find_spec("matplotlib") is None:
        print("cli: matplotlib is absent on this machine; speed runs without --plot")
    else:
        report.parent.mkdir(parents=True, exist_ok=True)
        argv += ["--plot", str(report)]
    before = _replays()
    _reset_counts()
    args, got, cli_wall = _run_command(argv, clip)
    speed_counts, _ = _read_counts()
    print(_graphs_line("cli speed", before))
    t0 = time.perf_counter()
    res = SpeedEstimator(cli._pipeline_config(args), device=dev).run(
        clip.reader, annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    torch.cuda.synchronize()
    lib_wall = time.perf_counter() - t0
    plotted = report.exists()
    report.unlink(missing_ok=True)
    same = (got["speed_kmh"] == res.speed_kmh and got["residual_px"] == res.residual_px
            and got["speed_std"] == res.speed_std)
    print(f"cli speed: {got['speed_kmh']!r} km/h, residual {got['residual_px']!r} px; "
          f"SpeedEstimator.run {res.speed_kmh!r} km/h, {res.residual_px!r} px; bit-equal "
          f"{same}; HTML report written {plotted}; wall cli {cli_wall:.3f} s (report "
          f"included), library {lib_wall:.3f} s; launches K1 {speed_counts['lk_block']} K2 "
          f"{speed_counts['extract_slabs']}")
    if not same:
        raise AssertionError(f"cli speed {got} differs from SpeedEstimator.run")
    _check_run("cli speed", res, clip, speed_counts, ("lk_block", "extract_slabs"),
               JAX_CPU_SPEED_KMH["driver"])

    argv = ["longvideo", "--video", "clip.MOV", "--frames", str(N_FRAMES), "--window", "16",
            "--overlap", "3", "--smooth", "3", "--json", "--quiet"]
    _reset_counts()
    args, got, cli_wall = _run_command(argv, clip)
    long_counts, _ = _read_counts()
    t0 = time.perf_counter()
    res = LongVideoRunner(cli._pipeline_config(args), device=dev).run(
        clip.reader, annotation=clip.annotation, n_frames=N_FRAMES, window=16, overlap=3,
        verbose=False)
    torch.cuda.synchronize()
    lib_wall = time.perf_counter() - t0
    want = {"speed_kmh": res.speed_kmh, "speed_std": res.speed_std,
            "residual_px": res.residual_px, "windows": res.timings["windows"],
            "ba_refined": res.timings["ba_refined"],
            "speed_kmh_polyfit": float(np.nanmean(res.smoothed(3)[1][1:]))}
    same = all(got[k] == v for k, v in want.items())
    print(f"cli longvideo: {json.dumps({k: got[k] for k in want})}; LongVideoRunner.run "
          f"equal {same}; wall cli {cli_wall:.3f} s, library {lib_wall:.3f} s; launches K1 "
          f"{long_counts['lk_block']} K2 {long_counts['extract_slabs']}")
    if not same:
        raise AssertionError(f"cli longvideo {got} differs from LongVideoRunner.run {want}")
    _check_run("cli longvideo", res, clip, long_counts, ("lk_block", "extract_slabs"), None)

    fn, example = graft_entry_torch.entry()
    fn(*example)  # warm
    fn, example = graft_entry_torch.entry()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn(*example)
    torch.cuda.synchronize()
    entry_wall = time.perf_counter() - t0
    entry_counts, _ = _read_counts()
    finite = all(bool(torch.isfinite(o).all()) for o in out if o.is_floating_point())
    print(f"entry: fused_frame_step at 1024 lanes on a 512x1024 pair, {entry_wall * 1e3:.1f} ms "
          f"warm; outputs {[tuple(o.shape) for o in out]}, finite {finite}; launches K1 "
          f"{entry_counts['lk_block']} K2 {entry_counts['extract_slabs']}")
    if not finite or entry_counts["lk_block"] <= 0 or entry_counts["extract_slabs"] <= 0:
        raise AssertionError(f"entry(): finite {finite}, launches {entry_counts}")

    t0 = time.perf_counter()
    points, cams, iters = graft_entry_torch.dryrun_multichip(4)
    torch.cuda.synchronize()
    dry_wall = time.perf_counter() - t0
    _, ba_args = graft_entry_torch.multichip_problem(4)
    ref = windowed_ba(*ba_args, make_mesh({"window": 1, "point": 1}, devices=[dev]),
                      config=BAConfig(max_iters=3))
    errs = (_rel(points, ref[0]), _rel(cams, ref[1]))
    print(f"dryrun_multichip(4): window 2 x point 2 in process on {dev}, {dry_wall:.3f} s, "
          f"iterations {iters.tolist()} (1 x 1 mesh {ref[2].tolist()}); against the 1 x 1 "
          f"mesh points {errs[0]:.2e} cams {errs[1]:.2e} (limit {DRYRUN_RTOL:g})")
    if max(errs) > DRYRUN_RTOL or not torch.equal(iters.cpu(), ref[2].cpu()):
        raise AssertionError(f"dryrun_multichip(4) differs from the 1 x 1 mesh: {errs}")
    print(f"cli: native_loader.available() = {native_loader.available()}")
    return {"cli": {k: speed_counts[k] + long_counts[k] for k in speed_counts},
            "entry": entry_counts}


def phase_bench(dev, clip):
    """The port's bench entry on the clip: ``bench_torch.run_bench`` in
    ``scan`` and ``frames`` modes (warm-up and ``BENCH_REPS`` timed lean
    runs each; every JSON line printed), each held to the truth and the JAX
    CPU value of its path, with K1 and K2 launched; then the scan runner
    lean and full in turns (lean, full, full, lean: walls beside each
    other), the lean trajectory bit-equal to the full one; then
    ``bench_ba_torch.py`` written to a temporary directory, its rows
    printed, each value finite. Returns the scan mode's launches."""
    import tempfile

    import bench_ba_torch
    import bench_torch
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    counts, results = {}, {}
    for mode, jax_kmh in (("scan", JAX_CPU_SPEED_KMH["lanes"]),
                          ("frames", JAX_CPU_SPEED_KMH["driver"])):
        before = _replays()
        _reset_counts()
        out, res = bench_torch.run_bench(clip.reader, clip.annotation, n_frames=N_FRAMES,
                                         reps=BENCH_REPS, mode=mode, device=dev,
                                         clip="synthetic", reference_kmh=clip.speed_kmh)
        counts[mode], _ = _read_counts()
        print(_graphs_line(f"bench {mode}", before))
        results[mode] = res
        print(json.dumps(out))
        print(f"bench {mode}: {out['value']:.3f} frames/s, launches over the warm-up and "
              f"{BENCH_REPS} timed runs K1 {counts[mode]['lk_block']} K2 "
              f"{counts[mode]['extract_slabs']}")
        _check_run(f"bench {mode}", res, clip, counts[mode], ("lk_block", "extract_slabs"),
                   jax_kmh)

    runner = ScanSpeedRunner(bench_torch.bench_config(), device=dev)
    walls, runs = {True: [], False: []}, {}
    for lean in (True, False, False, True):
        runs[lean] = runner.run(clip.reader, annotation=clip.annotation, n_frames=N_FRAMES,
                                verbose=False, lean=lean)
        walls[lean].append(runs[lean].timings["wall_s"])
    same = [np.array_equal(r.B[:, 0:6], runs[False].B[:, 0:6])
            for r in (runs[True], results["scan"])]
    print(f"bench lean / full scan runs in turns: lean {walls[True][0]:.3f} and "
          f"{walls[True][1]:.3f} s, full {walls[False][0]:.3f} and {walls[False][1]:.3f} s "
          f"({N_FRAMES} frames); B[:, 0:6] of the lean run and of the bench's last run "
          f"bit-equal to the full run's: {same}")
    if not all(same):
        raise AssertionError("a lean scan run's trajectory differs from the full run's")

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = Path(d) / "bench_ba.json"
        rc = bench_ba_torch.main(["--out", str(path), "--device", str(dev)])
        rows = json.loads(path.read_text())["rows"]
    print(f"bench_ba_torch: exit code {rc}, {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s")
    bad = [r["metric"] for r in rows if not (isinstance(r.get("value"), (int, float))
                                             and np.isfinite(r["value"]))]
    if rc != 0 or bad:
        raise AssertionError(f"bench_ba_torch: exit code {rc}, rows without a finite value "
                             f"{bad}")
    return counts["scan"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import velocity_tpu_torch  # noqa: F401  (fails where the package is absent)
    from velocity_tpu_torch.testing.synthetic_clip import render_clip

    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    k2_rows = phase_k2(dev)
    k3_rows = phase_k3(dev)
    k1_rows = phase_k1(dev)

    t0 = time.perf_counter()
    clip = render_clip(n_frames=N_FRAMES, width=1920, height=1080, seed=0)
    print(f"clip: {N_FRAMES} x 1080x1920 rendered in {time.perf_counter() - t0:.1f} s, "
          f"true speed {clip.speed_kmh:.3f} km/h")
    k4_rows = phase_k4(dev, clip)
    k5_rows = phase_k5(dev, clip)
    k6_rows = phase_k6(dev, clip)
    rows = {"lk_block": k1_rows, "extract_slabs": k2_rows, "extract_patches": k3_rows,
            "extract_warped": k5_rows, "source_window": k6_rows}
    lanes = phase_slice(dev, clip, "lanes", ("lk_block", "extract_slabs", "corner_subpix",
                                             "extract_warped", "source_window"), rows)
    fast = phase_slice(dev, clip, "fast", ("extract_patches", "extract_slabs", "corner_subpix"),
                       rows)
    phase_graph(dev, clip)
    drivers = phase_driver(dev, clip)
    phase_ba(dev, clip)
    phase_ba_solvers(dev)
    stills = phase_stills(dev)
    multivideo = phase_multivideo(dev, clip)
    sharded_lk = phase_parallel(dev, clip)
    longvideo = phase_longvideo(dev)
    surface = phase_cli(dev, clip)
    bench = phase_bench(dev, clip)

    k1_main = next(r for r in k1_rows if r.get("win") == 51 and r.get("cubic") and r.get("it0") == 0)
    k2_main = next(r for r in k2_rows if r["size"] == 64)
    k3_main = next(r for r in k3_rows if r["size"] == 82)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    paths = {"lanes": lanes, "fast": fast, **drivers, "stills": stills, **multivideo,
             "sharded_lk": sharded_lk, "longvideo": longvideo,
             **surface, "bench": bench}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    # launches: this slice's main path (the bench, scan mode: its warm-up and
    # BENCH_REPS timed runs) for K1 and K2; K3 runs only on the fast path
    kernels = [
        {"name": "lk_block", "route": "cuda", "source": "velocity_tpu_torch/csrc/lk_block.cu",
         "replaces": "velocity_tpu/ops/lk_block_pallas.py:207",
         "launches": bench["lk_block"], "launches_by_path": by_path("lk_block"),
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         **{k: k1_main[k] for k in keys}, "library_ms": None},
        {"name": "extract_slabs", "route": "cuda", "source": "velocity_tpu_torch/csrc/slab.cu",
         "replaces": "velocity_tpu/ops/slab_pallas.py:107",
         "launches": bench["extract_slabs"], "launches_by_path": by_path("extract_slabs"),
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         **{k: k2_main[k] for k in keys}, "library_ms": k2_main["library_ms"],
         "batched": [{k: r[k] for k in ("lanes", "size", "N", "ms", "lanes_2d_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")}
                     for r in k2_rows if "lanes" in r]},
        {"name": "extract_patches", "route": "cuda",
         "source": "velocity_tpu_torch/csrc/patch.cu",
         "replaces": "velocity_tpu/ops/patch_pallas.py:62",
         "launches": fast["extract_patches"], "launches_by_path": by_path("extract_patches"),
         "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
         **{k: k3_main[k] for k in keys}, "library_ms": k3_main["library_ms"],
         "batched": [{k: r[k] for k in ("lanes", "size", "N", "ms", "lanes_2d_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")}
                     for r in k3_rows if "lanes" in r]},
        {"name": "corner_subpix", "route": "cuda", "source": "velocity_tpu_torch/csrc/subpix.cu",
         "replaces": None, "launches": bench["corner_subpix"],
         "launches_by_path": by_path("corner_subpix"), "max_abs_err": k4_rows[0]["max_abs_err"],
         **{k: k4_rows[0][k] for k in keys}, "call_ms": k4_rows[0]["call_ms"],
         "library_ms": None},
        {"name": "extract_warped", "route": "cuda",
         "source": "velocity_tpu_torch/csrc/warp_window.cu", "replaces": None,
         "launches": bench["extract_warped"], "launches_by_path": by_path("extract_warped"),
         "max_abs_err": max(r["max_abs_err"] for r in k5_rows),
         **{k: k5_rows[0][k] for k in keys}, "library_ms": None,
         "shapes": [{k: r[k] for k in ("label", "N", "ms", "plain_ms", "bound_ms")}
                    for r in k5_rows]},
        {"name": "source_window", "route": "cuda",
         "source": "velocity_tpu_torch/csrc/source_window.cu", "replaces": None,
         "launches": bench["source_window"], "launches_by_path": by_path("source_window"),
         "max_abs_err": 0.0, "sum_err": max(r["sum_err"] for r in k6_rows),
         **{k: k6_rows[0][k] for k in keys}, "library_ms": None,
         "shapes": [{k: r[k] for k in ("label", "N", "ms", "call_ms", "plain_ms", "bound_ms",
                                       "near_gate")}
                    for r in k6_rows]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
