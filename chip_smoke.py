#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``velocity_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source; a K1 instantiation that spills fails),
holds each kernel against its plain PyTorch version at the shapes of the
main paths (K1 also at its edge cases and, with points up to and past the
image's edges, at every pyramid level of a 4032x3024 still; K2 and K3 with
corners past every side, K2 also on a still; each beside its launch floor,
the same call at size 1), then
drives the paths below on a 1920x1080, 20-frame synthetic clip with the default
widths (1024 features, 1024 RANSAC trials) and the f32 solver:

- ``ScanSpeedRunner.run`` with the default lanes LK engine (kernels K1 and
  K2) and with ``lk_backend="fast"`` (kernel K3, with K2 at init), each
  followed by a profiled warm run of the clip's first ``PROFILE_FRAMES``
  frames (device busy share, top kernels and the hand kernels', the share
  of each eager stencil in ``ANNOTATED``);
- phase ``driver``: ``SpeedEstimator.run``, the per-frame driver, beside the
  scan runner in turns, then with the feature-match rescue forced on every
  frame (``min_affine_inliers`` huge) through a matcher built from the
  clip's known motion (the card's machine has no cv2), directly and through
  the scan runner's own rescue;
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
- phase ``multivideo``: ``run_batch`` over three 1080p clips of 20 frames
  (``render_lanes``; lane 0 is the clip above), then the three single scan
  runner runs of the same clips: each lane and each single run against its
  truth and the JAX CPU lane, lane 0's track history and launches against
  its single run's, the batch's launches by lane, each MSV's
  iterations, and the batch's warm wall beside the single runs' summed
  walls, whole and less the host MSV;
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
  is retried, each held to the uninterrupted run.

It checks that each path went through its kernels (the counts are set to 0
just before a path's run and read just after) and recovered the clip's
speed, and prints each kernel's launches by shape with launches x (time -
bound). The ``kernels`` line gives K1's and K2's launches on the long-video
run and each kernel's launches on every counted path. Any failure exits
non-zero; there is no CPU fallback. The last line is a JSON object with
``"ok": true``.

Each kernel's bound is the larger of its bytes over the card's memory rate
and its f32 operations over the card's f32 rate (H100 SXM published peaks,
``PEAK_BYTES_PER_S`` and ``PEAK_F32_PER_S``), counted from this run's
inputs: a gather reads only the pixels its windows cover, once each; K1
reads the per-point tensors of the points still active on entry.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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
                     "batch": (39.996420154372416, 29.970769718057525, 49.89378033906219)}
# mean residuals (px) of JAX's run_batch lanes (the same runs). Lanes 1 and
# 2 are clips on which the MSV solve stops at its iteration cap, in both
# packages (phase multivideo prints the counts), and the structure it leaves
# puts lane 1 above MAX_RESIDUAL_PX in JAX too: every run of the phase, batch
# lane or single run, is held to JAX's residual on its lane within this margin
JAX_CPU_BATCH_RESIDUAL_PX = (0.06572684273123741, 1.3208546148318994, 0.9673360944970658)
BATCH_RESIDUAL_VS_JAX_PX = 0.1
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
SPEED_VS_TRUTH = 0.05
SPEED_VS_JAX = 0.02
MAX_RESIDUAL_PX = 1.0
N_POINTS = 1024
N_FRAMES = 20
PROFILE_FRAMES = 5  # the profiled runs: reading a 20-frame trace takes minutes
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
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
# (S, N) of every slab extraction on the lanes path: stages 1-2, stage-3
# source, stage-3 backward destination, warped slabs, corner_subpix
SLAB_SHAPES = ((24, 1024), (56, 1024), (64, 1024), (72, 1024), (27, 1020))
K1_CONFIGS = ((15, 24, 8, False), (51, 64, 10, True), (51, 64, 8, False))
K1_RTOL, K1_ATOL = 1e-5, 1e-4  # summation order and FMA contraction differ
# Functions (module of velocity_tpu_torch.ops, name) whose device time each
# path's profiled run reports: the eager PyTorch stencils that stand where
# JAX leaves the work to XLA (the warped slabs' K2 launch counts inside
# _extract_warped_lanes)
ANNOTATED = {"lanes": ("lk_lanes._extract_warped_lanes", "lk_lanes._sample_taps",
                       "lk_lanes._grad_xy"),
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


def cuda_ms(fn, calls: int = 10, rounds: int = 5) -> float:
    """Device milliseconds per ``fn()`` call: CUDA events around ``calls``
    back-to-back calls, median over ``rounds``. A spin kernel runs first so
    that the host queues the calls ahead of the device; where the host
    still cannot keep up (the plain versions launch hundreds of small
    kernels per call) the time includes their launch cost."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / calls)
    return statistics.median(per_call)


def bound(n_bytes: float, n_flops: float):
    """(least milliseconds, "bytes" or "operations") for the given work."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _window_index(x0, y0, size: int):
    """(rows (N, size, 1), cols (N, 1, size)) of windows at corners (x0, y0)."""
    ar = torch.arange(size, device=x0.device)
    return ((y0.long()[:, None] + ar)[:, :, None], (x0.long()[:, None] + ar)[:, None, :])


def _gather_bound(img, rows, cols, extra_bytes: int):
    """Bound of a window gather: the distinct pixels its windows cover, read
    once, plus every output word written once and ``extra_bytes``."""
    H, W = img.shape
    covered = torch.zeros(H * W, dtype=torch.bool, device=img.device)
    covered[(rows * W + cols).reshape(-1)] = True
    n_out = rows.shape[0] * rows.shape[1] * cols.shape[2]
    return bound(4 * (int(covered.sum()) + n_out) + extra_bytes, 0)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def _kernel_name(mangled: str) -> str:
    """``lk_block_point<cubic, cached>`` for the mangled name of a K1
    instantiation, ``gather_windows<128, 4, split>`` for the window gather
    of K2 and K3 (threads per block, words per thread and step, whether a
    thread's words may run into the next row); other kernels keep their
    mangled name."""
    if m := re.search(r"(lk_block_[a-z]+)I((?:Lb[01]E)+)E", mangled):
        flags = re.findall(r"Lb([01])E", m[2])
        args = ["cubic" if flags[0] == "1" else "linear"]
        args += ["cached" if f == "1" else "uncached" for f in flags[1:]]
        return f"{m[1]}<{', '.join(args)}>"
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
    compiled without spills, or if a window gather instantiation spills."""
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
    spilled = [r for r in rows if r[0].startswith("gather_windows") and (r[2] or r[3])]
    if spilled:
        raise AssertionError(f"window gather instantiations with spills: {spilled}")


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
    size, padded as the warped slabs pad it and as corner_subpix reads it
    (unpadded, corners reaching past the near sides too); corners past
    every side included: bit-equal."""
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
    still = torch.rand(STILLS_SIZE[::-1], generator=g, device=dev) * 255
    for label, im, lo in (("still padded by 72", _pad_edge(still, 72), 0),
                          ("unpadded still", still, None)):
        H, W = im.shape
        for S, N in SLAB_SHAPES:
            corners = _corners_with_outsiders(g, H, W, S, N, lo=-(S // 2) if lo is None else lo)
            _gather_check(f"K2 S={S} on the {label}", k2.extract_slabs, k2.extract_slabs_ref,
                          im, corners, S)
        print(f"K2 on the {label} ({H}x{W}), (S, N) {SLAB_SHAPES}: bit-equal, corners equal")
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
    return rows


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


def _k1_bound(win, P, n_taps, n_active):
    """K1's least time: the points active on entry read their slab and three
    windows; every point reads 12 and writes 5 f32 words. Operations per
    active point and iteration: the x-pass over win+n_taps-1 rows and the
    y-pass (one multiply-add per tap each) and the residual sums (5 per
    window pixel)."""
    from velocity_tpu_torch.ops.lk_block_pallas import BLOCK_ITERS

    n_bytes = 4 * (n_active * (P * P + 3 * win * win) + N_POINTS * (12 + 5))
    per_iter = 2 * n_taps * win * (win + n_taps - 1) + 2 * n_taps * win * win + 5 * win * win
    return bound(n_bytes, n_active * BLOCK_ITERS * per_iter)


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
            bound_ms, bound_by = _k1_bound(win, P, n_taps, n_active)
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


def _still_levels(dev):
    """(W, H) of every level of a still's two pyramids, largest first: the
    images whose size K1's in-bounds gate reads on the stills path."""
    from velocity_tpu_torch.config import TrackerConfig
    from velocity_tpu_torch.pipeline.tracker import frame_pyramids
    from velocity_tpu_torch.testing.synthetic_clip import STILLS_SIZE

    full, small = frame_pyramids(
        torch.zeros(STILLS_SIZE[::-1], dtype=torch.uint8, device=dev), TrackerConfig())
    return sorted({(lv.shape[1], lv.shape[0]) for lv in full + small}, reverse=True)


def _counters():
    from velocity_tpu_torch.ops import lk_block_pallas as k1
    from velocity_tpu_torch.ops import patch_pallas as k3
    from velocity_tpu_torch.ops import slab_pallas as k2

    return {"lk_block": k1.lk_block, "extract_slabs": k2.extract_slabs,
            "extract_patches": k3.extract_patches}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        fn.launches_by_shape.clear()


def _read_counts():
    """({kernel: launches}, {kernel: {shape: launches}}) since the last reset."""
    counters = _counters()
    return ({name: fn.launches for name, fn in counters.items()},
            {name: dict(fn.launches_by_shape) for name, fn in counters.items()})


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


def _profile(run, lk_backend):
    """One profiled warm run (of ``PROFILE_FRAMES`` frames): device busy
    share (union of device activity over the run's wall time), top kernels
    by device time (and the three hand kernels' wherever they rank), and the
    device time spent under each function of ``ANNOTATED[lk_backend]``."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    patched = []
    for path in ANNOTATED[lk_backend]:
        mod_name, attr = path.rsplit(".", 1)
        mod = importlib.import_module(f"velocity_tpu_torch.ops.{mod_name}")
        patched.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _annotated(attr, getattr(mod, attr)))
    names = {attr for _, attr, _ in patched}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)
    t0 = time.perf_counter()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.name not in names)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_kernel = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in names \
                and not getattr(e, "is_user_annotation", False):
            n, t = by_kernel.get(e.name, (0, 0.0))
            by_kernel[e.name] = (n + 1, t + e.time_range.elapsed_us())
    total_us = sum(t for _, t in by_kernel.values())
    shares = ""
    for name in sorted(names):
        us = sum(e.device_time_total for e in events
                 if e.name == name and e.device_type == DeviceType.CPU)
        shares += f"; {name} {us / 1e3:.1f} ms = {us / max(total_us, 1e-9):.1%} of kernel time"
    print(f"profile {lk_backend}, {PROFILE_FRAMES} frames: wall {wall:.3f} s (profiled), "
          f"device busy {busy / 1e6:.3f} s = {busy / 1e6 / wall:.1%}, kernel time "
          f"{total_us / 1e3:.1f} ms in {len(spans)} device activities{shares} (trace read "
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
    _check_run(lk_backend, res, clip, launches, path_kernels, jax_kmh)
    _profile(lambda: run(PROFILE_FRAMES), lk_backend)
    return launches


def phase_driver(dev, clip):
    """The per-frame driver on the full-size clip: beside the scan runner in
    turns (scan, driver, driver, scan; warm), its K1 and K2 launches, its
    speed within the limits; then with the rescue forced on every frame
    through the clip's known motion, directly and through the scan runner's
    rescue branch: every frame's T23 must be the matcher's."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
    from velocity_tpu_torch.pipeline import SpeedEstimator
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    solver = SolverConfig(dtype="float32")
    run_kw = dict(annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    scan = ScanSpeedRunner(PipelineConfig(solver=solver), device=dev)
    est = SpeedEstimator(PipelineConfig(solver=solver), device=dev)

    walls = {"scan": [], "driver": []}
    scan_res = scan.run(clip.reader, **run_kw)
    walls["scan"].append(scan_res.timings["wall_s"])
    _reset_counts()
    res = est.run(clip.reader, **run_kw)
    launches, by_shape = _read_counts()
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
          f"{by_shape['lk_block']} {by_shape['extract_slabs']}")
    _check_run("driver", res, clip, launches, ("lk_block", "extract_slabs"),
               JAX_CPU_SPEED_KMH["driver"])
    if abs(res.speed_kmh - scan_res.speed_kmh) > 1e-3 * scan_res.speed_kmh:
        raise AssertionError(f"driver speed {res.speed_kmh} vs scan runner "
                             f"{scan_res.speed_kmh}: one generator order, no frame rescued")

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
    _reset_counts()
    fres = forced.run(clip.reader, **run_kw)
    flaunches, _ = _read_counts()
    if len(asked) != N_FRAMES - 1 or len(used) != N_FRAMES - 1 or not all(
            np.array_equal(a, u) for a, u in zip(asked, used)):
        raise AssertionError(f"forced rescue: {len(asked)} matcher calls, {len(used)} steps, "
                             "or a frame's T23 is not the matcher's")
    print(f"driver, rescue forced on {len(asked)} frames: wall {fres.timings['wall_s']:.3f} s, "
          f"{N_FRAMES / fres.timings['wall_s']:.3f} frames/s, speed {fres.speed_kmh:.4f} km/h, "
          f"residual {fres.residual_px:.4f} px, every T23 the matcher's; launches K1 "
          f"{flaunches['lk_block']} K2 {flaunches['extract_slabs']}")
    _check_run("forced rescue", fres, clip, flaunches, ("lk_block", "extract_slabs"), None)

    n_before = len(asked)
    sres = ScanSpeedRunner(forced_cfg, device=dev, fallback_matcher=matcher).run(
        clip.reader, **run_kw)
    if len(asked) - n_before != N_FRAMES - 1 or sres.first_gray is not None:
        raise AssertionError("the scan runner did not hand the collapsed clip to the driver")
    if not np.allclose(sres.B, fres.B, rtol=1e-6, atol=1e-9):
        raise AssertionError("the scan runner's rescue and the driver disagree")
    print(f"scan runner, rescue forced: re-ran through the driver, speed {sres.speed_kmh:.4f} "
          f"km/h, trajectory bit-equal to the driver's: {np.array_equal(sres.B, fres.B)}")


def _ba_scene(nc, nt, dtype, dev, seed=0):
    """The windowed BA problem: ``nc`` cameras on a 3.3 m line, ``nt`` points
    6-10 m away, 0.3 px of pixel noise, the structure and the camera track
    perturbed (5 cm, 3 cm, 5 mrad). Made on the host from ``seed``."""
    from velocity_tpu_torch.geometry.projection import Intrinsics
    from velocity_tpu_torch.solvers.ba import BAProblem

    rng = np.random.default_rng(seed)
    f, cx, cy = 1993.9, 960.5, 540.5
    pts = np.concatenate([rng.uniform(-2, 2, (nt, 2)), rng.uniform(6, 10, (nt, 1))], 1)
    pos = np.stack([np.linspace(0, 3.3, nc), np.zeros(nc), np.zeros(nc)], 1)
    pc = pts[None] + pos[:, None]
    pix = np.stack([f * pc[..., 0] / pc[..., 2] + cx, f * pc[..., 1] / pc[..., 2] + cy], -1)
    pix += rng.normal(0, 0.3, pix.shape)
    cams0 = np.concatenate([pos, np.zeros((nc, 3))], 1)
    cams0[1:, 0:3] += rng.normal(0, 0.03, (nc - 1, 3))
    cams0[1:, 3:6] += rng.normal(0, 0.005, (nc - 1, 3))
    pts0 = pts + rng.normal(0, 0.05, pts.shape)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return BAProblem(intr=Intrinsics(*(t(v) for v in (f, f, cx, cy, 0.0))), pixels=t(pix),
                     mask=torch.ones((nc, nt), dtype=torch.bool, device=dev),
                     points0=t(pts0), cams0=t(cams0))


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
    t0 = time.perf_counter()
    est.run(burst.stills(), annotation=burst.annotation, verbose=False)
    print(f"stills cold run: {time.perf_counter() - t0:.2f} s")
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


def phase_multivideo(dev, clip):
    """run_batch over the three clips of render_lanes (lane 0 is ``clip``),
    counted, then the three single scan-runner runs of the same clips,
    counted each: the walls in turns (batch, then singles), whole and less
    each run's host MSV (the batch's MSV, the single runs' re-anchor), and
    each MSV's iterations and residual. Each run within the speed limits and
    within BATCH_RESIDUAL_VS_JAX_PX of JAX's residual on its lane; lane 0's
    track history bit-equal to its single run's. The batch's launches are
    counted lane by lane (each lane's frame-0 init and its segments) and
    summed to the batch's count; lane 0, which draws from seed 0 as the
    single runs do, launches what its single run launches. Lanes v > 0 draw
    from seed v (JAX's run_batch draws lane v from PRNGKey(v)), so their
    RANSAC hypotheses, and with them a few LK blocks, differ from their
    single runs'."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig
    from velocity_tpu_torch.pipeline.multivideo import run_batch
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
    from velocity_tpu_torch.testing.synthetic_clip import render_lanes

    t0 = time.perf_counter()
    lanes = render_lanes(clip)
    print(f"multivideo: lanes 1..{len(lanes) - 1} rendered in {time.perf_counter() - t0:.1f} s, "
          f"true speeds {[round(c.speed_kmh, 4) for c in lanes]} km/h")
    cfg = PipelineConfig(solver=SolverConfig(dtype="float32"))
    runner = ScanSpeedRunner(cfg, device=dev)
    msv_batch, msv_single = [], []

    from velocity_tpu_torch.pipeline import multivideo

    per_lane = [dict.fromkeys(_counters(), 0) for _ in lanes]
    inits = []

    def counted(fn, lane_of):
        def wrapper(*args, **kwargs):
            before = _read_counts()[0]
            out = fn(*args, **kwargs)
            lane = per_lane[lane_of(args)]
            for k, n in _read_counts()[0].items():
                lane[k] += n - before[k]
            return out
        return wrapper

    undo = _recording_msv(msv_batch)
    real = multivideo.scan_segment, multivideo._init_features
    multivideo.scan_segment = counted(real[0], lambda a: a[9].initial_seed())
    def init_lane(args):  # run_batch initialises the lanes in order
        inits.append(args)
        return len(inits) - 1

    multivideo._init_features = counted(real[1], init_lane)
    try:
        _reset_counts()
        t = time.perf_counter()
        res = run_batch([c.reader for c in lanes], annotations=[c.annotation for c in lanes],
                        n_frames=N_FRAMES, config=cfg, device=dev, verbose=False)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t
        launches, _ = _read_counts()
    finally:
        undo()
        multivideo.scan_segment, multivideo._init_features = real
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
    summed = {k: sum(c[k] for c in per_lane) for k in launches}
    cap = cfg.solver.max_iters_msv
    print(f"multivideo: run_batch of {len(lanes)} lanes x {N_FRAMES} frames warm wall "
          f"{wall_b:.3f} s, of it host MSV {msv_b:.3f} s, the rest {wall_b - msv_b:.3f} s; the "
          f"three single scan-runner runs {wall_s:.3f} s, of it re-anchor {msv_s:.3f} s, the "
          f"rest {wall_s - msv_s:.3f} s (in turns: batch, then singles); launches K1 "
          f"{launches['lk_block']} K2 {launches['extract_slabs']}, by lane K1 "
          f"{[c['lk_block'] for c in per_lane]} K2 {[c['extract_slabs'] for c in per_lane]}; "
          f"the single runs' K1 {[c['lk_block'] for c in single_counts]} K2 "
          f"{[c['extract_slabs'] for c in single_counts]}")
    if len(msv_batch) != len(lanes) or len(msv_single) != len(lanes):
        raise AssertionError(f"multivideo: {len(msv_batch)} batch and {len(msv_single)} single "
                             f"MSV solves for {len(lanes)} lanes")
    for v, (r, c, s, jax_kmh, jax_res, mb, ms) in enumerate(zip(
            res, lanes, single, JAX_CPU_SPEED_KMH["batch"], JAX_CPU_BATCH_RESIDUAL_PX,
            msv_batch, msv_single)):
        print(f"multivideo lane {v}: speed {r.speed_kmh:.4f} km/h (true {c.speed_kmh:.4f}, JAX "
              f"CPU run_batch {jax_kmh}, single scan runner {s.speed_kmh:.4f}), residual "
              f"{r.residual_px:.4f} px (JAX CPU {jax_res:.4f}, single {s.residual_px:.4f}); "
              f"host MSV {r.timings['msv_s']:.3f} s, {mb[0]} iterations of {cap}, rms "
              f"{mb[1]:.4f} px (single run's re-anchor {s.timings['msv_s']:.3f} s, its MSV "
              f"{ms[0]} iterations, rms {ms[1]:.4f} px)")
        limit = jax_res + BATCH_RESIDUAL_VS_JAX_PX
        _check_run(f"multivideo lane {v}", r, c, launches, ("lk_block", "extract_slabs"),
                   jax_kmh, limit)
        _check_run(f"multivideo single run {v}", s, c, single_counts[v],
                   ("lk_block", "extract_slabs"), jax_kmh, limit)
    if summed != launches or per_lane[0] != single_counts[0]:
        raise AssertionError(f"multivideo: launches {launches}, by lane {per_lane}, lane 0's "
                             f"single run {single_counts[0]}")
    same = (np.array_equal(res[0].track_px, single[0].track_px, equal_nan=True)
            and np.array_equal(res[0].valid, single[0].valid))
    print(f"multivideo: lane 0's track history bit-equal to the single run's: {same}")
    if not same:
        raise AssertionError("multivideo: lane 0's tracks differ from the single scan runner's")


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
    rows = {"lk_block": k1_rows, "extract_slabs": k2_rows, "extract_patches": k3_rows}
    lanes = phase_slice(dev, clip, "lanes", ("lk_block", "extract_slabs"), rows)
    fast = phase_slice(dev, clip, "fast", ("extract_patches", "extract_slabs"), rows)
    phase_driver(dev, clip)
    phase_ba(dev, clip)
    phase_ba_solvers(dev)
    phase_stills(dev)
    phase_multivideo(dev, clip)
    sharded_lk = phase_parallel(dev, clip)
    longvideo = phase_longvideo(dev)

    k1_main = next(r for r in k1_rows if r.get("win") == 51 and r.get("cubic") and r.get("it0") == 0)
    k2_main = next(r for r in k2_rows if r["size"] == 72)
    k3_main = next(r for r in k3_rows if r["size"] == 82)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    paths = {"lanes": lanes, "fast": fast, "sharded_lk": sharded_lk, "longvideo": longvideo}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    # launches: this slice's main path (the long-video runner) for K1 and
    # K2; K3 runs only on the fast path
    kernels = [
        {"name": "lk_block", "route": "cuda", "source": "velocity_tpu_torch/csrc/lk_block.cu",
         "replaces": "velocity_tpu/ops/lk_block_pallas.py:207",
         "launches": longvideo["lk_block"], "launches_by_path": by_path("lk_block"),
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         **{k: k1_main[k] for k in keys}, "library_ms": None},
        {"name": "extract_slabs", "route": "cuda", "source": "velocity_tpu_torch/csrc/slab.cu",
         "replaces": "velocity_tpu/ops/slab_pallas.py:107",
         "launches": longvideo["extract_slabs"], "launches_by_path": by_path("extract_slabs"),
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         **{k: k2_main[k] for k in keys}, "library_ms": k2_main["library_ms"]},
        {"name": "extract_patches", "route": "cuda",
         "source": "velocity_tpu_torch/csrc/patch.cu",
         "replaces": "velocity_tpu/ops/patch_pallas.py:62",
         "launches": fast["extract_patches"], "launches_by_path": by_path("extract_patches"),
         "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
         **{k: k3_main[k] for k in keys}, "library_ms": k3_main["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
