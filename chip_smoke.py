#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``velocity_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version at the shapes
of the main path, then drives the main path, ``ScanSpeedRunner.run``, on a
1920x1080, 20-frame synthetic clip with the default tracker (1024 features,
1024 RANSAC trials) and the f32 solver, and checks that it went through both
kernels and recovered the clip's speed. Any failure exits non-zero; there
is no CPU fallback. The last line is a JSON object with ``"ok": true``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Speed the JAX package's ScanSpeedRunner (f32 solver, default tracker)
# recovers on the same synthetic clip (seed 0, 1920x1080, 20 frames), run on
# the CPU; see CHANGES.md.
JAX_CPU_SPEED_KMH = 39.9964228614167
SPEED_VS_TRUTH = 0.05
SPEED_VS_JAX = 0.02
MAX_RESIDUAL_PX = 1.0
N_POINTS = 1024
# (S, N) of every slab extraction on the main path: stages 1-2, stage-3
# source, stage-3 backward destination, warped slabs, corner_subpix
SLAB_SHAPES = ((24, 1024), (56, 1024), (64, 1024), (72, 1024), (27, 1020))
K1_CONFIGS = ((15, 24, 8, False), (51, 64, 10, True), (51, 64, 8, False))
K1_RTOL, K1_ATOL = 1e-5, 1e-4  # summation order and FMA contraction differ


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


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from velocity_tpu_torch import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.relative_to(ROOT)}")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  ptxas:", line.strip())


def phase_k2(dev):
    """K2 against its plain version on a padded 1080p frame: bit-equal."""
    from velocity_tpu_torch.ops import slab_pallas as k2
    from velocity_tpu_torch.ops.lk_lanes import _pad_edge

    g = torch.Generator(device=dev).manual_seed(2)
    img = _pad_edge(torch.rand((1080, 1920), generator=g, device=dev) * 255, 72)
    H, W = img.shape
    rows = []
    for S, N in SLAB_SHAPES:
        cx = torch.randint(0, W - S + 1, (N,), generator=g, device=dev, dtype=torch.int32)
        cy = torch.randint(0, H - S + 1, (N,), generator=g, device=dev, dtype=torch.int32)
        got = k2.extract_slabs(img, cx, cy, S)
        want = k2.extract_slabs_ref(img, cx, cy, S)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from its plain version at S={S}")
        ms = cuda_ms(lambda: k2.extract_slabs(img, cx, cy, S))
        plain_ms = cuda_ms(lambda: k2.extract_slabs_ref(img, cx, cy, S))
        rows.append(dict(S=S, max_abs_err=0.0, ms=ms, plain_ms=plain_ms))
        print(f"K2 S={S:2d} N={N}: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return rows


def _k1_case(dev, win, P, n_taps, cubic, it0, seed=0):
    """Random K1 inputs at a main-path shape, points-major, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    N = N_POINTS

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
    c = (n_taps - 1) / 2 + (win - 1) / 2
    bx = (rnd(N) * 2 - 1) - pts[0] + c
    by = (rnd(N) * 2 - 1) - pts[1] + c
    trackable = rnd(N) > 0.1
    done = rnd(N) > 0.7 if it0 > 0 else torch.zeros(N, dtype=torch.bool, device=dev)
    pd = nrm(2, N) * 0.2
    kw = dict(win=win, n_taps=n_taps, cubic=cubic, eps=0.01, Wd=1920, Hd=1080)
    return (dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx.contiguous(), by.contiguous(),
            trackable, pts.contiguous(), done, pd.contiguous(), it0), kw


def phase_k1(dev):
    """K1 against its plain version: points within K1_RTOL/K1_ATOL, equal done flags."""
    from velocity_tpu_torch.ops import lk_block_pallas as k1

    rows = []
    for win, P, n_taps, cubic in K1_CONFIGS:
        for it0 in (0, 5):
            args, kw = _k1_case(dev, win, P, n_taps, cubic, it0)
            got_p, got_d, got_pd = k1.lk_block(*args, **kw)
            ref_p, ref_d, ref_pd = k1.block_iters_ref(*args, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got_p, ref_p, rtol=K1_RTOL, atol=K1_ATOL)
            torch.testing.assert_close(got_pd, ref_pd, rtol=K1_RTOL, atol=K1_ATOL)
            if not torch.equal(got_d, ref_d):
                raise AssertionError(f"K1 done flags differ ({win},{P},{n_taps},{cubic},"
                                     f"it0={it0}): {int((got_d != ref_d).sum())} points")
            err = float(torch.max(torch.abs(got_p - ref_p)))
            ms = cuda_ms(lambda: k1.lk_block(*args, **kw))
            plain_ms = cuda_ms(lambda: k1.block_iters_ref(*args, **kw))
            rows.append(dict(win=win, P=P, n_taps=n_taps, cubic=cubic, it0=it0,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms))
            print(f"K1 win={win} P={P} taps={n_taps} cubic={cubic} it0={it0} N={N_POINTS}: "
                  f"max|dp|={err:.3g} px, done equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return rows


def phase_slice(dev):
    """The main path end to end on the full-size synthetic clip."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig
    from velocity_tpu_torch.ops import lk_block_pallas as k1
    from velocity_tpu_torch.ops import slab_pallas as k2
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
    from velocity_tpu_torch.testing.synthetic_clip import render_clip

    t0 = time.perf_counter()
    clip = render_clip(n_frames=20, width=1920, height=1080, seed=0)
    print(f"clip: 20 x 1080x1920 rendered in {time.perf_counter() - t0:.1f} s, "
          f"true speed {clip.speed_kmh:.3f} km/h")
    runner = ScanSpeedRunner(PipelineConfig(solver=SolverConfig(dtype="float32")), device=dev)

    def run():
        return runner.run(clip.reader, annotation=clip.annotation, n_frames=20, verbose=False)

    t0 = time.perf_counter()
    run()  # first run: library load, allocator and cuBLAS/cuSOLVER warm-up
    print(f"slice cold run: {time.perf_counter() - t0:.2f} s")
    k1.lk_block.launches = 0
    k2.extract_slabs.launches = 0
    res = run()
    launches = {"lk_block": k1.lk_block.launches, "extract_slabs": k2.extract_slabs.launches}
    wall = res.timings["wall_s"]
    print(f"slice warm run: wall {wall:.3f} s, {20 / wall:.3f} frames/s "
          f"(decode {res.timings['decode_s']:.3f} s, init {res.timings['init_s']:.3f} s, "
          f"msv {res.timings.get('msv_s', float('nan')):.3f} s)")
    print(f"slice: speed {res.speed_kmh:.4f} km/h (true {clip.speed_kmh:.4f}, "
          f"JAX CPU {JAX_CPU_SPEED_KMH:.4f}), residual {res.residual_px:.4f} px, "
          f"launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    if not np.isfinite(res.B[:, 3:6]).all():
        raise AssertionError("non-finite per-frame translation")
    if abs(res.speed_kmh - clip.speed_kmh) > SPEED_VS_TRUTH * clip.speed_kmh:
        raise AssertionError(f"speed {res.speed_kmh} vs true {clip.speed_kmh}")
    if abs(res.speed_kmh - JAX_CPU_SPEED_KMH) > SPEED_VS_JAX * JAX_CPU_SPEED_KMH:
        raise AssertionError(f"speed {res.speed_kmh} vs JAX CPU {JAX_CPU_SPEED_KMH}")
    if not res.residual_px <= MAX_RESIDUAL_PX:
        raise AssertionError(f"mean residual {res.residual_px} px > {MAX_RESIDUAL_PX}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import velocity_tpu_torch  # noqa: F401  (fails where the package is absent)

    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    k2_rows = phase_k2(dev)
    k1_rows = phase_k1(dev)
    launches = phase_slice(dev)

    k1_main = next(r for r in k1_rows if r["win"] == 51 and r["cubic"] and r["it0"] == 0)
    k2_main = next(r for r in k2_rows if r["S"] == 72)
    kernels = [
        {"name": "lk_block", "route": "cuda", "source": "velocity_tpu_torch/csrc/lk_block.cu",
         "replaces": "velocity_tpu/ops/lk_block_pallas.py:207",
         "launches": launches["lk_block"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"]},
        {"name": "extract_slabs", "route": "cuda", "source": "velocity_tpu_torch/csrc/slab.cu",
         "replaces": "velocity_tpu/ops/slab_pallas.py:107",
         "launches": launches["extract_slabs"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
