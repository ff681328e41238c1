"""Extended benchmarks of the PyTorch/CUDA port: bundle adjustment and the
tracker's kernels. Twin of ``bench_ba.py``.

    python3 bench_ba_torch.py [--clip synthetic|IMG_4119] [--device cuda|cpu] [--out PATH]

Rows, each with its unit named for what it divides by:

1. BA ms/iter on a tracked 20-frame window (``ba_problem_from_run``: the
   tracks valid in every frame of a non-lean scan run of the clip, up to
   1024), ``ba_dense`` (cut to 256 tracks) and ``ba_schur``, and the Schur
   iteration's model FLOPs against the H100's f32 peak;
2. ``windowed_ba`` over 8 copies of that window (``fix_rotations``,
   ``pin_tracks=4``, 6 iterations), 20 solves in a row;
3. on CUDA only, the tracker's kernels: the 5-level 1080p pyramid (the
   port's separable stencils), K1 (``lk_block``, win 15, P 24, 8 taps, 1024
   points, 20 chained blocks) and K2 (``extract_slabs``, 1024 x 24x24),
   each beside its bound. On the CPU they are left out: a CPU row would
   time the plain versions;
4. ``ba_schur_sharded`` over 1/2/4/8 in-process point shards on the one
   device: code-path validation, as JAX's virtual-CPU rows are. The shards
   run one after another on one device, so the rows say nothing of scaling.

Timing, as in ``bench_ba.py``: each BA solver runs ``max_iters`` 2 and 12
with ``tol=0`` (the step floor of ``solvers/ba.py:step_tolerance`` may still
stop it earlier, so the iterations are read back), each the fastest of 3
warm calls ending in a device synchronisation; ms/iter = (t_hi - t_lo) /
(iterations_hi - iterations_lo). The difference is not clamped: on a noisy
host it can be negative, and each row carries its raw t_lo and t_hi.
Utilisation and bounds, on CUDA only, read against the H100 SXM published
peaks (3.35 TB/s, 67 TFLOP/s f32; ``velocity_tpu_torch/utils/profiling.py``);
the file names the card and its power limit (``device``).

Writes ``{"suite", "device", "rows"}`` to ``--out`` (default
``BENCH_EXTENDED_TORCH.json`` at the repository root) and prints it.
``--clip IMG_4119`` raises where the video is absent; ``--device``
defaults to "cuda" and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_FRAMES = 20
CAPACITY = 1024
DENSE_TRACKS = 256  # ba_dense forms the whole (3 nt + 6 (nc - 1))^2 system
ITERS_LO, ITERS_HI = 2, 12
BATCH_WINDOWS, BATCH_ITERS, BATCH_SOLVES = 8, 6, 20
SHARDS = (1, 2, 4, 8)
SHARD_ITERS_LO, SHARD_ITERS_HI = 2, 42
# far or non-finite N-ray intercepts start at this point (m)
FALLBACK_POINT = (0.0, 0.0, 8.0)


def ba_scene(nc, nt, dtype, dev, seed=0):
    """A seeded BA problem: ``nc`` cameras on a 3.3 m line, ``nt`` points
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


def ba_problem_from_run(res, cfg, capacity: int = CAPACITY, device="cpu"):
    """(BAProblem in f32 on ``device``, real tracks) from a run's tracks
    (``bench_ba.py:80-107``): the tracks valid in every frame fill the
    first lanes of ``capacity``, the cameras are the run's translations
    with camera 0 pinned at the origin, and each track starts at the N-ray
    intercept of its rays from those cameras; a non-finite intercept, one
    farther than 1e4 m, and every empty lane start at ``FALLBACK_POINT``."""
    from velocity_tpu_torch.geometry.projection import pixel_to_unit_ray
    from velocity_tpu_torch.solvers.ba import BAProblem
    from velocity_tpu_torch.solvers.triangulate import nray_intercept

    nc = res.B.shape[0]
    sel = np.where(res.valid.all(axis=0))[0][:capacity]
    n_real = len(sel)
    intr = res.camera.intrinsics(scale=cfg.native_scale).to(dtype=torch.float32)
    pix = np.zeros((nc, capacity, 2), np.float32)
    mask = np.zeros((nc, capacity), bool)
    pix[:, :n_real] = res.track_px[:, sel]
    mask[:, :n_real] = True
    cams = np.zeros((nc, 6), np.float32)
    cams[:, 0:3] = res.B[:, 0:3] - res.B[0, 0:3]

    # the intercept of the real lanes only: an empty lane's rays are parallel,
    # and torch.linalg.solve raises on an exactly singular system
    rays = pixel_to_unit_ray(intr, torch.as_tensor(pix[:, :n_real]))
    real = nray_intercept(torch.as_tensor(-cams[:, 0:3]), rays).numpy()
    pts0 = np.tile(np.asarray(FALLBACK_POINT, np.float32), (capacity, 1))
    ok = np.isfinite(real).all(axis=1) & (np.abs(real) < 1e4).all(axis=1)
    pts0[:n_real][ok] = real[ok]

    def t(a):
        return torch.as_tensor(a, device=device)

    prob = BAProblem(intr=intr.to(device=device), pixels=t(pix), mask=t(mask),
                     points0=t(pts0), cams0=t(cams))
    return prob, n_real


def real_problem(clip: str, device):
    """(BAProblem, real tracks) of a non-lean scan run over ``N_FRAMES``
    frames of ``clip`` (the bench's clips: ``bench_torch.load_clip``): the
    problem reads the tracks after the MSV frame, which a lean run does
    not keep."""
    from bench_torch import bench_config, load_clip
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    video, annotation, start, _reference = load_clip(clip)
    cfg = bench_config()
    res = ScanSpeedRunner(cfg, device=device).run(
        video, annotation=annotation, start_frame=start, n_frames=N_FRAMES, verbose=False,
        lean=False)
    return ba_problem_from_run(res, cfg, device=device)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_wall(fn, dev, rounds: int = 3):
    """(fastest wall seconds of ``rounds`` calls after a warm one, each
    ending in a device synchronisation; the last call's result)."""
    out = fn()
    _sync(dev)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def _per_iter(solve, dev, lo: int, hi: int):
    """Forced-iteration timing of ``solve(BAConfig)``: (ms per iteration or
    None where both runs stopped together, t_lo s, t_hi s, iterations lo,
    iterations hi)."""
    from velocity_tpu_torch.config import BAConfig

    t_lo, r_lo = _best_wall(lambda: solve(BAConfig(max_iters=lo, tol=0.0)), dev)
    t_hi, r_hi = _best_wall(lambda: solve(BAConfig(max_iters=hi, tol=0.0)), dev)
    d_it = r_hi.iterations - r_lo.iterations
    ms = (t_hi - t_lo) / d_it * 1e3 if d_it > 0 else None
    return ms, t_lo, t_hi, r_lo.iterations, r_hi.iterations


def schur_model_flops(nc: int, nt: int) -> int:
    """Model FLOPs of one Schur iteration (``bench_ba.py``'s count): the
    reduced camera system's assembly, the point blocks, the dense solve."""
    return nc * nc * nt * 216 + nc * nt * 500 + (6 * nc) ** 3


def bench_ba_rows(prob, n_real: int, dev, label: str):
    """ms/iter of ``ba_dense`` (cut to ``DENSE_TRACKS`` tracks where the
    window holds more than twice that) and ``ba_schur``, and on CUDA the
    Schur iteration's share of the H100's f32 peak."""
    from velocity_tpu_torch.solvers.ba import ba_dense
    from velocity_tpu_torch.solvers.schur import ba_schur
    from velocity_tpu_torch.utils.profiling import H100_PEAK_F32_PER_S

    rows = []
    nc, nt = prob.pixels.shape[0], prob.points0.shape[0]
    for name, solver in (("dense", ba_dense), ("schur", ba_schur)):
        p, label_nt = prob, nt
        if name == "dense" and nt > 2 * DENSE_TRACKS:
            p = prob._replace(pixels=prob.pixels[:, :DENSE_TRACKS],
                              mask=prob.mask[:, :DENSE_TRACKS],
                              points0=prob.points0[:DENSE_TRACKS])
            label_nt = DENSE_TRACKS
        ms, t_lo, t_hi, it_lo, it_hi = _per_iter(lambda c: solver(p, c), dev, ITERS_LO,
                                                 ITERS_HI)
        rows.append({
            "metric": f"BA ms/iter ({name}, {label} window, nc={nc}, nt={label_nt}, "
                      f"{n_real} real tracks)",
            "value": ms, "unit": "ms/iter", "t_lo_s": t_lo, "t_hi_s": t_hi,
            "iterations_lo": it_lo, "iterations_hi": it_hi,
        })
        if name == "schur" and dev.type == "cuda":
            flops = schur_model_flops(nc, label_nt)
            rows.append({
                "metric": "Schur iteration utilization (model FLOPs / H100 f32 peak)",
                "value": (flops / (ms / 1e3) / H100_PEAK_F32_PER_S * 100
                          if ms and ms > 0 else None),
                "unit": "% of 67 TFLOP/s f32", "model_mflops": flops / 1e6,
            })
    return rows


def bench_batched_schur_rows(prob, dev):
    """``windowed_ba`` over ``BATCH_WINDOWS`` copies of ``prob`` on one
    device, ``BATCH_SOLVES`` solves in a row: ms per batched iteration (and
    on CUDA its model FLOPs' share of the f32 peak)."""
    from velocity_tpu_torch.config import BAConfig
    from velocity_tpu_torch.parallel.mesh import make_mesh
    from velocity_tpu_torch.parallel.windows import windowed_ba
    from velocity_tpu_torch.utils.profiling import H100_PEAK_F32_PER_S

    nw = BATCH_WINDOWS
    nc, nt = prob.pixels.shape[0], prob.points0.shape[0]

    def batch(x):
        return x[None].expand((nw,) + tuple(x.shape)).contiguous()

    args = (batch(prob.pixels), batch(prob.mask), batch(prob.points0), batch(prob.cams0),
            prob.intr, make_mesh({"window": 1, "point": 1}, devices=[dev]))
    cfg = BAConfig(max_iters=BATCH_ITERS, tol=0.0)

    def solves():
        for _ in range(BATCH_SOLVES):
            out = windowed_ba(*args, config=cfg, fix_rotations=True, pin_tracks=4)
        return out

    t_total, (_p, _c, iters) = _best_wall(solves, dev, rounds=1)
    it = int(iters.max())
    ms = t_total / BATCH_SOLVES / max(it, 1) * 1e3
    row = {
        "metric": f"batched Schur BA ms/iter ({nw} windows x nc={nc}, nt={nt}, one device - "
                  "the windowed_ba shape)",
        "value": ms, "unit": "ms/iter (all windows)", "ms_per_window_iter": ms / nw,
        "iterations_per_solve": it, "amortized_solves": BATCH_SOLVES, "t_total_s": t_total,
    }
    if dev.type == "cuda":
        flops = nw * schur_model_flops(nc, nt)
        row["pct_of_67_TFLOPs_f32"] = flops / (ms / 1e3) / H100_PEAK_F32_PER_S * 100
    return [row]


def bench_kernel_rows(dev):
    """The pyramid, K1 and K2 on the card, each beside its bound."""
    from velocity_tpu_torch.ops.lk_block_pallas import lk_block
    from velocity_tpu_torch.ops.pyramid import build_pyramid
    from velocity_tpu_torch.ops.slab_pallas import extract_slabs
    from velocity_tpu_torch.utils.profiling import (
        bound_ms, cuda_ms, gather_bound_ms, k1_bound_ms, window_index)

    rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand((1080, 1920), generator=g, device=dev) * 255

    # ---- the pyramid: 4 levels down, each a 5-tap vertical then horizontal
    # pass (5 multiplies, 4 adds per output); the input read once, every
    # level written once
    ms = cuda_ms(lambda: build_pyramid(img, 4))
    H, W = img.shape
    n_bytes, ops = 4 * H * W, 0
    for _ in range(4):
        h2, w2 = (H + 1) // 2, (W + 1) // 2
        ops += 9 * h2 * (W + 4) + 9 * h2 * w2
        n_bytes += 4 * h2 * w2
        H, W = h2, w2
    b_ms, b_by = bound_ms(n_bytes, ops)
    rows.append({"metric": "5-level 1080p Gaussian pyramid (separable stencils)",
                 "value": ms, "unit": "ms", "bound_ms": b_ms, "bound_by": b_by,
                 "pct_of_bound": b_ms / ms * 100, "stencil_gops": ops / 1e9,
                 "achieved_GBps": n_bytes / ms / 1e6})

    # ---- K1: 20 chained blocks (bench_ba.py's inputs, points-major)
    N, P, win, taps, blocks = 1024, 24, 15, 8, 20

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev)

    slab, Ipw = rnd(N, P, P) * 255, rnd(N, win, win) * 255
    gxw = torch.randn((N, win, win), generator=g, device=dev) * 20
    gyw = torch.randn((N, win, win), generator=g, device=dev) * 20
    a11, a12, a22 = ((a * b).sum((1, 2)) for a, b in ((gxw, gxw), (gxw, gyw), (gyw, gyw)))
    inv_det = 1.0 / (a11 * a22 - a12 * a12)
    b3 = torch.full((N,), 3.0, device=dev)
    trackable = torch.ones(N, dtype=torch.bool, device=dev)
    kw = dict(win=win, n_taps=taps, cubic=False, eps=1e-9, Wd=1920, Hd=1080)
    state0 = (torch.full((2, N), 10.0, device=dev), torch.zeros(N, dtype=torch.bool, device=dev),
              torch.zeros((2, N), device=dev))

    def chain(record=None):
        p, d, pd = state0
        for _ in range(blocks):
            if record is not None:
                record.append(int((trackable & ~d).sum()))
            p, d, pd = lk_block(slab, Ipw, gxw, gyw, a11, a12, a22, inv_det, b3, b3,
                                trackable, p, d, pd, 0, **kw)
        return p

    active = []
    chain(active)
    per_block = cuda_ms(chain, calls=1) / blocks
    bounds = [k1_bound_ms(win, P, taps, n, N) for n in active]
    b_ms = sum(b for b, _ in bounds) / blocks
    rows.append({"metric": f"fused LK block kernel K1 (5 iters, win{win}, {N} pts, "
                           f"{blocks} chained blocks)",
                 "value": per_block, "unit": "ms/block", "bound_ms": b_ms,
                 "bound_by": bounds[0][1], "pct_of_bound": b_ms / per_block * 100,
                 "active_points": active})

    # ---- K2: 1024 slabs of 24x24 at random corners of the frame
    S = 24
    corners = torch.stack([torch.randint(0, 1920 - S, (N,), generator=g, device=dev),
                           torch.randint(0, 1080 - S, (N,), generator=g, device=dev)],
                          1).int()
    ms = cuda_ms(lambda: extract_slabs(img, corners, S))
    r_idx, c_idx = window_index(corners[:, 0], corners[:, 1], S)
    b_ms, b_by = gather_bound_ms(img, r_idx, c_idx, 16 * N)
    rows.append({"metric": f"slab extraction K2 ({N} x {S}x{S})", "value": ms, "unit": "ms",
                 "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": b_ms / ms * 100})
    return rows


def bench_scaling_rows(dev):
    """``ba_schur_sharded`` over 1/2/4/8 in-process point shards on ``dev``
    at 20 cameras x 1024 tracks (``ba_scene``)."""
    from velocity_tpu_torch.parallel.ba_dist import ba_schur_sharded
    from velocity_tpu_torch.parallel.mesh import make_mesh

    prob = ba_scene(20, CAPACITY, torch.float32, dev)
    rows = []
    for nd in SHARDS:
        mesh = make_mesh({"point": nd}, devices=[dev] * nd)
        ms, t_lo, t_hi, it_lo, it_hi = _per_iter(
            lambda c: ba_schur_sharded(prob, mesh, "point", c), dev, SHARD_ITERS_LO,
            SHARD_ITERS_HI)
        rows.append({
            "metric": f"point-sharded Schur BA ms/iter, {nd} in-process shards on one "
                      f"{dev.type} device (nc=20, nt={CAPACITY}; code-path validation)",
            "value": ms, "unit": "ms/iter", "t_lo_s": t_lo, "t_hi_s": t_hi,
            "iterations_lo": it_lo, "iterations_hi": it_hi,
            "note": "the shards run one after another on one device: these rows check "
                    "the sharded code path and say nothing of scaling over GPUs",
        })
    return rows


def run_suite(clip: str, device) -> dict:
    """Every row on ``device`` (the kernel rows on CUDA only)."""
    from bench_torch import device_fields
    from velocity_tpu_torch.pipeline.speedest import require_device

    dev = require_device(device, "bench_ba")
    prob, n_real = real_problem(clip, dev)
    rows = bench_ba_rows(prob, n_real, dev, clip)
    rows += bench_batched_schur_rows(prob, dev)
    if dev.type == "cuda":
        rows += bench_kernel_rows(dev)
    rows += bench_scaling_rows(dev)
    return {"suite": "velocity_tpu_torch extended benchmarks", "device": device_fields(dev),
            "rows": rows}


def main(argv=None) -> int:
    from velocity_tpu_torch.pipeline.speedest import require_device

    parser = argparse.ArgumentParser(prog="bench_ba_torch",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--clip", default="synthetic", choices=["synthetic", "IMG_4119"])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    parser.add_argument("--out", default=str(Path(__file__).resolve().parent
                                             / "BENCH_EXTENDED_TORCH.json"))
    args = parser.parse_args(argv)
    require_device(args.device, "bench_ba")
    out = run_suite(args.clip, args.device)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
