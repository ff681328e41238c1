"""Multi-video batch runner: several clips through one call.

Torch twin of ``velocity_tpu/pipeline/multivideo.py:run_batch``. JAX vmaps
``scan_segment`` over a video axis laid out on a device mesh; here lane
``v`` (one video) runs on ``mesh[v % len(mesh)]`` (or on the one
``device``), and each segment is a loop over lanes of ``scan_segment``
(``pipeline/scan.py``). Per video, on the host: decode and frame-0 init,
then segment A (frames 1..msv), then the MSV scale transfer in f64 (it calls
``msv_refine_translation`` directly and moves the cloud by the lane's
translation at the MSV frame; the rows before it keep their translations),
then segment B from ``vp = vg`` at the MSV frame. A lane whose tracking
collapsed at some frame is run again through the per-frame driver, which
carries the feature-match rescue.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from velocity_tpu_torch.config import PipelineConfig
from velocity_tpu_torch.pipeline.roi import inside_bbox
from velocity_tpu_torch.pipeline.scan import _decode, record_segment, scan_segment, stats_table
from velocity_tpu_torch.pipeline.speedest import (
    F64, RunResult, SpeedEstimator, _init_features, _init_geometry, open_reader, require_device,
    resolve_annotation)
from velocity_tpu_torch.pipeline.tracker import frame_pyramids
from velocity_tpu_torch.solvers.triangulate import msv_refine_translation


def run_batch(
    videos: list,
    annotations: list | None = None,
    n_frames: int | None = None,
    start_frames: list[int] | None = None,
    config: PipelineConfig = PipelineConfig(),
    mesh: list | None = None,
    verbose: bool = True,
    device="cuda",
    fallback_matcher=None,
) -> list[RunResult]:
    """Run the speed pipeline over several videos (paths or readers, see
    ``open_reader``); returns one ``RunResult`` per video.

    ``mesh``: optional list of torch devices; lane v runs on
    ``mesh[v % len(mesh)]``, else every lane on ``device``. Lane v's RANSAC
    draws from a generator seeded v. ``fallback_matcher`` is handed to the
    per-frame driver that re-runs a collapsed lane (see ``SpeedEstimator``).
    """
    t_wall0 = time.perf_counter()
    cfg = config
    devices = [require_device(d, "run_batch") for d in (mesh or [device])]
    sdt = F64 if cfg.solver.dtype == "float64" else torch.float32
    n = n_frames if n_frames is not None else cfg.n_frames
    V = len(videos)
    N = cfg.tracker.max_features
    scale = cfg.native_scale
    lane_dev = [devices[v % len(devices)] for v in range(V)]

    # ---- per-video decode + init (host; Harris on the lane's device) ----
    frames_all, times_all, cams, inits = [], [], [], []
    for v, video in enumerate(videos):
        dev = lane_dev[v]
        ann = resolve_annotation(video, annotations[v] if annotations else None)
        start = start_frames[v] if start_frames else ann.start_frame
        with open_reader(video, cfg.platform) as vr:
            cam = vr.info
            host, times, indices = _decode(vr, start, n, cfg.read_speed, pin=dev.type == "cuda")
        frames = host.to(dev, non_blocking=True)
        q = ann.q * scale
        p, valid, boxa, boxb = _init_features(cfg, frames[0], q)
        t0, p3, res0 = _init_geometry(cfg, cam, q, p, valid, scale)
        frames_all.append(frames)
        times_all.append((times, indices))
        cams.append(cam)
        inits.append(dict(p=p, valid=valid, boxa=boxa, boxb=boxb, t0=t0, p3=p3, res0=res0))

    n = min(f.shape[0] for f in frames_all)
    msv_i = cfg.msv_frame
    seg_a = min(msv_i, n - 1)

    # ---- segment A, lane by lane ----
    lanes = []
    for v in range(V):
        dev, init = lane_dev[v], inits[v]
        gen = torch.Generator(device=dev)
        gen.manual_seed(v)
        intr = cams[v].intrinsics(scale=scale).to(dtype=sdt, device=dev)
        p3_0 = torch.as_tensor(init["p3"], dtype=sdt, device=dev)
        pyr0, spyr0 = frame_pyramids(frames_all[v][0], cfg.tracker)
        carry, outs = scan_segment(
            frames_all[v][1 : seg_a + 1], pyr0, spyr0,
            torch.as_tensor(init["p"], dtype=torch.float32, device=dev),
            torch.as_tensor(init["valid"], device=dev),
            torch.as_tensor(init["valid"] & inside_bbox(init["p"], init["boxa"]), device=dev),
            torch.as_tensor(init["t0"], dtype=sdt, device=dev), p3_0, intr, gen,
            cfg.tracker, cfg.solver, sdt)
        lanes.append(dict(gen=gen, intr=intr, p3_0=p3_0, carry=carry, outA=outs))

    # ---- per-video tables from segment A ----
    B_all = np.zeros((V, n, 14))
    track_all = np.full((V, n, N, 2), np.nan, np.float32)
    valid_all = np.zeros((V, n, N), bool)
    res_all = np.zeros((V, n))
    n2_all = np.zeros((V, n))
    tables = [(B_all[v], track_all[v], valid_all[v], res_all[v], n2_all[v]) for v in range(V)]

    tA, msv_s = [], np.zeros(V)
    for v in range(V):
        times, indices = times_all[v]
        init = inits[v]
        B_all[v, :, 12] = times[:n]
        B_all[v, :, 13] = indices[:n]
        B_all[v, 0, 0:3] = init["t0"]
        track_all[v, 0, init["valid"]] = init["p"][init["valid"]]
        valid_all[v, 0] = init["valid"]
        res_all[v, 0] = init["res0"]
        tA.append(record_segment(1, lanes[v]["outA"], *tables[v]))

    if n > msv_i:
        for v in range(V):
            # ---- host MSV (f64): the cloud at the MSV frame, moved into
            # the frame-0 gauge by the lane's translation there ----
            lane = lanes[v]
            t_m = time.perf_counter()
            vg_msv = valid_all[v, seg_a]
            msv = msv_refine_translation(
                cams[v].intrinsics(scale=scale).to(dtype=F64),
                torch.as_tensor(track_all[v, : msv_i + 1], dtype=F64),
                torch.as_tensor(vg_msv),
                torch.as_tensor(B_all[v, : msv_i + 1, 0:3], dtype=F64),
                config=cfg.solver,
            )
            cloud = msv.points.numpy() - tA[v][seg_a - 1]
            p3_B = lane["p3_0"].cpu().numpy().copy()
            p3_B[vg_msv] = cloud[vg_msv]
            lane["p3_B"] = torch.as_tensor(p3_B, dtype=sdt, device=lane_dev[v])
            lane["vp_B"] = torch.as_tensor(vg_msv, device=lane_dev[v])
            msv_s[v] = time.perf_counter() - t_m
        # ---- segment B, lane by lane ----
        for v in range(V):
            lane = lanes[v]
            pyr, spyr, pts, vg, _vp, t_msv = lane["carry"]
            _carry, outs = scan_segment(
                frames_all[v][msv_i + 1 : n], pyr, spyr, pts, vg, lane["vp_B"], t_msv,
                lane["p3_B"], lane["intr"], lane["gen"], cfg.tracker, cfg.solver, sdt)
            record_segment(msv_i + 1, outs, *tables[v])

    # ---- feature-match rescue (reference KLT.py:126-130): a lane whose
    # stage-2 survivor count collapsed anywhere is re-run through the
    # per-frame driver, which carries the host feature-match fallback ----
    rescue = (n2_all[:, 1:] <= cfg.tracker.min_affine_inliers).any(axis=1)

    # ---- per-video tables ----
    # the lanes run as one batch: attribute wall time uniformly (reference
    # procTime contract: vidExample.py:162-165)
    for dev in set(lane_dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_wall0
    proc = wall / max(n * V, 1)
    results = []
    for v in range(V):
        if rescue[v]:
            est = SpeedEstimator(cfg, lane_dev[v], fallback_matcher)
            res_v = est.run(
                videos[v],
                annotation=(annotations[v] if annotations else None),
                n_frames=n,
                start_frame=(start_frames[v] if start_frames else None),
                verbose=False, collect_images=False,
            )
            if verbose:
                print(f"== {cams[v].filename}: rescued per-frame; "
                      f"{res_v.speed_kmh:.2f} +/- {res_v.speed_std:.2f} km/h")
            results.append(res_v)
            continue
        S = stats_table(B_all[v], valid_all[v], res_all[v], proc)
        if verbose:
            print(f"== {cams[v].filename}: "
                  f"{S[1:, 8].mean():.2f} +/- {S[1:, 8].std():.2f} km/h, "
                  f"res {S[1:, 3].mean():.3f} px")
        results.append(RunResult(
            S=S, B=B_all[v], track_px=track_all[v], proj_px=np.full((n, N, 2), np.nan),
            valid=valid_all[v], plate_box=inits[v]["boxa"], roi_box=inits[v]["boxb"],
            camera=cams[v], config=cfg, first_gray=frames_all[v][0].cpu().numpy(),
            last_gray=frames_all[v][n - 1].cpu().numpy(),
            timings={"wall_s": wall, "msv_s": msv_s[v]},
        ))
    return results
