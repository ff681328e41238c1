"""Multi-video batch runner: several clips through one call.

Torch twin of ``velocity_tpu/pipeline/multivideo.py:run_batch``. JAX vmaps
``scan_segment`` over a video axis laid out on a device mesh
(``_batched_segment``); here lane ``v`` (one video) runs on
``mesh[v % len(mesh)]`` (or on the one ``device``), and the lanes placed on
one mesh device run each segment as one ``scan_segment`` over a lane axis
(``pipeline/scan.py``): one batched frame step per device per frame. Per
lane: decode and frame-0 init, then segment A (frames 1..msv), then the MSV
scale transfer in f64 (it calls ``msv_refine_translation`` directly and
moves the cloud by the lane's translation at the MSV frame; the rows before
it keep their translations), then segment B from ``vp = vg`` at the MSV
frame. A lane whose tracking collapsed at some frame is run again through
the per-frame driver, which carries the feature-match rescue.

Every configuration takes the lane axis, as every one is vmapped in JAX:
the lanes, fast and gather LK engines track all lanes' points on image
stacks, and with ``shard_features > 1`` each feature shard takes its slice
of every lane's points.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from velocity_tpu_torch.config import PipelineConfig
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.pipeline.scan import _decode, record_segment, scan_segment, segment_to_host
from velocity_tpu_torch.pipeline.speedest import (
    F64, RunResult, RunTables, SpeedEstimator, _init_frame0, open_reader, require_device,
    resolve_annotation)
from velocity_tpu_torch.solvers.triangulate import msv_refine_translation


def _stack(states):
    """Per-lane states (tuples of tensors or of pyramids) stacked lane-major."""
    return tuple(tuple(torch.stack(levels) for levels in zip(*parts))
                 if isinstance(parts[0], tuple) else torch.stack(parts)
                 for parts in zip(*states))


def _unstack(state, i: int):
    """Lane i of a state that ``_stack`` built (or a segment returned)."""
    return tuple(tuple(level[i] for level in part) if isinstance(part, tuple) else part[i]
                 for part in state)


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
    frames_all, times_all, cams, inits, pyramids = [], [], [], [], []
    for v, video in enumerate(videos):
        dev = lane_dev[v]
        ann = resolve_annotation(video, annotations[v] if annotations else None)
        start = start_frames[v] if start_frames else ann.start_frame
        with open_reader(video, cfg.platform) as vr:
            cam = vr.info
            host, times, indices, _ = _decode(vr, start, n, cfg.read_speed,
                                              pin=dev.type == "cuda")
        frames = host.to(dev, non_blocking=True)
        frames_all.append(frames)
        times_all.append((times, indices))
        cams.append(cam)
        f0, pyr, spyr = _init_frame0(cfg, cam, frames[0], ann.q * scale, scale)
        inits.append(f0)
        pyramids.append((pyr, spyr))

    n = min(f.shape[0] for f in frames_all)
    msv_i = cfg.msv_frame
    seg_a = min(msv_i, n - 1)

    # ---- the segments: one batched call per mesh device ----
    slots = len(devices)
    groups = [[v for v in range(V) if v % slots == s] for s in range(min(slots, V))]
    for group in groups:
        shapes = {tuple(frames_all[v].shape[1:]) for v in group}
        if len(shapes) > 1:
            raise ValueError(f"run_batch: the lanes of one device need frames of one "
                             f"size, got {sorted(shapes)}")
    lanes = []
    for v in range(V):
        start, p3_0 = inits[v].carry(sdt, lane_dev[v])
        lanes.append(dict(
            gen=torch.Generator(device=lane_dev[v]).manual_seed(v),
            intr=cams[v].intrinsics(scale=scale).to(dtype=sdt, device=lane_dev[v]),
            p3_0=p3_0, start=(*pyramids[v], *start)))

    def segment(group, first, stop, starts, p3s):
        """Frames first..stop-1 of the group's lanes from their start states
        (pyr, spyr, pts, vg, vp, t) and structures: {v: (carry, outs)}."""
        carry, outs = scan_segment(
            torch.stack([frames_all[v][first:stop] for v in group]), *_stack(starts),
            torch.stack(p3s), Intrinsics.stack([lanes[v]["intr"] for v in group]),
            [lanes[v]["gen"] for v in group], cfg.tracker, cfg.solver, sdt)
        return {v: (_unstack(carry, i), _unstack(outs, i)) for i, v in enumerate(group)}

    # ---- segment A ----
    for group in groups:
        for v, (carry, outs) in segment(group, 1, seg_a + 1, [lanes[v]["start"] for v in group],
                                        [lanes[v]["p3_0"] for v in group]).items():
            lanes[v].update(carry=carry, outA=outs)

    # ---- per-video tables from segment A ----
    tables = [RunTables(n, N).start(inits[v]) for v in range(V)]
    msv_s = np.zeros(V)
    for v in range(V):
        times, indices = times_all[v]
        tables[v].B[:, 12] = times[:n]
        tables[v].B[:, 13] = indices[:n]
        record_segment(1, segment_to_host(lanes[v]["outA"]), tables[v], proj=False)

    if n > msv_i:
        for v in range(V):
            # ---- host MSV (f64): the cloud at the MSV frame, moved into
            # the frame-0 gauge by the lane's translation there ----
            lane, tab = lanes[v], tables[v]
            t_m = time.perf_counter()
            vg_msv = tab.valid_hist[seg_a]
            msv = msv_refine_translation(
                cams[v].intrinsics(scale=scale).to(dtype=F64),
                torch.as_tensor(tab.track_px[: msv_i + 1], dtype=F64),
                torch.as_tensor(vg_msv),
                torch.as_tensor(tab.B[: msv_i + 1, 0:3], dtype=F64),
                config=cfg.solver,
            )
            cloud = msv.points.numpy() - tab.B[seg_a, 3:6]
            p3_B = lane["p3_0"].cpu().numpy().copy()
            p3_B[vg_msv] = cloud[vg_msv]
            lane["p3_B"] = torch.as_tensor(p3_B, dtype=sdt, device=lane_dev[v])
            lane["vp_B"] = torch.as_tensor(vg_msv, device=lane_dev[v])
            msv_s[v] = time.perf_counter() - t_m
        # ---- segment B ----
        for group in groups:
            starts = []
            for v in group:
                pyr, spyr, pts, vg, _vp, t_msv = lanes[v]["carry"]
                starts.append((pyr, spyr, pts, vg, lanes[v]["vp_B"], t_msv))
            for v, (_carry, outs) in segment(group, msv_i + 1, n, starts,
                                              [lanes[v]["p3_B"] for v in group]).items():
                record_segment(msv_i + 1, segment_to_host(outs), tables[v], proj=False)

    # ---- feature-match rescue (reference KLT.py:126-130): a lane whose
    # stage-2 survivor count collapsed anywhere is re-run through the
    # per-frame driver, which carries the host feature-match fallback ----
    rescue = [(tab.n2[1:] <= cfg.tracker.min_affine_inliers).any() for tab in tables]

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
        tab = tables[v]
        S = tab.stats(proc)
        if verbose:
            print(f"== {cams[v].filename}: "
                  f"{S[1:, 8].mean():.2f} +/- {S[1:, 8].std():.2f} km/h, "
                  f"res {S[1:, 3].mean():.3f} px")
        results.append(RunResult(
            S=S, B=tab.B, track_px=tab.track_px, proj_px=tab.proj_px,
            valid=tab.valid_hist, plate_box=inits[v].boxa, roi_box=inits[v].boxb,
            camera=cams[v], config=cfg, first_gray=frames_all[v][0].cpu().numpy(),
            last_gray=frames_all[v][n - 1].cpu().numpy(),
            timings={"wall_s": wall, "msv_s": msv_s[v]},
        ))
    return results
