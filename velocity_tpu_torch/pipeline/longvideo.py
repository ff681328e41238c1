"""Long-video windowed driver: full-length videos with windowed BA and resume.

Torch twin of ``velocity_tpu/pipeline/longvideo.py``. The reference
processes a handful of frames in one stateless pass (its vidExample.py
defaults to 20 frames; the videos hold 201/146/122). This driver composes
the pieces of a long run:

  1. continuous tracking through the whole video in window-sized segments
     of ``scan_segment`` (the carry: pyramids, tracks, masks, running
     translation, crosses window boundaries, so the trajectory is globally
     consistent); a decode thread (``pipeline/scan.py:FrameStream``) keeps
     the frames coming while the card tracks;
  2. track replenishment at window boundaries: when survivorship drops,
     new Harris corners fill dead lanes and are back-projected onto the
     plane fitted to the live structure; they join the pose solve once
     N-ray triangulation places them (promotion), and the solve lanes'
     structure is re-triangulated from the last two windows (refresh);
  3. a checkpoint after every window (``parallel/checkpoint.py``) so a long
     run resumes at the last completed window boundary, and one retry of a
     segment that failed, from the host copies of the boundary state;
  4. optional per-window Schur BA refinement (``parallel/windows.py``:
     ``windowed_ba`` over a window x point mesh), stitched back into the
     global trajectory (``align_overlap``).

The MSV scale transfer runs once at the configured frame inside the first
window, exactly like the short-clip runners. RANSAC at row r draws from a
generator seeded r (the run's seed is 0, as JAX's ``PRNGKey(0)``), so a
resumed run and a retried segment draw what the uninterrupted run drew.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from velocity_tpu_torch.config import BAConfig, PipelineConfig
from velocity_tpu_torch.parallel.checkpoint import WindowState, load_state, save_state
from velocity_tpu_torch.parallel.mesh import make_mesh
from velocity_tpu_torch.parallel.windows import align_overlap, windowed_ba
from velocity_tpu_torch.pipeline import report
from velocity_tpu_torch.pipeline.anchor import reanchor
from velocity_tpu_torch.pipeline.roi import inside_bbox
from velocity_tpu_torch.pipeline.scan import (
    FrameStream, scan_segment, segment_to_host, stats_table)
from velocity_tpu_torch.pipeline.speedest import (
    RunResult, SpeedEstimator, _init_features, open_reader, require_device, resolve_annotation)
from velocity_tpu_torch.pipeline.tracker import frame_pyramids
from velocity_tpu_torch.solvers.triangulate import nray_intercept_masked_np


def _row_generator(device, row: int) -> torch.Generator:
    """The RANSAC generator of frame row ``row``: its draws depend on the
    row alone, wherever the row's segment starts."""
    return torch.Generator(device=device).manual_seed(row)


class LongVideoRunner:
    """Windowed long-video speed estimation (see module docstring), on
    ``device`` ("cuda" or "cpu")."""

    def __init__(self, config: PipelineConfig = PipelineConfig(), device="cuda"):
        self.config = config
        self.device = require_device(device, "LongVideoRunner")
        self._est = SpeedEstimator(config, self.device)

    # -------------------------------------------------------------- helpers
    def _replenish(self, gray, q, pts, vg, p3, t_abs, intr_np):
        """Refill dead lanes (shared SpeedEstimator._replenish)."""
        return self._est._replenish(gray, q, pts, vg, p3, t_abs, intr_np)

    def _depth_band(self, p3, vp, B, i):
        """(0.25, 4) x the median camera depth of the solve lanes at row i."""
        z_live = (p3[vp] + (B[i, 0:3] - B[0, 0:3]))[:, 2]
        med = float(np.median(z_live)) if vp.any() else 10.0
        return 0.25 * med, 4.0 * med

    def _promote(self, intr_np, track_px, B, valid_hist, pending, p3, vp, i, window):
        """Promote the pending (replenished) lanes whose history since row
        max(msv_frame, i - 2 window) triangulates self-consistently inside
        the live depth band: they join the pose solve with that structure.
        Returns (p3, vp, pending, n_promoted) (host numpy, f64 structure)."""
        lo = max(self.config.msv_frame, i - 2 * window)
        p3_tri, okt = nray_intercept_masked_np(
            intr_np, track_px[lo : i + 1], B[lo : i + 1, 0:3] - B[0, 0:3],
            valid_hist[lo : i + 1] & pending[None, :],
            depth_range=self._depth_band(p3, vp, B, i))
        promote = pending & okt
        if not promote.any():
            return p3, vp, pending, 0
        p3 = p3.copy()
        p3[promote] = p3_tri[promote]
        return p3, vp | promote, pending & ~promote, int(promote.sum())

    def _refresh(self, intr_np, track_px, B, valid_hist, p3, vp, i, window):
        """Re-triangulate the solve lanes from the last two windows of
        history (rows max(msv_frame, i - 2 window)..i, at least
        max(3, half of them) observations). Structure anchored at the MSV
        baseline goes stale as the car recedes (a 0.3 px track error at 10x
        the anchor range is metres of depth error), and the per-frame
        translation solves amplify it into tens of km/h of tail noise.
        Plate lanes 0..3 stay fixed: they carry the metric gauge. Returns
        (p3, n_refreshed)."""
        lo = max(self.config.msv_frame, i - 2 * window)
        p3_tri, okt = nray_intercept_masked_np(
            intr_np, track_px[lo : i + 1], B[lo : i + 1, 0:3] - B[0, 0:3],
            valid_hist[lo : i + 1] & vp[None, :], min_obs=max(3, (i - lo) // 2),
            depth_range=self._depth_band(p3, vp, B, i))
        refresh = vp & okt
        refresh[:4] = False
        if not refresh.any():
            return p3, 0
        p3 = p3.copy()
        p3[refresh] = p3_tri[refresh]
        return p3, int(refresh.sum())

    # ------------------------------------------------------------------ run
    def run(
        self,
        video,
        annotation=None,
        n_frames: int | None = None,
        start_frame: int | None = None,
        window: int = 24,
        overlap: int = 3,
        checkpoint: str | Path | None = None,
        resume: bool = False,
        ba_refine: bool = True,
        mesh=None,
        verbose: bool = True,
    ) -> RunResult:
        """Run the windowed long-video pipeline over ``video`` (a path or a
        reader, see ``open_reader``).

        ``window``: tracking-segment length; boundaries snap to an absolute
        row grid (multiples of ``window``) so resumed runs replay the exact
        boundary schedule of uninterrupted ones. ``overlap``: number of
        frames each BA refinement window shares with its predecessor (>= 3
        engages the Umeyama similarity gauge stitch; 1 = translation chain).
        ``mesh``: the window x point mesh of the BA refinement (default 1 x 1
        on the runner's device).

        ``timings`` carries the wall time, the decode thread's time and the
        time the tracker waited on it, the segments retried, the frames
        replenished (and lanes seeded), the lanes promoted and refreshed,
        and the BA windows accepted with each window's iterations.
        """
        cfg = self.config
        dev = self.device
        sdt = torch.float32
        t_wall0 = time.perf_counter()
        counts = dict(retries=0, replenished_frames=0, replenished_lanes=0, promoted=0,
                      refreshed=0)

        ann = resolve_annotation(video, annotation)
        with open_reader(video, cfg.platform) as vr:
            cam = vr.info
            scale = cfg.native_scale
            q = ann.q * scale
            intr = cam.intrinsics(scale=scale).to(dtype=sdt, device=dev)
            intr_np = tuple(float(v) for v in (intr.fx, intr.fy, intr.cx, intr.cy))
            start = (start_frame if start_frame is not None else
                     (cfg.start_frame if cfg.start_frame is not None else
                      (ann.start_frame or 0)))
            total = int(cam.frame_count) if cam.frame_count else 10**9
            n = min(n_frames or (total - start), total - start)
            N = cfg.tracker.max_features
            msv_i = cfg.msv_frame

            B = np.zeros((n, 14), np.float64)
            S = np.zeros((n, 9), np.float64)
            track_px = np.full((n, N, 2), np.nan, np.float32)
            valid_hist = np.zeros((n, N), bool)

            # ---- resume or frame-0 init ----
            ckpt = Path(checkpoint) if checkpoint else None
            state = None
            if resume and ckpt is not None and ckpt.exists():
                state = load_state(ckpt)
            ba_meta = []  # (seg_start, seg_end, p3 snapshot, replenished) per segment
            if state is not None:
                i0 = state.frame_index  # boundary frame (absolute row index)
                p_np = state.points
                vg_np = state.valid
                vp_np = state.valid_pose
                p3_np = state.p3
                B[: i0 + 1] = state.B
                S[: i0 + 1] = state.S
                if state.track_px is not None:
                    track_px[: i0 + 1] = state.track_px
                if state.valid_hist is not None:
                    valid_hist[: i0 + 1] = state.valid_hist
                valid_hist[i0] = vg_np
                stream = FrameStream(vr, start + i0, n - i0, cfg.read_speed, dev)
                base = i0
                res0 = float(S[0, 3])
                if state.boxes is not None:
                    boxa = tuple(int(v) for v in state.boxes[0])
                    boxb = tuple(int(v) for v in state.boxes[1])
                else:
                    boxa = boxb = (0, 0, 0, 0)
                if state.ba_bounds is not None and state.ba_p3 is not None:
                    ba_meta = [
                        (int(s), int(e), state.ba_p3[w].astype(np.float64),
                         (state.ba_repl[w] if state.ba_repl is not None
                          else np.zeros(N, bool)))
                        for w, (s, e) in enumerate(state.ba_bounds)
                    ]
            else:
                stream = FrameStream(vr, start, n, cfg.read_speed, dev)
                base = 0
            try:
                if state is None:
                    p_np, valid, boxa, boxb = _init_features(cfg, stream.wait(0), q)
                    t0_np, p3_np, res0 = self._est._init_geometry(cam, q, p_np, valid, scale)
                    vg_np = valid.copy()
                    vp_np = valid & inside_bbox(p_np, boxa)
                    B[0, 0:3] = t0_np
                    B[0, 12] = stream.times[0]
                    B[0, 13] = stream.indices[0]
                    track_px[0, vg_np] = p_np[vg_np]
                    valid_hist[0] = vg_np
                pyr_b, spyr_b = frame_pyramids(stream.wait(0), cfg.tracker)
                pts_dev = torch.as_tensor(p_np, dtype=torch.float32, device=dev)
                vg_dev = torch.as_tensor(vg_np, device=dev)
                vp_dev = torch.as_tensor(vp_np, device=dev)
                t_dev = torch.as_tensor(B[base, 0:3] - B[0, 0:3], dtype=sdt, device=dev)
                p3_dev = torch.as_tensor(p3_np, dtype=sdt, device=dev)

                # ---- window loop (continuous carry) ----
                # ba_meta snapshots are taken AFTER the MSV re-anchor but
                # BEFORE replenishment, so each window's structure matches the
                # content its pixel rows actually tracked (replenished lanes
                # only change identity at boundaries, after the snapshot)
                i = base  # absolute row index of the carry frame
                # lanes replenished at the upcoming segment's start boundary,
                # recorded per segment so BA's overlap extension can exclude
                # them from pre-boundary rows (their pixels there belong to
                # the lane's previous identity)
                repl_at_start = (state.repl_next.astype(bool)
                                 if state is not None and state.repl_next is not None
                                 else np.zeros(N, bool))
                # replenished lanes awaiting N-ray triangulation before joining
                # the pose solve (plane-seeded depth is provisional; a static
                # background corner seeded at car depth drags the solve toward
                # zero motion: the gating of the stills path)
                pending = (state.pending.astype(bool)
                           if state is not None and state.pending is not None
                           else repl_at_start.copy())
                while i < n - 1:
                    # the segment ends at the next boundary: the next multiple
                    # of ``window`` (an ABSOLUTE row grid: a resumed run hits
                    # the same boundaries as an uninterrupted one), the MSV
                    # frame, or the video end, whichever comes first
                    nexts = [(i // window + 1) * window, n - 1]
                    if i < msv_i < n:
                        nexts.append(msv_i)
                    j = min(x for x in nexts if x > i)

                    def _run_segment():
                        frames = torch.stack([stream.wait(r - base)
                                              for r in range(i + 1, j + 1)])
                        carry, outs = scan_segment(
                            frames, pyr_b, spyr_b, pts_dev, vg_dev, vp_dev, t_dev, p3_dev,
                            intr, [_row_generator(dev, r) for r in range(i + 1, j + 1)],
                            cfg.tracker, cfg.solver, sdt)
                        return carry, segment_to_host(outs)

                    try:
                        carry, outs = _run_segment()
                    except Exception as e:  # window-level fault recovery
                        # the segment's inputs all live on the host (decoded
                        # grays, boundary state): rebuild the device state
                        # from the last boundary and retry ONCE; a second
                        # failure propagates
                        counts["retries"] += 1
                        if verbose:
                            print(f"[window @{i}] segment failed ({type(e).__name__}: "
                                  f"{str(e)[:120]}); rebuilding device state and retrying")
                        pyr_b, spyr_b = frame_pyramids(
                            torch.as_tensor(stream.grays[i - base]).to(dev), cfg.tracker)
                        pts_dev = torch.as_tensor(p_np, dtype=torch.float32, device=dev)
                        vg_dev = torch.as_tensor(vg_np, device=dev)
                        vp_dev = torch.as_tensor(vp_np, device=dev)
                        t_dev = torch.as_tensor(B[i, 0:3] - B[0, 0:3], dtype=sdt, device=dev)
                        p3_dev = torch.as_tensor(p3_np, dtype=sdt, device=dev)
                        carry, outs = _run_segment()
                    ptsW, vgW, _vpW, tW, resW, _projW, _n2W = outs
                    pyr_b, spyr_b, pts_dev, vg_dev, vp_dev, t_dev = carry
                    for k in range(j - i):
                        r = i + 1 + k
                        track_px[r, vgW[k]] = ptsW[k][vgW[k]]
                        valid_hist[r] = vgW[k]
                        B[r, 3:6] = tW[k]
                        B[r, 0:3] = B[0, 0:3] + tW[k]
                        S[r, 3] = resW[k]
                    # timestamp/index columns fill as frames are decoded, so a
                    # checkpoint written at this boundary carries whole rows
                    B[i + 1 : j + 1, 12] = stream.times[i + 1 - base : j + 1 - base]
                    B[i + 1 : j + 1, 13] = stream.indices[i + 1 - base : j + 1 - base]
                    seg_start = i
                    i = j

                    # ---- MSV scale transfer at the configured frame ----
                    if i == msv_i and n > msv_i:
                        vg_np = vg_dev.cpu().numpy()
                        p3_new, t_abs, res_new = reanchor(
                            cfg, cam, scale, track_px[: msv_i + 1], vg_np, B,
                            t_dev.cpu().numpy().astype(np.float64), np.array(p3_np),
                            q=np.asarray(q, np.float64))
                        if t_abs is not None:
                            B[: msv_i + 1, 0:3] = t_abs
                            B[: msv_i + 1, 3:6] = t_abs - t_abs[0]
                            t_dev = torch.as_tensor(t_abs[-1] - t_abs[0], dtype=sdt,
                                                    device=dev)
                        if res_new is not None:
                            S[: msv_i + 1, 3] = res_new
                            res0 = float(res_new[0])
                        p3_np = p3_new
                        p3_dev = torch.as_tensor(p3_new, dtype=sdt, device=dev)
                        vp_dev = vg_dev.clone()

                    # ---- boundary host work: promote + refresh + snapshot +
                    # replenish + checkpoint ----
                    p_np = pts_dev.cpu().numpy()
                    vg_np = vg_dev.cpu().numpy()
                    vp_np = vp_dev.cpu().numpy()
                    pending &= vg_np
                    if i > msv_i and pending.any():
                        p3h, vp_np, pending, k = self._promote(
                            intr_np, track_px, B, valid_hist, pending,
                            p3_dev.cpu().numpy().astype(np.float64), vp_np, i, window)
                        if k:
                            p3_np = p3h
                            p3_dev = torch.as_tensor(p3h, dtype=sdt, device=dev)
                            vp_dev = torch.as_tensor(vp_np, device=dev)
                            counts["promoted"] += k
                            if verbose:
                                print(f"[window @{i}] promoted {k} replenished tracks "
                                      "into the pose solve")
                    if i > msv_i and i % window == 0:
                        p3h, k = self._refresh(intr_np, track_px, B, valid_hist,
                                               p3_dev.cpu().numpy().astype(np.float64),
                                               vp_np, i, window)
                        if k:
                            p3_np = p3h
                            p3_dev = torch.as_tensor(p3h, dtype=sdt, device=dev)
                            counts["refreshed"] += k
                            if verbose:
                                print(f"[window @{i}] refreshed structure of {k} lanes")
                    ba_meta.append((seg_start, i, p3_dev.cpu().numpy().astype(np.float64),
                                    repl_at_start.copy()))
                    repl_at_start = np.zeros(N, bool)
                    # replenish only at INTERIOR grid boundaries: a run that
                    # ends mid-grid (or a truncated run) must leave the state
                    # a longer run carries through that row, or resume diverges
                    if i > msv_i and i < n - 1 and i % window == 0:
                        p_r, vg_r, p3_r, n_new = self._replenish(
                            stream.grays[i - base], q, p_np, vg_np,
                            p3_dev.cpu().numpy().astype(np.float64), B[i, 0:3] - B[0, 0:3],
                            intr_np)
                        if n_new:
                            counts["replenished_frames"] += 1
                            counts["replenished_lanes"] += n_new
                            if verbose:
                                print(f"[window @{i}] replenished {n_new} tracks "
                                      f"({vg_np.sum()} -> {vg_r.sum()})")
                            repl_at_start = vg_r & ~vg_np
                            pending |= repl_at_start
                            p_np, vg_np, p3_np = p_r, vg_r, p3_r
                            pts_dev = torch.as_tensor(p_np, dtype=torch.float32, device=dev)
                            vg_dev = torch.as_tensor(vg_np, device=dev)
                            vp_dev = torch.as_tensor(vp_np, device=dev)
                            p3_dev = torch.as_tensor(p3_np, dtype=sdt, device=dev)
                            valid_hist[i] = vg_np
                            track_px[i, vg_np] = p_np[vg_np]
                    if ckpt is not None:
                        save_state(ckpt, WindowState(
                            frame_index=i, points=p_np, valid=vg_np, valid_pose=vp_np,
                            p3=p3_dev.cpu().numpy().astype(np.float64),
                            B=B[: i + 1], S=S[: i + 1], track_px=track_px[: i + 1],
                            valid_hist=valid_hist[: i + 1],
                            boxes=np.array([boxa, boxb], np.int64),
                            ba_bounds=np.array([(s, e) for s, e, _p, _r in ba_meta], np.int64),
                            ba_p3=np.stack([p3w for _s, _e, p3w, _r in ba_meta]),
                            ba_repl=np.stack([r for _s, _e, _p, r in ba_meta]),
                            repl_next=repl_at_start, pending=pending,
                            meta={"video": str(video), "start": str(start)},
                        ))
                stream.join()
            finally:
                stream.close()
            B[base:, 12] = stream.times
            B[base:, 13] = stream.indices
            first_gray = stream.grays[0]
            last_gray = stream.grays[n - 1 - base]

        # ---- optional per-window BA refinement + stitch ----
        ba = None
        if ba_refine and n > msv_i + 2 and len(ba_meta) > 0:
            ba = self._ba_refine(track_px, valid_hist, B, ba_meta, intr, mesh, verbose,
                                 overlap=overlap)

        # ---- stats table ----
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t_wall0
        if state is None:
            S[0, 3] = res0
        S = stats_table(B, valid_hist, S[:, 3], wall / n)
        if verbose:
            print(report.header())
            for r in range(n):
                print(report.row(S[r]))
            print(report.summary(S))
            print(f"Processed {n:g} images in {wall:.2f}s ({n / wall:.2f}fps)\n")

        return RunResult(
            S=S, B=B, track_px=track_px, proj_px=np.full_like(track_px, np.nan),
            valid=valid_hist, plate_box=boxa, roi_box=boxb, camera=cam, config=cfg,
            first_gray=first_gray, last_gray=last_gray,
            timings={"wall_s": wall, "fps": n / wall, "windows": len(ba_meta),
                     "ba_refined": ba is not None, "decode_s": stream.decode_s,
                     "decode_wait_s": stream.wait_s, **counts,
                     **({} if ba is None else ba)},
        )

    # ------------------------------------------------------ BA refinement
    def _ba_refine(self, track_px, valid_hist, B, ba_meta, intr, mesh, verbose,
                   overlap: int = 1):
        """Per-window Schur BA over the mesh, stitched back into B.

        Windows are the tracking segments extended backwards by up to
        ``overlap - 1`` rows, so consecutive BA windows share ``overlap``
        frames (clamped to the previous segment's span). The shared frames
        fix each window's gauge against the already-stitched trajectory:
        with >= 3 of them the full Umeyama similarity (rotation + scale +
        translation) is estimated (``align_overlap``), else the fit
        degenerates to the translation chain. Each window uses its own
        structure snapshot so replenished lanes never mix identities.

        Returns {"ba_windows", "ba_accepted", "ba_iterations" (per window)}.
        """
        n, N, _ = track_px.shape
        # window w spans rows ext_s..e; ext_s reaches back (overlap - 1) rows
        # into the previous segment so ``overlap`` frames are shared
        bounds = []
        for w, (s, e, _p3, _r) in enumerate(ba_meta):
            lo = ba_meta[w - 1][0] if w > 0 else s
            ext_s = max(s - (overlap - 1), lo) if w > 0 else s
            bounds.append((ext_s, s, e))
        nw = len(bounds)
        nc = max(e - ext_s + 1 for ext_s, _s, e in bounds)
        pix = np.zeros((nw, nc, N, 2), np.float32)
        msk = np.zeros((nw, nc, N), bool)
        pts0 = np.zeros((nw, N, 3), np.float32)
        cams0 = np.zeros((nw, nc, 6), np.float32)
        t_abs = B[:, 0:3] - B[0, 0:3]
        for w, (ext_s, s, e) in enumerate(bounds):
            p3w, repl_w = ba_meta[w][2], ba_meta[w][3]
            k = e - ext_s + 1
            m = valid_hist[ext_s : e + 1] & np.isfinite(track_px[ext_s : e + 1]).all(axis=2)
            # extension rows precede this segment's start boundary: lanes
            # replenished AT that boundary carried a different identity there
            ext = s - ext_s
            if ext > 0:
                m[:ext, repl_w] = False
            msk[w, :k] = m
            pix[w, :k] = np.where(m[..., None], track_px[ext_s : e + 1], 0.0)
            cams0[w, :k, 0:3] = t_abs[ext_s : e + 1] - t_abs[ext_s]
            # pad rows (short segments) repeat the final camera, masked off
            for r in range(k, nc):
                cams0[w, r] = cams0[w, k - 1]
            pts0[w] = p3w + t_abs[ext_s]
            dead = ~m.any(axis=0)
            pts0[w][dead] = np.array([0.0, 0.0, 8.0], np.float32)
        # tracks need >= 2 observations in a window to constrain anything;
        # mask the rest off entirely (damping keeps their updates at zero)
        seen = msk.sum(axis=1) < 2
        msk[np.broadcast_to(seen[:, None, :], msk.shape)] = False

        if mesh is None:
            mesh = make_mesh({"window": 1, "point": 1}, devices=[self.device])
        dev = self.device
        ptsR, camsR, iters = windowed_ba(
            torch.as_tensor(pix, device=dev), torch.as_tensor(msk, device=dev),
            torch.as_tensor(pts0, device=dev), torch.as_tensor(cams0, device=dev), intr, mesh,
            config=BAConfig(max_iters=6), fix_rotations=True,
            pin_tracks=4,  # plate corners = the metric scale anchor
        )
        camsR = camsR.cpu().numpy().copy()
        ptsR = ptsR.cpu().numpy().copy()
        iters = iters.cpu().numpy().ravel().tolist()

        # acceptance guard: keep each window's refinement only if it reduces
        # the masked reprojection rms; refinement must not harm the tracked
        # trajectory
        fx, fy = float(intr.fx), float(intr.fy)
        cx, cy = float(intr.cx), float(intr.cy)

        def _rms(w, pts_w, cams_w):
            pc = pts_w[None, :, :] + cams_w[:, None, 0:3]
            u = fx * pc[..., 0] / pc[..., 2] + cx
            v = fy * pc[..., 1] / pc[..., 2] + cy
            err = np.stack([u, v], -1) - pix[w]
            err = np.where(msk[w][..., None], err, 0.0)
            return float(np.sqrt((err ** 2).sum() / max(2 * msk[w].sum(), 1)))

        accepted = 0
        for w in range(nw):
            before = _rms(w, pts0[w], cams0[w])
            after = _rms(w, ptsR[w], camsR[w])
            # trust region: BA must not teleport any camera; a reprojection
            # improvement with a multi-step position jump means the (partly
            # wrong) structure pulled a poorly constrained camera, not that
            # the trajectory got better
            step = np.linalg.norm(np.diff(cams0[w][:, 0:3], axis=0), axis=1)
            move = np.linalg.norm(camsR[w][:, 0:3] - cams0[w][:, 0:3], axis=1)
            limit = 2.0 * max(float(np.median(step)), 1e-3)
            if not np.isfinite(after) or after >= before or float(move.max()) > limit:
                camsR[w] = cams0[w]  # reject: keep the tracked trajectory
            else:
                accepted += 1

        # chain-stitch the (variable-length) windows. Rotations and scale are
        # pinned per window (fix_rotations + pin_tracks), but each window's BA
        # still solves in its own local gauge; the shared overlap frames map
        # it onto the already-stitched trajectory: Umeyama similarity when
        # >= 3 non-collinear shared frames exist (align_overlap), else the
        # mean translation offset.
        pos_out = np.array(t_abs)
        for w, (ext_s, s, e) in enumerate(bounds):
            k = e - ext_s + 1
            local = camsR[w][:k, 0:3]
            if w == 0:
                pos_out[s : e + 1] = pos_out[s] + local
                continue
            shared = s - ext_s + 1  # rows ext_s..s are already stitched
            R, sc, tt = align_overlap(local[:shared], pos_out[ext_s : s + 1])
            mapped = sc * (R @ local.T).T + tt
            pos_out[s + 1 : e + 1] = mapped[shared:]
        B[:, 0:3] = B[0, 0:3] + pos_out
        B[:, 3:6] = pos_out
        if verbose:
            print(f"[ba] refined {nw} windows, accepted {accepted} (iters {iters})")
        return {"ba_windows": nw, "ba_accepted": accepted, "ba_iterations": iters}
