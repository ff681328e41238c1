"""The port's multi-video batch runner against the JAX package on two small
synthetic clips (CPU), and ``scan_segment``, the segment both runners share.

Lanes: the clip of ``test_torch_slice.py`` (seed 0, 40 km/h) and seed 1 at
35 km/h; 270x480, 8 frames, msv_frame 3, 128 features, 64 RANSAC trials, f32
solver. (At 30 km/h the MSV baseline of these small clips is too short:
``msv_refine_translation`` stalls in both packages, the stall of
``ROADMAP.md`` §3.) JAX decodes the clips through a patched VideoReader; the
port is handed lane v's RANSAC noise from PRNGKey(v), in the order its loop
over lanes draws it (segment A lane by lane, then segment B lane by lane).
The scan runner, handed lane 0's noise, is the single run lane 0 must
reproduce.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_clip import (HEIGHT, MSV, N_FRAMES, SCALE, WIDTH, _cfg, _inject, _jax_gumbel,
                         _JaxReader, _jcfg, _no_native_loader, make_clip)

import velocity_tpu.ingest.native_loader as jax_native_loader
import velocity_tpu.pipeline.datasets as jax_datasets
import velocity_tpu.pipeline.multivideo as jax_multivideo
from velocity_tpu.camera.annotations import Annotation as JaxAnnotation
from velocity_tpu.camera.annotations import save_annotation as jax_save_annotation
from velocity_tpu_torch.pipeline import anchor as port_anchor
from velocity_tpu_torch.pipeline.multivideo import run_batch
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner, scan_segment
from velocity_tpu_torch.pipeline.tracker import frame_pyramids, fused_frame_step_pyr
from velocity_tpu_torch.solvers.triangulate import msv_refine_translation
from velocity_tpu_torch.testing.synthetic_clip import render_clip

torch.set_num_threads(1)

LANE1_KMH = 35.0
ALWAYS = 10**6  # min_affine_inliers that sends every frame through the rescue


@pytest.fixture(scope="module")
def clips():
    return [make_clip(),
            render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=1,
                        speed_kmh=LANE1_KMH)]


def _annotations(clips):
    return [c.annotation for c in clips]


@pytest.fixture(scope="module")
def jax_batch(clips, tmp_path_factory):
    """JAX's run_batch over both clips, with the inputs of each lane's MSV
    solve recorded. Returns (results, [(args, kwargs, MSVResult)])."""
    mp = pytest.MonkeyPatch()
    paths = {f"lane{v}.MOV": c for v, c in enumerate(clips)}
    mp.setattr(jax_multivideo, "VideoReader", lambda path, *a, **k: _JaxReader(paths[path]))
    mp.setattr(jax_native_loader, "NativeVideoStream", _no_native_loader)
    real_msv = jax_multivideo.msv_refine_translation
    calls = []

    def recording_msv(*args, **kwargs):
        out = real_msv(*args, **kwargs)
        calls.append((tuple(np.array(a) for a in args[1:]), kwargs, out))
        return out

    mp.setattr(jax_multivideo, "msv_refine_translation", recording_msv)
    d = tmp_path_factory.mktemp("ann")
    anns = []
    for name, c in paths.items():
        a = c.annotation
        anns.append(str(d / f"{name}.npz"))
        jax_save_annotation(anns[-1], JaxAnnotation(a.q, a.fname, a.start_frame))
    try:
        res = jax_multivideo.run_batch(list(paths), annotations=anns, n_frames=N_FRAMES,
                                       config=_jcfg(), verbose=False)
    finally:
        mp.undo()
    return res, calls


def _batch_draws(n_lanes):
    """Lane v's noise from PRNGKey(v) in the port's order: segment A lane
    by lane, then segment B lane by lane."""
    a = [g for v in range(n_lanes) for g in _jax_gumbel(N_FRAMES, v, range(1, MSV + 1))[1]]
    b = [g for v in range(n_lanes) for g in _jax_gumbel(N_FRAMES, v, range(MSV + 1, N_FRAMES))[1]]
    return a + b


@pytest.fixture(scope="module")
def port_batch(clips):
    """The port's run_batch on the CPU with JAX's noise."""
    with pytest.MonkeyPatch.context() as mp:
        draws = _batch_draws(len(clips))
        _inject(mp, draws)
        out = run_batch([c.reader for c in clips], annotations=_annotations(clips),
                        n_frames=N_FRAMES, config=_cfg(), device="cpu", verbose=False)
        assert not draws
    return out


@pytest.fixture(scope="module")
def scan_run(clips):
    """The port's ScanSpeedRunner on lane 0's clip with lane 0's noise."""
    with pytest.MonkeyPatch.context() as mp:
        _, draws = _jax_gumbel(N_FRAMES)
        _inject(mp, draws)
        out = ScanSpeedRunner(_cfg(), device="cpu").run(
            clips[0].reader, annotation=clips[0].annotation, n_frames=N_FRAMES, verbose=False)
        assert not draws
    return out


def test_run_batch_matches_jax(clips, jax_batch, port_batch):
    """run_batch on JAX's noise: each lane's speed within 0.5% of JAX's
    lane, its translations within 1e-3 relative, equal validity on >= 99%
    of the track history; each lane within 15% of its truth."""
    want, _ = jax_batch
    got = port_batch
    assert len(got) == len(want) == 2
    for g, w, c in zip(got, want, clips):
        assert g.S.shape == w.S.shape == (N_FRAMES, 9)
        assert abs(g.speed_kmh - w.speed_kmh) <= 0.005 * w.speed_kmh
        dt = np.linalg.norm(g.B[1:, 3:6] - w.B[1:, 3:6], axis=1)
        assert (dt <= 1e-3 * np.linalg.norm(w.B[1:, 3:6], axis=1)).all(), dt
        assert (g.valid == w.valid).mean() >= 0.99
        np.testing.assert_array_equal(g.B[:, 12:14], w.B[:, 12:14])
        assert abs(g.speed_kmh - c.speed_kmh) <= 0.15 * c.speed_kmh


def test_msv_cloud_matches_jax_on_equal_inputs(clips, jax_batch):
    """Each lane's MSV solve, the port's on JAX's own inputs (host f64):
    the translation and the cloud within 1e-6 relative."""
    _, calls = jax_batch
    assert len(calls) == len(clips)
    for (pixels, mask, origins), kwargs, want in calls:
        assert pixels.shape[0] == MSV + 1
        got = msv_refine_translation(
            clips[0].reader.info.intrinsics(scale=SCALE).to(torch.float64),
            torch.as_tensor(pixels, dtype=torch.float64), torch.as_tensor(mask),
            torch.as_tensor(origins, dtype=torch.float64), config=_cfg().solver)
        w_pts = np.asarray(want.points)[mask]
        np.testing.assert_allclose(got.points.numpy()[mask], w_pts, rtol=0,
                                   atol=1e-6 * np.abs(w_pts).max())
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(want.t)).max())


def test_lane0_is_the_scan_runner(port_batch, scan_run):
    """Lane 0 takes the scan runner's noise in the scan runner's order and
    tracking does not read the structure, so its track history, validity
    and stats-table counts are the scan runner's bit for bit (the scan
    runner's re-anchor re-solves the pose rows that run_batch's MSV keeps,
    so the speeds agree only to 2%)."""
    lane0, want = port_batch[0], scan_run
    np.testing.assert_array_equal(lane0.track_px, want.track_px)
    np.testing.assert_array_equal(lane0.valid, want.valid)
    np.testing.assert_array_equal(lane0.S[:, 2], want.S[:, 2])
    np.testing.assert_array_equal(lane0.B[:, 12:14], want.B[:, 12:14])
    np.testing.assert_array_equal(lane0.first_gray, want.first_gray)
    assert abs(lane0.speed_kmh - want.speed_kmh) <= 0.02 * want.speed_kmh


def test_mesh_of_two_devices_equals_one(clips, monkeypatch):
    """mesh=[cpu, cpu] puts lane v on mesh[v % 2]: the same results as one
    device (segment A only, to keep it short); lane v's generator is seeded
    v on its lane's device."""
    import velocity_tpu_torch.pipeline.multivideo as port_multivideo

    real_segment, seeds = port_multivideo.scan_segment, []

    def recording_segment(*args):
        seeds.append((args[9].initial_seed(), args[9].device))
        return real_segment(*args)

    monkeypatch.setattr(port_multivideo, "scan_segment", recording_segment)
    cpu = torch.device("cpu")
    kw = dict(annotations=_annotations(clips), n_frames=MSV, config=_cfg(), verbose=False)
    got = run_batch([c.reader for c in clips], mesh=[cpu, cpu], **kw)
    want = run_batch([c.reader for c in clips], device="cpu", **kw)
    assert seeds == [(0, cpu), (1, cpu)] * 2
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.B, w.B)
        np.testing.assert_array_equal(g.track_px, w.track_px)
        np.testing.assert_array_equal(g.S[:, 2:], w.S[:, 2:])


def test_collapsed_lane_is_rescued_by_the_driver(clips):
    """A lane whose stage-2 count collapsed (forced: min_affine_inliers
    huge) is run again through SpeedEstimator.run with the given matcher:
    the lane's result is the driver's (it keeps no images), and every frame
    of the re-run asked the matcher."""
    clip = clips[0]
    seen = []

    def matcher(im_prev, im_cur, pts, valid):
        seen.append((clip.frame_index(im_prev), clip.frame_index(im_cur)))
        return clip.motion_affine(*seen[-1])

    n = MSV  # the clip up to the MSV frame: the re-run is what is checked
    (got,) = run_batch([clip.reader], annotations=[clip.annotation], n_frames=n,
                       config=_cfg(min_affine_inliers=ALWAYS), device="cpu", verbose=False,
                       fallback_matcher=matcher)
    assert seen == [(i - 1, i) for i in range(1, n)]
    assert got.first_gray is None and got.last_gray is None
    assert np.isfinite(got.B[:, 0:6]).all() and got.S.shape == (n, 9)
    assert abs(got.speed_kmh - clip.speed_kmh) <= 0.15 * clip.speed_kmh


def test_scan_runner_keeps_its_per_frame_loop(clips, scan_run, monkeypatch):
    """ScanSpeedRunner.run through scan_segment gives the bits of the
    per-frame loop it replaced (one fused step per frame, the MSV re-anchor
    at its frame), on the same noise: equal trajectory, track history and
    validity."""
    clip = clips[0]
    cfg = _cfg()
    got = scan_run
    _, draws = _jax_gumbel(N_FRAMES)
    _inject(monkeypatch, draws)

    from velocity_tpu_torch.pipeline.roi import inside_bbox
    from velocity_tpu_torch.pipeline.speedest import _init_features, _init_geometry

    frames = torch.as_tensor(clip.reader.grays[:N_FRAMES])
    cam, q = clip.reader.info, clip.annotation.q * SCALE
    intr = cam.intrinsics(scale=SCALE)
    p, valid, boxa, _ = _init_features(cfg, frames[0], q)
    pyr, spyr = frame_pyramids(frames[0], cfg.tracker)
    t0_np, p3_np, _ = _init_geometry(cfg, cam, q, p, valid, SCALE)
    pts, vg = torch.as_tensor(p), torch.as_tensor(valid)
    vp = torch.as_tensor(valid & inside_bbox(p, boxa))
    p3 = torch.as_tensor(p3_np, dtype=torch.float32)
    t_prev = torch.as_tensor(t0_np, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    B = np.zeros((N_FRAMES, 14))
    B[0, 0:3] = t0_np
    track = np.full((N_FRAMES, cfg.tracker.max_features, 2), np.nan, np.float32)
    hist = np.zeros((N_FRAMES, cfg.tracker.max_features), bool)
    track[0, valid], hist[0] = p[valid], valid
    for i in range(1, N_FRAMES):
        (pyr, spyr, pts, vg, vp, t, *_rest) = fused_frame_step_pyr(
            pyr, spyr, frames[i], pts, vg, vp, p3, intr, gen, cfg.tracker, cfg.solver,
            torch.float32, t_prev)
        t_prev = t.to(torch.float32)
        vg_np = vg.numpy()
        track[i, vg_np], hist[i] = pts.numpy()[vg_np], vg_np
        B[i, 3:6] = t.numpy().astype(np.float64)
        B[i, 0:3] = B[0, 0:3] + B[i, 3:6]
        if i == MSV:
            p3_new, t_abs, _ = port_anchor.reanchor(
                cfg, cam, SCALE, track[: i + 1], vg_np, B[: i + 1], B[i, 3:6].copy(),
                np.array(p3_np), q=np.asarray(q, np.float64))
            B[: i + 1, 0:3] = t_abs
            B[: i + 1, 3:6] = t_abs - t_abs[0]
            t_prev = torch.as_tensor(t_abs[-1] - t_abs[0], dtype=torch.float32)
            p3 = torch.as_tensor(p3_new, dtype=torch.float32)
            vp = vg.clone()
    assert not draws
    np.testing.assert_array_equal(got.B[:, 0:6], B[:, 0:6])
    np.testing.assert_array_equal(got.track_px, track)
    np.testing.assert_array_equal(got.valid, hist)


def test_scan_segment_carries_state_and_stacks_outputs(clips):
    """scan_segment over frames 1..3 then 4 equals one segment over 1..4
    with the generator carried: the carry of the first is the start of
    the second; outputs stack per frame. An empty segment returns its
    start as the carry and empty outputs."""
    clip = clips[0]
    cfg = _cfg()
    frames = torch.as_tensor(clip.reader.grays[:5])
    q = clip.annotation.q * SCALE
    from velocity_tpu_torch.pipeline.speedest import _init_features, _init_geometry

    p, valid, _, _ = _init_features(cfg, frames[0], q)
    t0, p3, _ = _init_geometry(cfg, clip.reader.info, q, p, valid, SCALE)
    intr = clip.reader.info.intrinsics(scale=SCALE)
    start = (*frame_pyramids(frames[0], cfg.tracker), torch.as_tensor(p),
             torch.as_tensor(valid), torch.as_tensor(valid),
             torch.as_tensor(t0, dtype=torch.float32))
    p3 = torch.as_tensor(p3, dtype=torch.float32)

    def seg(fr, carry, gen):
        return scan_segment(fr, *carry, p3, intr, gen, cfg.tracker, cfg.solver, torch.float32)

    g1 = torch.Generator().manual_seed(0)
    carry_a, outs_a = seg(frames[1:4], start, g1)
    _, outs_b = seg(frames[4:5], carry_a, g1)
    _, outs_all = seg(frames[1:5], start, torch.Generator().manual_seed(0))
    for a, b, whole in zip(outs_a, outs_b, outs_all):
        torch.testing.assert_close(torch.cat([a, b]), whole, rtol=0, atol=0)
    assert outs_all[0].shape == (4, cfg.tracker.max_features, 2) and outs_all[3].shape == (4, 3)
    carry_e, outs_e = seg(frames[1:1], start, torch.Generator())
    assert carry_e is not start and all(c is s for c, s in zip(carry_e, start))
    assert [o.shape[0] for o in outs_e] == [0] * 7


REF = Path(jax_datasets.DATA)  # the reference dataset (not in the repository)
HAVE_DATA = (REF / "IMG_4134.MOV").exists()


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_DATA, reason="dataset not mounted")
def test_three_videos_batched():
    """Mirror of ``tests/test_multivideo.py::test_three_videos_batched``."""
    res = run_batch(
        [REF / "IMG_4134.MOV", REF / "IMG_4119.MOV", REF / "IMG_4238.MOV"],
        annotations=[None, None, Path(__file__).parent.parent / "data" / "IMG_4238.MOV.npz"],
        start_frames=[19, 41, 8], n_frames=20, verbose=False,
        device="cuda" if torch.cuda.is_available() else "cpu",
    )
    assert len(res) == 3
    speeds = [r.speed_kmh for r in res]
    assert abs(speeds[0] - 39.89) < 1.5, speeds  # golden 4134
    assert abs(speeds[1] - 18.74) < 1.5, speeds  # golden 4119
    # GT ~60 km/h, the metric anchor itself uncertain (see the JAX test)
    assert 45.0 < speeds[2] < 75.0, speeds
    assert res[2].speed_std < 6.0, res[2].speed_std
    assert res[2].residual_px < 3.5, res[2].residual_px
    for r in res:
        assert r.S.shape == (20, 9)
        assert r.valid[1:].sum() > 0
