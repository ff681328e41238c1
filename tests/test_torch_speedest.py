"""The port's per-frame driver against the JAX package on the small synthetic
clip (CPU): ``SpeedEstimator.run``, the driver beside the port's own scan
runner, one frame step with the feature-match rescue forced, ``_replenish``
and ``ThreeStageTracker.track``.

The clip, sizes and configuration are those of ``test_torch_slice.py``
(270x480, 8 frames, msv_frame 3, 128 features, 64 RANSAC trials, f32
solver). RANSAC noise: the port is handed JAX's own Gumbel draws, in the
order the JAX driver splits its key. The rescue runs the cv2 SIFT matcher
on both sides, on the same images.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_clip import (FEATURES, N_FRAMES, SCALE, _cfg, _inject, _jax_gumbel_driver,
                         _jax_info, _jax_reads_clip, _jcfg, make_clip)

from velocity_tpu.pipeline.roi import inside_bbox
from velocity_tpu.pipeline.speedest import SpeedEstimator as JaxSpeedEstimator
from velocity_tpu.pipeline.tracker import ThreeStageTracker as JaxThreeStageTracker
from velocity_tpu.pipeline.tracker import frame_pyramids_jit as jax_frame_pyramids
from velocity_tpu_torch.convert import state_from_numpy
from velocity_tpu_torch.pipeline import SpeedEstimator, ThreeStageTracker, speedest
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

torch.set_num_threads(1)

ALWAYS = 10**6  # min_affine_inliers that sends every frame through the rescue


@pytest.fixture(scope="module")
def clip():
    return make_clip()


def test_driver_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeedEstimator()


def test_driver_run_matches_jax(clip, monkeypatch):
    """SpeedEstimator.run (lanes) against JAX's: speed within 0.5%,
    per-frame translations within 1e-3 relative, mean residual within
    0.05 px; the track history has the same validity on >= 99% of lanes."""
    want = JaxSpeedEstimator(_jcfg()).run(
        "synthetic.MOV", annotation=_jax_reads_clip(monkeypatch, clip), n_frames=N_FRAMES,
        verbose=False)
    _, draws = _jax_gumbel_driver(N_FRAMES)
    _inject(monkeypatch, draws)
    got = SpeedEstimator(_cfg(), device="cpu").run(
        clip.reader, annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    assert not draws
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.005 * want.speed_kmh
    dt = np.linalg.norm(got.B[1:, 3:6] - want.B[1:, 3:6], axis=1)
    assert (dt <= 1e-3 * np.linalg.norm(want.B[1:, 3:6], axis=1)).all(), dt
    assert abs(got.residual_px - want.residual_px) <= 0.05
    assert (got.valid == want.valid).mean() >= 0.99
    np.testing.assert_array_equal(got.first_gray, want.first_gray)
    np.testing.assert_array_equal(got.last_gray, want.last_gray)
    assert abs(got.speed_kmh - clip.speed_kmh) <= 0.15 * clip.speed_kmh


def test_driver_matches_scan_runner(clip):
    """The port's driver and its scan runner draw from one generator seeded 0
    in the same order, so where no frame is rescued they give the same bits:
    equal track history and trajectory. The stats rows differ only at the
    re-anchor frame, whose step the driver (as JAX's) measures before the
    re-anchor and the scan runner after."""
    run = dict(annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    a = SpeedEstimator(_cfg(), device="cpu").run(clip.reader, **run)
    b = ScanSpeedRunner(_cfg(), device="cpu").run(clip.reader, **run)
    np.testing.assert_array_equal(a.B, b.B)
    np.testing.assert_array_equal(a.track_px, b.track_px)
    np.testing.assert_array_equal(a.proj_px, b.proj_px)
    np.testing.assert_array_equal(a.valid, b.valid)
    msv = _cfg().msv_frame
    rows = [i for i in range(1, N_FRAMES) if i != msv]
    np.testing.assert_array_equal(a.S[rows][:, 2:], b.S[rows][:, 2:])
    assert abs(a.speed_kmh - b.speed_kmh) <= 1e-3 * b.speed_kmh


def _frame1_state(clip, jcfg):
    """Frame-0 state of the JAX driver, as both packages' step inputs."""
    g0 = clip.reader.grays[0]
    q = clip.annotation.q * SCALE
    est = JaxSpeedEstimator(jcfg)
    p, valid, boxa, _ = est._init_features(g0, q)
    t0, p3, _ = est._init_geometry(_jax_info(clip), q, p, valid, SCALE)
    vp = valid & inside_bbox(p, boxa)
    intr = _jax_info(clip).intrinsics(scale=SCALE).astype(jnp.float32)
    pyr, spyr = jax_frame_pyramids(jnp.asarray(g0), jcfg.tracker)
    return est, dict(pyr=pyr, spyr=spyr, pts=p, vg=valid, vp=vp, t=t0, p3=p3, intr=intr)


def test_forced_rescue_step_matches_jax(clip, monkeypatch):
    """_frame_step_with_fallback with the branch forced (min_affine_inliers
    huge) and the cv2 matcher on both sides: the same T23 (same cv2, same
    images and points), tracked points within 1e-3 px where both are valid,
    >= 99% equal validity, the translation within 1e-3 relative, the
    residual within 0.05 px."""
    cfg, jcfg = _cfg(min_affine_inliers=ALWAYS), _jcfg(min_affine_inliers=ALWAYS)
    g0, g1 = clip.reader.grays[0], clip.reader.grays[1]
    jest, s = _frame1_state(clip, jcfg)
    keys, draws = _jax_gumbel_driver(2)
    _inject(monkeypatch, draws)
    want = jest._frame_step_with_fallback(
        s["pyr"], s["spyr"], jnp.asarray(g1), jnp.asarray(s["pts"]), jnp.asarray(s["vg"]),
        jnp.asarray(s["vp"]), jnp.asarray(s["p3"], jnp.float32), s["intr"], keys[1],
        jnp.float32, g0, g1, jnp.asarray(s["t"], jnp.float32))
    st = state_from_numpy(**s, device="cpu")
    got = SpeedEstimator(cfg, device="cpu")._frame_step_with_fallback(
        st["pyr"], st["spyr"], torch.as_tensor(g1), st["pts"], st["vg"], st["vp"], st["p3"],
        st["intr"], None, torch.float32, g0, g1, st["t"])
    assert not draws
    (_, _, jpts, jvg, _jvp, jt, jres, _jproj, jn2, jT) = want[:10]
    (_, _, pts, vg, _vp, t, res, _proj, n2, T) = got
    np.testing.assert_array_equal(T.numpy(), np.asarray(jT))
    # the matcher's affine, not the stage-2 RANSAC model
    assert abs(int(n2) - int(jn2)) <= 1 and int(n2) > 10
    jvg = np.asarray(jvg)
    assert (vg.numpy() == jvg).mean() >= 0.99
    both = vg.numpy() & jvg
    assert both.sum() > 40
    np.testing.assert_allclose(pts.numpy()[both], np.asarray(jpts)[both], rtol=0, atol=1e-3)
    assert np.linalg.norm(t.numpy() - np.asarray(jt)) <= 1e-3 * np.linalg.norm(np.asarray(jt))
    assert abs(float(res) - float(jres)) < 0.05


def test_rescue_uses_the_given_matcher_and_needs_one(clip, monkeypatch):
    """With a ``fallback_matcher`` the rescue's T23 is the matcher's; without
    one and without cv2 the step raises: it never carries on with an
    identity affine."""
    import builtins

    cfg = _cfg(min_affine_inliers=ALWAYS)
    g0, g1 = clip.reader.grays[0], clip.reader.grays[1]
    _, s = _frame1_state(clip, _jcfg())
    st = state_from_numpy(**s, device="cpu")
    M = np.float32([[0.893, 0.002, 27.9], [0.002, 0.891, 14.1]])
    seen = []

    def matcher(im_prev, im_cur, pts, valid):
        seen.append((im_prev, im_cur, pts.shape, valid.dtype))
        return M

    def step(est):
        return est._frame_step_with_fallback(
            st["pyr"], st["spyr"], torch.as_tensor(g1), st["pts"], st["vg"], st["vp"],
            st["p3"], st["intr"], torch.Generator().manual_seed(0), torch.float32, g0, g1,
            st["t"])

    got = step(SpeedEstimator(cfg, device="cpu", fallback_matcher=matcher))
    np.testing.assert_array_equal(got[9].numpy(), M)
    assert len(seen) == 1 and seen[0][0] is g0 and seen[0][1] is g1
    assert seen[0][2:] == ((FEATURES, 2), np.dtype(bool))
    assert int(got[3].sum()) > 40  # stage 3 tracked through the matcher's affine

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="cv2"):
        step(SpeedEstimator(cfg, device="cpu"))


def _replenish_state(rng):
    """A tracked state on a tilted plane with half the lanes dead."""
    N = FEATURES
    intr_np = (1000.0, 1000.0, 240.0, 135.0)
    t_abs = np.array([0.3, -0.1, 0.5])
    n_pl = np.array([0.2, -0.1, 1.0])
    n_pl /= np.linalg.norm(n_pl)
    pts = np.stack([rng.uniform(150, 330, N), rng.uniform(80, 190, N)], 1).astype(np.float32)
    rays = np.stack([(pts[:, 0] - 240.0) / 1000.0, (pts[:, 1] - 135.0) / 1000.0,
                     np.ones(N)], 1)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    s = (4.0 + n_pl @ t_abs) / (rays @ n_pl)
    p3 = s[:, None] * rays - t_abs
    vg = np.ones(N, bool)
    vg[rng.permutation(N)[: N // 2 + 8]] = False
    vg[0:4] = True
    return pts, vg, p3, t_abs, intr_np


def test_replenish_matches_jax(clip, monkeypatch):
    """_replenish with both packages fed the same Harris output: the same
    re-seeded lanes, points and structure (host numpy on both sides, 1e-12);
    new structure lies on the plane of the live points; plate lanes are
    never re-seeded, live lanes never moved."""
    rng = np.random.default_rng(11)
    pts, vg, p3, t_abs, intr_np = _replenish_state(rng)
    vg[2] = False  # a dead plate lane: detection falls back to q, lane stays dead
    q = clip.annotation.q * SCALE
    p_new = np.stack([rng.uniform(150, 330, FEATURES), rng.uniform(80, 190, FEATURES)],
                     1).astype(np.float32)
    valid_new = rng.uniform(size=FEATURES) < 0.8
    seen = []

    def harris(self, gray, q_now):
        seen.append(np.array(q_now))
        return p_new, valid_new.copy(), None, None

    monkeypatch.setattr(JaxSpeedEstimator, "_init_features", harris)
    monkeypatch.setattr(speedest, "_init_features",
                        lambda cfg, gray, q_now: harris(None, gray, q_now))
    gray = clip.reader.grays[0]
    want = JaxSpeedEstimator(_jcfg())._replenish(gray, q, pts, vg, p3, t_abs, intr_np)
    got = SpeedEstimator(_cfg(), device="cpu")._replenish(gray, q, pts, vg, p3, t_abs, intr_np)
    np.testing.assert_array_equal(seen[0], q)
    np.testing.assert_array_equal(seen[1], q)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert got[3] == want[3] > 0
    new = got[1] & ~vg
    assert new.sum() == got[3] and not new[:4].any() and not got[1][2]
    np.testing.assert_array_equal(got[0][vg], pts[vg])
    np.testing.assert_array_equal(got[2][vg], p3[vg])
    n_pl = np.array([0.2, -0.1, 1.0]) / np.linalg.norm([0.2, -0.1, 1.0])
    np.testing.assert_allclose(got[2][new] @ n_pl, 4.0, atol=1e-9)


def test_replenish_detects_on_the_device(clip):
    """_replenish through the port's own Harris + subpixel init, around the
    tracked plate lanes: dead lanes are refilled with corners of the frame;
    above ``min_live`` nothing changes."""
    est = SpeedEstimator(_cfg(), device="cpu")
    gray = clip.reader.grays[0]
    q = clip.annotation.q * SCALE
    p, valid, _, _ = speedest._init_features(est.config, torch.as_tensor(gray), q)
    t0, p3, _ = speedest._init_geometry(est.config, clip.reader.info, q, p, valid, SCALE)
    intr = clip.reader.info.intrinsics(scale=SCALE)
    intr_np = tuple(float(v) for v in (intr.fx, intr.fy, intr.cx, intr.cy))
    same = est._replenish(gray, q, p, valid, p3, t0, intr_np, min_live=3)
    assert same[3] == 0 and same[0] is p
    vg = valid.copy()
    dead = np.arange(4, FEATURES, 2)
    vg[dead] = False
    pts, vg2, p3_new, n_new = est._replenish(gray, q, p, vg, p3, np.zeros(3), intr_np,
                                             min_live=FEATURES)
    assert n_new > 10 and vg2.sum() == vg.sum() + n_new
    new = vg2 & ~vg
    assert set(np.flatnonzero(new)) <= set(dead)
    # a re-seeded lane holds a corner the detector found, at positive depth
    d = np.linalg.norm(pts[new][:, None, :] - p[valid][None, :, :], axis=2).min(axis=1)
    assert d.max() < 1e-3 and (p3_new[new][:, 2] > 0).all()


@pytest.mark.parametrize("with_matcher", [False, True])
def test_tracker_track_matches_jax(clip, monkeypatch, with_matcher):
    """ThreeStageTracker.track on frames 0 -> 1 against JAX's, image-input
    forms on both sides: without a matcher the stage-2 RANSAC affine within
    1e-3 px over the valid points; with one and the branch forced, the
    matcher's affine exactly. Points within 1e-3 px where both are valid,
    >= 99% equal validity, the quarter-scale frame equal."""
    extra = dict(min_affine_inliers=ALWAYS) if with_matcher else {}
    cfg, jcfg = _cfg(**extra), _jcfg(**extra)
    g0, g1 = clip.reader.grays[0], clip.reader.grays[1]
    jest, s = _frame1_state(clip, jcfg)
    M = np.float32([[0.893, 0.002, 27.9], [0.002, 0.891, 14.1]])
    matcher = (lambda *a: M) if with_matcher else None
    keys, draws = _jax_gumbel_driver(2)
    _inject(monkeypatch, draws)

    jtracker = JaxThreeStageTracker(jcfg.tracker, matcher)
    want = jtracker.track(jnp.asarray(g0), jnp.asarray(g1),
                          jtracker.initial_small(jnp.asarray(g0)), jnp.asarray(s["pts"]),
                          jnp.asarray(s["vg"]), keys[1])
    tracker = ThreeStageTracker(cfg.tracker, matcher)
    im0, im1 = torch.as_tensor(g0), torch.as_tensor(g1)
    got = tracker.track(im0, im1, tracker.initial_small(im0), torch.as_tensor(s["pts"]),
                        torch.as_tensor(s["vg"]))
    assert not draws
    np.testing.assert_array_equal(got.small_cur.numpy(), np.asarray(want.small_cur))
    assert abs(int(got.n_stage2) - int(want.n_stage2)) <= 1
    if with_matcher:
        np.testing.assert_array_equal(got.affine.numpy(), M)
    else:
        src = s["pts"][s["vg"]].astype(np.float64)
        a, b = got.affine.numpy().astype(np.float64), np.asarray(want.affine, np.float64)
        np.testing.assert_allclose(src @ a[:, :2].T + a[:, 2], src @ b[:, :2].T + b[:, 2],
                                   rtol=0, atol=1e-3)
    jv = np.asarray(want.valid)
    assert (got.valid.numpy() == jv).mean() >= 0.99
    both = got.valid.numpy() & jv
    assert both.sum() > 40
    np.testing.assert_allclose(got.points.numpy()[both], np.asarray(want.points)[both],
                               rtol=0, atol=1e-3)
