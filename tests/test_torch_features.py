"""Mirrors of the JAX feature oracle tests (``tests/test_features.py``:
Harris and ``corner_subpix`` against cv2, RANSAC against cv2, warp against
``cv2.remap``) against the port's functions, with the same inputs (the same
seed, drawn in the same order; TestWarp's image excepted, since the JAX file
draws ``sigma_rejection``'s input before it) and tolerances. Where the JAX test checks
``jit``, the mirror checks that two calls under equally seeded
``torch.Generator``s give the same bits. (``sigma_rejection``'s mirror is in
``tests/test_torch_solvers_init.py``.)

``TestSubpixPlainTwin`` (its own seed, after the mirrors): on a CPU tensor
``corner_subpix`` is K4's plain twin, the eager loop as it was before K4,
bit for bit and with no kernel launched; its per-point iteration counts
give that loop's trip count, which the drivers' frame-0 init (and each
re-seeding) adds to the run's counter ``subpix.iterations``. K4 itself is
held to the twin on the card in ``test_torch_kernels.py``."""

import cv2
import numpy as np
import pytest
import torch

from velocity_tpu_torch.ops.harris import corner_subpix, good_features, harris_response
from velocity_tpu_torch.ops.ransac import estimate_affine_ransac, fit_affine_lsq
from velocity_tpu_torch.ops.warp import affine_warp

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
T = torch.as_tensor


def _checkerboardish(h=240, w=320, rng=RNG):
    img = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    img = cv2.GaussianBlur(img, (3, 3), 0)
    return img.astype(np.uint8)


def _generator(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


class TestHarris:
    def test_response_matches_cv2(self):
        img = _checkerboardish()
        want = cv2.cornerHarris(img, blockSize=5, ksize=3, k=0.04)
        got = harris_response(T(img), block=5, k=0.04).numpy()
        # compare away from borders (border handling differs at the edge ring)
        w, g = want[5:-5, 5:-5], got[5:-5, 5:-5]
        np.testing.assert_allclose(g, w, atol=np.abs(w).max() * 1e-4)

    def test_good_features_overlap_cv2(self):
        img = _checkerboardish()
        cvc = cv2.goodFeaturesToTrack(img, 200, 0.01, 0, blockSize=5,
                                      useHarrisDetector=True).squeeze(1)
        got = good_features(T(img), max_corners=200, quality_level=0.01, block=5)
        gpts = got.points.numpy()[got.valid.numpy()]
        # most cv2 corners should appear in ours (within 1 px)
        d = np.linalg.norm(cvc[:, None, :] - gpts[None, :, :], axis=2).min(axis=1)
        assert (d <= 1.0).mean() > 0.9, (d <= 1.0).mean()

    def test_ordering_is_by_response(self):
        img = _checkerboardish()
        got = good_features(T(img), max_corners=64)
        r = got.response.numpy()[got.valid.numpy()]
        assert (np.diff(r) <= 1e-9).all()

    def test_corner_subpix_close_to_cv2(self):
        img = _checkerboardish()
        cvc = cv2.goodFeaturesToTrack(img, 50, 0.01, 10, blockSize=5, useHarrisDetector=True)
        pts = cvc.squeeze(1).astype(np.float32)
        want = cv2.cornerSubPix(
            img, pts.copy(), (5, 5), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 100, 0.001),
        )
        got = corner_subpix(T(img.astype(np.float32)), T(pts), half_win=5).numpy()
        d = np.linalg.norm(got - want, axis=1)
        assert np.median(d) < 0.1, (np.median(d), np.percentile(d, 90))
        # both should stay near the integer detections
        assert np.linalg.norm(got - pts, axis=1).max() < 6.5


class TestRansacAffine:
    def _data(self, n=120, outlier_frac=0.25):
        src = RNG.uniform(0, 300, (n, 2))
        M = np.array([[1.01, 0.02, 5.0], [-0.015, 0.99, -3.0]])
        dst = src @ M[:, :2].T + M[:, 2] + RNG.normal(0, 0.3, (n, 2))
        n_out = int(n * outlier_frac)
        out_idx = RNG.choice(n, n_out, replace=False)
        dst[out_idx] += RNG.uniform(20, 60, (n_out, 2)) * RNG.choice([-1, 1], (n_out, 2))
        inl_true = np.ones(n, bool)
        inl_true[out_idx] = False
        return src.astype(np.float64), dst.astype(np.float64), M, inl_true

    def test_recovers_model_with_outliers(self):
        src, dst, M, inl_true = self._data()
        res = estimate_affine_ransac(T(src), T(dst), generator=_generator())
        np.testing.assert_allclose(res.M.numpy(), M, atol=0.05)
        assert (res.inliers.numpy() == inl_true).mean() > 0.95

    def test_agrees_with_cv2(self):
        src, dst, M, _ = self._data()
        Mcv, inlcv = cv2.estimateAffine2D(src, dst, method=cv2.RANSAC)
        res = estimate_affine_ransac(T(src), T(dst), generator=_generator())
        np.testing.assert_allclose(res.M.numpy(), Mcv, atol=0.05)
        agree = (res.inliers.numpy() == inlcv.ravel().astype(bool)).mean()
        assert agree > 0.9, agree

    def test_masked_lanes_excluded(self):
        src, dst, M, _ = self._data(n=80, outlier_frac=0.0)
        mask = np.ones(100, bool)
        mask[80:] = False
        src_p = np.concatenate([src, np.full((20, 2), np.nan)], 0)
        dst_p = np.concatenate([dst, np.full((20, 2), np.nan)], 0)
        src_p, dst_p = np.nan_to_num(src_p, nan=1e6), np.nan_to_num(dst_p, nan=-1e6)
        res = estimate_affine_ransac(T(src_p), T(dst_p), mask=T(mask), generator=_generator())
        np.testing.assert_allclose(res.M.numpy(), M, atol=0.15)
        assert not res.inliers.numpy()[80:].any()

    def test_lsq_exact_on_clean_data(self):
        src = RNG.uniform(0, 100, (30, 2))
        M = np.array([[0.9, 0.1, 2.0], [-0.1, 1.1, 7.0]])
        dst = src @ M[:, :2].T + M[:, 2]
        got = fit_affine_lsq(T(src), T(dst), torch.ones(30, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got, M, atol=1e-8)

    def test_seeded_generator_determinism(self):
        """(JAX: ``test_jit_and_determinism``) equally seeded generators give
        the same model, bit for bit."""
        src, dst, _, _ = self._data()
        a = estimate_affine_ransac(T(src), T(dst), generator=_generator(5)).M
        b = estimate_affine_ransac(T(src), T(dst), generator=_generator(5)).M
        assert torch.equal(a, b)


class TestWarp:
    def test_matches_cv2_remap(self):
        img = _checkerboardish().astype(np.float32)
        M = np.array([[1.02, 0.01, 3.0], [-0.02, 0.98, -2.0]], np.float32)
        h, w = 100, 140
        ox, oy = 30, 40
        x, y = np.meshgrid(np.arange(ox, ox + w, dtype=np.float32),
                           np.arange(oy, oy + h, dtype=np.float32))
        xm = x * M[0, 0] + y * M[0, 1] + M[0, 2]
        ym = x * M[1, 0] + y * M[1, 1] + M[1, 2]
        want = cv2.remap(img, xm, ym, cv2.INTER_LINEAR)
        got = affine_warp(T(img), T(M), (h, w), offset=(ox, oy)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-2)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])


def _corner_subpix_before(img, points, half_win=5, max_iters=100, eps=0.001):
    """``corner_subpix`` as it was before K4 (the eager loop with its
    early exit), returning (refined points, the loop's trip count)."""
    from velocity_tpu_torch.ops.lk_lanes import _extract_slabs, _sample_taps

    dtype = points.dtype if points.is_floating_point() else torch.float32
    pts = points.to(dtype)
    x = img.to(dtype)
    wsize = 2 * half_win + 1
    gsize = wsize + 2
    drift_max = half_win + 1
    Q = gsize + 2 * (drift_max + 1)
    n_taps = Q - gsize + 1
    corner = torch.floor(pts).to(torch.int32) - gsize // 2 - drift_max - 1
    slabs, cl = _extract_slabs(x, corner, Q)
    cl = cl.to(dtype)
    off = torch.arange(wsize, dtype=dtype) - half_win
    m1d = torch.exp(-(off * off) * (1.0 / (half_win * half_win)))
    mask2d = (m1d[:, None] * m1d[None, :])[None]
    offx, offy = off[None, None, :], off[None, :, None]
    gh = (gsize - 1) * 0.5
    tiny16 = torch.finfo(dtype).tiny * 16
    q = pts
    done = torch.zeros(pts.shape[0], dtype=torch.bool)
    trips = 0
    for _ in range(max_iters):
        if bool(torch.all(done)):
            break
        trips += 1
        ox = q[:, 0] - gh - cl[:, 0]
        oy = q[:, 1] - gh - cl[:, 1]
        patch = _sample_taps(slabs, oy, ox, gsize, n_taps)
        gx = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.5
        gy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.5
        gxx = torch.sum(gx * gx * mask2d, dim=(1, 2))
        gxy = torch.sum(gx * gy * mask2d, dim=(1, 2))
        gyy = torch.sum(gy * gy * mask2d, dim=(1, 2))
        bx = torch.sum((gx * gx * offx + gx * gy * offy) * mask2d, dim=(1, 2))
        by = torch.sum((gx * gy * offx + gy * gy * offy) * mask2d, dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        safe = torch.abs(det) > tiny16
        inv = torch.where(safe, 1.0 / det, torch.zeros_like(det))
        dx = (gyy * bx - gxy * by) * inv
        dy = (gxx * by - gxy * bx) * inv
        step = torch.stack([dx, dy], dim=1)
        q_new = torch.where((done | ~safe)[:, None], q, q + step)
        done = done | (torch.sum(step * step, dim=1) < eps * eps) | ~safe
        done = done | (torch.abs(q_new - pts) > drift_max).any(dim=1)
        q = q_new
    return q, trips


def _subpix_seeds(rng):
    """An image and 200 seeds from ``good_features`` on it, padded ones
    included (as the drivers refine them)."""
    img = T(_checkerboardish(rng=rng).astype(np.float32))
    return img, good_features(img, max_corners=200).points


class TestSubpixPlainTwin:
    @pytest.mark.parametrize("max_iters", [3, 100])
    def test_cpu_corner_subpix_is_the_loop_before_k4(self, max_iters):
        """No kernel launches (K4's counter stays 0), the points are the
        old loop's bit for bit, and the most iterations a point ran is the
        old loop's trip count (cut at ``max_iters`` or stopped early)."""
        from velocity_tpu_torch.ops import harris, launches

        img, seeds = _subpix_seeds(np.random.default_rng(17))
        want, trips = _corner_subpix_before(img, seeds, max_iters=max_iters)
        saved = launches.read()
        try:
            launches.set_counts()
            got = corner_subpix(img, seeds, half_win=5, max_iters=max_iters)
            refined, iters = harris._corner_subpix(img, seeds, 5, max_iters, 0.001)
            assert launches.read()["corner_subpix"] == (0, {})
        finally:
            launches.set_counts(saved)
        assert torch.equal(got, want) and torch.equal(refined, want)
        assert iters.dtype == torch.int32 and iters.shape == (seeds.shape[0],)
        assert int(iters.max()) == trips
        assert 0 < trips <= max_iters and (trips == 3 if max_iters == 3 else trips < 100)
        assert int(iters.min()) >= 1

    def test_drivers_count_the_trip_count_of_each_refinement(self, monkeypatch):
        """A scan run on the small clip adds its frame-0 refinement's trip
        count to ``subpix.iterations``; a stills burst whose lanes die
        adds the frame-0 one and its re-seeding's."""
        import dataclasses

        from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
        from velocity_tpu_torch.pipeline import speedest
        from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
        from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator
        from velocity_tpu_torch.testing.synthetic_clip import SyntheticStillsReader, render_clip

        trips = []
        real = speedest._corner_subpix

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            trips.append(int(out[1].max()))
            return out

        monkeypatch.setattr(speedest, "_corner_subpix", spy)
        msv, n = 3, 5

        def cfg(**tracker):
            return PipelineConfig(solver=SolverConfig(dtype="float32"), msv_frame=msv,
                                  anchor="ba", tracker=TrackerConfig(
                                      max_features=64, ransac_trials=32, **tracker))

        clip = render_clip(n_frames=n, width=480, height=270, seed=0)
        res = ScanSpeedRunner(cfg(), device="cpu").run(
            clip.reader, annotation=clip.annotation, n_frames=n, verbose=False, lean=True)
        assert len(trips) == 1 and trips[0] > 0
        assert res.timings["counts"]["subpix.iterations"] == trips[0]

        # few strong corners, so lanes die and are re-seeded in the MSV frame
        trips.clear()
        burst = render_clip(n_frames=n, width=480, height=270, seed=0, speed_kmh=40.0,
                            depth0_m=4.0, stride=3, filename="synthetic.JPG",
                            native_scale=1.0)
        full = burst.stills()
        reader = SyntheticStillsReader(full.grays, full.info, full.fps)
        res = StillsSpeedEstimator(
            dataclasses.replace(cfg(car_affine=True, harris_quality=0.6), native_scale=1.0),
            device="cpu").run(reader, annotation=burst.annotation, verbose=False)
        assert len(trips) == 2 and min(trips) > 0
        assert res.timings["counts"]["subpix.iterations"] == sum(trips)
