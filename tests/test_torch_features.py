"""Mirrors of the JAX feature oracle tests (``tests/test_features.py``:
Harris and ``corner_subpix`` against cv2, RANSAC against cv2, warp against
``cv2.remap``) against the port's functions, with the same inputs (the same
seed, drawn in the same order; TestWarp's image excepted, since the JAX file
draws ``sigma_rejection``'s input before it) and tolerances. Where the JAX test checks
``jit``, the mirror checks that two calls under equally seeded
``torch.Generator``s give the same bits. (``sigma_rejection``'s mirror is in
``tests/test_torch_solvers_init.py``.)"""

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


def _checkerboardish(h=240, w=320):
    img = RNG.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
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
